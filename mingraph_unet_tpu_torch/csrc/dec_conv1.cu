// relu(conv3x3([skip | ConvTranspose2x2(x_prev)]) + bias) in s2d layout: the
// s2d decoder block's conv1 with the upsample folded in. Replaces
// mingraph_unet_tpu/ops/pallas/psconv.py::dec_conv1_fused. The skip term is
// the conv_tile.cuh main term; the x_prev term runs on x_prev's own grid
// with ConvTranspose-folded weights; the upsample-bias field and the bias
// arrive as a (3, 3, 4Cout) border-class table applied in the epilogue.
#include "conv_tile.cuh"

extern "C" int mgu_dec_conv1(const void* xs, const void* xp, const void* ws, const void* wp,
                             const float* t9, void* y, int b, int hh, int ww, int cs, int cp,
                             int cout, int is_bf16, void* stream) {
  mgu::ConvArgs a{xs, ws, xp, wp, nullptr, t9, y, b, hh, ww, cs, cp, cout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mgu::launch_conv_tile<true, true>(a, is_bf16 != 0, s);
}
