// relu(3x3 'SAME' conv + bias) of a phase-major s2d tensor: the s2d
// ConvBlock's conv2. Replaces mingraph_unet_tpu/ops/pallas/psconv.py::
// conv3x3_s2d_psel. The tile design is in conv_tile.cuh.
#include "conv_tile.cuh"

extern "C" int mgu_psel_conv3x3(const void* x, const void* w, const float* bias, void* y,
                                int b, int hh, int ww, int c, int cout, int is_bf16,
                                void* stream) {
  mgu::ConvArgs a{x, w, nullptr, nullptr, bias, nullptr, y, b, hh, ww, c, 0, cout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mgu::launch_conv_tile<false>(a, is_bf16 != 0, s);
}
