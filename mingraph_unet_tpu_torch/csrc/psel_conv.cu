// 3x3 'SAME' conv + bias of a phase-major s2d tensor, with or without ReLU.
// With ReLU it is the s2d ConvBlock's inference conv2 and replaces
// mingraph_unet_tpu/ops/pallas/psconv.py::conv3x3_s2d_psel. Without it (bias
// null) it is the raw training conv of psconv.py::psconv_train: its forward,
// and its dgrad on the cotangent with the flipped, in/out-transposed kernel.
// The tile design is in conv_tile.cuh.
#include "conv_tile.cuh"

extern "C" int mgu_psel_conv3x3(const void* x, const void* w, const float* bias, void* y,
                                int b, int hh, int ww, int c, int cout, int is_bf16, int relu,
                                void* stream) {
  mgu::ConvArgs a{x, w, nullptr, nullptr, bias, nullptr, y, b, hh, ww, c, 0, cout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return relu ? mgu::launch_conv_tile<false, true>(a, is_bf16 != 0, s)
              : mgu::launch_conv_tile<false, false>(a, is_bf16 != 0, s);
}
