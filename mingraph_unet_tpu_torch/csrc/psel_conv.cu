// 3x3 'SAME' conv + bias of a phase-major s2d tensor, with or without ReLU.
// With ReLU it is the s2d ConvBlock's inference conv2 and replaces
// mingraph_unet_tpu/ops/pallas/psconv.py::conv3x3_s2d_psel. Without it (bias
// null) it is the raw training conv of psconv.py::psconv_train: its forward,
// and its dgrad on the cotangent with the flipped, in/out-transposed kernel.
// The tile design is in conv_tile.cuh.
//
// mgu_psel_conv3x3_halo is the same conv on one H-shard of the s2d grid,
// with the rows above and below the shard passed apart (null at a global
// border): it replaces mingraph_unet_tpu/parallel/halo.py::sharded_psconv,
// which concatenates the exchanged rows to the shard, runs the psel kernel
// on the extended block and discards its first and last output rows. Here
// the two rows are staged in place of the zero padding, so neither the
// shard-sized concat nor the discarded rows exist; the bound is the
// unsharded kernel's on the shard's bytes (memory, at the U-Net's widths).
#include "conv_tile.cuh"

extern "C" int mgu_psel_conv3x3(const void* x, const void* w, const float* bias, void* y,
                                int b, int hh, int ww, int c, int cout, int is_bf16, int relu,
                                void* stream) {
  mgu::ConvArgs a{x, w, nullptr, nullptr, bias, nullptr, y, b, hh, ww, c, 0, cout};
  a.hh_glob = hh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return relu ? mgu::launch_conv_tile<false, true>(a, is_bf16 != 0, s)
              : mgu::launch_conv_tile<false, false>(a, is_bf16 != 0, s);
}

extern "C" int mgu_psel_conv3x3_halo(const void* x, const void* x_top, const void* x_bot, const void* w,
                                     const float* bias, void* y, int b, int hh, int ww, int c, int cout,
                                     int is_bf16, int relu, void* stream) {
  mgu::ConvArgs a{x, w, nullptr, nullptr, bias, nullptr, y, b, hh, ww, c, 0, cout};
  a.x_top = x_top;
  a.x_bot = x_bot;
  a.hh_glob = hh;  // read only by dec_conv1's bias field
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return relu ? mgu::launch_conv_tile<false, true>(a, is_bf16 != 0, s)
              : mgu::launch_conv_tile<false, false>(a, is_bf16 != 0, s);
}
