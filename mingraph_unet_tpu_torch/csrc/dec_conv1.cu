// relu(conv3x3([skip | ConvTranspose2x2(x_prev)]) + bias) in s2d layout: the
// s2d decoder block's conv1 with the upsample folded in. Replaces
// mingraph_unet_tpu/ops/pallas/psconv.py::dec_conv1_fused. The skip term is
// the conv_tile.cuh main term; the x_prev term runs on x_prev's own grid
// with ConvTranspose-folded weights; the upsample-bias field and the bias
// arrive as a (3, 3, 4Cout) border-class table applied in the epilogue.
//
// mgu_dec_conv1_halo is the same conv on one H-shard of the s2d grid (the
// spatially sharded U-Net's decoder conv1): the rows above and below the
// shard of both inputs arrive apart (null at a global border), and the bias
// field's border class is taken from the global row (row0 + local row
// against hh_glob), so an inner shard's first row is interior and not the
// SAME padding of the upsample.
#include "conv_tile.cuh"

extern "C" int mgu_dec_conv1(const void* xs, const void* xp, const void* ws, const void* wp,
                             const float* t9, void* y, int b, int hh, int ww, int cs, int cp,
                             int cout, int is_bf16, void* stream) {
  mgu::ConvArgs a{xs, ws, xp, wp, nullptr, t9, y, b, hh, ww, cs, cp, cout};
  a.hh_glob = hh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mgu::launch_dec_conv1(a, is_bf16 != 0, s);
}

extern "C" int mgu_dec_conv1_halo(const void* xs, const void* xs_top, const void* xs_bot, const void* xp,
                                  const void* xp_top, const void* xp_bot, const void* ws, const void* wp,
                                  const float* t9, void* y, int b, int hh, int ww, int cs, int cp, int cout,
                                  int row0, int hh_glob, int is_bf16, void* stream) {
  mgu::ConvArgs a{xs, ws, xp, wp, nullptr, t9, y, b, hh, ww, cs, cp, cout};
  a.x_top = xs_top;
  a.x_bot = xs_bot;
  a.xp_top = xp_top;
  a.xp_bot = xp_bot;
  a.row0 = row0;
  a.hh_glob = hh_glob;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mgu::launch_dec_conv1(a, is_bf16 != 0, s);
}
