// What the s2d conv sources share: the argument block of the psel and
// dec-conv1 C entries (psel_conv.cu, dec_conv1.cu), and the tile constants
// and launch helper of wconv.cu's SIMT kernel. Which kernel runs is decided
// in Python, by the op of each U-Net site (ops/kernels/psconv.py); these
// sources launch only the widths they are instantiated for and return
// cudaErrorInvalidValue for any other.
//
// Layout. An s2d tensor is (B, Hh, Ww, 4C) with channel index ph*C + c,
// ph = 2*py + px. Full-resolution pixel (y, x, c) lives at s2d
// (y/2, x/2, ((y%2)*2 + x%2)*C + c).
//
// Sharded entries (K9, the halo form of psel; dec_conv1's halo form). An
// H-shard of the s2d grid is computed alone: the s2d rows just above and
// below it (one each, (B, 1, Ww, channels), from the neighbouring shards)
// arrive as separate pointers and are staged in place of rows -1 and hh; a
// null pointer is a global border and reads zero, as the unsharded launch
// does. dec_conv1's bias field reads its border class from the global row,
// row0 + gi against hh_glob (the unsharded launch passes 0 and hh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mgu {

constexpr int TH = 4;                  // s2d rows per block (8 full-res)
constexpr int TW = 16;                 // s2d cols per block (32 full-res)
constexpr int THREADS = 256;           // 8 warps
constexpr int HALO_H = TH + 2;         // staged s2d halo, also x_prev's
constexpr int HALO_W = TW + 2;
constexpr int HALO_PIX = HALO_H * HALO_W;

struct ConvArgs {
  const void* x;      // (B, Hh, Ww, 4C) s2d input
  const void* w;      // weights, as psel_conv.cu's and dec_conv1.cu's entries take them
  const void* xp;     // (B, Hh, Ww, Cp) x_prev (dec_conv1 only)
  const void* wp;     // x_prev weights (dec_conv1 only)
  const float* bias;  // (Cout,) (psel only); null adds none
  const float* t9;    // (3, 3, 4Cout) bias + upsample-bias class table (dec_conv1 only)
  void* y;            // (B, Hh, Ww, 4Cout) s2d output
  int b, hh, ww, c, cp, cout;
  // Sharded launches: the rows above and below the shard of x and x_prev,
  // (B, 1, Ww, channels), null at a global border; the global row of local
  // row 0 and the global s2d height (the unsharded launch: 0 and hh).
  const void *x_top = nullptr, *x_bot = nullptr, *xp_top = nullptr, *xp_bot = nullptr;
  int row0 = 0, hh_glob = 0;
};

// Launch `kern` over the TH x TW tiles of the (b, hh, ww) s2d grid of `a`
// (wconv.cu's SIMT kernel and its arguments).
template <typename Kern, typename Args>
int launch(Kern kern, const Args& a, size_t smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.ww + TW - 1) / TW, (a.hh + TH - 1) / TH, a.b);
  kern<<<grid, THREADS, smem_bytes, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace mgu
