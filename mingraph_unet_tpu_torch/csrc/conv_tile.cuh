// Tiled 3x3 'SAME' conv on a phase-major space-to-depth (s2d) tensor in
// f32: the FMA kernel that psel_conv.cu runs for f32 inputs at widths its
// tensor-core kernels have no instantiation for (Cin != Cout, or C outside
// {32, 64}: the s2d ConvBlock's conv2; without ReLU, the raw training conv's
// forward and dgrad) and dec_conv1.cu runs for every f32 input (the s2d
// decoder's conv1 with the ConvTranspose folded in). The bf16 paths, and
// psel's f32 path at C = Cout in {32, 64}, are Hopper kernels (psel_conv.cu,
// dec_conv1.cu, hopper.cuh); they and wconv.cu take the argument block and
// the launch helper from here.
//
// Layout. An s2d tensor is (B, Hh, Ww, 4C) with channel index ph*C + c,
// ph = 2*py + px. Full-resolution pixel (y, x, c) lives at s2d
// (y/2, x/2, ((y%2)*2 + x%2)*C + c). The kernel computes the full-resolution
// conv on that layout: the useful FLOPs only, not the dense s2d form's 4x or
// the TPU phase-select form's 16/9x.
//
// Work split. One block of 256 threads owns a 4 x 16 s2d tile (8 x 32
// full-res pixels) of one image and all output channels. It copies the
// tile's s2d input halo (6 x 18 s2d pixels, all 4C channels, zero outside
// the image) into shared memory once, then each thread computes one
// full-res pixel by plain FMA, weights from the raw HWIO kernel (ADJ: the
// adjoint's, read flipped and in/out transposed from the raw kernel), ReLU
// when RELU is set. It runs on the f32 FMA units (67 TFLOP/s on an H100
// SXM) and is not tuned: it serves the widths and the dec-conv1 path that
// no tensor-core kernel covers yet.
//
// The optional second source (HAS_PREV) is dec_conv1's x_prev term: a 3x3
// conv on x_prev's own (Hh, Ww) grid with the dense ConvTranspose-folded
// weights (3, 3, Cp, 4Cout), whose output columns depend on the output
// pixel's phase; the bias arrives as dec_conv1's (3, 3, 4Cout) border-class
// table.
//
// Sharded entries (K9, the halo form of psel; dec_conv1's halo form). An
// H-shard of the s2d grid is computed alone: the s2d rows just above and
// below it (one each, (B, 1, Ww, channels), from the neighbouring shards)
// arrive as separate pointers and are staged in place of rows -1 and hh; a
// null pointer is a global border and reads zero, as the unsharded launch
// does. Only the shard's own rows are computed and written. dec_conv1's
// bias field reads its border class from the global row, row0 + gi against
// hh_glob (the unsharded launch passes 0 and hh). The taps are summed in the
// same order as the unsharded launch, so stitched shards equal it bit for
// bit.
//
// Requirements (checked by the Python wrappers): all tensors contiguous,
// 16-byte aligned base pointers; C, Cp and Cout multiples of 16.
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
constexpr int PAD = 8;                 // elements appended to each staged pixel

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// Shared memory: the s2d halo of x (4C channels per pixel), then the halo of
// x_prev (Cp channels) when present. Identical on host and device.
template <typename T>
struct SmemPlan {
  int ss, sp;  // staged pixel strides, in elements
  size_t prev_off, bytes;
  __host__ __device__ SmemPlan(int c, int cp, bool has_prev) {
    ss = 4 * c + PAD;
    sp = cp + PAD;
    prev_off = align128(size_t(HALO_PIX) * ss * sizeof(T));
    bytes = prev_off + (has_prev ? align128(size_t(HALO_PIX) * sp * sizeof(T)) : 0);
  }
};

struct ConvArgs {
  const void* x;      // (B, Hh, Ww, 4C) s2d input
  const void* w;      // full-res (3, 3, C, Cout) weights: f32 HWIO, the raw (3, 3, Cout, C) kernel for ADJ (bf16: as the Hopper kernel takes them)
  const void* xp;     // (B, Hh, Ww, Cp) x_prev (HAS_PREV only)
  const void* wp;     // x_prev weights (HAS_PREV only): f32 the dense folded (3, 3, Cp, 4Cout) HWIO
  const float* bias;  // (Cout,) when !HAS_PREV; null adds none
  const float* t9;    // (3, 3, 4Cout) bias + upsample-bias class table (HAS_PREV)
  void* y;            // (B, Hh, Ww, 4Cout) s2d output
  int b, hh, ww, c, cp, cout;
  // Sharded launches: the rows above and below the shard of x and x_prev,
  // (B, 1, Ww, channels), null at a global border; the global row of local
  // row 0 and the global s2d height (the unsharded launch: 0 and hh).
  const void *x_top = nullptr, *x_bot = nullptr, *xp_top = nullptr, *xp_bot = nullptr;
  int row0 = 0, hh_glob = 0;
};

// Copy the HALO_H x HALO_W pixels of an NHWC tensor (B, hh, ww, ch) around
// grid pixel (i0, j0) of image b into shared memory (pixel stride `stride`
// elements), 16 bytes at a time: channels [c0, c0 + nch) of each pixel
// (all of them by default; both multiples of 16 bytes). Row -1 is read from
// `top` and row hh from `bot`, each (B, 1, ww, ch), where given; every other
// pixel outside the image is zero (SAME padding).
template <typename T>
__device__ void stage_halo(T* dst, int stride, const T* src, int b, int i0, int j0, int hh, int ww, int ch,
                           const T* top = nullptr, const T* bot = nullptr, int c0 = 0, int nch = -1) {
  constexpr int VE = 16 / sizeof(T);
  const int vpp = (nch < 0 ? ch : nch) / VE;
  const int total = HALO_PIX * vpp;
#pragma unroll 4
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int v = i % vpp;
    const int pix = i / vpp;
    const int gi = i0 - 1 + pix / HALO_W;
    const int gj = j0 - 1 + pix % HALO_W;
    const size_t off = size_t(c0) + size_t(v) * VE;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gj >= 0 && gj < ww) {
      if (gi >= 0 && gi < hh)
        val = *reinterpret_cast<const uint4*>(src + ((size_t(b) * hh + gi) * ww + gj) * size_t(ch) + off);
      else if (gi == -1 && top)
        val = *reinterpret_cast<const uint4*>(top + (size_t(b) * ww + gj) * size_t(ch) + off);
      else if (gi == hh && bot)
        val = *reinterpret_cast<const uint4*>(bot + (size_t(b) * ww + gj) * size_t(ch) + off);
    }
    *reinterpret_cast<uint4*>(dst + size_t(pix) * stride + size_t(v) * VE) = val;
  }
}

// Epilogue term for s2d pixel (gi, gj), phase p, output channel n. Without
// x_prev it is the bias, or zero when the bias pointer is null (the raw
// training conv). With x_prev, the (3, 3) class table is weighted by
// (first, interior, last) row and column indicators written additively,
// (f, 1 - f - l, l): when the s2d grid is one pixel high or wide a pixel is
// both first and last and the weights (1, -1, 1) give the value with both
// border taps invalid, exactly as the analytic bias field does.
template <bool HAS_PREV>
__device__ __forceinline__ float epilogue_term(const ConvArgs& a, int gi, int gj, int p, int n) {
  if constexpr (!HAS_PREV) {
    return a.bias ? a.bias[n] : 0.f;
  } else {
    const int z = 4 * a.cout;
    const float* t = a.t9 + p * a.cout + n;
    const int row = a.row0 + gi;  // the global row: a shard's first row is interior unless it is row 0
    const float fr = row == 0 ? 1.f : 0.f, lr = row == a.hh_glob - 1 ? 1.f : 0.f;
    const float fc = gj == 0 ? 1.f : 0.f, lc = gj == a.ww - 1 ? 1.f : 0.f;
    if (fr + lr + fc + lc == 0.f) return t[4 * z];  // interior: class (1, 1)
    const float wr[3] = {fr, 1.f - fr - lr, lr};
    const float wc[3] = {fc, 1.f - fc - lc, lc};
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int q = 0; q < 3; ++q) s += wr[r] * wc[q] * t[(r * 3 + q) * z];
    return s;
  }
}

// f32 FMA kernel: one full-res output pixel per thread, 16 output channels
// at a time, sizes at run time. Weight (tap, ci, n) is w[tap][ci][n], or
// with ADJ (the dgrad of psel_conv's training conv, without HAS_PREV)
// w[8 - tap][n][ci] of the raw kernel the adjoint is taken of.
template <bool HAS_PREV, bool RELU, bool ADJ = false>
__global__ void __launch_bounds__(THREADS) conv_f32_kernel(ConvArgs a) {
  static_assert(!(HAS_PREV && ADJ), "dec_conv1's weights are never adjoint");
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemPlan<float> plan(a.c, a.cp, HAS_PREV);
  float* halo = reinterpret_cast<float*>(smem);
  float* prev = reinterpret_cast<float*>(smem + plan.prev_off);
  const int bi = blockIdx.z, i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  stage_halo<float>(halo, plan.ss, reinterpret_cast<const float*>(a.x), bi, i0, j0, a.hh, a.ww, 4 * a.c,
                    reinterpret_cast<const float*>(a.x_top), reinterpret_cast<const float*>(a.x_bot));
  if constexpr (HAS_PREV)
    stage_halo<float>(prev, plan.sp, reinterpret_cast<const float*>(a.xp), bi, i0, j0, a.hh, a.ww, a.cp,
                      reinterpret_cast<const float*>(a.xp_top), reinterpret_cast<const float*>(a.xp_bot));
  __syncthreads();

  const float* w = reinterpret_cast<const float*>(a.w);
  const float* wp = reinterpret_cast<const float*>(a.wp);
  const int r = threadIdx.x / (2 * TW), col = threadIdx.x % (2 * TW);  // full-res, in the tile
  const int i = r >> 1, j = col >> 1, p = (r & 1) * 2 + (col & 1);
  const int gi = i0 + i, gj = j0 + j;
  const bool inside = gi < a.hh && gj < a.ww;
  const int cout = a.cout, z = 4 * cout;
  float* out = reinterpret_cast<float*>(a.y) + ((size_t(bi) * a.hh + gi) * a.ww + gj) * size_t(z) + p * cout;
  for (int n0 = 0; n0 < cout; n0 += 16) {
    float acc[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) acc[q] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      // full-res (r + ky - 1, col + kx - 1) in the s2d halo
      const int fy = r + tap / 3 + 1, fx = col + tap % 3 + 1;
      const float* src = halo + ((fy >> 1) * HALO_W + (fx >> 1)) * plan.ss + ((fy & 1) * 2 + (fx & 1)) * a.c;
      if constexpr (ADJ) {
        const float* wt = w + size_t(8 - tap) * a.c * cout + size_t(n0) * a.c;
        for (int ci = 0; ci < a.c; ++ci) {
          const float v = src[ci];
#pragma unroll
          for (int q = 0; q < 16; ++q) acc[q] = fmaf(v, wt[size_t(q) * a.c + ci], acc[q]);
        }
      } else {
        const float* wt = w + size_t(tap) * a.c * cout + n0;
        for (int ci = 0; ci < a.c; ++ci) {
          const float v = src[ci];
#pragma unroll
          for (int q = 0; q < 16; ++q) acc[q] = fmaf(v, wt[size_t(ci) * cout + q], acc[q]);
        }
      }
    }
    if constexpr (HAS_PREV) {
      for (int tap = 0; tap < 9; ++tap) {
        const float* src = prev + ((i + tap / 3) * HALO_W + j + tap % 3) * plan.sp;
        const float* wt = wp + size_t(tap) * a.cp * z + p * cout + n0;
        for (int ci = 0; ci < a.cp; ++ci) {
          const float v = src[ci];
#pragma unroll
          for (int q = 0; q < 16; ++q) acc[q] = fmaf(v, wt[size_t(ci) * z + q], acc[q]);
        }
      }
    }
    if (inside) {
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const float v = acc[q] + epilogue_term<HAS_PREV>(a, gi, gj, p, n0 + q);
        out[n0 + q] = RELU ? fmaxf(v, 0.f) : v;
      }
    }
  }
}

// Launch `kern` over the TH x TW tiles of the (b, hh, ww) s2d grid of `a`
// (ConvArgs here, wconv.cu's own arguments there).
template <typename Kern, typename Args>
int launch(Kern kern, const Args& a, size_t smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.ww + TW - 1) / TW, (a.hh + TH - 1) / TH, a.b);
  kern<<<grid, THREADS, smem_bytes, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace mgu
