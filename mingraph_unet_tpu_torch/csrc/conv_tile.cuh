// Tiled 3x3 'SAME' conv on a phase-major space-to-depth (s2d) tensor: the
// mma.sync tile of dec_conv1.cu (the s2d decoder's conv1 with the
// ConvTranspose folded in; K2, bf16 and f32), and the f32 FMA kernel that
// psel_conv.cu also runs for f32 inputs (the s2d ConvBlock's conv2; without
// ReLU, the raw training conv's forward and dgrad). psel's bf16 path is
// its own Hopper kernel (psel_conv.cu, hopper.cuh); wconv.cu takes the
// halo geometry, ldmatrix and the launch helper from here.
//
// Layout. An s2d tensor is (B, Hh, Ww, 4C) with channel index ph*C + c,
// ph = 2*py + px. Full-resolution pixel (y, x, c) lives at s2d
// (y/2, x/2, ((y%2)*2 + x%2)*C + c). The kernel computes the full-resolution
// conv on that layout: the useful FLOPs only, not the dense s2d form's 4x or
// the TPU phase-select form's 16/9x.
//
// Work split (dec_conv1 in bf16, and both in f32). One block of 256
// threads owns a 4 x 16 s2d tile (8 x 32 full-res pixels) of one image and
// all output channels. It copies the
// tile's s2d input halo (6 x 18 s2d pixels, all 4C channels, zero outside the
// image) into shared memory once, then runs an implicit GEMM over it:
// M = the tile's pixels, N = Cout, K = 9 taps x C.
//   bf16: tensor cores through mma.sync m16n8k16 (f32 accumulate). Warp w
//         owns the 32 pixels of phase p = w % 4 in s2d rows 2*(w / 4) and
//         2*(w / 4) + 1. Their 16-pixel rows read 16 consecutive halo pixels
//         for every tap (the tap picks the halo row, column offset and
//         input phase), so each A fragment is one ldmatrix.x4 from shared
//         memory. Staged pixels are padded by 16 bytes, which puts the 8 row
//         addresses of an ldmatrix phase in 8 different bank groups. The
//         weights arrive pre-packed in B-fragment order (psconv.py): a lane
//         reads its 4 values as one 8-byte load, and the 8 warps share them
//         through L1. Accumulators stay in registers; the epilogue adds the
//         bias field, applies the ReLU and writes bf16 pairs in the s2d
//         layout. The unroll depth and blocks per SM were picked by timing
//         variants at the serving shapes on an H100 (PERF.md).
//   f32:  plain FMA, one full-res pixel per thread, weights in their HWIO
//         layout, ReLU when RELU is set (psel, dec_conv1; the raw training
//         conv leaves it off). This path exists so that a card run can be
//         held against the CPU in f32; it is not tuned.
//
// The optional second source (HAS_PREV) is dec_conv1's x_prev term: a 3x3
// conv on x_prev's own (Hh, Ww) grid with ConvTranspose-folded weights
// (3, 3, Cp, 4Cout) whose output columns depend on the output pixel's phase.
// Warp w's pixels all have phase p, so they read one column block of those
// weights, and its rows read 16 consecutive x_prev halo pixels.
//
// Bound. dec_conv1's function needs at least 2*20*C*C operations per full-res
// pixel (the ConvTranspose, then the conv over [skip ‖ up]) and moves 2.5C
// values; that puts its bound on the memory line at level 0 and on the
// tensor-core line at level 1. The folded form this kernel runs does
// 2*27*C*C (the x_prev term runs at Cp = 2C with 4Cout columns per s2d
// pixel) in exchange for never writing the upsampled tensor. The tile
// reads every input byte from device memory once apart from the halo
// (18 x 6 s2d pixels staged per 16 x 4 computed, mostly L2 hits), keeps the
// full-res im2col and the upsampled decoder tensor out of device memory, and
// writes each output once in its final layout.
//
// Sharded entries (K9 in f32, the halo form of psel; dec_conv1's halo
// form). An
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
// 16-byte aligned base pointers. bf16: Cout = C in {32, 64} (the U-Net's two
// s2d levels) and, for dec_conv1, Cp = 2C. f32: C, Cp and Cout multiples
// of 16.
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
  const void* w;      // full-res (3, 3, C, Cout) weights: f32 HWIO, or bf16 in B-fragment order
  const void* xp;     // (B, Hh, Ww, Cp) x_prev (HAS_PREV only)
  const void* wp;     // folded (3, 3, Cp, 4Cout) x_prev weights, laid out as w (HAS_PREV only)
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// acc += A (16x16, row-major, from ldmatrix_x4) * B (16x8, packed pair).
__device__ __forceinline__ void mma_bf16(float (&acc)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// One GEMM term of a warp: acc[mi][j] += sum over 9 taps and K / 16 steps of
// A(rows of s2d row ib + mi) * B(step, column tile col0 + j). `a_of(tap)`
// gives the shared-memory address of the warp's first A row for s2d row ib
// (lane offsets included); `row_step` is the staged distance to row ib + 1.
// B is packed as (9 * K / 16, ncols / 8, 32 lanes) uint2 (psconv.py).
template <int K, int NT, typename AOf>
__device__ __forceinline__ void mma_term(float (&acc)[2][NT][4], AOf a_of, int row_step,
                                         const uint2* __restrict__ bp, int ncols8, int col0,
                                         int lane) {
  // Unrolling the taps at K > 64 lets the compiler hoist more B loads than
  // 128 registers hold; the spills cost 4x at dec_conv1's level-1 width.
  constexpr int kTapUnroll = K <= 64 ? 9 : 1;
#pragma unroll kTapUnroll
  for (int tap = 0; tap < 9; ++tap) {
    const __nv_bfloat16* arow = a_of(tap);
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks) {
      uint32_t af[2][4];
      ldmatrix_x4(af[0], arow + ks * 16);
      ldmatrix_x4(af[1], arow + row_step + ks * 16);
      const uint2* bk = bp + (size_t(tap * (K / 16) + ks) * ncols8 + col0) * 32 + lane;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint2 b = __ldg(bk + j * 32);
        mma_bf16(acc[0][j], af[0], b);
        mma_bf16(acc[1][j], af[1], b);
      }
    }
  }
}

// bf16 tensor-core kernel of dec_conv1 (the x_prev term and the ReLU always
// on); C = Cout, Cp = 2C (compile time, so the loops unroll and the
// accumulators stay in registers). 2 blocks per SM (128 registers).
template <int C>
__global__ void __launch_bounds__(THREADS, 2) conv_bf16_kernel(ConvArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int COUT = C, CP = 2 * C;
  constexpr int NCH = COUT < 64 ? COUT : 64;  // output channels per pass
  constexpr int NT = NCH / 8;                 // mma column tiles per pass
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemPlan<bf16> plan(C, CP, true);
  bf16* halo = reinterpret_cast<bf16*>(smem);
  bf16* prev = reinterpret_cast<bf16*>(smem + plan.prev_off);
  const int bi = blockIdx.z, i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  stage_halo<bf16>(halo, plan.ss, reinterpret_cast<const bf16*>(a.x), bi, i0, j0, a.hh, a.ww, 4 * C,
                   reinterpret_cast<const bf16*>(a.x_top), reinterpret_cast<const bf16*>(a.x_bot));
  stage_halo<bf16>(prev, plan.sp, reinterpret_cast<const bf16*>(a.xp), bi, i0, j0, a.hh, a.ww, CP,
                   reinterpret_cast<const bf16*>(a.xp_top), reinterpret_cast<const bf16*>(a.xp_bot));
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = warp & 3, py = p >> 1, px = p & 1;
  const int ib = 2 * (warp >> 2);              // first of the warp's two s2d rows
  const int lrow = lane & 15, lk = (lane >> 4) * 8;  // ldmatrix row (= s2d col) and k offset
  constexpr int SS = 4 * C + PAD, SP = CP + PAD;

  for (int nc = 0; nc < COUT; nc += NCH) {
    float acc[2][NT][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

    // Main term: output pixel (2I+py, 2J+px), tap (ky, kx) reads full-res
    // (2I+py+ky-1, 2J+px+kx-1): halo s2d pixel (I + (py+ky+1)/2,
    // J + (px+kx+1)/2), input phase ((py+ky+1)%2, (px+kx+1)%2).
    mma_term<C, NT>(
        acc,
        [&](int tap) {
          const int ky = tap / 3, kx = tap % 3;
          const int q = ((py + ky + 1) & 1) * 2 + ((px + kx + 1) & 1);
          return halo + ((ib + ((py + ky + 1) >> 1)) * HALO_W + lrow + ((px + kx + 1) >> 1)) * SS + q * C + lk;
        },
        HALO_W * SS, reinterpret_cast<const uint2*>(a.w), COUT / 8, nc / 8, lane);
    // x_prev term: tap (di, dj) reads x_prev halo pixel (I + di, J + dj) and
    // the column block of phase p.
    mma_term<CP, NT>(
        acc,
        [&](int tap) { return prev + ((ib + tap / 3) * HALO_W + lrow + tap % 3) * SP + lk; },
        HALO_W * SP, reinterpret_cast<const uint2*>(a.wp), 4 * COUT / 8, p * (COUT / 8) + nc / 8, lane);

    // Epilogue: lane (g, t) holds pixels J = g and g + 8 of each s2d row,
    // channels 2t and 2t + 1 of each column tile.
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int gi = i0 + ib + mi;
      if (gi >= a.hh) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gj = j0 + g + 8 * h;
        if (gj >= a.ww) continue;
        bf16* out = reinterpret_cast<bf16*>(a.y) + ((size_t(bi) * a.hh + gi) * a.ww + gj) * size_t(4 * COUT) + p * COUT;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = nc + j * 8 + 2 * t;
          const float v0 = fmaxf(acc[mi][j][2 * h] + epilogue_term<true>(a, gi, gj, p, n), 0.f);
          const float v1 = fmaxf(acc[mi][j][2 * h + 1] + epilogue_term<true>(a, gi, gj, p, n + 1), 0.f);
          *reinterpret_cast<__nv_bfloat162*>(out + n) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// f32 FMA kernel: one full-res output pixel per thread, 16 output channels
// at a time, sizes at run time.
template <bool HAS_PREV, bool RELU>
__global__ void __launch_bounds__(THREADS) conv_f32_kernel(ConvArgs a) {
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
      const float* wt = w + size_t(tap) * a.c * cout + n0;
      for (int ci = 0; ci < a.c; ++ci) {
        const float v = src[ci];
#pragma unroll
        for (int q = 0; q < 16; ++q) acc[q] = fmaf(v, wt[size_t(ci) * cout + q], acc[q]);
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

// dec_conv1 on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a bf16 width without an instantiation.
inline int launch_dec_conv1(const ConvArgs& a, bool is_bf16, cudaStream_t stream) {
  if (!is_bf16)
    return launch(conv_f32_kernel<true, true>, a, SmemPlan<float>(a.c, a.cp, true).bytes, stream);
  const size_t bytes = SmemPlan<__nv_bfloat16>(a.c, 2 * a.c, true).bytes;
  switch (a.c) {
    case 32: return launch(conv_bf16_kernel<32>, a, bytes, stream);
    case 64: return launch(conv_bf16_kernel<64>, a, bytes, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace mgu
