// Windowed 3x3 'SAME' conv (+ bias, optional ReLU) of a phase-major s2d
// tensor: every 2x2 output block is one (16*Cin -> 4*Cout) contraction of the
// 4x4 full-resolution window around it. Replaces
// mingraph_unet_tpu/ops/pallas/wconv.py::wconv3x3_s2d.
//
// Layout. x is (B, Hh, Ww, 4*Cin) s2d, possibly the channel concat of several
// separately transformed groups (the decoder's [skip || up]): group g of
// full-res width G_g starts at s2d channel 4*(G_0 + ... + G_{g-1}) and holds
// phase ph at ph*G_g + c. Window tap d = 4*dy + dx of s2d pixel (I, J) reads
// s2d pixel (I - 1 + pos(dy), J - 1 + pos(dx)) at phase
// (phase(dy), phase(dx)), pos = (0, 1, 1, 2), phase = (1, 0, 1, 0); row
// d*Cin + goff + c of the weights w2 (16*Cin, 4*Cout) multiplies it
// (wconv.py::wconv3x3_weights). Output column ph*Cout + co is the s2d
// output, so the product IS the output block.
// Pixels outside the image read zero (the conv's SAME padding).
//
// Work split. One block of 256 threads owns a 4 x 16 s2d tile of one image.
// It stages the tile's s2d halo (6 x 18 pixels, zero outside the image) in
// shared memory, in chunks of kch s2d channels (all 4*Cin at once where
// they fit: every U-Net site in bf16); the contraction reads its 16 taps
// from there, chunk by chunk, so no patch matrix is ever written. The group
// table is read from device memory, so any number of groups runs.
//   mma (bf16, every group width a multiple of 16, Cout a multiple of 8):
//     implicit GEMM on tensor cores, mma.sync m16n8k16 with f32 accumulate
//     (conv_tile.cuh's fragments). Warp w owns s2d rows 2*(w & 1) and
//     2*(w & 1) + 1 and output phase w >> 1 (Cout columns). A 16-wide k step
//     lies inside one group and one phase, so the 16 pixels of a row read 16
//     consecutive staged pixels: one ldmatrix.x4 each. Weights come packed in
//     B-fragment order (psconv.py::mma_b_fragments).
//   simt (f32, and bf16 at other widths such as the RGB input's Cin = 3):
//     the halo staged as f32 (at most 512 channels a chunk, so Cin 256 and
//     more fit), one s2d pixel per thread and 16 output columns at a time,
//     weights f32 (the x-dtype values) padded to 16 columns. With more than
//     one chunk the halo is staged anew for every 16-column pass.
// Both accumulate in f32 and add the bias, apply ReLU and round once in the
// epilogue.
//
// Bound. The function needs 2*9*Cin*Cout operations per full-res pixel and
// moves x and y once; at the U-Net's s2d sites (Cin, Cout <= 128 per pixel,
// bf16) that puts it on the memory line of an H100. The windowed form does
// 16/9 of the useful operations; the tile reads its input once apart from
// the halo (6 x 18 staged per 4 x 16 computed, mostly L2 hits) and writes
// each output once in its final layout.
#include "conv_tile.cuh"

namespace {

using mgu::HALO_PIX;
using mgu::HALO_W;
using mgu::launch;
using mgu::PAD;
using mgu::TH;
using mgu::THREADS;
using mgu::TW;

// Tap geometry: window tap row (or column) t in 0..3 reads s2d row
// I - 1 + pos(t) at phase phase(t), i.e. pos = (0, 1, 1, 2) and
// phase = (1, 0, 1, 0) (wconv.py's _POS and _PHASE).
__device__ __forceinline__ int pos(int t) { return (t + 1) >> 1; }
__device__ __forceinline__ int phase(int t) { return (t + 1) & 1; }
constexpr int SIMT_N = 16;  // output columns per SIMT pass (weights padded to it)

struct WconvArgs {
  const void* x;      // (B, Hh, Ww, 4*Cin) s2d
  const void* w;      // mma: bf16 B fragments of (16*Cin, 4*Cout); simt: f32 (16*Cin, npad)
  const float* bias;  // (Cout,) full-res bias
  void* y;            // (B, Hh, Ww, 4*Cout) s2d
  int b, hh, ww, cin, cout, npad;
  int ngroups;
  const int* groups;  // (ngroups,) full-res group widths, in device memory
  int kch;            // s2d channels staged per chunk (mma: a multiple of 16)
};

template <int NT, bool RELU>
__global__ void __launch_bounds__(THREADS, 1) wconv_mma_kernel(WconvArgs a) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);
  const int c4 = 4 * a.cin, ss = a.kch + PAD;
  const int nchunk = (c4 + a.kch - 1) / a.kch;
  const int bi = blockIdx.z, i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  const bf16* x = reinterpret_cast<const bf16*>(a.x);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ib = 2 * (warp & 1);  // first of the warp's two s2d rows
  const int ph_out = warp >> 1;   // the warp's output phase (Cout columns)
  const int lrow = lane & 15, lk = (lane >> 4) * 8;
  const int cout = a.cout, ncols8 = 4 * cout / 8;
  const uint2* bp = reinterpret_cast<const uint2*>(a.w);
  const int row_step = HALO_W * ss;

  for (int nc = 0; nc < cout; nc += NT * 8) {
    float acc[2][NT][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    const int col0 = (ph_out * cout + nc) / 8;

    for (int ck = 0; ck < nchunk; ++ck) {
      const int c0 = ck * a.kch, c1 = min(c4, c0 + a.kch);
      if (nchunk > 1 || nc == 0) {  // one chunk stays staged for every pass
        __syncthreads();
        mgu::stage_halo<bf16>(halo, ss, x, bi, i0, j0, a.hh, a.ww, c4, nullptr, nullptr, c0, c1 - c0);
        __syncthreads();
      }
      for (int d = 0; d < 16; ++d) {
        const int dy = d >> 2, dx = d & 3;
        const int ph = phase(dy) * 2 + phase(dx);
        const bf16* pix = halo + ((ib + pos(dy)) * HALO_W + lrow + pos(dx)) * ss + lk - c0;
        int off = 0, goff = 0;
        for (int g = 0; g < a.ngroups; ++g) {
          const int gw = __ldg(a.groups + g);
          // The 16-channel k steps of this group and phase that lie in the chunk.
          const int base = off + ph * gw;
          const int ks0 = max(0, (c0 - base) / 16), ks1 = min(gw, c1 - base) / 16;
          const bf16* arow = pix + base;
          for (int ks = ks0; ks < ks1; ++ks) {
            uint32_t af[2][4];
            mgu::ldmatrix_x4(af[0], arow + ks * 16);
            mgu::ldmatrix_x4(af[1], arow + row_step + ks * 16);
            const int kstep = (d * a.cin + goff) / 16 + ks;
            const uint2* bk = bp + (size_t(kstep) * ncols8 + col0) * 32 + lane;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const uint2 bv = __ldg(bk + j * 32);
              mgu::mma_bf16(acc[0][j], af[0], bv);
              mgu::mma_bf16(acc[1][j], af[1], bv);
            }
          }
          off += 4 * gw;
          goff += gw;
        }
      }
    }

    // Epilogue: lane (g, t) holds pixels J = g and g + 8 of each s2d row,
    // columns 2t and 2t + 1 of each column tile.
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int gi = i0 + ib + mi;
      if (gi >= a.hh) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gj = j0 + g + 8 * h;
        if (gj >= a.ww) continue;
        bf16* out = reinterpret_cast<bf16*>(a.y) + ((size_t(bi) * a.hh + gi) * a.ww + gj) * size_t(4 * cout) +
                    ph_out * cout;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = nc + j * 8 + 2 * t;
          float v0 = acc[mi][j][2 * h] + a.bias[n];
          float v1 = acc[mi][j][2 * h + 1] + a.bias[n + 1];
          if (RELU) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(out + n) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Staged f32 pixel stride for a chunk of nch channels: nch + 1 words, so
// the 32 pixels a warp reads at one channel fall in 32 different banks.
__host__ __device__ inline int simt_stride(int nch) { return nch + 1; }

template <typename T, bool RELU>
__global__ void __launch_bounds__(THREADS) wconv_simt_kernel(WconvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* halo = reinterpret_cast<float*>(smem);
  const int c4 = 4 * a.cin, ss = simt_stride(a.kch);
  const int nchunk = (c4 + a.kch - 1) / a.kch;
  const int bi = blockIdx.z, i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  const T* x = reinterpret_cast<const T*>(a.x);

  const int p = threadIdx.x % (TH * TW), cg = threadIdx.x / (TH * TW);  // 4 column groups
  const int i = p / TW, j = p % TW;
  const int gi = i0 + i, gj = j0 + j;
  const int n_out = 4 * a.cout;
  const float* w = reinterpret_cast<const float*>(a.w);
  // Every thread runs the same number of passes, so the barriers of the
  // chunked staging are reached by all.
  const int npass = (a.npad / SIMT_N + THREADS / (TH * TW) - 1) / (THREADS / (TH * TW));
  for (int pass = 0; pass < npass; ++pass) {
    const int n0 = (pass * (THREADS / (TH * TW)) + cg) * SIMT_N;
    float acc[SIMT_N];
#pragma unroll
    for (int q = 0; q < SIMT_N; ++q) acc[q] = 0.f;
    for (int ck = 0; ck < nchunk; ++ck) {
      const int c0 = ck * a.kch, c1 = min(c4, c0 + a.kch), nch = c1 - c0;
      if (nchunk > 1 || pass == 0) {  // one chunk stays staged for every pass
        __syncthreads();
        for (int e = threadIdx.x; e < HALO_PIX * nch; e += THREADS) {
          const int pix = e / nch, c = e % nch;
          const int hi = i0 - 1 + pix / HALO_W, hj = j0 - 1 + pix % HALO_W;
          float v = 0.f;
          if (hi >= 0 && hi < a.hh && hj >= 0 && hj < a.ww)
            v = to_f32(x[((size_t(bi) * a.hh + hi) * a.ww + hj) * size_t(c4) + c0 + c]);
          halo[pix * ss + c] = v;
        }
        __syncthreads();
      }
      if (n0 >= a.npad) continue;
      for (int d = 0; d < 16; ++d) {
        const int dy = d >> 2, dx = d & 3;
        const int ph = phase(dy) * 2 + phase(dx);
        const float* pix = halo + ((i + pos(dy)) * HALO_W + j + pos(dx)) * ss - c0;
        int off = 0, goff = 0;
        for (int g = 0; g < a.ngroups; ++g) {
          const int gw = __ldg(a.groups + g);
          // The channels of this group and phase that lie in the chunk.
          const int base = off + ph * gw;
          const int lo = max(0, c0 - base), hi = min(gw, c1 - base);
          const float* src = pix + base;
          const float* wk = w + size_t(d * a.cin + goff) * a.npad + n0;
          for (int c = lo; c < hi; ++c) {
            const float v = src[c];
            const float4* w4 = reinterpret_cast<const float4*>(wk + size_t(c) * a.npad);
#pragma unroll
            for (int q = 0; q < SIMT_N / 4; ++q) {
              const float4 wv = __ldg(w4 + q);
              acc[4 * q] = fmaf(v, wv.x, acc[4 * q]);
              acc[4 * q + 1] = fmaf(v, wv.y, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(v, wv.z, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(v, wv.w, acc[4 * q + 3]);
            }
          }
          off += 4 * gw;
          goff += gw;
        }
      }
    }
    if (n0 >= a.npad) continue;
    if (gi < a.hh && gj < a.ww) {
      T* out = reinterpret_cast<T*>(a.y) + ((size_t(bi) * a.hh + gi) * a.ww + gj) * size_t(n_out);
#pragma unroll
      for (int q = 0; q < SIMT_N; ++q) {
        const int n = n0 + q;
        if (n < n_out) {
          const float v = acc[q] + a.bias[n % a.cout];
          store(out + n, RELU ? fmaxf(v, 0.f) : v);
        }
      }
    }
  }
}

template <bool RELU>
int launch_mma(const WconvArgs& a, cudaStream_t stream) {
  const size_t bytes = size_t(HALO_PIX) * (a.kch + PAD) * sizeof(__nv_bfloat16);
  if (a.cout % 64 == 0) return launch(wconv_mma_kernel<8, RELU>, a, bytes, stream);
  if (a.cout % 32 == 0) return launch(wconv_mma_kernel<4, RELU>, a, bytes, stream);
  if (a.cout % 16 == 0) return launch(wconv_mma_kernel<2, RELU>, a, bytes, stream);
  return launch(wconv_mma_kernel<1, RELU>, a, bytes, stream);
}

template <bool RELU>
int launch_simt(const WconvArgs& a, bool is_bf16, cudaStream_t stream) {
  const size_t bytes = size_t(HALO_PIX) * simt_stride(a.kch) * sizeof(float);
  return is_bf16 ? launch(wconv_simt_kernel<__nv_bfloat16, RELU>, a, bytes, stream)
                 : launch(wconv_simt_kernel<float, RELU>, a, bytes, stream);
}

// Channels a chunk of the staged halo holds: everything where it fits in
// shared memory (232,448 bytes a block on an H100), else 1024 (mma, bf16)
// or 512 (simt, f32) s2d channels.
int chunk_channels(int c4, bool use_mma) {
  if (use_mma) return size_t(HALO_PIX) * (c4 + PAD) * 2 <= 232448 ? c4 : 1024;
  return c4 <= 512 ? c4 : 512;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch. The
// wrapper (ops/kernels/wconv.py) checks shapes and picks the path: use_mma
// needs bf16, every group width a multiple of 16 and Cout a multiple of 8,
// and the weights in B-fragment order; otherwise f32 weights padded to npad
// columns. `groups` is the (ngroups,) int32 table of group widths in device
// memory.
extern "C" int mgu_wconv3x3(const void* x, const void* w, const float* bias, void* y, int b, int hh, int ww,
                            int cin, int cout, int npad, int ngroups, const int* groups, int is_bf16, int relu,
                            int use_mma, void* stream) {
  if (ngroups < 1) return int(cudaErrorInvalidValue);
  WconvArgs a{x, w, bias, y, b, hh, ww, cin, cout, npad, ngroups, groups, chunk_channels(4 * cin, use_mma != 0)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma) return relu ? launch_mma<true>(a, s) : launch_mma<false>(a, s);
  return relu ? launch_simt<true>(a, is_bf16 != 0, s) : launch_simt<false>(a, is_bf16 != 0, s);
}
