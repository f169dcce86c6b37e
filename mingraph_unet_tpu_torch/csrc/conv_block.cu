// Fused inference ConvBlock: y = relu(conv3x3(h, w2) * s2 + b2) with
// h = relu(conv3x3(x, w1) * s1 + b1), both convs 'SAME', in f32 inside and
// one device-memory round trip: x is read and y written, h never leaves the
// chip. Replaces mingraph_unet_tpu/ops/pallas/conv_block.py::fused_conv_block.
//
// The function is f32 inside, as the TPU kernel is: taps and weights are f32
// (x widened on load), the scale/shift multiplies the f32 accumulator (it is
// not folded into the weights), h stays f32, and only y is rounded to x's
// dtype. This first version is SIMT f32 FMA; no operand is rounded to bf16.
//
// Work split. One block of 256 threads owns a TH x TW tile of output pixels
// of one image and all C output channels; conv2's accumulators stay in
// registers (each thread: 4 pixels of a row x 8 channels). h is produced in
// chunks of KC channels over the tile's one-pixel halo ((TH + 2) x (TW + 2)
// pixels) into shared memory, and each chunk is consumed by conv2 at once,
// so shared memory holds one h chunk whatever C is (an f32 h tile of all
// 512 bottleneck channels would not fit). conv1 itself runs over x in
// chunks of KX = 32 input channels staged with their two-pixel halo
// ((TH + 4) x (TW + 4), zero outside the image, elementwise, so any Cin,
// 1 and 3 included); each thread computes up to MAXI h pixels of one
// 4-channel quad, so one float4 of w1 serves all of them. The tile shrinks
// as C grows so that the accumulators fit, and KC grows as the halo
// shrinks so that every thread has h pixels to compute: C <= 32: 16 x 16,
// KC 16; <= 64: 8 x 16, KC 32; <= 128: 8 x 8, KC 32; <= 256: 4 x 8, KC 64;
// <= 512: 4 x 4, KC 64. Wider C runs in output-channel tiles of CT = 512
// (the 4 x 4 tile's 64 channel groups of 8): each block computes conv2 for
// one tile of output channels, over all of h, so conv1 is done once per
// tile (twice for the 1024-channel bottleneck of init_features 64).
//
// conv2's SAME padding of h: an h pixel outside the image is zero, not
// relu(b1) (which conv1 over a zero-padded x would give). The epilogue of
// each h chunk zeroes those pixels.
//
// The wrapper (ops/kernels/conv_block.py) pads C to C1p (a multiple of 64,
// so of every KC, for h) and C2p (a multiple of 8, for y) with zero
// weights, scales and shifts, so a padded h channel is relu(0) = 0 and adds
// nothing.
//
// Bound. In f32 the function needs 2*9*(Cin*C + C*C) operations per pixel on
// the f32 FMA units (67 TFLOP/s on an H100 SXM) against 2-4 bytes of x and y
// per channel: operations bound it at every U-Net width. This version redoes
// conv1 on the halo ((TH + 2)(TW + 2) / (TH * TW) of the useful conv1 work)
// and reads x once per h chunk (from L2 after the first).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int KX = 32;    // x channels per conv1 chunk
constexpr int PM = 4;     // conv2 pixels per thread (consecutive in a row)
constexpr int CN = 8;     // conv2 channels per thread
constexpr int MAXI = 6;   // conv1 h pixels per thread: the halo over THREADS / (KC / 4), rounded up
constexpr int CT = 512;   // output channels per block at most (the 4 x 4 tile's 64 groups x CN)

struct BlockArgs {
  const void* x;                // (B, H, W, Cin)
  const float* w1;              // (9, Cin, C1p)
  const float *s1, *b1;         // (C1p,)
  const float* w2;              // (9, C1p, C2p)
  const float *s2, *b2;         // (C2p,)
  void* y;                      // (B, H, W, C)
  int b, h, w, cin, c, c1p, c2p;
  int th, tw;                   // tile
  int ntiles;                   // output-channel tiles of CT: grid z = b * ntiles
};

// Shared memory: x chunk (stride KX + 1 words), w1 chunk, h chunk (stride
// KC + 1). Identical on host and device.
template <int KC>
struct Smem {
  int xp, hp;
  size_t w1_off, h_off, bytes;
  __host__ __device__ Smem(int th, int tw) {
    xp = (th + 4) * (tw + 4);
    hp = (th + 2) * (tw + 2);
    w1_off = (size_t(xp) * (KX + 1) + 3) & ~size_t(3);  // float4 reads of w1
    h_off = w1_off + size_t(9) * KX * KC;
    bytes = (h_off + size_t(hp) * (KC + 1)) * sizeof(float);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, int KC>
__global__ void __launch_bounds__(THREADS) conv_block_kernel(BlockArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int th = a.th, tw = a.tw;
  const Smem<KC> plan(th, tw);
  float* xs = smem;
  float* w1s = smem + plan.w1_off;
  float* hs = smem + plan.h_off;
  const int bi = blockIdx.z / a.ntiles, y0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  const int n0 = (blockIdx.z % a.ntiles) * CT;  // this block's first output channel
  const int nw = min(CT, a.c2p - n0);           // and how many it computes
  const int t = threadIdx.x;
  const int xw = tw + 4, hw = tw + 2;
  const T* x = reinterpret_cast<const T*>(a.x);

  // conv1 items: h channel quad kq, h pixels hp_i = t / Q + (THREADS / Q) i.
  constexpr int Q = KC / 4, HSTEP = THREADS / Q;
  const int kq = t % Q;
  int xbase[MAXI];
#pragma unroll
  for (int i = 0; i < MAXI; ++i) {
    const int hp = t / Q + HSTEP * i;
    xbase[i] = hp < plan.hp ? (hp / hw) * xw + hp % hw : -1;
  }

  // conv2: pixel group pg (row r, columns c0..c0+3), channel group cg.
  const int npg = th * tw / PM;
  const int pg = t % npg, cg = t / npg;
  const bool active2 = cg * CN < nw;
  const int r2 = pg / (tw / PM), c2 = (pg % (tw / PM)) * PM;
  float acc2[PM][CN];
#pragma unroll
  for (int m = 0; m < PM; ++m)
#pragma unroll
    for (int q = 0; q < CN; ++q) acc2[m][q] = 0.f;

  for (int hc = 0; hc < a.c1p; hc += KC) {
    float acc1[MAXI][4];
#pragma unroll
    for (int i = 0; i < MAXI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[i][e] = 0.f;

    for (int cx = 0; cx < a.cin; cx += KX) {
      __syncthreads();  // the previous chunk's readers are done
      for (int e = t; e < plan.xp * KX; e += THREADS) {
        const int pix = e / KX, ci = e % KX;
        const int gy = y0 - 2 + pix / xw, gx = x0 - 2 + pix % xw, c = cx + ci;
        float v = 0.f;
        if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w && c < a.cin)
          v = to_f32(x[((size_t(bi) * a.h + gy) * a.w + gx) * size_t(a.cin) + c]);
        xs[pix * (KX + 1) + ci] = v;
      }
      for (int e = t; e < 9 * KX * KC; e += THREADS) {
        const int tap = e / (KX * KC), ci = (e / KC) % KX, kc = e % KC, c = cx + ci;
        w1s[e] = c < a.cin ? a.w1[(size_t(tap) * a.cin + c) * a.c1p + hc + kc] : 0.f;
      }
      __syncthreads();
      const int kn = min(KX, a.cin - cx);
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = (tap / 3) * xw + tap % 3;
        for (int ci = 0; ci < kn; ++ci) {
          const float4 wv = *reinterpret_cast<const float4*>(w1s + (tap * KX + ci) * KC + kq * 4);
#pragma unroll
          for (int i = 0; i < MAXI; ++i) {
            if (xbase[i] < 0) continue;
            const float v = xs[(xbase[i] + toff) * (KX + 1) + ci];
            acc1[i][0] = fmaf(v, wv.x, acc1[i][0]);
            acc1[i][1] = fmaf(v, wv.y, acc1[i][1]);
            acc1[i][2] = fmaf(v, wv.z, acc1[i][2]);
            acc1[i][3] = fmaf(v, wv.w, acc1[i][3]);
          }
        }
      }
    }

    // h chunk: scale/shift on the f32 accumulator, ReLU, and zero at h
    // pixels outside the image (conv2's SAME padding).
#pragma unroll
    for (int i = 0; i < MAXI; ++i) {
      const int hp = t / Q + HSTEP * i;
      if (hp >= plan.hp) continue;
      const int gy = y0 - 1 + hp / hw, gx = x0 - 1 + hp % hw;
      const bool inside = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = hc + kq * 4 + e;
        const float v = fmaxf(acc1[i][e] * a.s1[n] + a.b1[n], 0.f);
        hs[hp * (KC + 1) + kq * 4 + e] = inside ? v : 0.f;
      }
    }
    __syncthreads();

    if (active2) {
      for (int tap = 0; tap < 9; ++tap) {
        const float* hrow = hs + ((r2 + tap / 3) * hw + c2 + tap % 3) * (KC + 1);
        const float* wrow = a.w2 + (size_t(tap) * a.c1p + hc) * a.c2p + n0 + cg * CN;
#pragma unroll 4
        for (int kc = 0; kc < KC; ++kc) {
          const float4 wa = __ldg(reinterpret_cast<const float4*>(wrow + size_t(kc) * a.c2p));
          const float4 wb = __ldg(reinterpret_cast<const float4*>(wrow + size_t(kc) * a.c2p + 4));
          const float wv[CN] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int m = 0; m < PM; ++m) {
            const float hv = hrow[m * (KC + 1) + kc];
#pragma unroll
            for (int q = 0; q < CN; ++q) acc2[m][q] = fmaf(hv, wv[q], acc2[m][q]);
          }
        }
      }
    }
  }

  if (!active2) return;
  const int gy = y0 + r2;
  if (gy >= a.h) return;
#pragma unroll
  for (int m = 0; m < PM; ++m) {
    const int gx = x0 + c2 + m;
    if (gx >= a.w) continue;
    T* out = reinterpret_cast<T*>(a.y) + ((size_t(bi) * a.h + gy) * a.w + gx) * size_t(a.c);
#pragma unroll
    for (int q = 0; q < CN; ++q) {
      const int n = n0 + cg * CN + q;
      if (n < a.c) store(out + n, fmaxf(acc2[m][q] * a.s2[n] + a.b2[n], 0.f));
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a C1p that is not a multiple of the tile's KC.
// Weights and scales are f32, padded as the header says; x and y are f32 or
// bf16. Any C: above CT the output channels run in tiles of CT.
extern "C" int mgu_conv_block(const void* x, const float* w1, const float* s1, const float* b1, const float* w2,
                              const float* s2, const float* b2, void* y, int b, int h, int w, int cin, int c,
                              int c1p, int c2p, int is_bf16, void* stream) {
  int th, tw, kc;
  const int cw = c2p < CT ? c2p : CT;  // channels a block computes
  if (cw <= 32) th = 16, tw = 16, kc = 16;
  else if (cw <= 64) th = 8, tw = 16, kc = 32;
  else if (cw <= 128) th = 8, tw = 8, kc = 32;
  else if (cw <= 256) th = 4, tw = 8, kc = 64;
  else th = 4, tw = 4, kc = 64;
  if (c1p % kc) return int(cudaErrorInvalidValue);
  const int ntiles = (c2p + CT - 1) / CT;
  BlockArgs a{x, w1, s1, b1, w2, s2, b2, y, b, h, w, cin, c, c1p, c2p, th, tw, ntiles};
  size_t bytes;
  void (*kern)(BlockArgs);
  switch (kc) {
    case 16:
      bytes = Smem<16>(th, tw).bytes;
      kern = is_bf16 ? conv_block_kernel<__nv_bfloat16, 16> : conv_block_kernel<float, 16>;
      break;
    case 32:
      bytes = Smem<32>(th, tw).bytes;
      kern = is_bf16 ? conv_block_kernel<__nv_bfloat16, 32> : conv_block_kernel<float, 32>;
      break;
    default:
      bytes = Smem<64>(th, tw).bytes;
      kern = is_bf16 ? conv_block_kernel<__nv_bfloat16, 64> : conv_block_kernel<float, 64>;
  }
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((w + tw - 1) / tw, (h + th - 1) / th, b * ntiles);
  kern<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
