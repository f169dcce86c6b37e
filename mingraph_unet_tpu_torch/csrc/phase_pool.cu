// MaxPool(2, 2) of a full-resolution tensor held in phase-major s2d layout:
// (B, Hh, Ww, 4C) -> (B, Hh, Ww, C), the max over the four phase groups.
// Replaces mingraph_unet_tpu/ops/pallas/pool.py::phase_max_pool_pallas.
//
// Bound: memory. It reads 4C and writes C values per s2d pixel and does one
// compare per value read, far below the card's rate of operations per byte.
// Design: one thread per 16 bytes of output; it reads the same 16-byte
// slice of each of the four phase groups (a pixel's groups are adjacent, so
// a warp's loads cover whole contiguous rows) and writes the max. The max
// selects one of its inputs, so the result is exact in any dtype; a NaN
// input gives NaN, as the plain version's amax does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bits_to_f32(uint16_t v) { return __uint_as_float(uint32_t(v) << 16); }
__device__ __forceinline__ float bits_to_f32(uint32_t v) { return __uint_as_float(v); }

// W is the word type of one element: uint16_t for bf16, uint32_t for f32.
template <typename W>
__global__ void phase_max_pool_kernel(const W* __restrict__ x, W* __restrict__ y,
                                      long long npix, int c) {
  constexpr int VE = 16 / sizeof(W);
  const int vpp = c / VE;
  const long long total = npix * vpp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long pix = i / vpp;
    const int v = int(i % vpp);
    const W* src = x + pix * 4 * c + v * VE;
    uint4 in[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) in[g] = *reinterpret_cast<const uint4*>(src + g * c);
    uint4 out;
    const W* e0 = reinterpret_cast<const W*>(&in[0]);
    W* eo = reinterpret_cast<W*>(&out);
#pragma unroll
    for (int k = 0; k < VE; ++k) {
      W best = e0[k];
      float bv = bits_to_f32(best);
#pragma unroll
      for (int g = 1; g < 4; ++g) {
        const W cand = reinterpret_cast<const W*>(&in[g])[k];
        const float cv = bits_to_f32(cand);
        if (cv > bv || cv != cv) {  // a NaN wins, as in amax
          best = cand;
          bv = cv;
        }
      }
      eo[k] = best;
    }
    *reinterpret_cast<uint4*>(y + pix * c + v * VE) = out;
  }
}

}  // namespace

extern "C" int mgu_phase_max_pool(const void* x, void* y, int b, int hh, int ww, int c,
                                  int is_bf16, void* stream) {
  const long long npix = (long long)b * hh * ww;
  const int ve = is_bf16 ? 8 : 4;
  const long long total = npix * (c / ve);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 blocks per SM
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    phase_max_pool_kernel<uint16_t><<<unsigned(blocks), threads, 0, s>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(y), npix, c);
  else
    phase_max_pool_kernel<uint32_t><<<unsigned(blocks), threads, 0, s>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y), npix, c);
  return int(cudaGetLastError());
}
