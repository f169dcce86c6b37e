// OpenCV equalizeHist per image on a batch of uint8 luma planes:
// (B, N) uint8 -> (B, N) uint8, N = H * W pixels per image.
// Replaces mingraph_unet_tpu/ops/pallas/histeq.py::equalize_channel_pallas.
//
// Function: a 256-bin histogram per image, its inclusive CDF, cdf_min = the
// CDF at the lowest non-empty bin, and the LUT
//   clip(round_half_even((cdf - cdf_min) / max(N - cdf_min, 1) * 255), 0, 255)
// in f32, applied to every pixel. Counts are exact integers, and so are their
// f32 CDF values while N <= 2^24 (4096^2 pixels per image; the wrapper
// refuses more). The LUT is computed with __fsub_rn, __fdiv_rn, __fmul_rn and
// rintf (round half to even), in the JAX formula's order and without fast
// math, so it is bit-exact with the plain version.
//
// Bound: memory. The function reads each pixel once and writes it once (one
// byte each); at the pipeline's 512^2 b8 that is 4.19 MB, about 1.25 us at
// 3.35 TB/s, so two launches' latency sets the time. Design:
//   1. histeq_hist_kernel, grid (chunk, image): each block counts its chunk
//      into per-warp shared-memory histograms (shared atomics; a warp-private
//      copy keeps a flat image's single bin from serialising the whole
//      block), sums them and adds the non-zero bins into a global (B, 256)
//      int32 histogram with atomics. Integer sums, so the order is free.
//   2. histeq_apply_kernel, grid (chunk, image): each block rebuilds its
//      image's LUT in shared memory from the 256 counts (a 256-wide scan)
//      and maps its chunk.
// Both read and write 16 bytes per thread on the 16-byte-aligned middle of
// a chunk and byte by byte on its ragged head and tail, so any N works.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;  // histeq_apply_kernel scans with one thread per bin
constexpr int kWarps = kThreads / 32;
constexpr long long kChunk = 8192;  // bytes per block, a multiple of 16

// The byte range [lo, hi) of one image split into a byte-wise head up to the
// first 16-byte boundary, 16-byte words, and a byte-wise tail.
struct Span {
  long long head_end, nvec, tail_begin;
};

__device__ __forceinline__ Span split(const uint8_t* base, long long lo, long long hi) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(base + lo);
  long long head = (long long)((16 - (addr & 15)) & 15);
  if (head > hi - lo) head = hi - lo;
  const long long nvec = (hi - lo - head) / 16;
  return {lo + head, nvec, lo + head + nvec * 16};
}

__global__ void histeq_hist_kernel(const uint8_t* __restrict__ y, int* __restrict__ hist, long long n) {
  __shared__ int sh[kWarps][kBins];
  int* mine = sh[threadIdx.x / 32];
  for (int i = threadIdx.x; i < kWarps * kBins; i += blockDim.x) (&sh[0][0])[i] = 0;
  __syncthreads();

  const int b = blockIdx.y;
  const uint8_t* img = y + (long long)b * n;
  const long long lo = blockIdx.x * kChunk;
  const long long hi = min(n, lo + kChunk);
  const Span s = split(img, lo, hi);
  for (long long i = lo + threadIdx.x; i < s.head_end; i += blockDim.x) atomicAdd(&mine[img[i]], 1);
  const uint4* v = reinterpret_cast<const uint4*>(img + s.head_end);
  for (long long i = threadIdx.x; i < s.nvec; i += blockDim.x) {
    const uint4 w = v[i];
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) atomicAdd(&mine[(words[k] >> (8 * j)) & 255u], 1);
    }
  }
  for (long long i = s.tail_begin + threadIdx.x; i < hi; i += blockDim.x) atomicAdd(&mine[img[i]], 1);
  __syncthreads();

  for (int bin = threadIdx.x; bin < kBins; bin += blockDim.x) {
    int count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) count += sh[w][bin];
    if (count) atomicAdd(&hist[b * kBins + bin], count);
  }
}

__global__ void histeq_apply_kernel(const uint8_t* __restrict__ y, uint8_t* __restrict__ out,
                                    const int* __restrict__ hist, long long n) {
  __shared__ int cdf[kBins];
  __shared__ uint8_t lut[kBins];
  __shared__ int cdf_min;
  const int b = blockIdx.y;
  const int t = threadIdx.x;  // one thread per bin

  const int count = hist[b * kBins + t];
  cdf[t] = count;
  if (t == 0) cdf_min = 0x7fffffff;
  __syncthreads();
  for (int off = 1; off < kBins; off <<= 1) {  // inclusive Hillis-Steele scan
    const int add = t >= off ? cdf[t - off] : 0;
    __syncthreads();
    cdf[t] += add;
    __syncthreads();
  }
  if (count > 0) atomicMin(&cdf_min, cdf[t]);
  __syncthreads();
  const float total = (float)n;
  const float m = (float)cdf_min;
  const float denom = fmaxf(__fsub_rn(total, m), 1.0f);
  float val = rintf(__fmul_rn(__fdiv_rn(__fsub_rn((float)cdf[t], m), denom), 255.0f));
  val = fminf(fmaxf(val, 0.0f), 255.0f);
  lut[t] = (uint8_t)val;
  __syncthreads();

  const uint8_t* img = y + (long long)b * n;
  uint8_t* dst = out + (long long)b * n;
  const long long lo = blockIdx.x * kChunk;
  const long long hi = min(n, lo + kChunk);
  const Span s = split(img, lo, hi);  // out and y share their alignment (checked by the wrapper)
  for (long long i = lo + t; i < s.head_end; i += blockDim.x) dst[i] = lut[img[i]];
  const uint4* v = reinterpret_cast<const uint4*>(img + s.head_end);
  uint4* vo = reinterpret_cast<uint4*>(dst + s.head_end);
  for (long long i = t; i < s.nvec; i += blockDim.x) {
    const uint4 w = v[i];
    unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned r = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) r |= unsigned(lut[(words[k] >> (8 * j)) & 255u]) << (8 * j);
      words[k] = r;
    }
    vo[i] = make_uint4(words[0], words[1], words[2], words[3]);
  }
  for (long long i = s.tail_begin + t; i < hi; i += blockDim.x) dst[i] = lut[img[i]];
}

}  // namespace

// y, out: (b, n) uint8, 16-byte aligned; hist: (b, 256) int32 scratch, zeroed here.
extern "C" int mgu_histeq(const void* y, void* out, void* hist, int b, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int) * kBins * (size_t)b, s);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned((n + kChunk - 1) / kChunk), unsigned(b));
  histeq_hist_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint8_t*>(y), static_cast<int*>(hist), n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  histeq_apply_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint8_t*>(y), static_cast<uint8_t*>(out),
                                               static_cast<const int*>(hist), n);
  return int(cudaGetLastError());
}
