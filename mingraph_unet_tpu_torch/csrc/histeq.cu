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
// 3.35 TB/s, so launch latency and the number of device operations set the
// time. Design: one launch, one thread block cluster per image, no scratch
// in device memory and no atomics outside shared memory.
//   - The image is cut into one slice a block of the cluster, each slice a
//     multiple of 16 bytes and at least kMinSlice bytes (up to 16 blocks, a
//     non-portable cluster size; fewer for a small image). At the serving
//     512^2 b8 that is eight clusters of 8 blocks of 32 KB: on an H100,
//     clusters of 16 blocks of 16 KB (128 SMs) took longer, as did 4 of
//     64 KB, since the cluster's barriers and remote stores grow with it.
//   - A block of 512 threads brings its slice's 16-byte-aligned middle into
//     shared memory by bulk copies of kCopyBytes, each completing on its own
//     mbarrier, and counts each copy as it lands into per-warp histograms
//     (shared atomics; a warp-private copy keeps a flat image's single bin
//     from serialising the whole block), the ragged head and tail of the
//     slice byte by byte from device memory.
//   - Each block pushes its 256 counts into every peer's shared memory
//     (distributed shared memory: mapa, st.shared::cluster). It first waits
//     on a cluster barrier that every block arrives at once its shared
//     memory is set up, so no peer is written before it has started; the
//     wait comes after the counting, which hides it. After a second cluster
//     barrier every block sums the cluster's counts locally, builds the LUT
//     (a 256-wide scan by warp shuffles, one thread a bin) and maps its
//     slice from shared memory: y is read from device memory once. No block
//     touches a peer after that barrier, so any block may exit first.
//   - A slice larger than kSmemSlice (an image above 1.5 M pixels) is
//     counted from device memory and mapped on a second read (from L2) by
//     the same launch.
#include "hopper.cuh"

namespace {

namespace sm90 = mgu::sm90;

constexpr int kBins = 256;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr long long kMinSlice = 32768;   // the least share of an image a block takes
constexpr long long kSmemSlice = 98304;   // the largest slice staged in shared memory
constexpr long long kCopyBytes = 8192;    // bytes a bulk copy: one 16-byte word a thread
constexpr int kCopies = int(kSmemSlice / kCopyBytes);
static_assert(kCopyBytes == 16 * kThreads && kSmemSlice % kCopyBytes == 0, "histeq copies misplanned");

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

__global__ void __launch_bounds__(kThreads) histeq_kernel(const uint8_t* __restrict__ y, uint8_t* __restrict__ out,
                                                          long long n, long long slice, int staged) {
  extern __shared__ __align__(16) uint8_t data[];  // the slice's aligned middle (staged launches)
  __shared__ int sh[kWarps][kBins];
  __shared__ int hist[kBins];  // this block's counts
  __shared__ int recv[kMaxCluster][kBins];  // every block's counts, pushed by each block of the cluster
  __shared__ int part[kBins / 32];
  __shared__ uint8_t lut[kBins];
  __shared__ int cdf_min;
  __shared__ __align__(8) uint64_t bar[kCopies];  // copy k of the slice landed
  const int t = threadIdx.x;
  int* mine = sh[t / 32];
  for (int i = t; i < kWarps * kBins; i += kThreads) (&sh[0][0])[i] = 0;
  if (t < kBins) hist[t] = 0;
  if (t < kCopies) {
    sm90::mbar_init(&bar[t], 1);
    sm90::fence_mbar_init();
  }
  if (t == 0) cdf_min = 0x7fffffff;
  __syncthreads();
  sm90::cluster_arrive_relaxed();  // this block has started; waited on before the first remote store

  const int rank = int(sm90::cluster_rank()), cl = sm90::cluster_size();
  const long long b = sm90::cluster_id();
  const uint8_t* img = y + b * n;
  uint8_t* dst = out + b * n;
  const long long lo = min(n, rank * slice), hi = min(n, lo + slice);
  const Span s = split(img, lo, hi);  // out and y share their alignment (checked by the wrapper)
  const long long bytes = s.nvec * 16;
  const int copies = staged ? int((bytes + kCopyBytes - 1) / kCopyBytes) : 0;
  if (t < copies) {
    const long long off = t * kCopyBytes;
    const uint32_t len = uint32_t(min(kCopyBytes, bytes - off));
    sm90::mbar_arrive_expect_tx(&bar[t], len);
    sm90::bulk_copy(data + off, img + s.head_end + off, len, &bar[t]);
  }
  for (long long i = lo + t; i < s.head_end; i += kThreads) atomicAdd(&mine[img[i]], 1);
  for (long long i = s.tail_begin + t; i < hi; i += kThreads) atomicAdd(&mine[img[i]], 1);
  const uint4* v = staged ? reinterpret_cast<const uint4*>(data) : reinterpret_cast<const uint4*>(img + s.head_end);
  // A copy is kThreads words, so the word a thread counts in pass c is in copy c.
  for (long long i = t, c = 0; i < s.nvec; i += kThreads, ++c) {
    if (staged) sm90::mbar_wait(&bar[c], 0);
    const uint4 w = v[i];
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) atomicAdd(&mine[(words[k] >> (8 * j)) & 255u], 1);
    }
  }
  __syncthreads();
  {  // the warps' counts of bin t % 256, half of the warps a thread
    const int bin = t % kBins, w0 = (t / kBins) * (kWarps * kBins / kThreads);
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps * kBins / kThreads; ++w) sum += sh[w0 + w][bin];
    atomicAdd(&hist[bin], sum);
  }
  __syncthreads();
  // Push the block's counts into row `rank` of every block's recv (remote
  // stores, not waited on one by one), once every peer has started, then a
  // cluster barrier: after it every block holds all the counts and nobody
  // touches a peer again.
  sm90::cluster_wait();
  for (int k = t; k < cl * kBins; k += kThreads)
    sm90::st_cluster_u32(sm90::map_rank(&recv[rank][k % kBins], uint32_t(k / kBins)), uint32_t(hist[k % kBins]));
  sm90::cluster_sync();
  int count = 0;
  if (t < kBins)
    for (int r = 0; r < cl; ++r) count += recv[r][t];

  // Inclusive scan of the 256 counts (threads 0-255): within each warp by
  // shuffles, then the warps' totals.
  int cdf = count;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, cdf, off);
    if ((t & 31) >= off) cdf += up;
  }
  if (t < kBins && (t & 31) == 31) part[t / 32] = cdf;
  __syncthreads();
  if (t < kBins) {
    for (int w = 0; w < t / 32; ++w) cdf += part[w];
    if (count > 0) atomicMin(&cdf_min, cdf);
  }
  __syncthreads();
  if (t < kBins) {
    const float total = (float)n;
    const float m = (float)cdf_min;
    const float denom = fmaxf(__fsub_rn(total, m), 1.0f);
    float val = rintf(__fmul_rn(__fdiv_rn(__fsub_rn((float)cdf, m), denom), 255.0f));
    val = fminf(fmaxf(val, 0.0f), 255.0f);
    lut[t] = (uint8_t)val;
  }
  __syncthreads();

  for (long long i = lo + t; i < s.head_end; i += kThreads) dst[i] = lut[img[i]];
  uint4* vo = reinterpret_cast<uint4*>(dst + s.head_end);
  for (long long i = t; i < s.nvec; i += kThreads) {
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
  for (long long i = s.tail_begin + t; i < hi; i += kThreads) dst[i] = lut[img[i]];
}

}  // namespace

// y, out: (b, n) uint8, 16-byte aligned, n <= 2^24. One launch on `stream`;
// returns cudaGetLastError() after it, or cudaErrorInvalidConfiguration
// where the card cannot hold one cluster of the launch.
extern "C" int mgu_histeq(const void* y, void* out, int b, int n, void* stream) {
  int cl = 1;
  while (cl < kMaxCluster && cl * kMinSlice < n) cl *= 2;
  const long long slice = ((n + cl - 1) / cl + 15) / 16 * 16;
  const int staged = slice <= kSmemSlice;
  const size_t smem = staged ? size_t(slice) : 0;
  cudaError_t err = cudaFuncSetAttribute(histeq_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(histeq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  static int fits_cl = 0;  // the last (cluster, shared memory) found to fit
  static size_t fits_smem = 0;
  if (cl != fits_cl || smem != fits_smem) {
    if (sm90::max_active_clusters(histeq_kernel, kThreads, smem, cl) < 1) return int(cudaErrorInvalidConfiguration);
    fits_cl = cl;
    fits_smem = smem;
  }
  return sm90::launch_cluster(histeq_kernel, b * cl, kThreads, smem, cl, static_cast<cudaStream_t>(stream),
                              static_cast<const uint8_t*>(y), static_cast<uint8_t*>(out), (long long)n, slice,
                              staged);
}
