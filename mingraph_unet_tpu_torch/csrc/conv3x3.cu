// 3x3 'SAME' convolution, stride 1, on NHWC f32: y = conv3x3(x, w) + bias,
// f32 out, the raw pre-BN conv output of a standard-layout ConvBlock in
// training. Run through the autograd Function of ops/kernels/conv3x3.py, it
// is also the conv's dgrad: the same kernel on the cotangent with the
// adjoint weights (taps flipped, input and output channels swapped), no
// bias.
//
// It replaces no TPU kernel: the JAX package leaves these convs to XLA. It
// was added because cuDNN runs them in f32 (TF32 off, as the configuration
// states) on the FMA units or by its FFT route at 5-6 TFLOP/s, the largest
// share of the f32 train step's device time.
//
// Bound. The conv needs 2*9*Cin*Cout operations per pixel against 4 bytes of
// x per input and of y per output channel: 192-288 operations a byte at the
// U-Net's widths (Cin, Cout 64-512), so operations bound it. On the f32 FMA
// units (67 TFLOP/s on an H100 SXM) that is the SIMT figure; this kernel does
// the work on the tensor cores instead, and its bound is the split form's
// floor below.
//
// Design: implicit GEMM on the tensor cores (wgmma), with f32 accuracy from a
// bf16 hi/lo split, the form of the fused ConvBlock kernel's conv2
// (conv_block.cu). An f32 value a is a_hi = bf16(a) plus a_lo = bf16(a -
// a_hi), within 2^-18 |a|; a*b is a_hi*b_hi + a_hi*b_lo + a_lo*b_hi in the
// f32 accumulator (the dropped a_lo*b_lo is below 2^-16 |ab|): three bf16
// products a term, so the least time is three times the operations over the
// bf16 rate (989 TFLOP/s): the split form's floor.
//   - A block owns an 8 x 16 tile of output pixels of one image (M = 128,
//     one 64-row wgmma for each of two consumer warpgroups: 4 output rows
//     each) and NT of its output channels (64, 128 or 256: N of the wgmma);
//     a wider Cout runs in NT-channel tiles.
//   - x is consumed in chunks of KX = 64 input channels over the tile's
//     one-pixel halo (10 x 18 pixels, zero outside the image and beyond
//     Cin, so any Cin and any H, W). A chunk is staged raw (f32) by cp.async
//     one chunk ahead of use, 16 bytes a copy where Cin is a multiple of 4,
//     else 4; at its turn every thread splits it into a hi and a lo bf16
//     plane in the 128-byte-swizzled layout the A fragments (ldmatrix) read.
//   - Weights: the wrapper splits w (or its adjoint) into hi/lo bf16 once a
//     call and packs it into one stream of 16 KB stages in consumption order
//     and in wgmma's K-major B layout (ops/kernels/conv3x3.py::pack_weights):
//     for each x chunk and tap, 16-64 rows of K x NT, hi then lo. They
//     stream through a ring of 7 stages by bulk copy, up to 5 stages ahead
//     of use.
//   - Two consumer warpgroups and no producer (256 threads, up to 255
//     registers a thread for the 128 accumulators at NT = 256): the first
//     thread refills the ring by predicated instructions, every thread
//     stages x. No divergent branch falls between two wgmma groups (ptxas
//     would serialize them): the copies past the halo land in spare shared
//     memory as zeros, not skipped. The warpgroups meet twice an x chunk
//     (before its planes are overwritten, once they are whole).
//   - Epilogue: the bias (none for the dgrad) added to the f32 accumulator,
//     stored as NHWC-contiguous f32.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace sm90 = mgu::sm90;

constexpr int TH = 8, TW = 16;                           // output tile
constexpr int HH = TH + 2, HW = TW + 2, HPIX = HH * HW;  // x halo: 10 x 18
constexpr int KX = 64;                                   // x chunk channels
constexpr int ROWS = 192;                                // halo pixels rounded up: three 64-row tiles
constexpr int XPLANE = ROWS * 128;                       // a hi or lo plane: 64 bf16 channels a pixel
constexpr int UNITS = ROWS * KX * 4 / 16;                // 16-byte units of a raw f32 chunk
constexpr int STAGE_BYTES = 16384, STAGES = 7, LAG = 2;  // weight ring; a slot is refilled LAG stages after use
constexpr int THREADS = 256;                             // two consumer warpgroups
constexpr int SM90_SHARED = 232448;
static_assert(UNITS % THREADS == 0, "raw units must divide among the threads");

// Shared memory: the weight ring, the chunk's hi and lo planes, the raw f32
// chunk, the mbarriers.
struct Plan {
  static constexpr int PLANES = STAGES * STAGE_BYTES;
  static constexpr int RAW = PLANES + 2 * XPLANE;
  static constexpr int BAR = RAW + UNITS * 16;
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8;
  static_assert(PLANES % 1024 == 0 && XPLANE % 1024 == 0 && RAW % 16 == 0 && BAR % 8 == 0, "conv3x3 plan misaligned");
  static_assert(BYTES <= SM90_SHARED, "conv3x3 plan exceeds shared memory");
};

struct ConvArgs {
  const float* x;                // (B, H, W, Cin)
  const unsigned char* wts;      // the weight stream: ntl streams of `stages` stages
  const float* bias;             // (Cout,), or null
  float* y;                      // (B, H, W, Cout)
  int b, h, w, cin, cout;
  int xc;                        // x chunks (ceil(Cin / KX))
  int tiles_w, tiles_h, spatial; // spatial tiles
  int stages;                    // stages of one channel tile's stream
  int vec;                       // Cin % 4 == 0: x staged 16 bytes a copy
};

struct Tile {
  int nt, bi, y0, x0;
};

// Block `blk`'s tile: channel tile, image, output origin.
__device__ __forceinline__ Tile decode(const ConvArgs& a, int blk) {
  const int t = blk % a.spatial, r = t / a.tiles_w;
  return Tile{blk / a.spatial, r / a.tiles_h, (r % a.tiles_h) * TH, (t % a.tiles_w) * TW};
}

struct Bars {
  uint64_t* p;
  __device__ explicit Bars(unsigned char* smem) : p(reinterpret_cast<uint64_t*>(smem + Plan::BAR)) {}
  __device__ uint64_t* wfull(int s) const { return p + s; }            // the stage's bytes landed
  __device__ uint64_t* wempty(int s) const { return p + STAGES + s; }  // both warpgroups released it
  __device__ uint64_t* raw() const { return p + 2 * STAGES; }          // every thread's copies landed
};

// The consumer warpgroups meet (named barrier 1).
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// 4 bytes global -> shared (both 4-byte aligned); src_bytes 0 writes zeros
// and leaves src unread.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sm90::smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

// Stage x chunk `chunk` of the tile's halo (10 x 18 pixels x 64 channels as
// f32, 256 bytes a pixel; zero outside the image and beyond Cin) into `raw`.
// Every thread takes UNITS / THREADS 16-byte units, the halo rounded up to
// ROWS pixels (the spare ones zero), and arrives on `full` once its copies
// land.
__device__ void stage_raw(unsigned char* raw, const ConvArgs& a, const Tile& tl, int chunk, uint64_t* full) {
  const int c0 = chunk * KX;
#pragma unroll 4
  for (int k = 0; k < UNITS / THREADS; ++k) {
    const int u = threadIdx.x + THREADS * k, pix = u >> 4, c = c0 + 4 * (u & 15);
    const int gy = tl.y0 - 1 + pix / HW, gx = tl.x0 - 1 + pix % HW;
    const bool in = pix < HPIX && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
    const size_t base = in ? ((size_t(tl.bi) * a.h + gy) * a.w + gx) * a.cin : 0;
    if (a.vec) {
      const bool ok = in && c < a.cin;
      sm90::cp_async16(raw + u * 16, a.x + (ok ? base + c : 0), ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = in && c + e < a.cin;
        cp_async4(raw + u * 16 + 4 * e, a.x + (ok ? base + c + e : 0), ok ? 4 : 0);
      }
    }
  }
  sm90::cp_async_arrive(full);
}

// The staged chunk as a hi and a lo bf16 plane (128-byte swizzle): every
// thread splits ROWS * 8 / THREADS units of 8 channels of a pixel.
__device__ __forceinline__ void split_chunk(unsigned char* planes, const unsigned char* raw) {
#pragma unroll
  for (int k = 0; k < ROWS * 8 / THREADS; ++k) {
    const int u = threadIdx.x + THREADS * k, pix = u >> 3, q = u & 7;
    const float4 v0 = *reinterpret_cast<const float4*>(raw + pix * 256 + q * 32);
    const float4 v1 = *reinterpret_cast<const float4*>(raw + pix * 256 + q * 32 + 16);
    const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      const __nv_bfloat162 l2 = __floats2bfloat162_rn(v[2 * e] - __low2float(h2), v[2 * e + 1] - __high2float(h2));
      hi[e] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[e] = *reinterpret_cast<const uint32_t*>(&l2);
    }
    *reinterpret_cast<uint4*>(planes + sm90::swz128(pix, q)) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(planes + XPLANE + sm90::swz128(pix, q)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// A lane's ldmatrix of one k-step's A fragment: pixel `pix` of a plane of
// 64 channels a pixel (128-byte swizzle), 16-byte chunk `chunk`.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const unsigned char* plane, int pix, int chunk) {
  sm90::ldmatrix_x4(r, reinterpret_cast<const bf16*>(plane + sm90::swz128(pix, chunk)));
}

// The weight stream of the tile's channel tile: stage i into slot i % STAGES,
// issued by the block's first thread by predicated instructions, so every
// thread runs it.
struct Stream {
  unsigned char* ring;
  const unsigned char* src;
  const Bars& bars;
  int count;
  bool lead;
  __device__ __forceinline__ void issue(int i) const {
    const int s = i % STAGES;
    sm90::mbar_arrive_expect_tx_if(bars.wfull(s), STAGE_BYTES, lead);
    sm90::bulk_copy_if(ring + s * STAGE_BYTES, src + size_t(i) * STAGE_BYTES, STAGE_BYTES, bars.wfull(s), lead);
  }
  // Before stage i: refill the slot of stage i - LAG once both warpgroups
  // released it (both wait: no branch on who issues), then wait for stage i
  // itself.
  __device__ __forceinline__ void acquire(int i) const {
    const int r = i - LAG;
    if (r >= 0 && r + STAGES < count) {
      sm90::mbar_wait(bars.wempty(r % STAGES), (r / STAGES) & 1);
      issue(r + STAGES);
    }
    sm90::mbar_wait(bars.wfull(i % STAGES), (i / STAGES) & 1);
  }
  // Stage i's release by this warpgroup (its leader, where `pred` holds).
  __device__ __forceinline__ void release(int i, bool pred) const {
    sm90::mbar_arrive_if(bars.wempty((i + STAGES) % STAGES), pred);
  }
};

// A consumer warpgroup: for each x chunk, its split into the planes, then
// the chunk's products into its 64 output pixels x NT channels; the
// epilogue.
template <int NT>
__device__ void consume(const ConvArgs& a, unsigned char* smem, const Bars& bars, const Tile& tl) {
  constexpr int KSS = 256 / NT;  // k-steps a stage
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp >> 2, w = warp & 3;
  const int lrow = lane & 15, lkc = lane >> 4;  // ldmatrix row, 16-byte chunk offset
  const int gq = lane >> 2, t4 = lane & 3;      // accumulator row, column pair
  const bool leader = (threadIdx.x & 127) == 0;
  const Stream ws{smem, a.wts + size_t(tl.nt) * a.stages * STAGE_BYTES, bars, a.stages, threadIdx.x == 0};
  unsigned char* planes = smem + Plan::PLANES;
  unsigned char* raw = smem + Plan::RAW;
  // A rows: output pixel (4g + w, lrow) as a halo pixel at tap (0, 0).
  const int hb = (4 * g + w) * HW + lrow;

  for (int i = 0; i < STAGES && i < a.stages; ++i) ws.issue(i);
  stage_raw(raw, a, tl, 0, bars.raw());

  uint32_t ah[2][4], al[2][4];  // A fragments, double-buffered by k-step parity
  float acc[NT / 2];
#pragma unroll
  for (int r = 0; r < NT / 2; ++r) acc[r] = 0.f;
  sm90::fence_operand(acc);
  int i = 0;  // weight stage
  for (int xc = 0; xc < a.xc; ++xc) {
    sm90::mbar_wait(bars.raw(), xc & 1);
    consumer_sync();  // both warpgroups are done reading the previous chunk's planes
    split_chunk(planes, raw);
    consumer_sync();  // the planes are whole, and the raw chunk is free
    if (xc + 1 < a.xc) stage_raw(raw, a, tl, xc + 1, bars.raw());
    for (int tap = 0; tap < 9; ++tap) {
      const int hp = hb + (tap / 3) * HW + tap % 3;
#pragma unroll
      for (int q = 0; q < NT / 64; ++q, ++i) {
        ws.acquire(i);
        const unsigned char* st = smem + (i % STAGES) * STAGE_BYTES;
#pragma unroll
        for (int kk = 0; kk < KSS; ++kk) {
          const int ks = q * KSS + kk;  // k-step of the tap: 4 a tap, so its parity picks the A buffer
          uint32_t(&h0)[4] = ah[ks & 1], (&l0)[4] = al[ks & 1];
          load_a(h0, planes, hp, 2 * ks + lkc);
          load_a(l0, planes + XPLANE, hp, 2 * ks + lkc);
          sm90::wgmma_fence();
          const unsigned char* bh = st + kk * 64 * NT;  // 16 x NT hi, then lo
          const unsigned char* bl = bh + 32 * NT;
          sm90::Wgmma<NT>::run(acc, h0, sm90::desc_b(bh));
          sm90::Wgmma<NT>::run(acc, h0, sm90::desc_b(bl));
          sm90::Wgmma<NT>::run(acc, l0, sm90::desc_b(bh));
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // the k-step before this one is done: its A buffer is free
          if (kk == 0) ws.release(i - 1, leader && (tap > 0 || q > 0));  // ... and so is the previous stage
        }
      }
    }
    sm90::wgmma_wait<0>();
    ws.release(i - 1, leader);
  }
  sm90::fence_operand(acc);

  // Epilogue: lane (gq, t4) holds output pixels (4g + w, gq) and (4g + w,
  // gq + 8), channels 8j + 2t4 and 8j + 2t4 + 1 of the channel tile.
  const int gy = tl.y0 + 4 * g + w;
  if (gy >= a.h) return;
  const bool pair = (a.cout & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gx = tl.x0 + gq + 8 * half;
    if (gx >= a.w) continue;
    float* out = a.y + ((size_t(tl.bi) * a.h + gy) * a.w + gx) * size_t(a.cout);
#pragma unroll
    for (int jn = 0; jn < NT / 8; ++jn) {
      const int n = tl.nt * NT + 8 * jn + 2 * t4;
      if (n >= a.cout) continue;
      const bool both = n + 1 < a.cout;
      const float b0 = a.bias ? __ldg(a.bias + n) : 0.f;
      const float b1 = a.bias && both ? __ldg(a.bias + n + 1) : 0.f;
      const float v0 = acc[4 * jn + 2 * half] + b0, v1 = acc[4 * jn + 2 * half + 1] + b1;
      if (both && pair) {
        *reinterpret_cast<float2*>(out + n) = make_float2(v0, v1);
      } else {
        out[n] = v0;
        if (both) out[n + 1] = v1;
      }
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1) conv3x3_kernel(ConvArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Bars bars(smem);
  const Tile tl = decode(a, blockIdx.x);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bars.wfull(s), 1);   // the first thread's arrival and the bytes
      sm90::mbar_init(bars.wempty(s), 2);  // each warpgroup
    }
    sm90::mbar_init(bars.raw(), THREADS);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  consume<NT>(a, smem, bars, tl);
}

template <int NT>
int launch(ConvArgs a, int ntl, cudaStream_t stream) {
  const auto kern = conv3x3_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan::BYTES);
  if (err != cudaSuccess) return int(err);
  kern<<<ntl * a.spatial, THREADS, Plan::BYTES, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take. `w` is the
// weight stream that ops/kernels/conv3x3.py::pack_weights packs for the
// channel tile `nt` (64, 128 or 256); `bias` is (Cout,) f32 or null. x and y
// are f32, contiguous, 16-byte aligned.
extern "C" int mgu_conv3x3(const float* x, const void* w, const float* bias, float* y, int b, int h, int w_, int cin,
                           int cout, int nt, void* stream) {
  if (b <= 0 || h <= 0 || w_ <= 0 || cin <= 0 || cout <= 0 || (nt != 64 && nt != 128 && nt != 256))
    return int(cudaErrorInvalidValue);
  ConvArgs a{x, static_cast<const unsigned char*>(w), bias, y, b, h, w_, cin, cout};
  a.xc = (cin + KX - 1) / KX;
  a.tiles_w = (w_ + TW - 1) / TW;
  a.tiles_h = (h + TH - 1) / TH;
  a.spatial = b * a.tiles_w * a.tiles_h;
  a.stages = a.xc * 9 * nt / 64;
  a.vec = cin % 4 == 0;
  const int ntl = (cout + nt - 1) / nt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 64: return launch<64>(a, ntl, s);
    case 128: return launch<128>(a, ntl, s);
    default: return launch<256>(a, ntl, s);
  }
}
