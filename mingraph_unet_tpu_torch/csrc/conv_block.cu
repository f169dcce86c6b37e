// Fused inference ConvBlock: y = relu(conv3x3(h, w2) * s2 + b2) with
// h = relu(conv3x3(x, w1) * s1 + b1), both convs 'SAME', in f32 inside and
// one device-memory round trip: x is read and y written, h never leaves the
// chip. Replaces mingraph_unet_tpu/ops/pallas/conv_block.py::fused_conv_block.
//
// The function is f32 inside, as the TPU kernel is: taps and weights are f32
// (x widened), the scale/shift multiplies the f32 accumulator (it is not
// folded into the weights), h stays f32 to within the split below, and only
// y is rounded to x's dtype.
//
// Bound. The function needs 2*9*(Cin*C + C*C) operations per pixel against
// 2-4 bytes of x and y per channel: operations bound it at every U-Net
// width. On the f32 FMA units (67 TFLOP/s on an H100 SXM) that is the SIMT
// figure; this kernel does the work on the tensor cores instead, and its
// bound is the split form's floor below.
//
// Design: implicit GEMM on the tensor cores (wgmma), with f32 accuracy from a
// bf16 hi/lo split. An f32 value a is a_hi = bf16(a) plus a_lo = bf16(a -
// a_hi), within 2^-18 |a|; a*b is a_hi*b_hi + a_hi*b_lo + a_lo*b_hi in the
// f32 accumulator (the dropped a_lo*b_lo is below 2^-16 |ab|). A bf16 x is
// exact in bf16 (x_lo = 0), so conv1 on bf16 x takes 2 products, conv1 on
// f32 x and conv2 on h take 3. The least time is then the products times the
// operations over the bf16 rate (989 TFLOP/s): the split form's floor.
//   - A block owns an 8 x 16 tile of output pixels of one image (M = 128,
//     one 64-row wgmma for each consumer warpgroup: 4 output rows) and NT of
//     its output channels (64, 128 or 256: N of conv2's wgmma); a wider C
//     runs in NT-channel tiles, each with conv1 recomputed.
//   - h is computed in chunks of KC = 64 channels over the tile's one-pixel
//     halo (10 x 18 = 180 pixels, three 64-row wgmma tiles: 192 / 128 = 1.5x
//     the useful conv1 rows), each chunk's epilogue (scale/shift, ReLU, zero
//     outside the image: conv2's SAME padding is zero, not relu(b1)) writing
//     it as a hi/lo bf16 pair into shared memory in the 128-byte-swizzled
//     layout that conv2's A fragments (ldmatrix) read, and conv2 consumes the
//     chunk at once into accumulators that live in registers for the whole
//     tile. Consumer warpgroup g computes conv1's halo tile g (all 64 h
//     channels) and half the channels of the third halo tile.
//   - conv1 runs over x in chunks of KX = 64 input channels staged with
//     their two-pixel halo (12 x 20 pixels, zero outside the image and
//     beyond Cin, so any Cin) by all the block's threads one chunk ahead of
//     use: cp.async for a bf16 x with Cin a multiple of 8, else loaded,
//     split into hi/lo and stored.
//   - Weights: the wrapper splits w1 and w2 into hi/lo bf16 once a call and
//     packs them into one stream of 16 KB stages in consumption order and in
//     wgmma's K-major B layout (ops/kernels/conv_block.py::pack_weights):
//     for each h chunk, conv1's stages (one a (x chunk, tap): 64 x 64 hi and
//     lo), then conv2's (one a (tap, 16-64 rows of K): K x NT hi and lo).
//     They do not fit a block, so they stream through a ring of 7 stages by
//     bulk copy, up to 5 stages ahead of use. Each block streams its own: a
//     cluster of two blocks with each stage multicast to both halves the L2
//     traffic but ties the four warpgroups to each other's pace at every
//     stage, and measured no faster on an H100.
//   - Two consumer warpgroups and no producer: 256 threads let ptxas give a
//     thread up to 255 registers (conv2's 128 accumulators at NT = 256 and
//     conv1's 48 live together); with a ninth warp it caps them at 168 and
//     spills, whatever setmaxnreg hands over at run time. So the warpgroups
//     issue the copies themselves, in step: at each stage both wait until the
//     stage two back is released by both, and the first thread refills its
//     slot by predicated instructions; both stage the next x chunk. No
//     divergent branch falls between two wgmma groups (ptxas would serialize
//     them), so halo and padding rows are written to spare shared memory or
//     zeroed by selects, not skipped. The warpgroups meet twice an h chunk
//     (before h is overwritten, once it is complete).
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace sm90 = mgu::sm90;

constexpr int TH = 8, TW = 16;                           // output tile
constexpr int HH = TH + 2, HW = TW + 2, HPIX = HH * HW;  // h halo: 10 x 18
constexpr int HROWS = 192;                               // three 64-row wgmma tiles over the h halo
constexpr int XW = TW + 4, XPIX = (TH + 4) * XW;         // x halo: 12 x 20
constexpr int XROWS = 256;                               // x halo pixels rounded up: 8 units a thread
constexpr int KC = 64, KX = 64;                          // h chunk, x chunk channels
constexpr int STAGE_BYTES = 16384, STAGES = 7, LAG = 2;  // weight ring; a slot is refilled LAG stages after use
constexpr int XPLANE = XROWS * 128, HPLANE = HROWS * 128;  // 64 bf16 channels a pixel
constexpr int THREADS = 256;                             // two consumer warpgroups
constexpr int SM90_SHARED = 232448;

// Shared memory: the weight ring, the x ring (bf16 x: two stages of hi; f32
// x: one stage of hi and lo planes), h's hi and lo planes, the mbarriers.
template <bool XF32>
struct Plan {
  static constexpr int XSTAGES = XF32 ? 1 : 2, XPLANES = XF32 ? 2 : 1;
  static constexpr int XRING = STAGES * STAGE_BYTES;
  static constexpr int HBUF = XRING + XSTAGES * XPLANES * XPLANE;
  static constexpr int BAR = HBUF + 2 * HPLANE;
  static constexpr int BYTES = BAR + (2 * STAGES + 2 * XSTAGES) * 8;
  static_assert(XRING % 1024 == 0 && HBUF % 128 == 0 && BAR % 8 == 0, "conv-block plan misaligned");
  static_assert(BYTES <= SM90_SHARED, "conv-block plan exceeds shared memory");
};

struct BlockArgs {
  const void* x;                   // (B, H, W, Cin), bf16 or f32
  const unsigned char* wts;        // the weight stream: ntl streams of `stages` stages
  const float *s1, *b1, *s2, *b2;  // (C1p,), (C1p,), (C2p,), (C2p,)
  void* y;                         // (B, H, W, C), x's dtype
  int b, h, w, cin, c;
  int hc, xc;                      // h chunks (C1p / KC), x chunks (ceil(Cin / KX))
  int tiles_w, tiles_h, spatial;   // spatial tiles
  int stages;                      // stages of one channel tile's stream
  int vec;                         // bf16 x with Cin % 8 == 0: x staged by cp.async
};

struct Tile {
  int nt, bi, y0, x0;
};

// Block `blk`'s tile: channel tile, image, output origin.
__device__ __forceinline__ Tile decode(const BlockArgs& a, int blk) {
  const int t = blk % a.spatial, r = t / a.tiles_w;
  return Tile{blk / a.spatial, r / a.tiles_h, (r % a.tiles_h) * TH, (t % a.tiles_w) * TW};
}

template <bool XF32>
struct Bars {
  static constexpr int XS = Plan<XF32>::XSTAGES;
  uint64_t* p;
  __device__ explicit Bars(unsigned char* smem) : p(reinterpret_cast<uint64_t*>(smem + Plan<XF32>::BAR)) {}
  __device__ uint64_t* wfull(int s) const { return p + s; }               // the stage's bytes landed
  __device__ uint64_t* wempty(int s) const { return p + STAGES + s; }     // both warpgroups released it
  __device__ uint64_t* xfull(int j) const { return p + 2 * STAGES + j; }  // every thread's copies landed
  __device__ uint64_t* xempty(int j) const { return p + 2 * STAGES + XS + j; }
};

// The consumer warpgroups meet (named barrier 1).
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// Stage x chunk `chunk` (of hc x xc, x chunk chunk % xc) of the tile's x halo
// (12 x 20 pixels x 64 channels, zero outside the image and beyond Cin) into
// `dst` in the 128-byte-swizzled layout: hi plane, then (f32 x) lo plane.
// Every thread takes 8 units of 8 channels of a pixel (the halo rounded up
// to 256 pixels) and arrives on `full` (at once; cp.async copies complete
// the arrival as they land).
template <bool XF32>
__device__ void stage_x(unsigned char* dst, const BlockArgs& a, const Tile& tl, int chunk, uint64_t* full) {
  const int c0 = (chunk % a.xc) * KX;
  if (!XF32 && a.vec) {
    const bf16* x = static_cast<const bf16*>(a.x);
#pragma unroll
    for (int k = 0; k < XROWS * 8 / THREADS; ++k) {
      const int u = threadIdx.x + THREADS * k, pix = u >> 3, q = u & 7, c = c0 + 8 * q;
      const int gy = tl.y0 - 2 + pix / XW, gx = tl.x0 - 2 + pix % XW;
      const bool in = pix < XPIX && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w && c < a.cin;
      const bf16* src = x + (in ? ((size_t(tl.bi) * a.h + gy) * a.w + gx) * a.cin + c : 0);
      sm90::cp_async16(dst + sm90::swz128(pix, q), src, in ? 16 : 0);
    }
    sm90::cp_async_arrive(full);
    return;
  }
#pragma unroll 1
  for (int k = 0; k < XROWS * 8 / THREADS; ++k) {
    const int u = threadIdx.x + THREADS * k, pix = u >> 3, q = u & 7, c = c0 + 8 * q;
    const int gy = tl.y0 - 2 + pix / XW, gx = tl.x0 - 2 + pix % XW;
    const bool in = pix < XPIX && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
    const size_t base = in ? ((size_t(tl.bi) * a.h + gy) * a.w + gx) * a.cin + c : 0;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {  // selects, not branches: a load from a clamped address, then zero
      const bool ok = in && c + e < a.cin;
      const size_t at = ok ? base + e : 0;
      const float t = XF32 ? static_cast<const float*>(a.x)[at] : __bfloat162float(static_cast<const bf16*>(a.x)[at]);
      v[e] = ok ? t : 0.f;
    }
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      const __nv_bfloat162 l2 = __floats2bfloat162_rn(v[2 * e] - __low2float(h2), v[2 * e + 1] - __high2float(h2));
      hi[e] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[e] = *reinterpret_cast<const uint32_t*>(&l2);
    }
    *reinterpret_cast<uint4*>(dst + sm90::swz128(pix, q)) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    if (XF32) *reinterpret_cast<uint4*>(dst + XPLANE + sm90::swz128(pix, q)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  sm90::mbar_arrive(full);
}

// A lane's ldmatrix of one k-step's A fragment: pixel `pix` of a plane of
// 64 channels a pixel (128-byte swizzle), 16-byte chunk `chunk`.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const unsigned char* plane, int pix, int chunk) {
  sm90::ldmatrix_x4(r, reinterpret_cast<const bf16*>(plane + sm90::swz128(pix, chunk)));
}

// h chunk values of one accumulator fragment (m64nN, rows from `m0`,
// channels from `n0` of the chunk) into the hi / lo planes: scale/shift,
// ReLU, zero at h pixels outside the image and on the rows past the halo.
template <int N>
__device__ __forceinline__ void put_h(unsigned char* hbuf, const float (&acc)[N / 2], const BlockArgs& a,
                                      const Tile& tl, int m0, int n0, int hc, int gq, int t4) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = m0 + gq + 8 * half;
    const int gy = tl.y0 - 1 + p / HW, gx = tl.x0 - 1 + p % HW;
    const bool inside = p < HPIX && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t4, cg = hc * KC + n;
      const float v0 = fmaxf(acc[4 * j + 2 * half] * __ldg(a.s1 + cg) + __ldg(a.b1 + cg), 0.f);
      const float v1 = fmaxf(acc[4 * j + 2 * half + 1] * __ldg(a.s1 + cg + 1) + __ldg(a.b1 + cg + 1), 0.f);
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(inside ? v0 : 0.f, inside ? v1 : 0.f);
      const __nv_bfloat162 l2 =
          __floats2bfloat162_rn((inside ? v0 : 0.f) - __low2float(h2), (inside ? v1 : 0.f) - __high2float(h2));
      const uint32_t off = sm90::swz128(p, n >> 3) + 4 * t4;
      *reinterpret_cast<__nv_bfloat162*>(hbuf + off) = h2;
      *reinterpret_cast<__nv_bfloat162*>(hbuf + HPLANE + off) = l2;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float v0, float v1, bool both, bool pair);
template <>
__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1, bool both, bool pair) {
  if (both && pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16_rn(v0);
    if (both) p[1] = __float2bfloat16_rn(v1);
  }
}
template <>
__device__ __forceinline__ void store_pair(float* p, float v0, float v1, bool both, bool pair) {
  if (both && pair) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (both) p[1] = v1;
  }
}

// The weight stream of the tile's channel tile: stage i into slot i % STAGES,
// issued by the block's first thread by predicated instructions, so every
// thread runs it.
template <bool XF32>
struct Stream {
  unsigned char* ring;
  const unsigned char* src;
  const Bars<XF32>& bars;
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

// A consumer warpgroup: conv1 over its halo rows for each h chunk, the h
// chunk into shared memory, conv2's products of the chunk into its 64
// output pixels x NT channels, and the epilogue.
template <int NT, bool XF32, typename T>
__device__ void consume(const BlockArgs& a, unsigned char* smem, const Bars<XF32>& bars, const Tile& tl) {
  using P = Plan<XF32>;
  constexpr int PIPE = XF32 ? 1 : 2;      // conv1 k-steps in flight (f32 x: its A doubles, no room for two)
  constexpr int KSS = 256 / NT;           // conv2 k-steps a stage
  constexpr int AHEAD = P::XSTAGES - 1;   // x chunks staged ahead of use
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp >> 2, w = warp & 3;
  const int lrow = lane & 15, lkc = lane >> 4;  // ldmatrix row, 16-byte chunk offset
  const int gq = lane >> 2, t4 = lane & 3;      // accumulator row, column pair
  const bool leader = (threadIdx.x & 127) == 0;
  const Stream<XF32> ws{smem, a.wts + size_t(tl.nt) * a.stages * STAGE_BYTES, bars, a.stages, threadIdx.x == 0};
  unsigned char* xring = smem + P::XRING;
  unsigned char* hbuf = smem + P::HBUF;
  const int chunks = a.hc * a.xc;

  // conv1 A rows: h halo pixel m of tile g and of the shared third tile
  // (clamped past the halo), as x halo pixels at tap (0, 0).
  const int m0 = 64 * g + 16 * w + lrow, m1 = min(128 + 16 * w + lrow, HPIX - 1);
  const int xb0 = (m0 / HW) * XW + m0 % HW, xb1 = (m1 / HW) * XW + m1 % HW;
  // conv2 A rows: output pixel (4g + w, lrow) as an h halo pixel at tap (0, 0).
  const int hb = (4 * g + w) * HW + lrow;

  for (int i = 0; i < STAGES && i < a.stages; ++i) ws.issue(i);
  for (int j = 0; j < AHEAD && j < chunks; ++j) stage_x<XF32>(xring + j * P::XPLANES * XPLANE, a, tl, j, bars.xfull(j));

  uint32_t ah[2][2][4], al[2][2][4];  // A fragments, double-buffered: [k-step parity][halo tile or h]
  float acc2[NT / 2];
#pragma unroll
  for (int r = 0; r < NT / 2; ++r) acc2[r] = 0.f;
  sm90::fence_operand(acc2);
  int i = 0, j = 0;  // weight stage, x chunk
  for (int hc = 0; hc < a.hc; ++hc) {
    float acc1a[32], acc1b[16];  // tile g: 64 h channels; third tile: channels 32g .. 32g + 31
#pragma unroll
    for (int r = 0; r < 32; ++r) acc1a[r] = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) acc1b[r] = 0.f;
    sm90::fence_operand(acc1a);
    sm90::fence_operand(acc1b);
    for (int xc = 0; xc < a.xc; ++xc, ++j) {
      const int jn = j + AHEAD;
      if (jn < chunks) {  // stage the chunk AHEAD of this one once both warpgroups released its slot
        const int xn = jn % P::XSTAGES;
        sm90::mbar_wait(bars.xempty(xn), ((jn / P::XSTAGES) & 1) ^ 1);
        stage_x<XF32>(xring + xn * P::XPLANES * XPLANE, a, tl, jn, bars.xfull(xn));
      }
      const int xs = j % P::XSTAGES;
      sm90::mbar_wait(bars.xfull(xs), (j / P::XSTAGES) & 1);
      const unsigned char* xh = xring + xs * P::XPLANES * XPLANE;
      for (int tap = 0; tap < 9; ++tap, ++i) {
        ws.acquire(i);
        const unsigned char* st = smem + (i % STAGES) * STAGE_BYTES;
        const int toff = (tap / 3) * XW + tap % 3;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t(&h0)[4] = ah[ks % PIPE][0], (&h1)[4] = ah[ks % PIPE][1];
          uint32_t(&l0)[4] = al[ks % PIPE][0], (&l1)[4] = al[ks % PIPE][1];
          load_a(h0, xh, xb0 + toff, 2 * ks + lkc);
          load_a(h1, xh, xb1 + toff, 2 * ks + lkc);
          if constexpr (XF32) {
            load_a(l0, xh + XPLANE, xb0 + toff, 2 * ks + lkc);
            load_a(l1, xh + XPLANE, xb1 + toff, 2 * ks + lkc);
          }
          sm90::wgmma_fence();
          const unsigned char* bh = st + ks * 4096;  // 16 x 64 hi, then lo
          const unsigned char* bl = bh + 2048;
          sm90::Wgmma<64>::run(acc1a, h0, sm90::desc_b(bh));
          sm90::Wgmma<64>::run(acc1a, h0, sm90::desc_b(bl));
          sm90::Wgmma<32>::run(acc1b, h1, sm90::desc_b(bh + 1024 * g));
          sm90::Wgmma<32>::run(acc1b, h1, sm90::desc_b(bl + 1024 * g));
          if constexpr (XF32) {
            sm90::Wgmma<64>::run(acc1a, l0, sm90::desc_b(bh));
            sm90::Wgmma<32>::run(acc1b, l1, sm90::desc_b(bh + 1024 * g));
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait<PIPE - 1>();  // the k-step before this one is done: its A buffer is free
          if (ks == 0) ws.release(i - 1, leader && tap > 0);  // ... and so is the previous tap's stage
        }
      }
      sm90::wgmma_wait<0>();
      ws.release(i - 1, leader);
      sm90::mbar_arrive_if(bars.xempty(xs), leader);
    }
    sm90::fence_operand(acc1a);
    sm90::fence_operand(acc1b);

    consumer_sync();  // both warpgroups are done reading the previous h chunk
    put_h<64>(hbuf, acc1a, a, tl, 64 * g + 16 * w, 0, hc, gq, t4);
    put_h<32>(hbuf, acc1b, a, tl, 128 + 16 * w, 32 * g, hc, gq, t4);
    consumer_sync();  // the h chunk is whole

    for (int tap = 0; tap < 9; ++tap) {
      const int hp = hb + (tap / 3) * HW + tap % 3;
#pragma unroll
      for (int q = 0; q < NT / 64; ++q, ++i) {
        ws.acquire(i);
        const unsigned char* st = smem + (i % STAGES) * STAGE_BYTES;
#pragma unroll
        for (int kk = 0; kk < KSS; ++kk) {
          const int ks = q * KSS + kk;  // k-step of the tap: 4 a tap, so its parity picks the A buffer
          uint32_t(&h0)[4] = ah[ks & 1][0], (&l0)[4] = al[ks & 1][0];
          load_a(h0, hbuf, hp, 2 * ks + lkc);
          load_a(l0, hbuf + HPLANE, hp, 2 * ks + lkc);
          sm90::wgmma_fence();
          const unsigned char* bh = st + kk * 64 * NT;  // 16 x NT hi, then lo
          const unsigned char* bl = bh + 32 * NT;
          sm90::Wgmma<NT>::run(acc2, h0, sm90::desc_b(bh));
          sm90::Wgmma<NT>::run(acc2, h0, sm90::desc_b(bl));
          sm90::Wgmma<NT>::run(acc2, l0, sm90::desc_b(bh));
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // the k-step before this one is done: its A buffer is free
          if (kk == 0) ws.release(i - 1, leader && (tap > 0 || q > 0));  // ... and so is the previous stage
        }
      }
    }
    sm90::wgmma_wait<0>();
    ws.release(i - 1, leader);
  }
  sm90::fence_operand(acc2);

  // Epilogue: lane (gq, t4) holds output pixels (4g + w, gq) and (4g + w,
  // gq + 8), channels 8j + 2t4 and 8j + 2t4 + 1 of the channel tile.
  const int gy = tl.y0 + 4 * g + w;
  if (gy >= a.h) return;
  const bool pair = (a.c & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gx = tl.x0 + gq + 8 * half;
    if (gx >= a.w) continue;
    T* out = static_cast<T*>(a.y) + ((size_t(tl.bi) * a.h + gy) * a.w + gx) * size_t(a.c);
#pragma unroll
    for (int jn = 0; jn < NT / 8; ++jn) {
      const int n = tl.nt * NT + 8 * jn + 2 * t4;
      if (n >= a.c) continue;
      const float v0 = fmaxf(acc2[4 * jn + 2 * half] * __ldg(a.s2 + n) + __ldg(a.b2 + n), 0.f);
      const float v1 = fmaxf(acc2[4 * jn + 2 * half + 1] * __ldg(a.s2 + n + 1) + __ldg(a.b2 + n + 1), 0.f);
      store_pair(out + n, v0, v1, n + 1 < a.c, pair);
    }
  }
}

template <int NT, bool XF32, typename T>
__global__ void __launch_bounds__(THREADS, 1) conv_block_kernel(BlockArgs a) {
  using P = Plan<XF32>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const Bars<XF32> bars(smem);
  const Tile tl = decode(a, blockIdx.x);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bars.wfull(s), 1);              // the first thread's arrival and the bytes
      sm90::mbar_init(bars.wempty(s), 2);             // each warpgroup
    }
    for (int j = 0; j < P::XSTAGES; ++j) {
      sm90::mbar_init(bars.xfull(j), THREADS);
      sm90::mbar_init(bars.xempty(j), 2);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  consume<NT, XF32, T>(a, smem, bars, tl);
}

template <int NT, bool XF32, typename T>
int launch(BlockArgs a, int ntl, cudaStream_t stream) {
  const auto kern = conv_block_kernel<NT, XF32, T>;
  const int bytes = Plan<XF32>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  kern<<<ntl * a.spatial, THREADS, bytes, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take. `w` is the
// weight stream that ops/kernels/conv_block.py::pack_weights packs for the
// channel tile `nt` (64, 128 or 256); the scales are f32, padded with zeros
// to C1p = 64 * ceil(C / 64) (s1, b1) and C2p = nt * ceil(C / nt) (s2, b2).
// x and y are bf16 or f32, contiguous, 16-byte aligned.
extern "C" int mgu_conv_block(const void* x, const void* w, const float* s1, const float* b1, const float* s2,
                              const float* b2, void* y, int b, int h, int w_, int cin, int c, int nt, int is_bf16,
                              void* stream) {
  if (b <= 0 || h <= 0 || w_ <= 0 || cin <= 0 || c <= 0 || (nt != 64 && nt != 128 && nt != 256))
    return int(cudaErrorInvalidValue);
  const int ntl = (c + nt - 1) / nt;
  BlockArgs a{x, static_cast<const unsigned char*>(w), s1, b1, s2, b2, y, b, h, w_, cin, c};
  a.hc = (c + KC - 1) / KC;
  a.xc = (cin + KX - 1) / KX;
  a.tiles_w = (w_ + TW - 1) / TW;
  a.tiles_h = (h + TH - 1) / TH;
  a.spatial = b * a.tiles_w * a.tiles_h;
  a.stages = a.hc * 9 * (a.xc + nt / 64);
  a.vec = is_bf16 && cin % 8 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (nt) {
      case 64: return launch<64, false, bf16>(a, ntl, s);
      case 128: return launch<128, false, bf16>(a, ntl, s);
      default: return launch<256, false, bf16>(a, ntl, s);
    }
  }
  switch (nt) {
    case 64: return launch<64, true, float>(a, ntl, s);
    case 128: return launch<128, true, float>(a, ntl, s);
    default: return launch<256, true, float>(a, ntl, s);
  }
}
