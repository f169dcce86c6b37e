// 3x3 'SAME' convolution, stride 1, on NHWC f32: y = conv3x3(x, w) + bias,
// f32 out, the raw pre-BN conv output of a standard-layout ConvBlock in
// training and of the detection head's two convs. Run through the autograd Function of ops/kernels/conv3x3.py, it
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
// U-Net's widths (Cin, Cout 64-512), so operations bound it (at the head's
// 48 -> 24, 32 a byte: there the bytes do). On the f32 FMA units (67
// TFLOP/s on an H100 SXM) that is the SIMT figure; this kernel does the work
// on the tensor cores instead, and its bound is the split form's floor
// below.
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
//     each) and NT of its output channels (N of the wgmma); a wider Cout
//     runs in NT-channel tiles. NT is the smallest of 24, 48, 64, 96, 128 and
//     256 that holds Cout (256 above; ops/kernels/conv3x3.py::tile): 64, 128
//     or 256 where Cout is a multiple of 64, and the narrow tile at 24, 48
//     and 96 (the detection head's 96 -> 48 -> 24 and their adjoints), so
//     that no wgmma computes more than 8 padded channels there.
//   - x is consumed in chunks of KX = 64 input channels over the tile's
//     one-pixel halo (10 x 18 pixels, zero outside the image and beyond
//     Cin, so any Cin and any H, W). A chunk is staged raw (f32) by cp.async
//     one chunk ahead of use, 16 bytes a copy where Cin is a multiple of 4,
//     else 4; at its turn every thread splits it into a hi and a lo bf16
//     plane in the 128-byte-swizzled layout the A fragments (ldmatrix) read.
//     A chunk is KL = 4 k-steps of 16 channels; with the narrow tile the
//     last chunk runs only those that hold input channels (Cin 96: 4 then
//     2; 48: 3; 24: 2).
//   - Weights: the wrapper splits w (or its adjoint) into hi/lo bf16 once a
//     call and packs it into one stream in consumption order and in wgmma's
//     K-major B layout (ops/kernels/conv3x3.py::pack_weights): for each x
//     chunk and tap its KL k-steps of 16 x NT, hi then lo, read in stages of
//     KSS k-steps that fall on tap boundaries (16 KB where Cout is a multiple
//     of 64). They stream through a ring of slots by bulk copy, up to
//     SLOTS - 2 stages ahead of use.
//   - Two consumer warpgroups and no producer (256 threads, up to 255
//     registers a thread for the 128 accumulators at NT = 256): the first
//     thread refills the ring by predicated instructions, every thread
//     stages x. No divergent branch falls between two wgmma groups (ptxas
//     would serialize them): the copies past the halo land in spare shared
//     memory as zeros, not skipped. The warpgroups meet twice an x chunk
//     (before its planes are overwritten, once they are whole).
//   - The narrow tile (NT 24, 48, 96). Its k-steps are short, and one block
//     an SM would leave the tensor cores idle while it stages and splits x
//     and waits on each wgmma's latency. So two blocks share an SM (up to 128
//     registers a thread): a ring of 5 slots of 12 KB and no raw chunk (x is
//     split from device memory through registers at the chunk's turn), 108
//     KB a block; one block's loads and split run while the other's
//     products do. At NT 24 three blocks (4 slots of 6 KB, up to 85
//     registers), and a k-step's hi.hi and hi.lo are one wgmma of 48 columns
//     (Plan::FUSE).
//   - Epilogue: the bias (none for the dgrad) added to the f32 accumulator,
//     stored as NHWC-contiguous f32.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace sm90 = mgu::sm90;

constexpr int TH = 8, TW = 16;                           // output tile
constexpr int HH = TH + 2, HW = TW + 2, HPIX = HH * HW;  // x halo: 10 x 18
constexpr int KX = 64, KSTEPS = KX / 16;                 // x chunk channels, its k-steps
constexpr int ROWS = 192;                                // halo pixels rounded up: three 64-row tiles
constexpr int XPLANE = ROWS * 128;                       // a hi or lo plane: 64 bf16 channels a pixel
constexpr int UNITS = ROWS * KX * 4 / 16;                // 16-byte units of a raw f32 chunk
constexpr int LAG = 2;                                   // a ring slot is refilled LAG stages after use
constexpr int THREADS = 256;                             // two consumer warpgroups
constexpr int SM90_SHARED = 232448, SM90_SM_SHARED = 233472;  // a block's shared memory at most; an SM's

// A weight ring slot's bytes at channel tile NT: 16 KB for the wide tile;
// the narrow tile's stages are at most 12 KB, and at 24 channels 6 KB.
__host__ __device__ constexpr int slot_bytes(int nt) { return nt % 64 == 0 ? 16384 : nt == 24 ? 6144 : 12288; }
static_assert(UNITS % THREADS == 0, "raw units must divide among the threads");

// Shared memory at channel tile NT: the weight ring, the chunk's hi and lo
// planes, the raw f32 chunk (not with the narrow tile), the mbarriers.
template <int NT>
struct Plan {
  static constexpr bool NARROW = NT % 64 != 0;
  static constexpr int SLOT = slot_bytes(NT), SLOTS = !NARROW ? 7 : NT == 24 ? 4 : 5;
  static constexpr int BLOCKS = !NARROW ? 1 : NT == 24 ? 3 : 2;  // blocks an SM
  // At 24 channels, hi·hi and hi·lo are one wgmma of 2 NT columns (the hi
  // and lo slabs side by side are a 16 x 2NT slab), lo·hi a second into its
  // first NT: two wgmmas a k-step, 2 NT accumulator columns (at 48 the wider
  // accumulator costs more than the wgmma it saves).
  static constexpr bool FUSE = NT <= 24;
  static constexpr int ACC = FUSE ? NT : NT / 2;  // accumulator registers a thread
  static constexpr int PLANES = SLOTS * SLOT;
  static constexpr int RAW = PLANES + 2 * XPLANE;
  static constexpr int BAR = RAW + (NARROW ? 0 : UNITS * 16);
  static constexpr int BYTES = BAR + (2 * SLOTS + 1) * 8;
  static_assert(PLANES % 1024 == 0 && XPLANE % 1024 == 0 && RAW % 16 == 0 && BAR % 8 == 0, "conv3x3 plan misaligned");
  static_assert(BYTES <= SM90_SHARED && BLOCKS * (BYTES + 1024) <= SM90_SM_SHARED,  // 1 KB an SM keeps a block
                "conv3x3 plan exceeds shared memory");
};

// k-steps a weight stage holds in a chunk of KL k-steps at channel tile NT:
// the most that divide KL and fit a ring slot (64 NT bytes a k-step, hi then
// lo), so that stages fall on tap boundaries.
__host__ __device__ constexpr int stage_steps(int nt, int kl, int d = 0) {
  return d == 0 ? stage_steps(nt, kl, kl)
         : d == 1 || (kl % d == 0 && d * 64 * nt <= slot_bytes(nt)) ? d : stage_steps(nt, kl, d - 1);
}
static_assert(stage_steps(64, 4) == 4 && stage_steps(128, 4) == 2 && stage_steps(256, 4) == 1,
              "a whole chunk's stages are 16 KB from 64 output channels up");

struct ConvArgs {
  const float* x;                // (B, H, W, Cin)
  const unsigned char* wts;      // the weight stream: ntl streams of `stages` stages
  const float* bias;             // (Cout,), or null
  float* y;                      // (B, H, W, Cout)
  int b, h, w, cin, cout;
  int xc;                        // x chunks (ceil(Cin / KX))
  int klast;                     // k-steps of the last chunk: 4, or with the narrow tile ceil(channels left / 16)
  int tiles_w, tiles_h, spatial; // spatial tiles
  int stages;                    // stages of one channel tile's stream
  int whole, wbytes, lbytes;     // stages of the whole chunks, their bytes, the last chunk's stages' bytes
  int vec;                       // Cin % 4 == 0: x read 16 bytes at a time
};

struct Tile {
  int nt, bi, y0, x0;
};

// Block `blk`'s tile: channel tile, image, output origin.
__device__ __forceinline__ Tile decode(const ConvArgs& a, int blk) {
  const int t = blk % a.spatial, r = t / a.tiles_w;
  return Tile{blk / a.spatial, r / a.tiles_h, (r % a.tiles_h) * TH, (t % a.tiles_w) * TW};
}

template <int NT>
struct Bars {
  static constexpr int SLOTS = Plan<NT>::SLOTS;
  uint64_t* p;
  __device__ explicit Bars(unsigned char* smem) : p(reinterpret_cast<uint64_t*>(smem + Plan<NT>::BAR)) {}
  __device__ uint64_t* wfull(int s) const { return p + s; }           // the stage's bytes landed
  __device__ uint64_t* wempty(int s) const { return p + SLOTS + s; }  // both warpgroups released it
  __device__ uint64_t* raw() const { return p + 2 * SLOTS; }          // every thread's copies landed
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

// Eight f32 values as a hi and a lo bf16 unit of the planes (128-byte
// swizzle), pixel `pix`, 16-byte chunk `q`.
__device__ __forceinline__ void split_unit(unsigned char* planes, int pix, int q, const float (&v)[8]) {
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

// The staged chunk as a hi and a lo bf16 plane: every thread splits
// ROWS * 8 / THREADS units of 8 channels of a pixel.
__device__ __forceinline__ void split_chunk(unsigned char* planes, const unsigned char* raw) {
#pragma unroll
  for (int k = 0; k < ROWS * 8 / THREADS; ++k) {
    const int u = threadIdx.x + THREADS * k, pix = u >> 3, q = u & 7;
    const float4 v0 = *reinterpret_cast<const float4*>(raw + pix * 256 + q * 32);
    const float4 v1 = *reinterpret_cast<const float4*>(raw + pix * 256 + q * 32 + 16);
    split_unit(planes, pix, q, {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w});
  }
}

// The narrow tile's x: chunk `chunk` of the tile's halo read from device
// memory into registers (zero outside the image and beyond Cin) and split
// into the planes, the same units as split_chunk, in batches of 3 units a
// thread, each batch's loads issued before its first unit is split.
__device__ __forceinline__ void split_global(unsigned char* planes, const ConvArgs& a, const Tile& tl, int chunk) {
  constexpr int K = ROWS * 8 / THREADS, BATCH = 3;
  static_assert(K % BATCH == 0, "the units must divide into batches");
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += BATCH) {
    float v[BATCH][8];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int u = threadIdx.x + THREADS * (k0 + k), pix = u >> 3, c = chunk * KX + 8 * (u & 7);
      const int gy = tl.y0 - 1 + pix / HW, gx = tl.x0 - 1 + pix % HW;
      const bool in = pix < HPIX && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
      const float* src = a.x + (in ? ((size_t(tl.bi) * a.h + gy) * a.w + gx) * a.cin + c : 0);
      if (a.vec) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool ok = in && c + 4 * h < a.cin;
          const float4 f = ok ? __ldg(reinterpret_cast<const float4*>(src) + h) : make_float4(0.f, 0.f, 0.f, 0.f);
          v[k][4 * h] = f.x, v[k][4 * h + 1] = f.y, v[k][4 * h + 2] = f.z, v[k][4 * h + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[k][e] = in && c + e < a.cin ? __ldg(src + e) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int u = threadIdx.x + THREADS * (k0 + k);
      split_unit(planes, u >> 3, u & 7, v[k]);
    }
  }
}

// A lane's ldmatrix of one k-step's A fragment: pixel `pix` of a plane of
// 64 channels a pixel (128-byte swizzle), 16-byte chunk `chunk`.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const unsigned char* plane, int pix, int chunk) {
  sm90::ldmatrix_x4(r, reinterpret_cast<const bf16*>(plane + sm90::swz128(pix, chunk)));
}

// The weight stream of the tile's channel tile: stage i into slot i % SLOTS,
// issued by the block's first thread by predicated instructions, so every
// thread runs it. The whole chunks' stages come first, then the last
// chunk's (of another size where it has fewer k-steps).
template <int NT>
struct Stream {
  static constexpr int SLOT = Plan<NT>::SLOT, SLOTS = Plan<NT>::SLOTS;
  unsigned char* ring;
  const unsigned char* src;
  const Bars<NT>& bars;
  int count, whole, wbytes, lbytes;
  bool lead;
  __device__ __forceinline__ void issue(int i) const {
    const int s = i % SLOTS;
    int bytes = SLOT;
    size_t off = size_t(i) * SLOT;
    if constexpr (Plan<NT>::NARROW) {
      const bool last = i >= whole;
      bytes = last ? lbytes : wbytes;
      off = last ? size_t(whole) * wbytes + size_t(i - whole) * lbytes : size_t(i) * wbytes;
    }
    sm90::mbar_arrive_expect_tx_if(bars.wfull(s), bytes, lead);
    sm90::bulk_copy_if(ring + s * SLOT, src + off, bytes, bars.wfull(s), lead);
  }
  // Before stage i: refill the slot of stage i - LAG once both warpgroups
  // released it (both wait: no branch on who issues), then wait for stage i
  // itself.
  __device__ __forceinline__ void acquire(int i) const {
    const int r = i - LAG;
    if (r >= 0 && r + SLOTS < count) {
      sm90::mbar_wait(bars.wempty(r % SLOTS), (r / SLOTS) & 1);
      issue(r + SLOTS);
    }
    sm90::mbar_wait(bars.wfull(i % SLOTS), (i / SLOTS) & 1);
  }
  // Stage i's release by this warpgroup (its leader, where `pred` holds).
  __device__ __forceinline__ void release(int i, bool pred) const {
    sm90::mbar_arrive_if(bars.wempty((i + SLOTS) % SLOTS), pred);
  }
};

// What a consumer warpgroup reads through a chunk's k-steps.
struct Lane {
  const unsigned char* smem;
  unsigned char* planes;
  int hb, lkc;  // its A rows' halo pixel at tap (0, 0); the lane's 16-byte chunk offset
  bool leader;
};

// Tap `tap` of a chunk of KL k-steps, from weight stage i on, its first
// k-step's A buffer P: a stage of KSS k-steps at a time, each k-step's three
// products.
template <int NT, int KL, int P>
__device__ __forceinline__ void tap_products(float (&acc)[Plan<NT>::ACC], uint32_t (&ah)[2][4], uint32_t (&al)[2][4],
                                             const Stream<NT>& ws, const Lane& ln, int tap, int& i) {
  constexpr int KSS = stage_steps(NT, KL);
  const int hp = ln.hb + (tap / 3) * HW + tap % 3;
#pragma unroll
  for (int q = 0; q < KL / KSS; ++q, ++i) {
    ws.acquire(i);
    const unsigned char* st = ln.smem + (i % Plan<NT>::SLOTS) * Plan<NT>::SLOT;
#pragma unroll
    for (int kk = 0; kk < KSS; ++kk) {
      const int ks = q * KSS + kk;  // k-step of the tap
      uint32_t(&h0)[4] = ah[(P + ks) & 1], (&l0)[4] = al[(P + ks) & 1];
      load_a(h0, ln.planes, hp, 2 * ks + ln.lkc);
      load_a(l0, ln.planes + XPLANE, hp, 2 * ks + ln.lkc);
      sm90::wgmma_fence();
      const unsigned char* bh = st + kk * 64 * NT;  // 16 x NT hi, then lo
      const unsigned char* bl = bh + 32 * NT;
      if constexpr (Plan<NT>::FUSE) {
        sm90::Wgmma<2 * NT>::run(acc, h0, sm90::desc_b(bh));
        sm90::Wgmma<NT>::run(reinterpret_cast<float(&)[NT / 2]>(acc), l0, sm90::desc_b(bh));
      } else {
        sm90::Wgmma<NT>::run(acc, h0, sm90::desc_b(bh));
        sm90::Wgmma<NT>::run(acc, h0, sm90::desc_b(bl));
        sm90::Wgmma<NT>::run(acc, l0, sm90::desc_b(bh));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the k-step before this one is done: its A buffer is free
      if (kk == 0) ws.release(i - 1, ln.leader && (tap > 0 || q > 0));  // ... and so is the previous stage
    }
  }
}

// A chunk of KL k-steps: its 9 taps. Where KL is odd a tap's first A buffer
// alternates, so the taps run in pairs.
template <int NT, int KL>
__device__ __forceinline__ void chunk_products(float (&acc)[Plan<NT>::ACC], uint32_t (&ah)[2][4], uint32_t (&al)[2][4],
                                               const Stream<NT>& ws, const Lane& ln, int& i) {
  if constexpr (KL % 2 == 0) {
    for (int t = 0; t < 9; ++t) tap_products<NT, KL, 0>(acc, ah, al, ws, ln, t, i);
  } else {
    for (int t = 0; t < 8; t += 2) {
      tap_products<NT, KL, 0>(acc, ah, al, ws, ln, t, i);
      tap_products<NT, KL, 1>(acc, ah, al, ws, ln, t + 1, i);
    }
    tap_products<NT, KL, 0>(acc, ah, al, ws, ln, 8, i);
  }
}

// A consumer warpgroup: for each x chunk, its split into the planes (the
// wide tile stages the next chunk raw while this one's products run), then
// the chunk's products into its 64 output pixels x NT channels; the
// epilogue.
template <int NT>
__device__ void consume(const ConvArgs& a, unsigned char* smem, const Bars<NT>& bars, const Tile& tl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp >> 2, w = warp & 3;
  const int lrow = lane & 15;               // ldmatrix row
  const int gq = lane >> 2, t4 = lane & 3;  // accumulator row, column pair
  const size_t tile_bytes = size_t(a.whole) * a.wbytes + size_t(a.stages - a.whole) * a.lbytes;
  const Stream<NT> ws{smem, a.wts + size_t(tl.nt) * tile_bytes, bars, a.stages, a.whole, a.wbytes, a.lbytes,
                      threadIdx.x == 0};
  unsigned char* planes = smem + Plan<NT>::PLANES;
  unsigned char* raw = smem + Plan<NT>::RAW;
  // A rows: output pixel (4g + w, lrow) as a halo pixel at tap (0, 0).
  const Lane ln{smem, planes, (4 * g + w) * HW + lrow, lane >> 4, (threadIdx.x & 127) == 0};

  for (int i = 0; i < Plan<NT>::SLOTS && i < a.stages; ++i) ws.issue(i);
  if constexpr (!Plan<NT>::NARROW) stage_raw(raw, a, tl, 0, bars.raw());

  uint32_t ah[2][4], al[2][4];  // A fragments, double-buffered by k-step parity
  float acc[Plan<NT>::ACC];
#pragma unroll
  for (int r = 0; r < Plan<NT>::ACC; ++r) acc[r] = 0.f;
  sm90::fence_operand(acc);
  int i = 0;  // weight stage
  for (int xc = 0; xc < a.xc; ++xc) {
    if constexpr (Plan<NT>::NARROW) {
      if (xc > 0) consumer_sync();  // both warpgroups are done reading the previous chunk's planes
      split_global(planes, a, tl, xc);
      consumer_sync();  // the planes are whole
      switch (xc + 1 < a.xc ? KSTEPS : a.klast) {
        case 4: chunk_products<NT, 4>(acc, ah, al, ws, ln, i); break;
        case 3: chunk_products<NT, 3>(acc, ah, al, ws, ln, i); break;
        case 2: chunk_products<NT, 2>(acc, ah, al, ws, ln, i); break;
        default: chunk_products<NT, 1>(acc, ah, al, ws, ln, i); break;
      }
    } else {
      sm90::mbar_wait(bars.raw(), xc & 1);
      consumer_sync();  // both warpgroups are done reading the previous chunk's planes
      split_chunk(planes, raw);
      consumer_sync();  // the planes are whole, and the raw chunk is free
      if (xc + 1 < a.xc) stage_raw(raw, a, tl, xc + 1, bars.raw());
      chunk_products<NT, KSTEPS>(acc, ah, al, ws, ln, i);
    }
    sm90::wgmma_wait<0>();
    ws.release(i - 1, ln.leader);
  }
  sm90::fence_operand(acc);
  if constexpr (Plan<NT>::FUSE) {
#pragma unroll
    for (int r = 0; r < NT / 2; ++r) acc[r] += acc[NT / 2 + r];  // hi·lo's columns onto the others
  }

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
__global__ void __launch_bounds__(THREADS, Plan<NT>::BLOCKS) conv3x3_kernel(ConvArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Bars<NT> bars(smem);
  const Tile tl = decode(a, blockIdx.x);
  if (threadIdx.x == 0) {
    for (int s = 0; s < Plan<NT>::SLOTS; ++s) {
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
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan<NT>::BYTES);
  if (err != cudaSuccess) return int(err);
  // The stream's stages: the whole chunks', then the last chunk's, and their
  // bytes. Only the narrow tile cuts the last chunk's k-steps.
  constexpr int KSS[5] = {0, stage_steps(NT, 1), stage_steps(NT, 2), stage_steps(NT, 3), stage_steps(NT, 4)};
  if (!Plan<NT>::NARROW) a.klast = KSTEPS;
  a.whole = (a.xc - 1) * 9 * KSTEPS / KSS[KSTEPS];
  a.stages = a.whole + 9 * a.klast / KSS[a.klast];
  a.wbytes = KSS[KSTEPS] * 64 * NT;
  a.lbytes = KSS[a.klast] * 64 * NT;
  kern<<<ntl * a.spatial, THREADS, Plan<NT>::BYTES, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take. `w` is the
// weight stream that ops/kernels/conv3x3.py::pack_weights packs for the
// channel tile `nt` (24, 48, 96: the narrow tile; 64, 128, 256:
// conv3x3.py::tile); `bias` is (Cout,) f32 or null. x and y are f32,
// contiguous, 16-byte aligned.
extern "C" int mgu_conv3x3(const float* x, const void* w, const float* bias, float* y, int b, int h, int w_, int cin,
                           int cout, int nt, void* stream) {
  if (b <= 0 || h <= 0 || w_ <= 0 || cin <= 0 || cout <= 0 || nt <= 0) return int(cudaErrorInvalidValue);
  ConvArgs a{x, static_cast<const unsigned char*>(w), bias, y, b, h, w_, cin, cout};
  a.xc = (cin + KX - 1) / KX;
  a.klast = (cin - KX * (a.xc - 1) + 15) / 16;
  a.tiles_w = (w_ + TW - 1) / TW;
  a.tiles_h = (h + TH - 1) / TH;
  a.spatial = b * a.tiles_w * a.tiles_h;
  a.vec = cin % 4 == 0;
  const int ntl = (cout + nt - 1) / nt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 24: return launch<24>(a, ntl, s);
    case 48: return launch<48>(a, ntl, s);
    case 64: return launch<64>(a, ntl, s);
    case 96: return launch<96>(a, ntl, s);
    case 128: return launch<128>(a, ntl, s);
    case 256: return launch<256>(a, ntl, s);
    default: return int(cudaErrorInvalidValue);
  }
}
