// relu(conv3x3([skip | ConvTranspose2x2(x_prev)]) + bias) in s2d layout: the
// s2d decoder block's conv1 with the upsample folded in. Replaces
// mingraph_unet_tpu/ops/pallas/psconv.py::dec_conv1_fused (its body
// _dec1_kernel).
//
// Layout. skip is (B, Hh, Ww, 4C) with channel ph*C + c, ph = 2*py + px:
// full-resolution pixel (2I + py, 2J + px). x_prev is (B, Hh, Ww, Cp) on the
// same s2d grid. The output is (B, Hh, Ww, 4C) like skip. The skip term is
// the 3x3 conv of the full-resolution skip, computed on the s2d layout as
// K1 does. The x_prev term is a 3x3 conv on x_prev's own grid with the
// ConvTranspose folded into its weights, k_prev (3, 3, Cp, 4C): for output
// phase p = (py, px) only the 2x2 taps {py, py+1} x {px, px+1} of p's column
// block are non-zero. The upsample's bias and conv1's bias arrive as a
// (3, 3, 4C) table of (row class, column class) in {first, interior, last}
// and are added in the epilogue.
//
// mgu_dec_conv1_halo is the same conv on one H-shard of the s2d grid (the
// spatially sharded U-Net's decoder conv1): the rows above and below the
// shard of both inputs arrive apart (null at a global border), and the bias
// table's row class is taken from the global row (row0 + local row against
// hh_glob), so an inner shard's first row is interior.
//
// bf16 (C = Cout in {32, 64}, Cp = 2C: the U-Net's two s2d levels): a Hopper
// kernel.
//   Bound. The function needs 2*17*C^2 operations a full-res pixel (9C^2 for
//   the skip taps, 4 * 2C * C for the live x_prev taps) against 2.5C bf16
//   values moved (skip, x_prev read once, y written once): memory bounds it
//   on the H100 at C = 32 (L0: 336 MB, 100 us), the tensor cores at C = 64
//   (L1: 73 GFLOP, 74 us).
//   Design.
//   - A tile is 4 x 16 s2d pixels of one image. A wgmma.m64nCk16 covers the
//     tile's 64 pixels in ONE output phase (warp w takes s2d row w, lane r
//     of its ldmatrix pixel r), so its B is shared by all 64 rows: W_skip[tap]
//     for the skip term, the phase's own live x_prev block for the x_prev
//     term. Each phase sums its 9 skip taps x C/16 k-steps, then its 4 live
//     x_prev taps x Cp/16: no zero block of k_prev is read or multiplied.
//   - Live weights resident in shared memory for the block's life, copied
//     once by bulk (TMA) copies in wgmma's K-major B layout (hopper.cuh;
//     packed by psconv.py::dec_conv1_live_weights and wgmma_b_layout).
//   - Warp specialised and persistent, as K1 (psel_conv.cu): a producer
//     warpgroup (its registers handed to the consumers by setmaxnreg)
//     stages each tile's two halos (6 x 18 s2d pixels, all channels) by TMA,
//     one box a 64-channel plane landing with the 128-byte swizzle, into two
//     rings, one for skip and one for x_prev, with full / empty mbarriers.
//     The two consumer warpgroups take alternate tiles (ping-pong), so one's
//     epilogue and halo waits overlap the other's products; a tile's skip
//     stage is released as soon as its skip term is done, so the next tile's
//     skip halo loads while the x_prev term runs.
//   - L0 (C = 32): a block computes all four phases of its tiles; live
//     weights 18,432 + 65,536 bytes, 3 stages of 43,008. A is loaded once
//     for each distinct source and fed to every phase that reads it: 16
//     full-res offsets for the 36 (phase, skip tap) pairs, 9 x_prev pixels
//     for the 16 (phase, live tap) pairs.
//   - L1 (C = 64): all live weights (335,872 bytes) do not fit in a block,
//     so a cluster of 4 blocks shares each tile, block r computing phase r
//     and holding W_skip (73,728) and its phase's live block (65,536). Each
//     halo (82,944 bytes) is loaded once per cluster: block 0 multicasts it
//     to the four (TMA .multicast::cluster) once every block has released
//     the slot (remote mbarrier arrivals on block 0's cluster-empty
//     barriers). One stage of each ring fits beside the weights.
//   - Epilogue in registers: the bias table's column block of the phase,
//     chosen by border class, ReLU, bf16 rounding; the four lanes of a quad
//     exchange their channel pairs (shuffles) so each lane holds 8
//     consecutive channels, written with one 16-byte store.
//   - Sharded launches: tiles whose halo holds a neighbour's row (row -1 or
//     hh, passed apart) stage both halos by cp.async into the same swizzled
//     layout (each block of an L1 cluster its own copy). The per-pixel sum
//     runs in one order wherever a tile or shard starts, so stitched shards
//     equal the unsharded launch bit for bit.
// f32 (C = Cout in {32, 64}, Cp = 2C): dec1_split_kernel, the same function
// on the tensor cores with f32 accuracy from a bf16 hi/lo split, as
// psel_conv.cu's split kernel (K1, K4, K9 in f32) and conv_block.cu's K8: an
// f32 value a is hi = bf16(a) plus lo = bf16(a - hi), and each product is
// hi*hi + hi*lo + lo*hi in the f32 accumulator. This is the configured
// precision's decoder conv1 (configs/training.yaml: bf16 false): the f32
// serving forward and the CLIs' inference run it twice, the f32 sharded
// forward its sharded entry twice.
//   Bound. The split form's 3 * 2*17*C^2 operations a full-res pixel at the
//   bf16 rate (219 GFLOP at 512^2 b8, both levels: 221.5 us) against f32
//   skip and x_prev in, y out (L0: 671 MB, 200 us; L1: 336 MB, 100 us):
//   operations bound it at both levels.
//   Design.
//   - Weights. One output phase's live x_prev blocks as a hi/lo pair beside
//     W_skip's pair take 278,528 bytes at C = 64, more than a block holds.
//     So a block computes all four phases of NB = 1024 / C of the output
//     columns: its images (W_skip's 9 taps and the 16 live (phase, tap)
//     blocks, hi and lo, NB columns) take 167,936 bytes at both widths; at
//     C = 64 a cluster of four blocks shares each tile, block r computing
//     columns 16r .. 16r + 15 (wgmma N = 16; N = 32 at C = 32, one block a
//     tile). The consumers lay the images out at the block's start from the
//     raw f32 k_skip and the dense k_prev (only its live blocks are read),
//     each as it lies in memory (any strides of its leading dimensions), so
//     a call is one device operation: no per-call pack on the host or the
//     card.
//   - The f32 halo is staged in k-slices, as the split psel kernel's: a ring
//     stage is two unswizzled TMA boxes of 16 f32 channels (64 bytes a
//     pixel) of the tile's 6 x 18 halo: k-slice ks of the skip's two input
//     phases of one input row parity, or two k-slices of x_prev. 4 stages
//     fit beside the weights; in a cluster block 0 multicasts each box once
//     every block's producer has passed on its consumers' release.
//   - One consumer warpgroup (warp w takes s2d row w of the 4 x 16 tile)
//     and one producer warp, 160 threads: each A source (16 full-res
//     offsets a skip k-slice, 9 x_prev pixels a k-slice) is loaded from the
//     stage once, split into hi and lo fragments in registers, and fed to
//     every phase that reads it (36 of the skip's (phase, tap) pairs, 16 of
//     x_prev's live ones), three wgmmas a pair; the next group of sources is
//     formed while the last group's wgmmas run (two fragment buffers).
//   - Epilogue from registers: the bias table by border class as the bf16
//     kernel's, ReLU, f32 stores whose four lanes write a pixel's 8
//     channels, a whole 32-byte sector.
//   - Sharded launches: a tile whose halo holds a neighbour row is staged row
//     by row from one-row maps of the input and of the rows (TMA, as the
//     psel kernel's shards). The sum runs in one order (k-slices, offsets,
//     the three products) wherever a tile or shard starts, so stitched
//     shards equal the unsharded launch bit for bit. A stage goes back to
//     its producer only once the fragments formed from it are in a
//     committed wgmma group (the split psel kernel's race: an earlier
//     release let a box land before a load read the stage).
//   What holds it back (tools/dec1_variants.py builds the kernel without
//   its loads, or without its products, beside it; PERF.md has the times):
//   at C = 32 the products alone take nearly the whole kernel's time, a
//   wgmma of N = 32 from registers costing about twice its share of the
//   tensor-core rate, as the bf16 kernel's do; at C = 64 the loads alone
//   take most of it: each block of the cluster takes in the whole halo (by
//   multicast) for a quarter of the output, and a ring of 3 stages does as
//   well as one of 4. Tried beside this design and no faster over the two
//   levels: two consumer warpgroups (one output row parity each), 128-byte
//   boxes (fewer, larger stages), an L2 prefetch of the next tile, and block
//   0's multicasts shared out among the cluster's blocks.
#include "conv_tile.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace sm90 = mgu::sm90;

constexpr int TH = 4, TW = 16;  // s2d tile: one wgmma's 64 rows
constexpr int HALO_W = TW + 2, HALO_PIX = (TH + 2) * HALO_W;
constexpr int THREADS = 384;    // two consumer warpgroups, then the producer warpgroup
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;  // setmaxnreg: 128 * 56 + 256 * 224 <= 65536
constexpr int SM90_SHARED = 232448;                     // dynamic shared memory a block may use
constexpr int BOX_BYTES = HALO_PIX * 128;               // one TMA box: 64 channels of a halo
constexpr int PLANE_BYTES = (BOX_BYTES + 1023) / 1024 * 1024;  // the 128-byte swizzle repeats every 1024

// Shared memory of the bf16 kernel: the live weights, the skip ring, the
// x_prev ring, the mbarriers.
template <int C>
struct Plan {
  static constexpr int CP = 2 * C;
  static constexpr int KS = C / 16, KP = CP / 16;      // k-steps of a skip tap, of an x_prev tap
  static constexpr int CLUSTER = C <= 32 ? 1 : 4;      // blocks sharing a tile
  static constexpr int PHASES = 4 / CLUSTER;           // output phases a block computes
  static constexpr int WS_BYTES = 9 * C * C * 2;
  static constexpr int WP_BYTES = PHASES * 4 * CP * C * 2;
  static constexpr int SPL = 4 * C / 64, PPL = CP / 64;  // 64-channel planes of the skip, x_prev halos
  static constexpr int S_BYTES = SPL * PLANE_BYTES, P_BYTES = PPL * PLANE_BYTES;
  static constexpr int STAGES = C <= 32 ? 3 : 1;
  static constexpr int RING = WS_BYTES + WP_BYTES;
  static constexpr int BAR = RING + STAGES * (S_BYTES + P_BYTES);
  static constexpr int BYTES = BAR + (1 + 8 * STAGES) * 8;
  // Uses of a stage by one consumer warpgroup come every LCM-th tile (the
  // warpgroups take alternate tiles).
  static constexpr int LCM = STAGES % 2 ? 2 * STAGES : STAGES;
  static_assert(RING % 1024 == 0, "the halo rings must start 1024-byte aligned");
  static_assert(BYTES <= SM90_SHARED, "dec-conv1 plan exceeds shared memory");
};

struct Dec1Args {
  const bf16 *xs, *xp;  // skip (B, Hh, Ww, 4C), x_prev (B, Hh, Ww, Cp)
  const bf16 *ws, *wp;  // k_skip (9C, C); live k_prev (4 phases, 4 taps, Cp, C) as (16Cp, C): wgmma B layout
  const float* t9;      // (3, 3, 4C) bias class table
  bf16* y;              // (B, Hh, Ww, 4C)
  const bf16 *xs_top, *xs_bot, *xp_top, *xp_bot;  // (B, 1, Ww, ch) rows of a shard, null at a global border
  int b, hh, ww, row0, hh_glob, tiles_w, tiles_h, ntiles;
};

struct Tile {
  int bi, i0, j0;
};

__device__ __forceinline__ Tile decode(const Dec1Args& a, int t) {
  const int tx = t % a.tiles_w, rest = t / a.tiles_w;
  return Tile{rest / a.tiles_h, (rest % a.tiles_h) * TH, tx * TW};
}

// The barriers: the weights', then for each ring (skip, x_prev) full, one
// set for each consumer warpgroup (a tile's halo completes on the barrier of
// the warpgroup that takes the tile, so each waits its own phases in order),
// empty (released by that warpgroup) and cluster-empty (by that warpgroup in
// every block of the cluster, on block 0, which issues the multicast).
template <int C>
struct Bars {
  static constexpr int S = Plan<C>::STAGES;
  uint64_t* w;  // then, for ring r: full of warpgroup 0, of warpgroup 1, empty, cluster-empty (S each)
  __device__ explicit Bars(unsigned char* smem) : w(reinterpret_cast<uint64_t*>(smem + Plan<C>::BAR)) {}
  __device__ uint64_t* full(int r, int g, int s) const { return w + 1 + r * 4 * S + g * S + s; }
  __device__ uint64_t* empty(int r, int s) const { return w + 1 + r * 4 * S + 2 * S + s; }
  __device__ uint64_t* cempty(int r, int s) const { return w + 1 + r * 4 * S + 3 * S + s; }
};

// The producer warpgroup meets (named barrier 1; the consumers use none).
__device__ __forceinline__ void producer_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

// Whether tile tl's halo of one input holds a shard's neighbour row (row -1
// from `top`, row hh from `bot`), which TMA cannot fetch.
__device__ __forceinline__ bool neighbour_rows(const Dec1Args& a, const Tile& tl, const bf16* top, const bf16* bot) {
  return (tl.i0 == 0 && top) || (tl.i0 + TH >= a.hh && bot);
}

// Stage one input's halo of tile `tl` (`planes` 64-channel planes of `ch`
// channels a pixel) into `dst` by TMA boxes from `map` (out-of-bounds zeros
// are the SAME padding; block 0 of a cluster multicasts to all). One
// producer thread; `full` completes on the boxes' bytes.
template <int CLUSTER>
__device__ void fill_tma(unsigned char* dst, int planes, const CUtensorMap* map, const Tile& tl, uint64_t* full,
                         uint32_t rank) {
  sm90::mbar_arrive_expect_tx(full, planes * BOX_BYTES);
  if (rank != 0) return;
  for (int pl = 0; pl < planes; ++pl) {
    if constexpr (CLUSTER == 1)
      sm90::tma_load_4d(dst + pl * PLANE_BYTES, map, 64 * pl, tl.j0 - 1, tl.i0 - 1, tl.bi, full);
    else
      sm90::tma_load_4d_multicast(dst + pl * PLANE_BYTES, map, 64 * pl, tl.j0 - 1, tl.i0 - 1, tl.bi, full,
                                  uint16_t((1 << CLUSTER) - 1));
  }
}

// The same halo by cp.async of the same swizzled layout, every producer
// thread copying, where a neighbour row falls in it; the rows of the
// neighbours come from `top` and `bot`. Each thread's arrival is counted by
// the barrier itself (cp_async_arrive_inc); the producer warpgroup then
// meets, and its first thread arrives once, completing the phase when the
// copies have landed.
__device__ void fill_rows(unsigned char* dst, int planes, int ch, const bf16* x, const bf16* top, const bf16* bot,
                          const Dec1Args& a, const Tile& tl, uint64_t* full) {
  const int ptid = threadIdx.x - CONSUMERS;
  for (int i = ptid; i < planes * HALO_PIX * 8; i += 128) {
    const int ck = i & 7, pix = (i >> 3) % HALO_PIX, pl = (i >> 3) / HALO_PIX;
    const int gi = tl.i0 - 1 + pix / HALO_W, gj = tl.j0 - 1 + pix % HALO_W;
    const bf16* src = nullptr;
    if (gj >= 0 && gj < a.ww) {
      if (gi >= 0 && gi < a.hh)
        src = x + ((size_t(tl.bi) * a.hh + gi) * a.ww + gj) * ch;
      else if (gi == -1 && top)
        src = top + (size_t(tl.bi) * a.ww + gj) * ch;
      else if (gi == a.hh && bot)
        src = bot + (size_t(tl.bi) * a.ww + gj) * ch;
    }
    sm90::cp_async16(dst + pl * PLANE_BYTES + sm90::swz128(pix, ck), src ? src + 64 * pl + 8 * ck : x, src ? 16 : 0);
  }
  sm90::cp_async_arrive_inc(full);
  producer_sync();
  if (ptid == 0) sm90::mbar_arrive(full);
}

// Wait until stage s of ring r is free: released by this block's consumers
// and, on block 0 of a cluster, by every block's.
template <int C>
__device__ __forceinline__ void acquire(const Bars<C>& bars, int r, int s, uint32_t ph, uint32_t rank) {
  sm90::mbar_wait(bars.empty(r, s), ph ^ 1);
  if constexpr (Plan<C>::CLUSTER > 1)
    if (rank == 0) sm90::mbar_wait(bars.cempty(r, s), ph ^ 1);
}

// The producer warpgroup: the live weights once, then each tile's skip and
// x_prev halos into the next free stage of their rings, the full barrier of
// the consumer warpgroup that takes the tile. Its first thread tracks the
// stages and issues the TMA boxes; the whole warpgroup copies the halos
// that hold a neighbour's row, after meeting, so that every thread waits on
// a stage only when the first thread has waited on all the ones before.
template <int C>
__device__ void produce(const Dec1Args& a, const CUtensorMap* smap, const CUtensorMap* pmap, unsigned char* smem,
                        const Bars<C>& bars, uint32_t rank, int first, int step) {
  using P = Plan<C>;
  const bool lead = threadIdx.x == CONSUMERS;
  if (lead) {
    sm90::mbar_arrive_expect_tx(bars.w, P::WS_BYTES + P::WP_BYTES);
    sm90::bulk_copy(smem, a.ws, P::WS_BYTES, bars.w);
    sm90::bulk_copy(smem + P::WS_BYTES, a.wp + size_t(rank) * (P::WP_BYTES / 2), P::WP_BYTES, bars.w);
  }
  unsigned char* sring = smem + P::RING;
  unsigned char* pring = sring + P::STAGES * P::S_BYTES;
  int s = 0, k = 0;  // the block's k-th tile, for consumer warpgroup k % 2
  uint32_t ph = 0;
  for (int t = first; t < a.ntiles; t += step, ++k) {
    const Tile tl = decode(a, t);
    for (int r = 0; r < 2; ++r) {
      unsigned char* dst = r == 0 ? sring + s * P::S_BYTES : pring + s * P::P_BYTES;
      const bf16 *x = r == 0 ? a.xs : a.xp, *top = r == 0 ? a.xs_top : a.xp_top, *bot = r == 0 ? a.xs_bot : a.xp_bot;
      const int planes = r == 0 ? P::SPL : P::PPL;
      uint64_t* full = bars.full(r, k & 1, s);
      if (neighbour_rows(a, tl, top, bot)) {
        producer_sync();
        acquire<C>(bars, r, s, ph, rank);
        fill_rows(dst, planes, 64 * planes, x, top, bot, a, tl, full);
      } else if (lead) {
        acquire<C>(bars, r, s, ph, rank);
        fill_tma<P::CLUSTER>(dst, planes, r == 0 ? smap : pmap, tl, full, rank);
      }
    }
    if (++s == P::STAGES) {
      s = 0;
      ph ^= 1;
    }
  }
  if (!lead) return;
  for (int i = 0; i < P::STAGES; ++i) {  // leave only when every stage is released
    acquire<C>(bars, 0, s, ph, rank);
    acquire<C>(bars, 1, s, ph, rank);
    if (++s == P::STAGES) {
      s = 0;
      ph ^= 1;
    }
  }
}

// Give stage s of ring r back: to this block's producer and, in a cluster,
// to block 0's (after the warpgroup's last wgmma has read the stage). The
// warpgroup's first thread arrives, by predicated instructions: the release
// of the skip ring falls between two wgmma groups.
template <int C>
__device__ __forceinline__ void release(const Bars<C>& bars, int r, int s, bool leader) {
  sm90::mbar_arrive_if(bars.empty(r, s), leader);
  if constexpr (Plan<C>::CLUSTER > 1) sm90::mbar_arrive_cluster(bars.cempty(r, s), 0, leader);
}

// Lane t4 of a quad holds channel pairs (2t4, 2t4 + 1) of the four 8-channel
// groups j as m[j]; it returns group t4 whole, pair q in word q: a 4 x 4
// transpose across the quad, by exchanges with lane t4 ^ 1, then t4 ^ 2.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&m)[4], int t4) {
  const bool b0 = t4 & 1, b1 = t4 & 2;
  uint32_t a[4];
#pragma unroll
  for (int c = 0; c < 4; c += 2) {  // swap the words whose index differs from t4 in bit 0
    const uint32_t r = __shfl_xor_sync(0xffffffffu, b0 ? m[c] : m[c + 1], 1);
    a[c] = b0 ? r : m[c];
    a[c + 1] = b0 ? m[c + 1] : r;
  }
  uint32_t o[4];
#pragma unroll
  for (int c = 0; c < 2; ++c) {  // then in bit 1
    const uint32_t r = __shfl_xor_sync(0xffffffffu, b1 ? a[c] : a[c + 2], 2);
    o[c] = b1 ? r : a[c];
    o[c + 2] = b1 ? a[c + 2] : r;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// A lane's ldmatrix of the A fragment of one k-step: 16 consecutive halo
// pixels from `pix` (lanes 0-15, channels ch .. ch + 7; lanes 16-31 the next
// 8) in a halo of 64-channel planes with the 128-byte swizzle.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const unsigned char* halo, int pix, int ch) {
  sm90::ldmatrix_x4(r, reinterpret_cast<const bf16*>(halo + (ch >> 6) * PLANE_BYTES + sm90::swz128(pix, (ch & 63) >> 3)));
}

// The products of one tile for a consumer warpgroup (lane rows: s2d row w,
// pixel lrow; k offset lk), into acc[phase of the block]. Each phase sums
// its skip taps in raster order, then its live x_prev taps in raster order,
// k-steps inside each: one order wherever the tile starts. The wgmmas go in
// a few large groups (a row of taps each), each behind one wgmma.fence and
// closed by one commit and wait, rather than one group a tap.
//   L0 (all four phases): A is loaded once for each distinct source and fed
//   to every phase that reads it: the 16 full-res offsets (fy, fx) in
//   {-1..2}^2 of the skip term (36 phase-tap pairs), in 4 groups by fy; the
//   9 x_prev pixels (16 pairs), in 3 groups by row.
//   L1 (phase p of the cluster's block): its 9 skip taps in 3 groups by ky,
//   its 4 live taps in 2 groups by row.
template <int C>
__device__ __forceinline__ void products(float (&acc)[Plan<C>::PHASES][C / 2], const unsigned char* hs,
                                         const unsigned char* hp, const bf16* wsk, const bf16* wpr,
                                         const Bars<C>& bars, int s, int wg, uint32_t par, bool leader, int p,
                                         int w, int lrow, int lk) {
  using P = Plan<C>;
  constexpr int KS = P::KS, KP = P::KP;
  const auto wsk_desc = [&](int tap, int ks) { return sm90::desc_b(wsk + (tap * KS + ks) * 16 * C); };
  const auto wpr_desc = [&](int blk, int u, int ks) { return sm90::desc_b(wpr + ((blk * 4 + u) * KP + ks) * 16 * C); };
  if constexpr (P::PHASES == 4) {
#pragma unroll
    for (int fy = -1; fy <= 2; ++fy) {
      // Full-res offset (fy, fx) of s2d pixel (I, J): halo pixel
      // (I + (fy+2)/2, J + (fx+2)/2), input phase (fy%2, fx%2); phase
      // (py, px) reads it as tap (fy - py + 1, fx - px + 1).
      uint32_t af[4][KS][4];
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          load_a(af[f][ks], hs, (w + ((fy + 2) >> 1)) * HALO_W + lrow + ((f + 1) >> 1),
                 ((fy & 1) * 2 + ((f + 1) & 1)) * C + 16 * ks + lk);
      sm90::wgmma_fence();
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int ph = 0; ph < 4; ++ph) {
          const int ky = fy - (ph >> 1) + 1, kx = f - (ph & 1);
          if (ky < 0 || ky > 2 || kx < 0 || kx > 2) continue;  // decided at compile time
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) sm90::Wgmma<C>::run(acc[ph], af[f][ks], wsk_desc(ky * 3 + kx, ks));
        }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();  // the group has read its A registers
    }
  } else {
    const int py = p >> 1, px = p & 1;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      uint32_t af[3][KS][4];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          load_a(af[kx][ks], hs, (w + ((py + ky + 1) >> 1)) * HALO_W + lrow + ((px + kx + 1) >> 1),
                 (((py + ky + 1) & 1) * 2 + ((px + kx + 1) & 1)) * C + 16 * ks + lk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) sm90::Wgmma<C>::run(acc[0], af[kx][ks], wsk_desc(ky * 3 + kx, ks));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
    }
  }
  release<C>(bars, 0, s, leader);

  sm90::mbar_wait(bars.full(1, wg, s), par);
  if constexpr (P::PHASES == 4) {
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      // x_prev halo pixel (I + di, J + dj): live tap (di - py, dj - px)
      // of phase (py, px) where both are 0 or 1.
      uint32_t af[3][KP][4];
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
#pragma unroll
        for (int ks = 0; ks < KP; ++ks) load_a(af[dj][ks], hp, (w + di) * HALO_W + lrow + dj, 16 * ks + lk);
      sm90::wgmma_fence();
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
#pragma unroll
        for (int ph = 0; ph < 4; ++ph) {
          const int ua = di - (ph >> 1), ub = dj - (ph & 1);
          if (ua < 0 || ua > 1 || ub < 0 || ub > 1) continue;  // decided at compile time
#pragma unroll
          for (int ks = 0; ks < KP; ++ks) sm90::Wgmma<C>::run(acc[ph], af[dj][ks], wpr_desc(ph, 2 * ua + ub, ks));
        }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
    }
  } else {
    const int py = p >> 1, px = p & 1;
#pragma unroll
    for (int ua = 0; ua < 2; ++ua) {
      uint32_t af[2][KP][4];
#pragma unroll
      for (int ub = 0; ub < 2; ++ub)
#pragma unroll
        for (int ks = 0; ks < KP; ++ks)
          load_a(af[ub][ks], hp, (w + py + ua) * HALO_W + lrow + px + ub, 16 * ks + lk);
      sm90::wgmma_fence();
#pragma unroll
      for (int ub = 0; ub < 2; ++ub)
#pragma unroll
        for (int ks = 0; ks < KP; ++ks) sm90::Wgmma<C>::run(acc[0], af[ub][ks], wpr_desc(0, 2 * ua + ub, ks));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
    }
  }
#pragma unroll
  for (int i = 0; i < P::PHASES; ++i) sm90::fence_operand(acc[i]);
  release<C>(bars, 1, s, leader);
}

// A consumer warpgroup: every other tile of the block (ping-pong, so one
// warpgroup's epilogue overlaps the other's products), all of the block's
// output phases and channels (wgmma.m64nCk16).
template <int C>
__device__ void consume(const Dec1Args& a, const unsigned char* smem, const Bars<C>& bars, uint32_t rank, int first,
                        int step) {
  using P = Plan<C>;
  constexpr int PH = P::PHASES, NR = C / 2;
  const bf16* wsk = reinterpret_cast<const bf16*>(smem);
  const bf16* wpr = reinterpret_cast<const bf16*>(smem + P::WS_BYTES);
  const unsigned char* sring = smem + P::RING;
  const unsigned char* pring = sring + P::STAGES * P::S_BYTES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, w = warp & 3;
  const int lrow = lane & 15, lk = (lane >> 4) * 8, g = lane >> 2, t4 = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  const int z = 4 * C;
  sm90::mbar_wait(bars.w, 0);  // the weights are resident for the block's life
  int k = wg;                  // the block's k-th tile uses stage k % STAGES of both rings
  for (int t = first + wg * step; t < a.ntiles; t += 2 * step, k += 2) {
    const Tile tl = decode(a, t);
    const int s = k % P::STAGES;
    const uint32_t par = (k / P::LCM) & 1;
    float acc[PH][NR];
#pragma unroll
    for (int i = 0; i < PH; ++i) {
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[i][r] = 0.f;
      sm90::fence_operand(acc[i]);
    }
    sm90::mbar_wait(bars.full(0, wg, s), par);
    products<C>(acc, sring + s * P::S_BYTES, pring + s * P::P_BYTES, wsk, wpr, bars, s, wg, par, leader, int(rank),
                w, lrow, lk);

    // Epilogue: lane (g, t4) holds pixels J = g and g + 8 of s2d row w,
    // channels 8j + 2t4 and 8j + 2t4 + 1 of each 8-channel group j. The
    // table's class weights (first, 1 - first - last, last) of the pixel's
    // global row and column give the value with both border taps invalid on
    // a grid one pixel high or wide; on any other grid they are one-hot and
    // the value is the table's entry of the pixel's class. Interior warps
    // (uniform: the warp's row and every column of the tile), border warps
    // and warps of a grid one pixel high or wide run three separate straight
    // copies of the body: interleaved per value, the paths' code made the
    // kernel a third slower on an H100 (every value jumps over the others).
    const int gi = tl.i0 + w;
    const int row = a.row0 + gi;
    const float fr = row == 0 ? 1.f : 0.f, lr = row == a.hh_glob - 1 ? 1.f : 0.f;
    const float wr[3] = {fr, 1.f - fr - lr, lr};
    const int rc = row == 0 ? 0 : row == a.hh_glob - 1 ? 2 : 1;
    const auto body = [&](auto bias_of) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gj = tl.j0 + g + 8 * h;
        const float fc = gj == 0 ? 1.f : 0.f, lc = gj == a.ww - 1 ? 1.f : 0.f;
        const float wc[3] = {fc, 1.f - fc - lc, lc};
        const int cls = rc * 3 + (gj == 0 ? 0 : gj == a.ww - 1 ? 2 : 1);
#pragma unroll
        for (int i = 0; i < PH; ++i) {
          const int ph = PH == 4 ? i : int(rank);
#pragma unroll
          for (int jc = 0; jc < C / 32; ++jc) {  // 32 channels: four 8-channel groups
            uint32_t m[4];
#pragma unroll
            for (int j4 = 0; j4 < 4; ++j4) {
              const int j = 4 * jc + j4;
              const float v0 = fmaxf(acc[i][4 * j + 2 * h] + bias_of(ph, 2 * j, cls, wc), 0.f);
              const float v1 = fmaxf(acc[i][4 * j + 2 * h + 1] + bias_of(ph, 2 * j + 1, cls, wc), 0.f);
              const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
              m[j4] = *reinterpret_cast<const uint32_t*>(&pair);
            }
            const uint4 out = quad_transpose(m, t4);
            if (gi < a.hh && gj < a.ww)
              *reinterpret_cast<uint4*>(a.y + ((size_t(tl.bi) * a.hh + gi) * a.ww + gj) * z + ph * C + 32 * jc +
                                        8 * t4) = out;
          }
        }
      }
    };
    // Channel 8 * (c / 2) + 2 * t4 + c % 2 of phase ph: c = 2j + e.
    const auto entry = [&](int ph, int c, int k) {
      return __ldg(a.t9 + k * z + ph * C + 8 * (c >> 1) + 2 * t4 + (c & 1));
    };
    if (fr + lr == 0.f && tl.j0 > 0 && tl.j0 + TW < a.ww)
      body([&](int ph, int c, int, const float(&)[3]) { return entry(ph, c, 4); });  // class (1, 1)
    else if (a.hh_glob > 1 && a.ww > 1)
      body([&](int ph, int c, int cls, const float(&)[3]) { return entry(ph, c, cls); });
    else
      body([&](int ph, int c, int, const float(&wc)[3]) {
        float bias = 0.f;
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int q = 0; q < 3; ++q) bias += wr[r] * wc[q] * entry(ph, c, r * 3 + q);
        return bias;
      });
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
    dec1_wgmma_kernel(Dec1Args a, const __grid_constant__ CUtensorMap smap, const __grid_constant__ CUtensorMap pmap) {
  using P = Plan<C>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const Bars<C> bars(smem);
  uint32_t rank = 0;
  int first = blockIdx.x, step = gridDim.x;
  if constexpr (P::CLUSTER > 1) {
    rank = sm90::cluster_rank();
    first = sm90::cluster_id();
    step = sm90::cluster_count();
  }
  if (threadIdx.x == 0) {
    sm90::mbar_init(bars.w, 1);
    for (int r = 0; r < 2; ++r)
      for (int i = 0; i < P::STAGES; ++i) {
        for (int g = 0; g < 2; ++g)
          sm90::mbar_init(bars.full(r, g, i), 1);  // the producer's first thread (and the bytes or copies)
        sm90::mbar_init(bars.empty(r, i), 1);   // the consumer warpgroup of the stage's tile
        sm90::mbar_init(bars.cempty(r, i), P::CLUSTER);
      }
    sm90::fence_mbar_init();
  }
  if constexpr (P::CLUSTER > 1)
    sm90::cluster_sync();  // no multicast or remote arrival before every block's barriers exist
  else
    __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    produce<C>(a, &smap, &pmap, smem, bars, rank, first, step);
  } else {
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    consume<C>(a, smem, bars, rank, first, step);
  }
  if constexpr (P::CLUSTER > 1) sm90::cluster_sync();  // no block leaves while another may still signal it
}

// Persistent grid: one block a SM (the plan takes its shared memory), at
// most one tile a block, or a cluster; 0 where the card cannot say how many
// clusters it holds.
template <int C>
int grid_blocks(int ntiles) {
  using P = Plan<C>;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int units = sms;
  if constexpr (P::CLUSTER > 1) units = sm90::max_active_clusters(dec1_wgmma_kernel<C>, THREADS, P::BYTES, P::CLUSTER);
  return (ntiles < units ? ntiles : units) * P::CLUSTER;
}

template <int C>
int launch_wgmma(Dec1Args a, cudaStream_t stream) {
  using P = Plan<C>;
  a.tiles_w = (a.ww + TW - 1) / TW;
  a.tiles_h = (a.hh + TH - 1) / TH;
  a.ntiles = a.b * a.tiles_w * a.tiles_h;
  if (a.ntiles == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(dec1_wgmma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return int(err);
  // Both inputs as (channels, Ww, Hh, B) in boxes of 64 channels x 18 x 6 x 1.
  CUtensorMap smap, pmap;
  const cuuint32_t box[4] = {64, HALO_W, TH + 2, 1};
  if (!sm90::nhwc_map(&smap, a.xs, a.b, a.hh, a.ww, 4 * C, box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !sm90::nhwc_map(&pmap, a.xp, a.b, a.hh, a.ww, P::CP, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return int(cudaErrorInvalidValue);
  const int grid = grid_blocks<C>(a.ntiles);
  if (grid == 0) return int(cudaErrorInvalidConfiguration);
  if constexpr (P::CLUSTER == 1) {
    dec1_wgmma_kernel<C><<<grid, THREADS, P::BYTES, stream>>>(a, smap, pmap);
    return int(cudaGetLastError());
  } else {
    return sm90::launch_cluster(dec1_wgmma_kernel<C>, grid, THREADS, P::BYTES, P::CLUSTER, stream, a, smap, pmap);
  }
}

// ---------------------------------------------------------------------------
// f32 at C = Cout in {32, 64}, Cp = 2C: the split kernel (dec1_split_kernel)
// ---------------------------------------------------------------------------

constexpr int SPLIT_THREADS = 160;  // one consumer warpgroup, then one producer warp
constexpr int SPLIT_CONSUMERS = 128;
constexpr int SPLIT_MAX_STAGES = 8;

// Shared memory of the split kernel. A block computes all four output
// phases of NB = 1024 / C output columns of every tile it takes, and a
// cluster of C / NB blocks (1 at C = 32, 4 at C = 64) shares each tile,
// block r computing columns r*NB .. r*NB + NB - 1 of every phase. Its
// weights: the hi and lo images of W_skip's columns (9 taps x C rows) and of
// the 16 live (phase, tap) blocks' columns (Cp rows each), 167,936 bytes at
// both widths. Then a ring of stages, each 2 unswizzled boxes of 16 f32
// channels of the tile's 6 x 18 halo (64 bytes a pixel): a skip stage is
// k-slice ks of the two input phases of one input row parity, an x_prev
// stage two k-slices of x_prev. The mbarriers at the top.
template <int C>
struct SplitPlan {
  static constexpr int CP = 2 * C;
  static constexpr int NB = 1024 / C;                // output columns of a block, of each phase
  static constexpr int CLUSTER = C / NB;             // blocks sharing a tile
  static constexpr int KS = C / 16, KP = CP / 16;    // k-slices of the skip, of x_prev
  static constexpr int WS_IMG = 9 * C * NB * 2;      // one W_skip image (hi or lo), bf16
  static constexpr int WP_IMG = 16 * CP * NB * 2;    // one live image: (phase, tap) blocks of Cp rows
  static constexpr int WS_LO = WS_IMG, WP_HI = 2 * WS_IMG, WP_LO = WP_HI + WP_IMG;
  static constexpr int W_BYTES = 2 * (WS_IMG + WP_IMG);
  static constexpr int ROW_BYTES = HALO_W * 64, BOX_BYTES = HALO_PIX * 64, STAGE_BYTES = 2 * BOX_BYTES;
  static constexpr int SKIP_STAGES = 2 * KS, PREV_STAGES = KP / 2;  // a tile's
  static constexpr int BAR_BYTES = 3 * SPLIT_MAX_STAGES * 8;        // full, empty, cluster-empty
  static constexpr int STAGES_FIT = (SM90_SHARED - W_BYTES - BAR_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT < SPLIT_MAX_STAGES ? STAGES_FIT : SPLIT_MAX_STAGES;
  static constexpr int BAR = W_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR + BAR_BYTES;
  static_assert(C * NB == 1024 && W_BYTES % 128 == 0 && ROW_BYTES % 128 == 0 && BOX_BYTES % 128 == 0,
                "split boxes and rows must land 128-byte aligned");
  static_assert(STAGES >= 2 && BYTES <= SM90_SHARED, "split dec-conv1 plan exceeds shared memory");
};

struct SplitArgs {
  const float *xs, *xp;  // skip (B, Hh, Ww, 4C), x_prev (B, Hh, Ww, Cp)
  const float *ws, *wp;  // raw k_skip (3, 3, C, C), dense k_prev (3, 3, Cp, 4C): f32, as they lie
  const float* t9;       // (3, 3, 4C) bias class table
  float* y;              // (B, Hh, Ww, 4C)
  const float *xs_top, *xs_bot, *xp_top, *xp_bot;  // (B, 1, Ww, ch) rows of a shard, null at a global border
  int ws_s[3], wp_s[3], t9_s[2];  // element strides of the leading dimensions (the last one's is 1)
  int b, hh, ww, row0, hh_glob, tiles_w, tiles_h, ntiles;
};

// One input's tensor maps: 6-row boxes of x; where a shard has a neighbour
// row, one-row boxes of x, of `top` and of `bot` (unset otherwise).
struct SplitMaps {
  CUtensorMap x, row, top, bot;
};

__device__ __forceinline__ Tile decode(const SplitArgs& a, int t) {
  const int tx = t % a.tiles_w, rest = t / a.tiles_w;
  return Tile{rest / a.tiles_h, (rest % a.tiles_h) * TH, tx * TW};
}

// Two f32 values as their bf16x2 hi and lo words (the first value in the
// low halves): hi = bf16(a), lo = bf16(a - hi).
__device__ __forceinline__ void split2(float a0, float a1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a0, a1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a0 - __low2float(h), a1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Byte offset of chunk (k8, n) in wgmma's K-major B image of N columns: B's
// rows 8*k8 .. 8*k8 + 7 of column n, 16 bytes (hopper.cuh).
template <int N>
__device__ __forceinline__ int chunk_at(int k8, int n) {
  return (k8 >> 1) * 32 * N + ((n >> 3) * 2 + (k8 & 1)) * 128 + (n & 7) * 16;
}

// The consumers lay out the block's hi and lo images from the raw f32
// weights in global memory, each thread a share of the chunks. W_skip's
// slab (tap, ks) is B's rows tap*C + 16ks .. + 15, the live image's slab
// ((phase*4 + u)*KP + ks) the rows of live tap u = 2a + b of phase
// (py, px): k_prev[py + a][px + b][16ks ..][phase*C + col0 + n]. Each slab
// holds its 16 channels in the order the A fragments take them
// (psel_conv.cu::lay_tap_split, ops/kernels/psconv.py::SPLIT_SLAB_ROWS):
// row 8h + e is channel 16ks + 4(e / 2) + 2h + e % 2.
// ops/kernels/psconv.py::dec_conv1_image_index is the same map.
template <int C>
__device__ void lay_split_weights(const SplitArgs& a, unsigned char* smem, int col0) {
  using P = SplitPlan<C>;
  constexpr int NB = P::NB;
  constexpr int WS_CHUNKS = 9 * C / 8 * NB, ALL = WS_CHUNKS + 16 * P::CP / 8 * NB;
#pragma unroll 4
  for (int q = threadIdx.x; q < ALL; q += SPLIT_CONSUMERS) {
    const bool skip = q < WS_CHUNKS;
    const int r = skip ? q : q - WS_CHUNKS;
    const int k8 = r / NB, n = r % NB, sl = k8 >> 1, h = k8 & 1;
    const float* src;
    int cs;
    if (skip) {
      const int tap = sl / P::KS, ks = sl % P::KS;
      src = a.ws + (tap / 3) * a.ws_s[0] + (tap % 3) * a.ws_s[1] + (16 * ks + 2 * h) * a.ws_s[2] + col0 + n;
      cs = a.ws_s[2];
    } else {
      const int pu = sl / P::KP, ks = sl % P::KP, ph = pu >> 2, u = pu & 3;
      src = a.wp + ((ph >> 1) + (u >> 1)) * a.wp_s[0] + ((ph & 1) + (u & 1)) * a.wp_s[1] +
            (16 * ks + 2 * h) * a.wp_s[2] + ph * C + col0 + n;
      cs = a.wp_s[2];
    }
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __ldg(src + (4 * (e >> 1) + (e & 1)) * cs);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split2(v[2 * e], v[2 * e + 1], hi[e], lo[e]);
    const int at = chunk_at<NB>(k8, n);
    *reinterpret_cast<uint4*>(smem + (skip ? 0 : P::WP_HI) + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(smem + (skip ? P::WS_LO : P::WP_LO) + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// The producer (one thread): each tile's stages into the ring, the skip's
// (k-slice ks, input row parity ip) in order 2ks + ip, then x_prev's. A
// stage is two boxes; out-of-bounds zeros are the SAME padding. A tile whose
// halo holds a shard's neighbour row (row -1 from `top`, row hh from `bot`)
// is staged row by row from the one-row maps, each row landing at its
// offset; its rows past hh feed only outputs that are not stored and are
// not loaded. In a cluster every block's producer waits for its own
// consumers to release the stage, then arrives on block 0's cluster-empty
// barrier, and block 0 issues each box once, multicast to the cluster.
template <int C>
__device__ void produce_split(const SplitArgs& a, const SplitMaps& ms, const SplitMaps& mp, unsigned char* ring,
                              uint64_t* full, uint64_t* empty, uint64_t* cempty, uint32_t rank, int first,
                              int step) {
  using P = SplitPlan<C>;
  int s = 0;
  uint32_t ph = 0;
  const auto next = [&]() {
    if (++s == P::STAGES) {
      s = 0;
      ph ^= 1;
    }
  };
  for (int t = first; t < a.ntiles; t += step) {
    const Tile tl = decode(a, t);
#pragma unroll
    for (int in = 0; in < 2; ++in) {
      const SplitMaps& m = in == 0 ? ms : mp;
      const float *top = in == 0 ? a.xs_top : a.xp_top, *bot = in == 0 ? a.xs_bot : a.xp_bot;
      const bool rows = (tl.i0 == 0 && top) || (tl.i0 + TH >= a.hh && bot);
      const int nr = rows ? min(TH + 2, a.hh - tl.i0 + 2) : TH + 2;  // staged row r is row i0 - 1 + r
      const int nst = in == 0 ? P::SKIP_STAGES : P::PREV_STAGES;
      for (int i = 0; i < nst; ++i) {
        sm90::mbar_wait(&empty[s], ph ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * nr * P::ROW_BYTES);
        if constexpr (P::CLUSTER > 1) {
          sm90::mbar_arrive_cluster(&cempty[s], 0, true);
          if (rank == 0) sm90::mbar_wait(&cempty[s], ph);
        }
        if (rank == 0) {
          unsigned char* dst = ring + s * P::STAGE_BYTES;
          for (int q = 0; q < 2; ++q) {
            const int c0 = in == 0 ? (2 * (i & 1) + q) * C + 16 * (i >> 1) : 16 * (2 * i + q);
            for (int r = 0; r < (rows ? nr : 1); ++r) {
              const int gi = tl.i0 - 1 + r;
              const bool up = rows && gi == -1 && top, down = rows && gi == a.hh && bot;
              const CUtensorMap* map = !rows ? &m.x : up ? &m.top : down ? &m.bot : &m.row;
              unsigned char* at = dst + q * P::BOX_BYTES + r * P::ROW_BYTES;
              const int row = up || down ? 0 : gi;
              if constexpr (P::CLUSTER == 1)
                sm90::tma_load_4d(at, map, c0, tl.j0 - 1, row, tl.bi, &full[s]);
              else
                sm90::tma_load_4d_multicast(at, map, c0, tl.j0 - 1, row, tl.bi, &full[s],
                                            uint16_t((1 << P::CLUSTER) - 1));
            }
          }
        }
        next();
      }
    }
  }
  for (int i = 0; i < P::STAGES; ++i) {  // leave only when every stage is released
    sm90::mbar_wait(&empty[s], ph ^ 1);
    next();
  }
}

// A's hi and lo fragments of one k-step for the lane (g, t4) of warp w:
// rows g and g + 8 are halo pixels `pix` and pix + 8 of a 16-channel box,
// the lane's channels 4t4 .. 4t4 + 3 (16-byte loads; at 64 bytes a pixel
// the 8 lanes of a load phase fall in 8 bank groups) as fragment columns
// 2t4, 2t4 + 1, 2t4 + 8, 2t4 + 9.
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const unsigned char* box, int pix,
                                        int t4) {
  const float4 r0 = *reinterpret_cast<const float4*>(box + pix * 64 + t4 * 16);
  const float4 r1 = *reinterpret_cast<const float4*>(box + (pix + 8) * 64 + t4 * 16);
  split2(r0.x, r0.y, hi[0], lo[0]);
  split2(r1.x, r1.y, hi[1], lo[1]);
  split2(r0.z, r0.w, hi[2], lo[2]);
  split2(r1.z, r1.w, hi[3], lo[3]);
}

// The consumer warpgroup: every tile of the block (or cluster), all four
// output phases of the block's NB columns; warp w takes s2d row w of the
// tile, so each wgmma.m64nNBk16 covers the tile's 64 pixels in one output
// phase. Per k-slice the skip term takes the 16 full-res offsets (fy, fx)
// in {-1..2}^2 in two stages (input row parity fy % 2: fy = 0, 2, then -1,
// 1), each group of four offsets one row fy, and feeds each offset's A to
// every phase that reads it as a tap; then x_prev's stages, each two
// k-slices of the 9 x_prev pixels (one group a row), each fed to the phases
// for which it is a live tap. Every product is hi*hi + hi*lo + lo*hi (the
// dropped lo*lo is below 2^-16 of it). The fragments of the next group are
// formed while the last group's wgmmas run (two register buffers; a group
// count per k-slice and per x_prev stage that is even keeps the buffers'
// order fixed across the loops). One order wherever a tile or shard starts:
// k-slices, then offsets, then the three products. A stage goes back to
// the producer when this thread's last fragments from it are in a
// committed wgmma group: their loads have landed by then.
template <int C>
__device__ void consume_split(const SplitArgs& a, const unsigned char* smem, uint64_t* full, uint64_t* empty,
                              int col0, int first, int step) {
  using P = SplitPlan<C>;
  constexpr int NB = P::NB, NR = NB / 2;
  const unsigned char* ring = smem + P::W_BYTES;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int z = 4 * C;
  const auto desc = [&](int img, int slab) { return sm90::desc_b(smem + img + slab * 32 * NB); };
  const auto run3 = [](float(&d)[NR], const uint32_t(&ah)[4], const uint32_t(&al)[4], uint64_t dh, uint64_t dl) {
    sm90::Wgmma<NB>::run(d, ah, dh);
    sm90::Wgmma<NB>::run(d, ah, dl);
    sm90::Wgmma<NB>::run(d, al, dh);
  };
  int s = 0;
  uint32_t ph = 0;
  const auto next = [&]() {
    if (++s == P::STAGES) {
      s = 0;
      ph ^= 1;
    }
  };
  for (int t = first; t < a.ntiles; t += step) {
    const Tile tl = decode(a, t);
    float acc[4][NR];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[i][r] = 0.f;
      sm90::fence_operand(acc[i]);
    }
    uint32_t ah[2][4][4], al[2][4][4];
#pragma unroll 1
    for (int ks = 0; ks < P::KS; ++ks) {
#pragma unroll
      for (int ip = 0; ip < 2; ++ip) {
        sm90::mbar_wait(&full[s], ph);
        const unsigned char* st = ring + s * P::STAGE_BYTES;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // Full-res offset (fy, fx) of s2d pixel (I, J): halo pixel
          // (I + (fy+2)/2, J + (fx+2)/2), input phase (fy%2, fx%2), box
          // fx%2 of the stage; phase (py, px) reads it as tap
          // (fy - py + 1, fx - px + 1).
          const int fy = ip == 0 ? 2 * half : 2 * half - 1;
#pragma unroll
          for (int f = 0; f < 4; ++f)
            split_a(ah[half][f], al[half][f], st + ((f + 1) & 1) * P::BOX_BYTES,
                    (w + ((fy + 2) >> 1)) * HALO_W + g + ((f + 1) >> 1), t4);
          sm90::wgmma_fence();
#pragma unroll
          for (int f = 0; f < 4; ++f)
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const int ky = fy - (p >> 1) + 1, kx = f - (p & 1);
              if (ky < 0 || ky > 2 || kx < 0 || kx > 2) continue;  // decided at compile time
              const int slab = (ky * 3 + kx) * P::KS + ks;
              run3(acc[p], ah[half][f], al[half][f], desc(0, slab), desc(P::WS_LO, slab));
            }
          sm90::wgmma_commit();
          if (half == 1) sm90::mbar_arrive(&empty[s]);
          sm90::wgmma_wait<1>();  // the group before has read the other buffer
        }
        next();
      }
    }
#pragma unroll 1
    for (int j = 0; j < P::PREV_STAGES; ++j) {
      sm90::mbar_wait(&full[s], ph);
      const unsigned char* st = ring + s * P::STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          // x_prev halo pixel (I + di, J + dj): live tap (di - py, dj - px)
          // of phase (py, px) where both are 0 or 1.
          const int buf = (3 * kk + di) & 1;
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
            split_a(ah[buf][dj], al[buf][dj], st + kk * P::BOX_BYTES, (w + di) * HALO_W + g + dj, t4);
          sm90::wgmma_fence();
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const int ua = di - (p >> 1), ub = dj - (p & 1);
              if (ua < 0 || ua > 1 || ub < 0 || ub > 1) continue;  // decided at compile time
              const int slab = (p * 4 + 2 * ua + ub) * P::KP + 2 * j + kk;
              run3(acc[p], ah[buf][dj], al[buf][dj], desc(P::WP_HI, slab), desc(P::WP_LO, slab));
            }
          sm90::wgmma_commit();
          if (kk == 1 && di == 2) sm90::mbar_arrive(&empty[s]);
          sm90::wgmma_wait<1>();
        }
      next();
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 4; ++i) sm90::fence_operand(acc[i]);

    // Epilogue: lane (g, t4) holds pixels J = g and g + 8 of s2d row w,
    // columns 8j + 2t4 and 8j + 2t4 + 1 of the block's NB in each phase:
    // the 4 lanes of a pixel write 8 channels, a whole 32-byte sector. The
    // bias as the bf16 kernel's epilogue takes it (three straight copies of
    // the body: an interior warp, one-hot border classes, the weights of a
    // grid one pixel high or wide).
    const int gi = tl.i0 + w;
    const int row = a.row0 + gi;
    const float fr = row == 0 ? 1.f : 0.f, lr = row == a.hh_glob - 1 ? 1.f : 0.f;
    const float wr[3] = {fr, 1.f - fr - lr, lr};
    const int rc = row == 0 ? 0 : row == a.hh_glob - 1 ? 2 : 1;
    const auto body = [&](auto bias_of) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gj = tl.j0 + g + 8 * h;
        if (gi >= a.hh || gj >= a.ww) continue;
        const float fc = gj == 0 ? 1.f : 0.f, lc = gj == a.ww - 1 ? 1.f : 0.f;
        const float wc[3] = {fc, 1.f - fc - lc, lc};
        const int cls = rc * 3 + (gj == 0 ? 0 : gj == a.ww - 1 ? 2 : 1);
        float* out = a.y + ((size_t(tl.bi) * a.hh + gi) * a.ww + gj) * z + col0 + 2 * t4;
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int j = 0; j < NB / 8; ++j) {
            const float v0 = fmaxf(acc[p][4 * j + 2 * h] + bias_of(p, 8 * j, cls, wc), 0.f);
            const float v1 = fmaxf(acc[p][4 * j + 2 * h + 1] + bias_of(p, 8 * j + 1, cls, wc), 0.f);
            *reinterpret_cast<float2*>(out + p * C + 8 * j) = make_float2(v0, v1);
          }
      }
    };
    // Entry (class k) of column col0 + c + 2t4 of phase p.
    const auto entry = [&](int p, int c, int k) {
      return __ldg(a.t9 + (k / 3) * a.t9_s[0] + (k % 3) * a.t9_s[1] + p * C + col0 + c + 2 * t4);
    };
    if (fr + lr == 0.f && tl.j0 > 0 && tl.j0 + TW < a.ww)
      body([&](int p, int c, int, const float(&)[3]) { return entry(p, c, 4); });  // class (1, 1)
    else if (a.hh_glob > 1 && a.ww > 1)
      body([&](int p, int c, int cls, const float(&)[3]) { return entry(p, c, cls); });
    else
      body([&](int p, int c, int, const float(&wc)[3]) {
        float bias = 0.f;
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int q = 0; q < 3; ++q) bias += wr[r] * wc[q] * entry(p, c, r * 3 + q);
        return bias;
      });
  }
}

template <int C>
__global__ void __launch_bounds__(SPLIT_THREADS, 1)
    dec1_split_kernel(SplitArgs a, const __grid_constant__ SplitMaps ms, const __grid_constant__ SplitMaps mp) {
  using P = SplitPlan<C>;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* empty = full + SPLIT_MAX_STAGES;
  uint64_t* cempty = empty + SPLIT_MAX_STAGES;
  uint32_t rank = 0;
  int first = blockIdx.x, step = gridDim.x;
  if constexpr (P::CLUSTER > 1) {
    rank = sm90::cluster_rank();
    first = sm90::cluster_id();
    step = sm90::cluster_count();
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < P::STAGES; ++i) {
      sm90::mbar_init(&full[i], 1);                  // the producer's arrival (and the boxes' bytes)
      sm90::mbar_init(&empty[i], SPLIT_CONSUMERS);   // every consumer thread, its fragments formed
      sm90::mbar_init(&cempty[i], P::CLUSTER);       // (block 0) every block's producer
    }
    sm90::fence_mbar_init();
  }
  if constexpr (P::CLUSTER > 1)
    sm90::cluster_sync();  // no multicast or remote arrival before every block's barriers exist
  else
    __syncthreads();
  if (threadIdx.x >= SPLIT_CONSUMERS) {
    if (threadIdx.x == SPLIT_CONSUMERS)
      produce_split<C>(a, ms, mp, smem + P::W_BYTES, full, empty, cempty, rank, first, step);
  } else {
    lay_split_weights<C>(a, smem, int(rank) * P::NB);  // resident for the block's life
    sm90::fence_proxy_async_shared();                  // wgmma reads the images by the async proxy
    sm90::bar_sync(1, SPLIT_CONSUMERS);
    consume_split<C>(a, smem, full, empty, int(rank) * P::NB, first, step);
  }
  if constexpr (P::CLUSTER > 1) sm90::cluster_sync();  // no block leaves while another may still signal it
}

template <int C>
int launch_split(SplitArgs a, cudaStream_t stream) {
  using P = SplitPlan<C>;
  a.tiles_w = (a.ww + TW - 1) / TW;
  a.tiles_h = (a.hh + TH - 1) / TH;
  a.ntiles = a.b * a.tiles_w * a.tiles_h;
  if (a.ntiles == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(dec1_split_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return int(err);
  // Both inputs as (channels, Ww, Hh, B) in boxes of 16 f32 channels x 18 x
  // 6 (or 1) x 1, no swizzle.
  SplitMaps ms, mp;
  const cuuint32_t box[4] = {16, HALO_W, TH + 2, 1}, row[4] = {16, HALO_W, 1, 1};
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
  bool ok = true;
  for (int in = 0; in < 2; ++in) {
    SplitMaps& m = in == 0 ? ms : mp;
    const float *x = in == 0 ? a.xs : a.xp, *top = in == 0 ? a.xs_top : a.xp_top, *bot = in == 0 ? a.xs_bot : a.xp_bot;
    const int ch = in == 0 ? 4 * C : P::CP;
    ok = ok && sm90::nhwc_map(&m.x, x, a.b, a.hh, a.ww, ch, box, none, f32);
    if (top || bot) ok = ok && sm90::nhwc_map(&m.row, x, a.b, a.hh, a.ww, ch, row, none, f32);
    if (top) ok = ok && sm90::nhwc_map(&m.top, top, a.b, 1, a.ww, ch, row, none, f32);
    if (bot) ok = ok && sm90::nhwc_map(&m.bot, bot, a.b, 1, a.ww, ch, row, none, f32);
  }
  if (!ok) return int(cudaErrorInvalidValue);
  int dev = 0, units = 0;
  cudaGetDevice(&dev);
  if constexpr (P::CLUSTER == 1)
    cudaDeviceGetAttribute(&units, cudaDevAttrMultiProcessorCount, dev);
  else
    units = sm90::max_active_clusters(dec1_split_kernel<C>, SPLIT_THREADS, P::BYTES, P::CLUSTER);
  if (units == 0) return int(cudaErrorInvalidConfiguration);
  const int grid = (a.ntiles < units ? a.ntiles : units) * P::CLUSTER;  // persistent: one block a SM
  if constexpr (P::CLUSTER == 1) {
    dec1_split_kernel<C><<<grid, SPLIT_THREADS, P::BYTES, stream>>>(a, ms, mp);
    return int(cudaGetLastError());
  } else {
    return sm90::launch_cluster(dec1_split_kernel<C>, grid, SPLIT_THREADS, P::BYTES, P::CLUSTER, stream, a, ms, mp);
  }
}

// dec_conv1 on `stream`, Cout = Cs in {32, 64} and Cp = 2 Cs; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for widths
// without an instantiation. bf16 weights as Dec1Args says; f32 weights raw:
// k_skip (3, 3, Cs, Cout) and the dense k_prev (3, 3, Cp, 4Cout) with the
// strides `ws_s` and `wp_s` of their three leading dimensions, and t9 with
// `t9_s` (their last dimension contiguous), read as they lie by the split
// kernel.
int launch(const mgu::ConvArgs& a, const int (&ws_s)[3], const int (&wp_s)[3], const int (&t9_s)[2], bool is_bf16,
           cudaStream_t stream) {
  if (a.cout != a.c || a.cp != 2 * a.c || (a.c != 32 && a.c != 64)) return int(cudaErrorInvalidValue);
  if (!is_bf16) {
    const SplitArgs s{static_cast<const float*>(a.x), static_cast<const float*>(a.xp),
                      static_cast<const float*>(a.w), static_cast<const float*>(a.wp), a.t9,
                      static_cast<float*>(a.y), static_cast<const float*>(a.x_top),
                      static_cast<const float*>(a.x_bot), static_cast<const float*>(a.xp_top),
                      static_cast<const float*>(a.xp_bot), {ws_s[0], ws_s[1], ws_s[2]},
                      {wp_s[0], wp_s[1], wp_s[2]}, {t9_s[0], t9_s[1]},
                      a.b, a.hh, a.ww, a.row0, a.hh_glob, 0, 0, 0};
    return a.c == 32 ? launch_split<32>(s, stream) : launch_split<64>(s, stream);
  }
  const Dec1Args d{static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.xp), static_cast<const bf16*>(a.w),
                   static_cast<const bf16*>(a.wp), a.t9, static_cast<bf16*>(a.y),
                   static_cast<const bf16*>(a.x_top), static_cast<const bf16*>(a.x_bot),
                   static_cast<const bf16*>(a.xp_top), static_cast<const bf16*>(a.xp_bot),
                   a.b, a.hh, a.ww, a.row0, a.hh_glob, 0, 0, 0};
  return a.c == 32 ? launch_wgmma<32>(d, stream) : launch_wgmma<64>(d, stream);
}

}  // namespace

extern "C" int mgu_dec_conv1(const void* xs, const void* xp, const void* ws, const void* wp,
                             const float* t9, void* y, int b, int hh, int ww, int cs, int cp, int cout,
                             int ws_s0, int ws_s1, int ws_s2, int wp_s0, int wp_s1, int wp_s2, int t9_s0,
                             int t9_s1, int is_bf16, void* stream) {
  mgu::ConvArgs a{xs, ws, xp, wp, nullptr, t9, y, b, hh, ww, cs, cp, cout};
  a.hh_glob = hh;
  return launch(a, {ws_s0, ws_s1, ws_s2}, {wp_s0, wp_s1, wp_s2}, {t9_s0, t9_s1}, is_bf16 != 0,
                static_cast<cudaStream_t>(stream));
}

extern "C" int mgu_dec_conv1_halo(const void* xs, const void* xs_top, const void* xs_bot, const void* xp,
                                  const void* xp_top, const void* xp_bot, const void* ws, const void* wp,
                                  const float* t9, void* y, int b, int hh, int ww, int cs, int cp, int cout,
                                  int row0, int hh_glob, int ws_s0, int ws_s1, int ws_s2, int wp_s0, int wp_s1,
                                  int wp_s2, int t9_s0, int t9_s1, int is_bf16, void* stream) {
  mgu::ConvArgs a{xs, ws, xp, wp, nullptr, t9, y, b, hh, ww, cs, cp, cout};
  a.x_top = xs_top;
  a.x_bot = xs_bot;
  a.xp_top = xp_top;
  a.xp_bot = xp_bot;
  a.row0 = row0;
  a.hh_glob = hh_glob;
  return launch(a, {ws_s0, ws_s1, ws_s2}, {wp_s0, wp_s1, wp_s2}, {t9_s0, t9_s1}, is_bf16 != 0,
                static_cast<cudaStream_t>(stream));
}
