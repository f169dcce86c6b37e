// 3x3 'SAME' conv + bias of a phase-major s2d tensor, with or without ReLU.
// With ReLU it is the s2d ConvBlock's inference conv2 and replaces
// mingraph_unet_tpu/ops/pallas/psconv.py::conv3x3_s2d_psel. Without it (bias
// null) it is the raw training conv of psconv.py::psconv_train: its forward,
// and its dgrad on the cotangent with the flipped, in/out-transposed kernel.
//
// mgu_psel_conv3x3_halo is the same conv on one H-shard of the s2d grid,
// with the rows above and below the shard passed apart (null at a global
// border): it replaces mingraph_unet_tpu/parallel/halo.py::sharded_psconv,
// which concatenates the exchanged rows to the shard, runs the psel kernel
// on the extended block and discards its first and last output rows. Here
// the two rows are staged in place of the zero padding, so neither the
// shard-sized concat nor the discarded rows exist.
//
// Layout. x is (B, Hh, Ww, 4C) with channel ph*C + c, ph = 2*py + px: full
// resolution pixel (2I + py, 2J + px). The conv is computed on that layout
// as full-resolution pixels: the useful 9-tap arithmetic only, not the
// dense s2d form's 4x or the TPU phase-select form's 16/9x.
//
// bf16 (C = Cout in {32, 64}): a Hopper kernel.
//   Bound. 2*9*C^2 operations a full-res pixel against 2C bf16 values moved
//   (x read once, y written once): at C = 32 the H100's memory line bounds it
//   (L0: 268 MB, 80 us), at C = 64 it sits on the ridge (L1: 134 MB, 40 us,
//   and 38.7 GFLOP, 39 us at the dense bf16 rate). So it needs wgmma's rate
//   and the full memory bandwidth at once.
//   Design.
//   - Persistent blocks, one a SM, walk the TH x 16 s2d tiles, column-fastest
//     so that neighbours share their halo rows in L2.
//   - The kernel takes the conv's raw HWIO (3, 3, C, C) kernel, f32 or bf16,
//     as the parameter lies, and lays it out itself: its tap planes are
//     staged in shared memory by bulk (TMA) copies, in slots that the ring's
//     first stage does not use, and the consumer threads write wgmma's
//     K-major B image of the 9C x C weights (hopper.cuh) from them, rounded
//     to bf16 as Tensor.to(bfloat16) rounds, direct or (the dgrad) the
//     adjoint's (flipped, in/out transposed): 18.4 KB at C = 32, 73.7 KB at
//     C = 64, resident for the block's life. Meanwhile the first halo is in
//     flight. So a call is one device operation: no weight pack, no
//     adjoint copy, and no cache of prepared weights that could go stale.
//   - Warp specialised: a producer warpgroup (its registers handed to the
//     consumers by setmaxnreg; one thread of it issues the copies) stages
//     each tile's s2d halo (TH+2 x 18 pixels, all 4C channels) into a ring
//     of stages (3 at C = 32, 2 at C = 64, what shared memory holds beside
//     the weights) with full / empty
//     mbarriers, so the loads run ahead of the products without a
//     block-wide barrier. The halo is one TMA box a 64-channel plane, from
//     a 4-D tensor map over x whose out-of-bounds zeros are the SAME
//     padding, landing with the 128-byte swizzle (hopper.cuh::swz128) so the
//     8 rows of an ldmatrix fall in 8 bank groups. TMA keeps the copies off
//     the load/store unit, which a cp.async halo shares with the ldmatrix
//     reads of the products.
//     A tile whose halo holds a shard's neighbour row (row -1 from `top`,
//     row hh from `bot`, passed apart) is staged row by row: one box a row
//     and plane, from a one-row map of x, of `top` or of `bot`, each landing
//     at its row's offset (HALO_W * 128 bytes a row: 128-byte aligned, not
//     1024; TMA's swizzle follows the address, so the rows land in swz128's
//     layout, which tools/tma_row_probe.cu checks on the card).
//   - Two consumer warpgroups; warpgroup g computes s2d rows g*TH/2 ..
//     (g+1)*TH/2 - 1 of the tile. Its warp p takes output phase p, so one
//     wgmma.m64nCk16 covers 16 pixels of all four phases: each warp's A
//     rows (filled by ldmatrix from the staged halo at its own phase's tap
//     offset) differ, and
//     B = W[ky, kx] is shared. 9 taps x C/16 k-steps. A tap's ldmatrix
//     waits for the last tap's wgmma (one register buffer; more buffers
//     hide latency, but shared memory bounds the main loop, and trial builds
//     with two or three were no faster). Each wgmma.m64nCk16 reads 2 KB of A
//     (ldmatrix) and C*32 bytes of B from shared memory for 1024*C
//     multiply-adds, so at 128 bytes a clock the SM's shared memory feeds
//     at most 67% (C = 32) or 100% (C = 64) of the tensor-core rate.
//   - Epilogue, per consumer warpgroup (its stage already released): bias,
//     ReLU flag, bf16 rounding in registers, its rows staged in shared
//     memory and written with 16-byte stores, each row 16 consecutive pixels
//     of 4C channels.
//   The sum runs over taps and k-steps in a fixed order that does not depend
//   on where a tile or a shard starts, so K9's stitched shards equal the
//   unsharded launch bit for bit.
// f32 (C = Cout in {32, 64}): the same design on the tensor cores, with f32
// accuracy from a bf16 hi/lo split (conv_block.cu's K8 does the same): an
// f32 value a is hi = bf16(a) plus lo = bf16(a - hi), within 2^-18 |a|, and
// each product is hi*hi + hi*lo + lo*hi in the f32 accumulator (the dropped
// lo*lo is below 2^-16 of it). This is the configured precision
// (configs/training.yaml: bf16 false), so K1, the whole K4, K9 and K4 on a
// shard run here on every f32 path.
//   Bound. f32 x in and y out (L0: 537 MB, 160 us at 3.35 TB/s) against the
//   split form's 3 * 2*9*C^2 operations a full-res pixel at the bf16 rate
//   (116 GFLOP, 117 us); on the f32 FMA units (67 TFLOP/s) the same
//   function takes at least 577 us.
//   Design, as the bf16 kernel's but:
//   - Weights: the consumers lay out two B images, hi and lo, from the raw
//     f32 planes (147.5 KB at C = 64, 36.9 KB at C = 32), resident.
//   - The f32 halo does not fit beside them at C = 64 (a TH = 4 tile's is
//     110.6 KB), so a ring stage holds one k-slice of the tile: the 16
//     channels 16ks .. 16ks + 15 of all four input phases (27.6 KB at
//     TH = 4, 46.1 KB at TH = 8), four TMA boxes of 16 f32 channels (64
//     bytes a pixel, no swizzle). The sum runs over k-slices, then taps:
//     each wgmma.m64nCk16 needs one k-slice of every phase, as its four
//     warps read four input phases at one tap.
//   - A from registers: each lane reads the four consecutive channels
//     4t .. 4t + 3 of its two rows (16-byte loads; at 64 bytes a pixel the
//     8 lanes of a load phase fall in 8 bank groups) and splits them into
//     hi and lo fragments. The channels fill fragment columns (2t, 2t + 1,
//     2t + 8, 2t + 9), so B's rows are laid out in the same order
//     (ops/kernels/psconv.py::psel_b_image_index, `split`). At C = 64 the
//     next tap's fragments are formed while the last tap's wgmma runs (two
//     register buffers). ptxas caps a thread of the 288 (one producer warp
//     beside the two consumer warpgroups) at 168 registers, and at C = 32
//     (MI = 4) a second buffer beside the 64 accumulators serializes the
//     wgmmas, so there each warpgroup forms its fragments while the other's
//     products run. A producer warpgroup that hands its registers over by
//     setmaxnreg (384 threads), or TH = 4 at C = 32 with two buffers, built
//     and timed beside this (tools/psel_variants.py --f32), was no faster.
//   - Epilogue from registers: bias, ReLU flag, 8-byte stores, whose lanes
//     write whole 32-byte sectors (8 channels of one pixel and phase).
//   The sum's order (k-slices, taps, the three products) does not depend on
//   where a tile or shard starts, so K9 and K4 on shards stitch bit for bit.
#include <atomic>
#include <type_traits>

#include "conv_tile.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace sm90 = mgu::sm90;

constexpr int TW = 16, HALO_W = TW + 2;                 // s2d tile width, staged halo width
constexpr int THREADS = 384;                            // bf16: two consumer warpgroups, then the producer warpgroup
constexpr int SPLIT_THREADS = 288;                      // f32: two consumer warpgroups, then one producer warp
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;  // setmaxnreg: 128 * 56 + 256 * 224 <= 65536
constexpr int SM90_SHARED = 232448;                     // dynamic shared memory a block may use
constexpr int MAX_STAGES = 8;
constexpr int BAR_BYTES = (2 * MAX_STAGES + 9 + 1) * 8;
// The consumers meet at named barrier WEIGHTS_BAR once the weights are
// laid out (1 and 2 are the consumer warpgroups' own).
constexpr int WEIGHTS_BAR = 3;

// Shared memory of the bf16 kernel: the weights' image, each consumer
// warpgroup's output staging (its two s2d rows of the tile), the ring of
// halo stages, and at the top the mbarriers. While the image is laid out,
// the raw kernel's tap planes are staged in slots (RawSlots) in the output
// staging and above ring stage 0. A stage is one tile's halo in BOXES
// planes of 64 channels (128 bytes a pixel, 128-byte swizzle), each plane
// 1024-byte aligned: one TMA box a plane.
template <int C>
struct Plan {
  // s2d rows a tile, TH / 2 a consumer warpgroup: 8 at C = 32 (a 1.41x halo
  // instead of 1.69x, 3 stages), 4 at C = 64 (2 stages fit beside the weights).
  static constexpr int TH = C <= 32 ? 8 : 4;
  static constexpr int MI = TH / 2;
  static constexpr int HALO_PIX = (TH + 2) * HALO_W;
  static constexpr int OS = 4 * C + 8;                  // staged output pixel stride
  static constexpr int WEIGHTS = C * C, W_BYTES = 9 * WEIGHTS * 2;  // a tap plane's weights, the image
  static constexpr int SLICES = 1, BOXES = C / 16;      // stages a tile, boxes a stage
  static constexpr int RELEASES = 2;                    // a stage's: one a consumer warpgroup
  static constexpr int ROW_BYTES = HALO_W * 128;        // one staged halo row of one box
  static constexpr int BOX_BYTES = (HALO_PIX * 128 + 1023) / 1024 * 1024;
  static constexpr int HALO_BYTES = BOXES * BOX_BYTES;
  static constexpr int OUT_BYTES = MI * TW * OS * 2;   // a warpgroup's rows
  static constexpr int OUT = W_BYTES, RING = OUT + 2 * OUT_BYTES;
  static constexpr int BAR = SM90_SHARED - BAR_BYTES, TOP = BAR / 128 * 128;
  static constexpr int STAGES_FIT = (BAR - RING) / HALO_BYTES;
  static constexpr int STAGES = STAGES_FIT < MAX_STAGES ? STAGES_FIT : MAX_STAGES;
  static constexpr int BYTES = SM90_SHARED;
  static_assert(STAGES >= 2 && RING + STAGES * HALO_BYTES <= BAR, "psel plan exceeds shared memory");
  // First channel of box i of k-slice ks.
  static __device__ __forceinline__ int channel(int i, int) { return 64 * i; }
};

// Shared memory of the f32 (split) kernel: the hi and lo images, the ring
// of k-slice stages, the mbarriers. A stage is the k-slice ks of one tile's
// halo: BOXES = 4 boxes, box q the channels q*C + 16ks .. + 15 (input phase
// q) in f32, 64 bytes a pixel, no swizzle, each box 128-byte aligned.
template <int C>
struct SplitPlan {
  static constexpr int TH = C <= 32 ? 8 : 4;  // s2d rows a tile, as the bf16 plan's
  static constexpr int MI = TH / 2;
  static constexpr int HALO_PIX = (TH + 2) * HALO_W;
  static constexpr int WEIGHTS = C * C, W_BYTES = 9 * WEIGHTS * 2;  // one image, hi or lo
  static constexpr int SLICES = C / 16, BOXES = 4;
  static constexpr int RELEASES = CONSUMERS;     // a stage's: one a consumer thread
  // A fragment buffers: with two, a tap's hi and lo fragments are formed
  // while the last tap's products run; at C = 32 (MI = 4) the second does
  // not fit in ptxas's registers beside the accumulators.
  static constexpr int ABUF = C <= 32 ? 1 : 2;
  static constexpr int ROW_BYTES = HALO_W * 64;
  static constexpr int BOX_BYTES = HALO_PIX * 64;
  static constexpr int HALO_BYTES = BOXES * BOX_BYTES;
  static constexpr int OUT = 2 * W_BYTES, RING = OUT;  // no output staging
  static constexpr int BAR = SM90_SHARED - BAR_BYTES, TOP = BAR / 128 * 128;
  static constexpr int STAGES_FIT = (TOP - RING) / HALO_BYTES;
  static constexpr int STAGES = STAGES_FIT < MAX_STAGES ? STAGES_FIT : MAX_STAGES;
  static constexpr int BYTES = SM90_SHARED;
  static_assert(BOX_BYTES % 128 == 0 && ROW_BYTES % 128 == 0, "split boxes must stay 128-byte aligned");
  static_assert(STAGES >= 2 && RING + STAGES * HALO_BYTES <= TOP, "split plan exceeds shared memory");
  static __device__ __forceinline__ int channel(int i, int ks) { return i * C + 16 * ks; }
};

// Where the raw kernel's nine tap planes (C x C weights, f32 or bf16) are
// staged while the consumers lay out the image: `lo` slots in the output
// staging (free until the first epilogue; none in the split plan), then
// slots down from TOP, above ring stage 0, which the producer fills
// meanwhile: `ns` in all (9 or fewer: then a slot takes a second plane).
// Ring stages from `first_blocked` on overlap a slot, and the producer waits
// for the image before it fills them.
template <class P>
struct RawSlots {
  int pb, lo, ns, first_blocked;
  __device__ explicit RawSlots(bool f32) {
    pb = P::WEIGHTS * (f32 ? 4 : 2);
    lo = (P::RING - P::OUT) / pb;
    ns = lo + (P::TOP - P::RING - P::HALO_BYTES) / pb;
    const int hi_used = min(9, ns) - lo, lowest = P::TOP - hi_used * pb;
    first_blocked = P::STAGES;
    for (int st = P::STAGES - 1; st >= 1 && hi_used > 0; --st)
      if (P::RING + (st + 1) * P::HALO_BYTES > lowest) first_blocked = st;
  }
  __device__ int at(int j) const { return j < lo ? P::OUT + j * pb : P::TOP - (j - lo + 1) * pb; }
};

struct PselArgs {
  const void* x;      // (B, Hh, Ww, 4C), bf16 or (split) f32
  const void* w;      // the conv's raw HWIO (3, 3, C, C) kernel, f32 (w_f32) or bf16
  const float* bias;  // (C,) or null
  void* y;            // (B, Hh, Ww, 4C), x's dtype
  const void *top, *bot;  // (B, 1, Ww, 4C) halo rows of a shard, null at a global border
  int b, hh, ww, tiles_w, tiles_h, ntiles;
  int w_f32, adjoint;  // adjoint: convolve with the flipped, in/out-transposed kernel (the dgrad)
};

// The halo's tensor maps: x in (TH + 2)-row boxes; where a shard has a
// neighbour row, x, `top` and `bot` in one-row boxes (unset otherwise).
struct Maps {
  CUtensorMap x, row, top, bot;
};

struct Tile {
  int bi, i0, j0;
};

__device__ __forceinline__ Tile decode(const PselArgs& a, int t, int th) {
  const int tx = t % a.tiles_w, rest = t / a.tiles_w;
  return Tile{rest / a.tiles_h, (rest % a.tiles_h) * th, tx * TW};
}

// Two weights as one bf16x2 word, the first in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(unsigned short lo, unsigned short hi) { return lo | uint32_t(hi) << 16; }

// Two f32 values as their bf16x2 hi and lo words (the first value in the
// low halves): hi = bf16(a), lo = bf16(a - hi).
__device__ __forceinline__ void split2(float a0, float a1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a0, a1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a0 - __low2float(h), a1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 8 weights of a staged plane as one 16-byte chunk of bf16: consecutive
// ones (16 or 32 aligned bytes), or C apart.
template <int C, bool CONSECUTIVE>
__device__ __forceinline__ uint4 chunk8(const float* p) {
  if constexpr (CONSECUTIVE) {
    const float4 lo = reinterpret_cast<const float4*>(p)[0], hi = reinterpret_cast<const float4*>(p)[1];
    return make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w), pack2(hi.x, hi.y), pack2(hi.z, hi.w));
  } else {
    return make_uint4(pack2(p[0], p[C]), pack2(p[2 * C], p[3 * C]), pack2(p[4 * C], p[5 * C]),
                      pack2(p[6 * C], p[7 * C]));
  }
}
template <int C, bool CONSECUTIVE>
__device__ __forceinline__ uint4 chunk8(const unsigned short* p) {
  if constexpr (CONSECUTIVE) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    return make_uint4(pack2(p[0], p[C]), pack2(p[2 * C], p[3 * C]), pack2(p[4 * C], p[5 * C]),
                      pack2(p[6 * C], p[7 * C]));
  }
}

// Byte offset of chunk (k8, n) in wgmma's K-major B image of C columns:
// B's rows 8*k8 .. 8*k8 + 7 of column n, 16 bytes (hopper.cuh).
template <int C>
__device__ __forceinline__ int chunk_at(int k8, int n) {
  return (k8 >> 1) * 32 * C + ((n >> 3) * 2 + (k8 & 1)) * 128 + (n & 7) * 16;
}

// The image of tap `it` of B (9C x C, row tap*C + ci; wgmma's K-major
// layout, hopper.cuh) from the staged raw plane of HWIO tap `it` (direct)
// or 8 - `it` (adjoint), each consumer thread a share of its C*C/8 chunks.
// Chunk q of the image is B's rows 8*k8 .. 8*k8 + 7 of column n, 16 bytes
// of the image. Direct: B[tap*C + ci][n] = W[tap][ci][n], q = (k8, n), the
// chunk's weights C apart in the plane and consecutive threads on
// consecutive columns. Adjoint: B[tap*C + i][n] = W[8 - tap][n][i], q =
// (tap, n, i / 8), 8 consecutive weights. ops/kernels/psconv.py::
// psel_b_image_index is the same map, held against wgmma_b_layout by the
// CPU tests.
template <int C, bool ADJ, typename T>
__device__ void lay_tap(const T* plane, int it, unsigned char* wsm) {
  constexpr int PER = C * C / 8;
  for (int q = it * PER + int(threadIdx.x); q < (it + 1) * PER; q += CONSUMERS) {
    int k8, n, at;
    if (ADJ) {
      const int rem = q - it * PER;
      n = rem / (C / 8);
      k8 = it * (C / 8) + rem % (C / 8);
      at = 8 * rem;  // n * C + 8 * (rem % (C / 8))
    } else {
      k8 = q / C;
      n = q % C;
      at = 8 * (k8 % (C / 8)) * C + n;
    }
    *reinterpret_cast<uint4*>(wsm + chunk_at<C>(k8, n)) = chunk8<C, ADJ>(plane + at);
  }
}

template <int C>
__device__ void lay_tap(const PselArgs& a, const unsigned char* plane, int t, unsigned char* wsm) {
  if (a.adjoint) {
    if (a.w_f32) lay_tap<C, true>(reinterpret_cast<const float*>(plane), 8 - t, wsm);
    else lay_tap<C, true>(reinterpret_cast<const unsigned short*>(plane), 8 - t, wsm);
  } else {
    if (a.w_f32) lay_tap<C, false>(reinterpret_cast<const float*>(plane), t, wsm);
    else lay_tap<C, false>(reinterpret_cast<const unsigned short*>(plane), t, wsm);
  }
}

// The split kernel's hi and lo images of tap `it` from a raw f32 plane, as
// lay_tap's, but with each 16-row slab's rows in the order the consumers'
// A fragments take the channels: slab (tap, ks) row 8h + e holds channel
// 16ks + 4(e / 2) + 2h + e % 2 (fragment columns 2t, 2t + 1 from channels
// 4t, 4t + 1; columns 2t + 8, 2t + 9 from 4t + 2, 4t + 3). So chunk
// (k8 = 2ks + h, n) holds channels 16ks + 2h + {0, 1, 4, 5, 8, 9, 12, 13}:
// C apart in the plane (direct) or in pairs (adjoint).
template <int C, bool ADJ>
__device__ void lay_tap_split(const float* plane, int it, unsigned char* whi, unsigned char* wlo) {
  constexpr int PER = C * C / 8;
  for (int q = it * PER + int(threadIdx.x); q < (it + 1) * PER; q += CONSUMERS) {
    int k8, n;
    if (ADJ) {
      const int rem = q - it * PER;
      n = rem / (C / 8);
      k8 = it * (C / 8) + rem % (C / 8);
    } else {
      k8 = q / C;
      n = q % C;
    }
    const int ci0 = 8 * (k8 % (C / 8)) - 6 * (k8 & 1);  // 16ks + 2h
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int ci = ci0 + 4 * (e >> 1) + (e & 1);
      v[e] = ADJ ? plane[n * C + ci] : plane[ci * C + n];
    }
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split2(v[2 * e], v[2 * e + 1], hi[e], lo[e]);
    const int at = chunk_at<C>(k8, n);
    *reinterpret_cast<uint4*>(whi + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(wlo + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// The consumers lay out the weights at the start of the block, `lay(plane,
// tap)` a tap from its staged raw plane. The first consumer thread stages
// the raw tap planes into the slots by bulk (TMA) copies, plane p into slot
// p % ns, each completing on its slot's barrier; every consumer lays out
// its share of each plane as it lands, and where a slot takes a later plane
// they meet at WEIGHTS_BAR first (the slot is read). Then the ring stages
// under the slots go back to the producer (`wready`). The copies run beside
// the producer's first halo boxes; a TMA copy keeps a plane's bytes in
// flight at once, where loads by the threads of every SM from the same
// lines at once wait on L2 (tools/psel_variants.py).
template <class P, class Lay>
__device__ void lay_weights(const PselArgs& a, unsigned char* smem, uint64_t* sbar, uint64_t* wready, Lay lay) {
  const RawSlots<P> sl(a.w_f32);
  const bool lead = threadIdx.x == 0;
  const unsigned char* w = static_cast<const unsigned char*>(a.w);
  if (lead)
    for (int p = 0; p < 9 && p < sl.ns; ++p) {
      sm90::mbar_arrive_expect_tx(&sbar[p], sl.pb);
      sm90::bulk_copy(smem + sl.at(p), w + size_t(p) * sl.pb, sl.pb, &sbar[p]);
    }
  for (int p = 0; p < 9; ++p) {
    const int j = p % sl.ns;
    sm90::mbar_wait(&sbar[j], (p / sl.ns) & 1);
    lay(smem + sl.at(j), p);
    if (p + sl.ns < 9) {
      sm90::fence_proxy_async_shared();  // the next copy writes the slot by the async proxy
      sm90::bar_sync(WEIGHTS_BAR, CONSUMERS);
      if (lead) {
        sm90::mbar_arrive_expect_tx(&sbar[j], sl.pb);
        sm90::bulk_copy(smem + sl.at(j), w + size_t(p + sl.ns) * sl.pb, sl.pb, &sbar[j]);
      }
    }
  }
  sm90::fence_proxy_async_shared();  // wgmma reads the image, and the producer's boxes write the slots, by the async proxy
  sm90::bar_sync(WEIGHTS_BAR, CONSUMERS);
  if (lead) sm90::mbar_arrive(wready);
}

// The producer (one thread): every tile's halo, in P::SLICES stages of
// P::BOXES TMA boxes each, into the next free stage (the stages under the
// raw weights' slots once the image is laid out); the boxes' out-of-bounds
// zeros are the SAME padding. A tile whose halo holds a shard's neighbour
// row (row -1 from `top`, row hh from `bot`) is staged row by row, each row
// from its own one-row map, landing at its row's offset (a row is ROW_BYTES:
// 128-byte aligned, not 1024; TMA's swizzle follows the address, so the
// rows land in swz128's layout, which tools/tma_row_probe.cu checks on the
// card). Such a tile's rows past hh feed only outputs that are not stored,
// so they are not loaded.
template <class P>
__device__ void produce(const PselArgs& a, const Maps& m, unsigned char* ring, uint64_t* full, uint64_t* empty,
                        uint64_t* wready) {
  const int blocked = RawSlots<P>(a.w_f32).first_blocked;  // stages that hold raw weights until the image is laid out
  bool held = blocked < P::STAGES;
  int s = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
    const Tile tl = decode(a, t, P::TH);
    const bool rows = (tl.i0 == 0 && a.top) || (tl.i0 + P::TH >= a.hh && a.bot);
    const int nr = rows ? min(P::TH + 2, a.hh - tl.i0 + 2) : P::TH + 2;  // staged row r is row i0 - 1 + r
    for (int ks = 0; ks < P::SLICES; ++ks) {
      sm90::mbar_wait(&empty[s], ph ^ 1);
      if (held && s >= blocked) {
        sm90::mbar_wait(wready, 0);
        held = false;
      }
      unsigned char* dst = ring + size_t(s) * P::HALO_BYTES;
      sm90::mbar_arrive_expect_tx(&full[s], P::BOXES * nr * P::ROW_BYTES);
      for (int i = 0; i < P::BOXES; ++i) {
        const int c0 = P::channel(i, ks);
        if (!rows) {
          sm90::tma_load_4d(dst + i * P::BOX_BYTES, &m.x, c0, tl.j0 - 1, tl.i0 - 1, tl.bi, &full[s]);
          continue;
        }
        for (int r = 0; r < nr; ++r) {
          const int gi = tl.i0 - 1 + r;
          const bool up = gi == -1 && a.top, down = gi == a.hh && a.bot;
          const CUtensorMap* map = up ? &m.top : down ? &m.bot : &m.row;
          sm90::tma_load_4d(dst + i * P::BOX_BYTES + r * P::ROW_BYTES, map, c0, tl.j0 - 1, up || down ? 0 : gi,
                            tl.bi, &full[s]);
        }
      }
      if (++s == P::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
  }
  for (int i = 0; i < P::STAGES; ++i) {  // leave only when every stage is released
    sm90::mbar_wait(&empty[s], ph ^ 1);
    if (++s == P::STAGES) {
      s = 0;
      ph ^= 1;
    }
  }
}

// A consumer warpgroup of the bf16 kernel: s2d rows MI*g .. MI*g + MI - 1
// of every tile; warp p of it takes output phase p.
template <int C, bool RELU>
__device__ void consume(const PselArgs& a, const bf16* wsm, bf16* outs, const unsigned char* ring, uint64_t* full,
                        uint64_t* empty) {
  using P = Plan<C>;
  constexpr int KS = C / 16;   // k-steps a tap
  constexpr int NR = C / 2;    // accumulator registers a thread per 64-row tile
  constexpr int VPP = C / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, p = warp & 3, py = p >> 1, px = p & 1;
  constexpr int MI = P::MI;
  const int ib = MI * wg;  // the warpgroup's first s2d row in the tile
  const int lrow = lane & 15, lk = (lane >> 4) * 8;
  const int g = lane >> 2, t4 = lane & 3;
  const int wtid = threadIdx.x & 127;
  const bool leader = wtid == 0;
  const auto wg_sync = [wg]() { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); };
  bf16* y = static_cast<bf16*>(a.y);
  int s = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
    const Tile tl = decode(a, t, P::TH);
    sm90::mbar_wait(&full[s], ph);
    const unsigned char* hb = ring + size_t(s) * P::HALO_BYTES;
    float acc[MI][NR];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[mi][r] = 0.f;
    uint32_t af[MI][KS][4];
    // Output pixel (2I+py, 2J+px), tap (ky, kx) reads full-res
    // (2I+py+ky-1, 2J+px+kx-1): halo s2d pixel (I + (py+ky+1)/2,
    // J + (px+kx+1)/2), input phase ((py+ky+1)%2, (px+kx+1)%2).
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      const int q = ((py + ky + 1) & 1) * 2 + ((px + kx + 1) & 1);
      const int pix = (ib + ((py + ky + 1) >> 1)) * HALO_W + lrow + ((px + kx + 1) >> 1);
      sm90::wgmma_wait<0>();  // the last tap's group has read its A registers
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int ch = q * C + 16 * ks + lk;  // the lane's 8 channels: plane ch / 64, chunk ch % 64 / 8
          sm90::ldmatrix_x4(af[mi][ks], reinterpret_cast<const bf16*>(
                                            hb + (ch >> 6) * P::BOX_BYTES + sm90::swz128(pix + mi * HALO_W, (ch & 63) >> 3)));
        }
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint64_t desc = sm90::desc_b(wsm + (tap * KS + ks) * 16 * C);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) sm90::Wgmma<C>::run(acc[mi], af[mi][ks], desc);
      }
      sm90::wgmma_commit();
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) sm90::fence_operand(acc[mi]);
    if (leader) sm90::mbar_arrive(&empty[s]);  // the stage goes back to the producer
    if (++s == P::STAGES) {
      s = 0;
      ph ^= 1;
    }

    // Epilogue: lane (g, t4) holds pixels J = g and g + 8 of each of its
    // rows, channels 8j + 2t4 and 8j + 2t4 + 1 of phase p.
    wg_sync();  // the last tile's stores have read the staging buffer
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int n = 8 * j + 2 * t4;
      const float b0 = a.bias ? __ldg(a.bias + n) : 0.f, b1 = a.bias ? __ldg(a.bias + n + 1) : 0.f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[mi][4 * j + 2 * h] + b0, v1 = acc[mi][4 * j + 2 * h + 1] + b1;
          if (RELU) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(outs + (mi * TW + g + 8 * h) * P::OS + p * C + n) =
              __floats2bfloat162_rn(v0, v1);
        }
    }
    wg_sync();
    for (int i = wtid; i < MI * TW * VPP; i += 128) {  // 16-byte stores, a row's pixels one after another
      const int v = i % VPP, pix = i / VPP;
      const int gi = tl.i0 + ib + pix / TW, gj = tl.j0 + pix % TW;
      if (gi < a.hh && gj < a.ww)
        *reinterpret_cast<uint4*>(y + ((size_t(tl.bi) * a.hh + gi) * a.ww + gj) * (4 * C) + v * 8) =
            *reinterpret_cast<const uint4*>(outs + pix * P::OS + v * 8);
    }
  }
}

// A consumer warpgroup of the split kernel: s2d rows MI*g .. MI*g + MI - 1
// of every tile, warp p output phase p, as the bf16 one; a tile's halo in
// k-slices, each released once every tap has read it.
template <int C, bool RELU>
__device__ void consume_split(const PselArgs& a, const unsigned char* whi, const unsigned char* ring,
                              uint64_t* full, uint64_t* empty) {
  using P = SplitPlan<C>;
  constexpr int KS = P::SLICES;
  constexpr int NR = C / 2;  // accumulator registers a thread per 64-row tile
  constexpr int MI = P::MI;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, p = warp & 3, py = p >> 1, px = p & 1;
  const int ib = MI * wg;  // the warpgroup's first s2d row in the tile
  const int g = lane >> 2, t4 = lane & 3;
  const unsigned char* wlo = whi + P::W_BYTES;
  float* y = static_cast<float*>(a.y);
  int s = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
    const Tile tl = decode(a, t, P::TH);
    float acc[MI][NR];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[mi][r] = 0.f;
    uint32_t ah[P::ABUF][MI][4], al[P::ABUF][MI][4];  // hi and lo A fragments
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      sm90::mbar_wait(&full[s], ph);
      const unsigned char* hb = ring + size_t(s) * P::HALO_BYTES;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int buf = (ks * 9 + tap) % P::ABUF;
        const int ky = tap / 3, kx = tap % 3;
        const int q = ((py + ky + 1) & 1) * 2 + ((px + kx + 1) & 1);
        // Row g of the warp's A: halo pixel (ib + mi + dy, g + dx) of box q,
        // the lane's 4 channels 4t4 .. 4t4 + 3; row g + 8 eight pixels on.
        const unsigned char* at =
            hb + q * P::BOX_BYTES + ((ib + ((py + ky + 1) >> 1)) * HALO_W + g + ((px + kx + 1) >> 1)) * 64 + t4 * 16;
        if (P::ABUF == 1) sm90::wgmma_wait<0>();  // the last tap's group has read the registers
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const float4 r0 = *reinterpret_cast<const float4*>(at + mi * HALO_W * 64);
          const float4 r1 = *reinterpret_cast<const float4*>(at + (mi * HALO_W + 8) * 64);
          split2(r0.x, r0.y, ah[buf][mi][0], al[buf][mi][0]);
          split2(r1.x, r1.y, ah[buf][mi][1], al[buf][mi][1]);
          split2(r0.z, r0.w, ah[buf][mi][2], al[buf][mi][2]);
          split2(r1.z, r1.w, ah[buf][mi][3], al[buf][mi][3]);
        }
        sm90::wgmma_fence();
        const int slab = (tap * KS + ks) * 32 * C;
        const uint64_t dh = sm90::desc_b(whi + slab), dl = sm90::desc_b(wlo + slab);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          sm90::Wgmma<C>::run(acc[mi], ah[buf][mi], dh);
          sm90::Wgmma<C>::run(acc[mi], ah[buf][mi], dl);
          sm90::Wgmma<C>::run(acc[mi], al[buf][mi], dh);
        }
        sm90::wgmma_commit();
        // The slice goes back to the producer once this thread's reads of it
        // have landed: their values are in the fragments the wgmma took (an
        // arrive right after the loads let a TMA box overwrite the slice
        // before a load read it, now and then).
        if (tap == 8) sm90::mbar_arrive(&empty[s]);
        if (P::ABUF == 2) sm90::wgmma_wait<1>();  // the group before has read the other buffer
      }
      if (++s == P::STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) sm90::fence_operand(acc[mi]);

    // Epilogue: lane (g, t4) holds pixels J = g and g + 8 of each of its
    // rows, channels 8j + 2t4 and 8j + 2t4 + 1 of phase p: the 4 lanes of a
    // pixel write its 8 channels, 32 bytes.
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int n = 8 * j + 2 * t4;
      const float b0 = a.bias ? __ldg(a.bias + n) : 0.f, b1 = a.bias ? __ldg(a.bias + n + 1) : 0.f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gi = tl.i0 + ib + mi, gj = tl.j0 + g + 8 * h;
          if (gi >= a.hh || gj >= a.ww) continue;
          float v0 = acc[mi][4 * j + 2 * h] + b0, v1 = acc[mi][4 * j + 2 * h + 1] + b1;
          if (RELU) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<float2*>(y + ((size_t(tl.bi) * a.hh + gi) * a.ww + gj) * (4 * C) + p * C + n) =
              make_float2(v0, v1);
        }
    }
  }
}

// The barriers: full[i] and empty[i] of ring stage i, sbar[j] of raw slot
// j, wready once the image is laid out.
template <class P>
__device__ __forceinline__ uint64_t* init_barriers(unsigned char* smem) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR);
  if (threadIdx.x == 0) {
    for (int i = 0; i < P::STAGES; ++i) {
      sm90::mbar_init(&full[i], 1);                   // the producer's arrival (and the boxes' expected bytes)
      sm90::mbar_init(&full[MAX_STAGES + i], P::RELEASES);
    }
    for (int j = 0; j < 10; ++j) sm90::mbar_init(&full[2 * MAX_STAGES + j], 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  return full;
}

template <int C, bool RELU>
__global__ void __launch_bounds__(THREADS, 1) psel_wgmma_kernel(PselArgs a, const __grid_constant__ Maps maps) {
  using P = Plan<C>;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = init_barriers<P>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* sbar = empty + MAX_STAGES;  // a raw plane has landed in slot j
  uint64_t* wready = sbar + 9;          // the image is laid out
  if (threadIdx.x >= CONSUMERS) {
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) produce<P>(a, maps, smem + P::RING, full, empty, wready);
  } else {
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    lay_weights<P>(a, smem, sbar, wready,  // resident for the block's life
                   [&](const unsigned char* plane, int t) { lay_tap<C>(a, plane, t, smem); });
    bf16* outs = reinterpret_cast<bf16*>(smem + P::OUT + (threadIdx.x >> 7) * P::OUT_BYTES);
    consume<C, RELU>(a, reinterpret_cast<const bf16*>(smem), outs, smem + P::RING, full, empty);
  }
}

// The f32 kernel: the hi image at 0, the lo image after it.
template <int C, bool RELU>
__global__ void __launch_bounds__(SPLIT_THREADS, 1) psel_split_kernel(PselArgs a, const __grid_constant__ Maps maps) {
  using P = SplitPlan<C>;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = init_barriers<P>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* sbar = empty + MAX_STAGES;
  uint64_t* wready = sbar + 9;
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) produce<P>(a, maps, smem + P::RING, full, empty, wready);
  } else {
    lay_weights<P>(a, smem, sbar, wready, [&](const unsigned char* plane, int t) {
      const float* f = reinterpret_cast<const float*>(plane);
      if (a.adjoint) lay_tap_split<C, true>(f, 8 - t, smem, smem + P::W_BYTES);
      else lay_tap_split<C, false>(f, t, smem, smem + P::W_BYTES);
    });
    consume_split<C, RELU>(a, smem, smem + P::RING, full, empty);
  }
}

constexpr int MAX_DEVICES = 64;

// The device's SM count, asked once a device.
int sm_count(int dev) {
  static std::atomic<int> sms[MAX_DEVICES];
  int n = sms[dev].load(std::memory_order_relaxed);
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
    sms[dev].store(n, std::memory_order_relaxed);
  return n;
}

// The kernel's dynamic shared memory allowed, once a kernel and device.
template <bool SPLIT, int C, bool RELU, class Kernel>
cudaError_t allow_smem(Kernel kern, int dev) {
  static std::atomic<bool> done[MAX_DEVICES];  // one array an instantiation
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SM90_SHARED);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

// Persistent grid: one block a SM (the plan takes its shared memory), at
// most one a tile. The maps are encoded every launch (they hold the
// tensors' addresses); the device's attributes are asked once. bf16: x in
// boxes of 64 channels, 128-byte swizzle; f32 (SPLIT): boxes of 16
// channels, no swizzle.
template <bool SPLIT, int C, bool RELU>
int launch_wgmma(PselArgs a, cudaStream_t stream) {
  using P = std::conditional_t<SPLIT, SplitPlan<C>, Plan<C>>;
  const auto kern = SPLIT ? psel_split_kernel<C, RELU> : psel_wgmma_kernel<C, RELU>;
  a.tiles_w = (a.ww + TW - 1) / TW;
  a.tiles_h = (a.hh + P::TH - 1) / P::TH;
  a.ntiles = a.b * a.tiles_w * a.tiles_h;
  if (a.ntiles == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= MAX_DEVICES) return int(cudaErrorInvalidDevice);
  if ((err = allow_smem<SPLIT, C, RELU>(kern, dev)) != cudaSuccess) return int(err);
  const int sms = sm_count(dev);
  if (sms == 0) return int(cudaErrorInvalidDevice);
  // x as (4C, Ww, Hh, B) in boxes of channels x (TW + 2) x (TH + 2) x 1;
  // the row maps in boxes one row high.
  Maps m;
  const cuuint32_t ch = SPLIT ? 16 : 64;
  const cuuint32_t box[4] = {ch, HALO_W, P::TH + 2, 1}, row[4] = {ch, HALO_W, 1, 1};
  const auto swz = SPLIT ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  const auto dt = SPLIT ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  bool ok = sm90::nhwc_map(&m.x, a.x, a.b, a.hh, a.ww, 4 * C, box, swz, dt);
  if (a.top || a.bot) ok = ok && sm90::nhwc_map(&m.row, a.x, a.b, a.hh, a.ww, 4 * C, row, swz, dt);
  if (a.top) ok = ok && sm90::nhwc_map(&m.top, a.top, a.b, 1, a.ww, 4 * C, row, swz, dt);
  if (a.bot) ok = ok && sm90::nhwc_map(&m.bot, a.bot, a.b, 1, a.ww, 4 * C, row, swz, dt);
  if (!ok) return int(cudaErrorInvalidValue);
  kern<<<a.ntiles < sms ? a.ntiles : sms, SPLIT ? SPLIT_THREADS : THREADS, P::BYTES, stream>>>(a, m);
  return int(cudaGetLastError());
}

template <bool SPLIT, bool RELU>
int launch_width(const PselArgs& p, int c, cudaStream_t stream) {
  switch (c) {
    case 32: return launch_wgmma<SPLIT, 32, RELU>(p, stream);
    case 64: return launch_wgmma<SPLIT, 64, RELU>(p, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

// Either dtype, C = Cout in {32, 64}: w is the conv's raw HWIO kernel, the
// adjoint's when `adjoint` ((3, 3, Cout, Cin) then). bf16 x: f32 (w_f32) or
// bf16, the wgmma kernel; f32 x: f32, the split kernel.
template <bool RELU>
int launch(const mgu::ConvArgs& a, bool is_bf16, bool w_f32, bool adjoint, cudaStream_t stream) {
  if ((!is_bf16 && !w_f32) || a.cout != a.c) return int(cudaErrorInvalidValue);
  const PselArgs p{a.x, a.w, a.bias, a.y, a.x_top, a.x_bot, a.b, a.hh, a.ww, 0, 0, 0, int(w_f32), int(adjoint)};
  return is_bf16 ? launch_width<false, RELU>(p, a.c, stream) : launch_width<true, RELU>(p, a.c, stream);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a width without an instantiation. w is the
// conv's raw HWIO (3, 3, C, Cout) kernel, laid out by the kernel, the
// adjoint's when `adjoint`: f32 (w_f32) or, for bf16 x, bf16.
extern "C" int mgu_psel_conv3x3(const void* x, const void* w, const float* bias, void* y,
                                int b, int hh, int ww, int c, int cout, int is_bf16, int relu, int w_f32,
                                int adjoint, void* stream) {
  mgu::ConvArgs a{x, w, nullptr, nullptr, bias, nullptr, y, b, hh, ww, c, 0, cout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return relu ? launch<true>(a, is_bf16 != 0, w_f32 != 0, adjoint != 0, s)
              : launch<false>(a, is_bf16 != 0, w_f32 != 0, adjoint != 0, s);
}

extern "C" int mgu_psel_conv3x3_halo(const void* x, const void* x_top, const void* x_bot, const void* w,
                                     const float* bias, void* y, int b, int hh, int ww, int c, int cout,
                                     int is_bf16, int relu, int w_f32, int adjoint, void* stream) {
  mgu::ConvArgs a{x, w, nullptr, nullptr, bias, nullptr, y, b, hh, ww, c, 0, cout};
  a.x_top = x_top;
  a.x_bot = x_bot;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return relu ? launch<true>(a, is_bf16 != 0, w_f32 != 0, adjoint != 0, s)
              : launch<false>(a, is_bf16 != 0, w_f32 != 0, adjoint != 0, s);
}
