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
//   - The 9C x C weights are copied into shared memory once a block, by one
//     bulk (TMA) copy completing on an mbarrier, in wgmma's K-major B layout
//     (hopper.cuh; packed by psconv.py::wgmma_b_layout): 18.4 KB at C = 32,
//     73.7 KB at C = 64. No weight byte crosses L2 twice for a block.
//   - Warp specialised: a producer warpgroup (its registers handed to the
//     consumers by setmaxnreg) stages each tile's s2d halo (TH+2 x 18
//     pixels, all 4C channels) into a ring of stages (3 at C = 32, 2 at
//     C = 64, what shared memory holds beside the weights) with full / empty
//     mbarriers, so the loads run ahead of the products without a
//     block-wide barrier. The halo is one TMA box a 64-channel plane, from
//     a 4-D tensor map over x whose out-of-bounds zeros are the SAME
//     padding, landing with the 128-byte swizzle (hopper.cuh::swz128) so the
//     8 rows of an ldmatrix fall in 8 bank groups. TMA keeps the copies off
//     the load/store unit, which a cp.async halo shares with the ldmatrix
//     reads of the products.
//     K9's tiles whose halo holds a neighbour's row (row -1 or hh, passed
//     apart) take cp.async into the same swizzled layout.
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
// f32: conv_tile.cuh's FMA kernel, for the card-vs-CPU f32 checks.
#include "conv_tile.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace sm90 = mgu::sm90;

constexpr int TW = 16, HALO_W = TW + 2;                 // s2d tile width, staged halo width
constexpr int THREADS = 384;                            // two consumer warpgroups, then the producer warpgroup
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;  // setmaxnreg: 128 * 56 + 256 * 224 <= 65536
constexpr int SM90_SHARED = 232448;                     // dynamic shared memory a block may use
constexpr int MAX_STAGES = 8;

// Shared memory of the bf16 kernel: the weights, each consumer warpgroup's
// output staging (its two s2d rows of the tile), the ring of halo stages,
// the mbarriers.
template <int C>
struct Plan {
  // s2d rows a tile, TH / 2 a consumer warpgroup: 8 at C = 32 (a 1.41x halo
  // instead of 1.69x, 3 stages), 4 at C = 64 (2 stages fit beside the weights).
  static constexpr int TH = C <= 32 ? 8 : 4;
  static constexpr int MI = TH / 2;
  static constexpr int HALO_PIX = (TH + 2) * HALO_W;
  static constexpr int OS = 4 * C + 8;                  // staged output pixel stride
  static constexpr int W_BYTES = 9 * C * C * 2;
  // The halo in planes of 64 channels (128 bytes a pixel, 128-byte swizzle),
  // each plane 1024-byte aligned: one TMA box a plane.
  static constexpr int PLANES = C / 16;
  static constexpr int PLANE_BYTES = (HALO_PIX * 128 + 1023) / 1024 * 1024;
  static constexpr int HALO_BYTES = PLANES * PLANE_BYTES;
  static constexpr int OUT_BYTES = MI * TW * OS * 2;   // a warpgroup's rows
  static constexpr int BAR_BYTES = (1 + 2 * MAX_STAGES) * 8;
  static constexpr int OUT = W_BYTES, RING = OUT + 2 * OUT_BYTES;
  static constexpr int STAGES_FIT = (SM90_SHARED - RING - BAR_BYTES) / HALO_BYTES;
  static constexpr int STAGES = STAGES_FIT < MAX_STAGES ? STAGES_FIT : MAX_STAGES;
  static constexpr int BAR = RING + STAGES * HALO_BYTES;
  static constexpr int BYTES = BAR + BAR_BYTES;
  static_assert(STAGES >= 2 && BYTES <= SM90_SHARED, "psel plan exceeds shared memory");
};

struct PselArgs {
  const bf16* x;      // (B, Hh, Ww, 4C)
  const bf16* w;      // (9C, C) in wgmma B layout
  const float* bias;  // (C,) or null
  bf16* y;            // (B, Hh, Ww, 4C)
  const bf16 *top, *bot;  // (B, 1, Ww, 4C) halo rows of a shard, null at a global border
  int b, hh, ww, tiles_w, tiles_h, ntiles;
};

struct Tile {
  int bi, i0, j0;
};

__device__ __forceinline__ Tile decode(const PselArgs& a, int t, int th) {
  const int tx = t % a.tiles_w, rest = t / a.tiles_w;
  return Tile{rest / a.tiles_h, (rest % a.tiles_h) * th, tx * TW};
}

// The producer warpgroup: the weights once (one bulk copy), then every
// tile's halo into the next free stage: one TMA box a plane (out-of-bounds
// zeros are the SAME padding), or, where a shard's neighbour row falls in the
// halo (row -1 from `top`, row hh from `bot`), cp.async of the same swizzled
// layout by every producer thread. Each producer thread arrives on the
// stage's barrier once (after its copies, on the cp.async path).
template <int C>
__device__ void produce(const PselArgs& a, const CUtensorMap* xmap, bf16* wsm, unsigned char* ring, uint64_t* wbar,
                        uint64_t* full, uint64_t* empty) {
  using P = Plan<C>;
  const int ptid = threadIdx.x - CONSUMERS;
  if (ptid == 0) {
    sm90::mbar_arrive_expect_tx(wbar, P::W_BYTES);
    sm90::bulk_copy(wsm, a.w, P::W_BYTES, wbar);
  }
  int s = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
    const Tile tl = decode(a, t, P::TH);
    sm90::mbar_wait(&empty[s], ph ^ 1);
    unsigned char* dst = ring + size_t(s) * P::HALO_BYTES;
    const bool rows = (tl.i0 == 0 && a.top) || (tl.i0 + P::TH >= a.hh && a.bot);
    if (!rows) {
      if (ptid == 0) {
        sm90::mbar_arrive_expect_tx(&full[s], P::PLANES * P::HALO_PIX * 128);
        for (int pl = 0; pl < P::PLANES; ++pl)
          sm90::tma_load_4d(dst + pl * P::PLANE_BYTES, xmap, 64 * pl, tl.j0 - 1, tl.i0 - 1, tl.bi, &full[s]);
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    } else {
      for (int i = ptid; i < P::PLANES * P::HALO_PIX * 8; i += 128) {
        const int ck = i & 7, pix = (i >> 3) % P::HALO_PIX, pl = (i >> 3) / P::HALO_PIX;
        const int gi = tl.i0 - 1 + pix / HALO_W, gj = tl.j0 - 1 + pix % HALO_W;
        const bf16* src = nullptr;
        if (gj >= 0 && gj < a.ww) {
          if (gi >= 0 && gi < a.hh)
            src = a.x + ((size_t(tl.bi) * a.hh + gi) * a.ww + gj) * (4 * C);
          else if (gi == -1 && a.top)
            src = a.top + (size_t(tl.bi) * a.ww + gj) * (4 * C);
          else if (gi == a.hh && a.bot)
            src = a.bot + (size_t(tl.bi) * a.ww + gj) * (4 * C);
        }
        sm90::cp_async16(dst + pl * P::PLANE_BYTES + sm90::swz128(pix, ck), src ? src + 64 * pl + 8 * ck : a.x,
                         src ? 16 : 0);
      }
      sm90::cp_async_arrive(&full[s]);
    }
    if (++s == P::STAGES) {
      s = 0;
      ph ^= 1;
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

// A consumer warpgroup: s2d rows MI*g .. MI*g + MI - 1 of every tile; warp p
// of it takes output phase p.
template <int C, bool RELU>
__device__ void consume(const PselArgs& a, const bf16* wsm, bf16* outs, const unsigned char* ring, uint64_t* wbar,
                        uint64_t* full, uint64_t* empty) {
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
  sm90::mbar_wait(wbar, 0);  // the weights are resident for the block's life
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
                                            hb + (ch >> 6) * P::PLANE_BYTES + sm90::swz128(pix + mi * HALO_W, (ch & 63) >> 3)));
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
        *reinterpret_cast<uint4*>(a.y + ((size_t(tl.bi) * a.hh + gi) * a.ww + gj) * (4 * C) + v * 8) =
            *reinterpret_cast<const uint4*>(outs + pix * P::OS + v * 8);
    }
  }
}

template <int C, bool RELU>
__global__ void __launch_bounds__(THREADS, 1) psel_wgmma_kernel(PselArgs a, const __grid_constant__ CUtensorMap xmap) {
  using P = Plan<C>;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* wsm = reinterpret_cast<bf16*>(smem);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* full = wbar + 1;
  uint64_t* empty = full + MAX_STAGES;
  if (threadIdx.x == 0) {
    sm90::mbar_init(wbar, 1);
    for (int i = 0; i < P::STAGES; ++i) {
      sm90::mbar_init(&full[i], 128);  // each producer thread once (and the TMA boxes' expected bytes)
      sm90::mbar_init(&empty[i], 2);   // one release a consumer warpgroup
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    produce<C>(a, &xmap, wsm, smem + P::RING, wbar, full, empty);
  } else {
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    bf16* outs = reinterpret_cast<bf16*>(smem + P::OUT + (threadIdx.x >> 7) * P::OUT_BYTES);
    consume<C, RELU>(a, wsm, outs, smem + P::RING, wbar, full, empty);
  }
}

// Persistent grid: one block a SM (the plan takes its shared memory), at
// most one a tile.
int grid_blocks(int ntiles) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return ntiles < sms ? ntiles : sms;
}

template <int C, bool RELU>
int launch_wgmma(PselArgs a, cudaStream_t stream) {
  a.tiles_w = (a.ww + TW - 1) / TW;
  a.tiles_h = (a.hh + Plan<C>::TH - 1) / Plan<C>::TH;
  a.ntiles = a.b * a.tiles_w * a.tiles_h;
  if (a.ntiles == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(psel_wgmma_kernel<C, RELU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Plan<C>::BYTES);
  if (err != cudaSuccess) return int(err);
  // x as (4C, Ww, Hh, B) in boxes of 64 channels x (TW + 2) x (TH + 2) x 1.
  CUtensorMap xmap;
  const cuuint32_t box[4] = {64, HALO_W, Plan<C>::TH + 2, 1};
  if (!sm90::nhwc_map(&xmap, a.x, a.b, a.hh, a.ww, 4 * C, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return int(cudaErrorInvalidValue);
  psel_wgmma_kernel<C, RELU><<<grid_blocks(a.ntiles), THREADS, Plan<C>::BYTES, stream>>>(a, xmap);
  return int(cudaGetLastError());
}

template <bool RELU>
int launch(const mgu::ConvArgs& a, bool is_bf16, cudaStream_t stream) {
  if (!is_bf16)
    return mgu::launch(mgu::conv_f32_kernel<false, RELU>, a, mgu::SmemPlan<float>(a.c, a.cp, false).bytes, stream);
  if (a.cout != a.c) return int(cudaErrorInvalidValue);
  PselArgs p{static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.w), a.bias, static_cast<bf16*>(a.y),
             static_cast<const bf16*>(a.x_top), static_cast<const bf16*>(a.x_bot), a.b, a.hh, a.ww, 0, 0, 0};
  switch (a.c) {
    case 32: return launch_wgmma<32, RELU>(p, stream);
    case 64: return launch_wgmma<64, RELU>(p, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a bf16 width without an instantiation. bf16
// weights in wgmma B layout, f32 weights HWIO.
extern "C" int mgu_psel_conv3x3(const void* x, const void* w, const float* bias, void* y,
                                int b, int hh, int ww, int c, int cout, int is_bf16, int relu,
                                void* stream) {
  mgu::ConvArgs a{x, w, nullptr, nullptr, bias, nullptr, y, b, hh, ww, c, 0, cout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return relu ? launch<true>(a, is_bf16 != 0, s) : launch<false>(a, is_bf16 != 0, s);
}

extern "C" int mgu_psel_conv3x3_halo(const void* x, const void* x_top, const void* x_bot, const void* w,
                                     const float* bias, void* y, int b, int hh, int ww, int c, int cout,
                                     int is_bf16, int relu, void* stream) {
  mgu::ConvArgs a{x, w, nullptr, nullptr, bias, nullptr, y, b, hh, ww, c, 0, cout};
  a.x_top = x_top;
  a.x_bot = x_bot;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return relu ? launch<true>(a, is_bf16 != 0, s) : launch<false>(a, is_bf16 != 0, s);
}
