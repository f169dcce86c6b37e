// Windowed 3x3 'SAME' conv (+ bias, optional ReLU) of a phase-major s2d
// tensor: every 2x2 output block is one (16*Cin -> 4*Cout) contraction of the
// 4x4 full-resolution window around it. Replaces
// mingraph_unet_tpu/ops/pallas/wconv.py::wconv3x3_s2d.
//
// Layout. x is (B, Hh, Ww, 4*Cin) s2d, possibly the channel concat of several
// separately transformed groups (the decoder's [skip || up]): group g of
// full-res width G_g starts at s2d channel 4*(G_0 + ... + G_{g-1}) and holds
// phase ph at ph*G_g + c. Window tap d = 4*dy + dx of s2d pixel (I, J) reads
// s2d pixel (I - 1 + pos(dy), J - 1 + pos(dx)) at phase
// (phase(dy), phase(dx)), pos = (0, 1, 1, 2), phase = (1, 0, 1, 0); row
// d*Cin + goff + c of the weights w2 (16*Cin, 4*Cout) multiplies it
// (wconv.py::wconv3x3_weights). Output column ph*Cout + co is the s2d
// output, so the product IS the output block.
// Pixels outside the image read zero (the conv's SAME padding).
//
// bf16, every width: a Hopper kernel (wconv_wgmma_kernel).
//   Bound. The function needs 2*9*Cin*Cout operations a full-res pixel and
//   moves x and y once: at the U-Net's s2d sites the H100's memory line
//   bounds it, except dec-L1 conv1. The windowed form does 16/9 of those
//   operations (its "form floor", 68.8 GFLOP at 64 -> 64: 70 us at the dense
//   bf16 rate). What held the mma.sync kernel back was the weights: every
//   64-pixel tile streamed the whole (16*Cin, 4*Cout) matrix from L2, once a
//   warp, 0.5-2.1 GB a call.
//   Design.
//   - One wgmma.m64nNk16 with N = 4*Cout (padded to 16, 32, 64, 128 or 256;
//     wider outputs run in 256-column blocks) covers all four output phases,
//     so each A fragment is loaded once a tap, not once an output phase.
//   - Block tiles of 128 s2d pixels (N = 256: 8 x 16) or 256 (N <= 128:
//     16 x 16), two consumer warpgroups of 64 rows (one or two m-tiles each),
//     persistent blocks walking the tiles. The weights cross L2 once a block
//     tile: 2-4x less than the mma.sync kernel.
//   - K streams in chunks of 16 input channels, each feeding the 4 window
//     taps of one input phase. Where every group width is a multiple of 16
//     (every U-Net site but the image's), a chunk is one 16-channel step of
//     one (group, phase) block: no operation is wasted. Otherwise (the RGB
//     input's Cin 3, odd test widths) a chunk is 16 consecutive s2d channels
//     taken four times, once per tap phase, with zero weight rows for the
//     channels of the other phases: for Cin <= 4 that is the same work.
//     The wrapper packs w2 into chunks with those zero rows and resolves the
//     group layout into a chunk table (source channel, valid channels,
//     phase, copy size), staged in shared memory once a block.
//   - A producer warpgroup (setmaxnreg hands its registers to the
//     consumers) fills a ring of stages: the chunk's 4 x 16 x N weight slab
//     by one bulk copy and its halo box (TH + 2 rows x 18 columns x 16
//     channels) by one TMA tile load from a 4-D tensor map over x, whose
//     out-of-bounds zeros are the SAME padding, both completing on the
//     stage's mbarrier. The box lands with the 32-byte swizzle
//     (hopper.cuh::swz32), so the 8 rows of an ldmatrix fall in 8 bank
//     groups. Where the pixel stride is not 16-byte aligned (odd widths, no
//     tensor map) the producer threads copy the same layout by cp.async, 8
//     bytes at a time with zero fill. The consumers release a stage on a
//     second mbarrier once their wgmma have read it, so the next chunks'
//     loads overlap this chunk's products.
//   - Epilogue: bias (pre-tiled to the four phases), ReLU flag, bf16 in
//     registers, staged in shared memory and written with 16-byte stores.
//   L2 -> SM weight bytes a call, worked out from the tiling: tiles x chunks
//   x 128*N bytes (chip_smoke.py prints it beside the compulsory bytes).
// f32: SIMT FMA (wconv_simt_kernel), for the card's f32 checks: the halo
//   staged as f32 (at most 512 channels a chunk, so Cin 256 and more fit),
//   one s2d pixel a thread and 16 output columns at a time, weights padded
//   to 16 columns; the group table in device memory.
// Both accumulate in f32 and add the bias, apply ReLU and round once.
#include "conv_tile.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace sm90 = mgu::sm90;

// Tap geometry: window tap row (or column) t in 0..3 reads s2d row
// I - 1 + pos(t) at phase phase(t), i.e. pos = (0, 1, 1, 2) and
// phase = (1, 0, 1, 0) (wconv.py's _POS and _PHASE).
__device__ __forceinline__ int pos(int t) { return (t + 1) >> 1; }
__device__ __forceinline__ int phase(int t) { return (t + 1) & 1; }

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 384;    // two consumer warpgroups, then the producer warpgroup
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;  // setmaxnreg: 128 * 56 + 256 * 224 <= 65536
constexpr int SM90_SHARED = 232448;
constexpr int MAX_STAGES = 8;

template <int NP>
struct WPlan {
  static constexpr int MT = NP <= 128 ? 2 : 1;  // m-tiles (64 rows) a warpgroup
  static constexpr int TH = 8 * MT, TW = 16;     // s2d tile
  static constexpr int HW = TW + 2, HPIX = (TH + 2) * HW;
  static constexpr int A_BYTES = (HPIX * 32 + 1023) / 1024 * 1024;  // 16 channels a pixel, 32-byte swizzle
  static constexpr int B_BYTES = 4 * 16 * NP * 2;  // 4 taps x 16 k x NP columns
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int OS = NP + 8;                // staged output pixel stride
  static constexpr int OUT_BYTES = TH * TW * OS * 2;
  // Bytes beside the ring: the output tile, 2 mbarriers a stage, the chunk table.
  static constexpr int fixed(int nchunks) { return OUT_BYTES + 2 * MAX_STAGES * 8 + nchunks * 16; }
  static constexpr int stages(int nchunks) {
    const int s = (SM90_SHARED - fixed(nchunks)) / STAGE;
    return s < MAX_STAGES ? s : MAX_STAGES;
  }
  static constexpr int bytes(int nchunks) { return stages(nchunks) * STAGE + fixed(nchunks); }
};

struct WgArgs {
  const bf16* x;              // (B, Hh, Ww, c4)
  const unsigned char* w;     // (ncb, nchunks, 4, NP/8, 2, 8, 8) bf16 chunks (wconv.py::wgmma_weight_chunks)
  const float* bias4;         // (4*Cout,) bias tiled to the four phases
  bf16* y;                    // (B, Hh, Ww, 4*Cout)
  const int4* table;          // (nchunks,) (source channel, valid channels, input phase, 0)
  int b, hh, ww, c4, n_out, nchunks, ncb, stages, tiles_w, tiles_h, ntiles;
  int tma;                    // halo chunks by TMA (every group width a multiple of 16), else cp.async
};

struct Tile {
  int cb, bi, i0, j0;
};

template <int NP>
__device__ __forceinline__ Tile decode(const WgArgs& a, int t) {
  Tile r;
  r.cb = t % a.ncb;
  t /= a.ncb;
  r.j0 = (t % a.tiles_w) * WPlan<NP>::TW;
  t /= a.tiles_w;
  r.i0 = (t % a.tiles_h) * WPlan<NP>::TH;
  r.bi = t / a.tiles_h;
  return r;
}

// The producer warpgroup: fills stage after stage with a chunk's weight
// slab (one bulk copy) and its halo box (one TMA load, or cp.async by every
// producer thread), all completing on the stage's `full` barrier.
template <int NP>
__device__ void produce(const WgArgs& a, const CUtensorMap* tmap, unsigned char* ring, uint64_t* full, uint64_t* empty,
                        const int4* table) {
  using P = WPlan<NP>;
  const int ptid = threadIdx.x - CONSUMERS;
  int s = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
    const Tile tl = decode<NP>(a, t);
    const unsigned char* wsrc = a.w + size_t(tl.cb) * a.nchunks * P::B_BYTES;
    const size_t img = size_t(tl.bi) * a.hh;
    for (int k = 0; k < a.nchunks; ++k) {
      sm90::mbar_wait(&empty[s], ph ^ 1);
      unsigned char* as = ring + size_t(s) * P::STAGE;
      const int4 e = table[k];
      if (ptid == 0) {
        sm90::mbar_arrive_expect_tx(&full[s], P::B_BYTES + (a.tma ? P::HPIX * 32 : 0));
        sm90::bulk_copy(as + P::A_BYTES, wsrc + size_t(k) * P::B_BYTES, P::B_BYTES, &full[s]);
        // The halo box: 16 channels x (TW + 2) columns x (TH + 2) rows of one
        // image, from (channel, col, row) = (source, j0 - 1, i0 - 1).
        if (a.tma) sm90::tma_load_4d(as, tmap, e.x, tl.j0 - 1, tl.i0 - 1, tl.bi, &full[s]);
      }
      if (a.tma) {
        sm90::mbar_arrive(&full[s]);
      } else {
        // 8 bytes (4 channels) at a time: an s2d pixel is 8*Cin bytes.
        for (int i = ptid; i < P::HPIX * 4; i += 128) {
          const int pix = i >> 2, u = i & 3;
          const int gi = tl.i0 - 1 + pix / P::HW, gj = tl.j0 - 1 + pix % P::HW;
          const bool in = gi >= 0 && gi < a.hh && gj >= 0 && gj < a.ww;
          const int nb = in ? min(8, max(0, 2 * (e.y - 4 * u))) : 0;
          sm90::cp_async8(as + sm90::swz32(pix, u >> 1) + (u & 1) * 8,
                          nb ? a.x + ((img + gi) * a.ww + gj) * a.c4 + e.x + 4 * u : a.x, nb);
        }
        sm90::cp_async_arrive(&full[s]);
      }
      if (++s == a.stages) {
        s = 0;
        ph ^= 1;
      }
    }
  }
  // Leave only when the consumers have released every stage.
  for (int i = 0; i < a.stages; ++i) {
    sm90::mbar_wait(&empty[s], ph ^ 1);
    if (++s == a.stages) {
      s = 0;
      ph ^= 1;
    }
  }
}

__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

template <int NP, bool RELU>
__device__ void consume(const WgArgs& a, unsigned char* ring, bf16* outs, uint64_t* full, uint64_t* empty,
                        const int4* table) {
  using P = WPlan<NP>;
  constexpr int MT = P::MT, NR = NP / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wp = warp & 3;
  const int lrow = lane & 15;
  const int g = lane >> 2, t4 = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;  // releases the warpgroup's stages
  int s = 0, prev = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < a.ntiles; t += gridDim.x) {
    const Tile tl = decode<NP>(a, t);
    float acc[MT][NR];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[mi][r] = 0.f;
    for (int k = 0; k < a.nchunks; ++k) {
      sm90::mbar_wait(&full[s], ph);
      // The previous chunk's products are done: its A registers may be
      // rewritten and its stage goes back to the producer. (A second
      // register buffer, to overlap this ldmatrix with those products, makes
      // ptxas serialize every wgmma: C7513.)
      sm90::wgmma_wait<0>();
      if (k > 0 && leader) sm90::mbar_arrive(&empty[prev]);
      const int4 e = table[k];
      // The chunk's input phase (py, px) is read by the taps dy with
      // phase(dy) = py: dy in (1, 3) for py = 0 (pos 1, 2), (0, 2) for py = 1
      // (pos 0, 1); likewise dx.
      const int oy = (e.z >> 1) ? 0 : 1, ox = (e.z & 1) ? 0 : 1;
      const unsigned char* as = ring + size_t(s) * P::STAGE;
      const unsigned char* bs = as + P::A_BYTES;
      uint32_t af[4][MT][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const int r = (wg * MT + mi) * 4 + wp;  // the warp's s2d row in the tile
          const int pix = (r + oy + (j >> 1)) * P::HW + lrow + ox + (j & 1);
          sm90::ldmatrix_x4(af[j][mi], reinterpret_cast<const bf16*>(as + sm90::swz32(pix, lane >> 4)));
        }
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t desc = sm90::desc_b(bs + j * 16 * NP * 2);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) sm90::Wgmma<NP>::run(acc[mi], af[j][mi], desc);
      }
      sm90::wgmma_commit();
      prev = s;
      if (++s == a.stages) {
        s = 0;
        ph ^= 1;
      }
    }
    sm90::wgmma_wait<0>();
    if (leader) sm90::mbar_arrive(&empty[prev]);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) sm90::fence_operand(acc[mi]);

    // Epilogue: lane (g, t4) holds pixels g and g + 8 of its row in each
    // m-tile, columns 8j + 2*t4 and 8j + 2*t4 + 1 of the column block.
    const int col0 = tl.cb * 256;
    const int ncols = min(NP, a.n_out - col0);
    consumer_sync();  // the last tile's stores have read the staging buffer
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const int n = 8 * j + 2 * t4;
      const float b0 = n < ncols ? __ldg(a.bias4 + col0 + n) : 0.f;
      const float b1 = n + 1 < ncols ? __ldg(a.bias4 + col0 + n + 1) : 0.f;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (wg * MT + mi) * 4 + wp;
          float v0 = acc[mi][4 * j + 2 * h] + b0, v1 = acc[mi][4 * j + 2 * h + 1] + b1;
          if (RELU) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(outs + (r * P::TW + g + 8 * h) * P::OS + n) = __floats2bfloat162_rn(v0, v1);
        }
    }
    consumer_sync();
    const int ctid = threadIdx.x;  // 0..255
    if (a.n_out % 8 == 0) {        // 16-byte stores, each tile row's pixels one after another
      const int vpp = ncols / 8;
      for (int i = ctid; i < P::TH * P::TW * vpp; i += 256) {
        const int v = i % vpp, pix = i / vpp;
        const int gi = tl.i0 + pix / P::TW, gj = tl.j0 + pix % P::TW;
        if (gi < a.hh && gj < a.ww)
          *reinterpret_cast<uint4*>(a.y + ((size_t(tl.bi) * a.hh + gi) * a.ww + gj) * a.n_out + col0 + 8 * v) =
              *reinterpret_cast<const uint4*>(outs + pix * P::OS + 8 * v);
      }
    } else {
      for (int i = ctid; i < P::TH * P::TW * ncols; i += 256) {
        const int n = i % ncols, pix = i / ncols;
        const int gi = tl.i0 + pix / P::TW, gj = tl.j0 + pix % P::TW;
        if (gi < a.hh && gj < a.ww)
          a.y[((size_t(tl.bi) * a.hh + gi) * a.ww + gj) * a.n_out + col0 + n] = outs[pix * P::OS + n];
      }
    }
  }
}

template <int NP, bool RELU>
__global__ void __launch_bounds__(WG_THREADS, 1) wconv_wgmma_kernel(WgArgs a, const __grid_constant__ CUtensorMap tmap) {
  // Registers move from the producer warpgroup to the consumers (setmaxnreg):
  // the launch gives every thread 168, the consumers' accumulators (up to
  // 128 a thread) and A fragments need more, the producer far fewer.
  using P = WPlan<NP>;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  bf16* outs = reinterpret_cast<bf16*>(smem + size_t(a.stages) * P::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + size_t(a.stages) * P::STAGE + P::OUT_BYTES);
  uint64_t* empty = full + MAX_STAGES;
  int4* table = reinterpret_cast<int4*>(empty + MAX_STAGES);
  for (int i = threadIdx.x; i < a.nchunks; i += WG_THREADS) table[i] = a.table[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      sm90::mbar_init(&full[s], 129);  // each producer thread, and the expected bytes of the copies
      sm90::mbar_init(&empty[s], 2);  // one release a consumer warpgroup
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    produce<NP>(a, &tmap, ring, full, empty, table);
  } else {
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    consume<NP, RELU>(a, ring, outs, full, empty, table);
  }
}

// The halo's tensor map: x as (c4, Ww, Hh, B), a box of 16 channels x
// (TW + 2) x (TH + 2) x 1 with the 32-byte swizzle, zeros out of bounds.
template <int NP>
bool halo_map(CUtensorMap* m, const WgArgs& a) {
  using P = WPlan<NP>;
  const cuuint32_t box[4] = {16, P::HW, P::TH + 2, 1};
  return sm90::nhwc_map(m, a.x, a.b, a.hh, a.ww, a.c4, box, CU_TENSOR_MAP_SWIZZLE_32B);
}

template <int NP, bool RELU>
int launch_wgmma_np(WgArgs a, cudaStream_t stream) {
  using P = WPlan<NP>;
  a.tiles_w = (a.ww + P::TW - 1) / P::TW;
  a.tiles_h = (a.hh + P::TH - 1) / P::TH;
  a.ntiles = a.ncb * a.b * a.tiles_w * a.tiles_h;
  a.stages = P::stages(a.nchunks);
  if (a.ntiles == 0) return 0;
  if (a.stages < 2) return int(cudaErrorInvalidValue);
  const int bytes = P::bytes(a.nchunks);
  cudaError_t err = cudaFuncSetAttribute(wconv_wgmma_kernel<NP, RELU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = a.ntiles < sms ? a.ntiles : sms;  // one block a SM: the plan takes its shared memory
  CUtensorMap tmap = {};
  if (a.tma && !halo_map<NP>(&tmap, a)) return int(cudaErrorInvalidValue);
  wconv_wgmma_kernel<NP, RELU><<<grid, WG_THREADS, bytes, stream>>>(a, tmap);
  return int(cudaGetLastError());
}

template <bool RELU>
int launch_wgmma(const WgArgs& a, int np, cudaStream_t stream) {
  switch (np) {
    case 16: return launch_wgmma_np<16, RELU>(a, stream);
    case 32: return launch_wgmma_np<32, RELU>(a, stream);
    case 64: return launch_wgmma_np<64, RELU>(a, stream);
    case 128: return launch_wgmma_np<128, RELU>(a, stream);
    case 256: return launch_wgmma_np<256, RELU>(a, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// f32: SIMT
// ---------------------------------------------------------------------------

using mgu::HALO_PIX;
using mgu::HALO_W;
using mgu::TH;
using mgu::THREADS;
using mgu::TW;
constexpr int SIMT_N = 16;  // output columns per SIMT pass (weights padded to it)

struct SimtArgs {
  const float* x;     // (B, Hh, Ww, 4*Cin) s2d
  const float* w;     // (16*Cin, npad)
  const float* bias;  // (Cout,) full-res bias
  float* y;           // (B, Hh, Ww, 4*Cout) s2d
  int b, hh, ww, cin, cout, npad;
  int ngroups;
  const int* groups;  // (ngroups,) full-res group widths, in device memory
  int kch;            // s2d channels staged per chunk
};

// Staged f32 pixel stride for a chunk of nch channels: nch + 1 words, so
// the 32 pixels a warp reads at one channel fall in 32 different banks.
__host__ __device__ inline int simt_stride(int nch) { return nch + 1; }

template <bool RELU>
__global__ void __launch_bounds__(THREADS) wconv_simt_kernel(SimtArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* halo = reinterpret_cast<float*>(smem);
  const int c4 = 4 * a.cin, ss = simt_stride(a.kch);
  const int nchunk = (c4 + a.kch - 1) / a.kch;
  const int bi = blockIdx.z, i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;

  const int p = threadIdx.x % (TH * TW), cg = threadIdx.x / (TH * TW);  // 4 column groups
  const int i = p / TW, j = p % TW;
  const int gi = i0 + i, gj = j0 + j;
  const int n_out = 4 * a.cout;
  // Every thread runs the same number of passes, so the barriers of the
  // chunked staging are reached by all.
  const int npass = (a.npad / SIMT_N + THREADS / (TH * TW) - 1) / (THREADS / (TH * TW));
  for (int pass = 0; pass < npass; ++pass) {
    const int n0 = (pass * (THREADS / (TH * TW)) + cg) * SIMT_N;
    float acc[SIMT_N];
#pragma unroll
    for (int q = 0; q < SIMT_N; ++q) acc[q] = 0.f;
    for (int ck = 0; ck < nchunk; ++ck) {
      const int c0 = ck * a.kch, c1 = min(c4, c0 + a.kch), nch = c1 - c0;
      if (nchunk > 1 || pass == 0) {  // one chunk stays staged for every pass
        __syncthreads();
        for (int e = threadIdx.x; e < HALO_PIX * nch; e += THREADS) {
          const int pix = e / nch, c = e % nch;
          const int hi = i0 - 1 + pix / HALO_W, hj = j0 - 1 + pix % HALO_W;
          float v = 0.f;
          if (hi >= 0 && hi < a.hh && hj >= 0 && hj < a.ww)
            v = a.x[((size_t(bi) * a.hh + hi) * a.ww + hj) * size_t(c4) + c0 + c];
          halo[pix * ss + c] = v;
        }
        __syncthreads();
      }
      if (n0 >= a.npad) continue;
      for (int d = 0; d < 16; ++d) {
        const int dy = d >> 2, dx = d & 3;
        const int ph = phase(dy) * 2 + phase(dx);
        const float* pix = halo + ((i + pos(dy)) * HALO_W + j + pos(dx)) * ss - c0;
        int off = 0, goff = 0;
        for (int g = 0; g < a.ngroups; ++g) {
          const int gw = __ldg(a.groups + g);
          // The channels of this group and phase that lie in the chunk.
          const int base = off + ph * gw;
          const int lo = max(0, c0 - base), hi = min(gw, c1 - base);
          const float* src = pix + base;
          const float* wk = a.w + size_t(d * a.cin + goff) * a.npad + n0;
          for (int c = lo; c < hi; ++c) {
            const float v = src[c];
            const float4* w4 = reinterpret_cast<const float4*>(wk + size_t(c) * a.npad);
#pragma unroll
            for (int q = 0; q < SIMT_N / 4; ++q) {
              const float4 wv = __ldg(w4 + q);
              acc[4 * q] = fmaf(v, wv.x, acc[4 * q]);
              acc[4 * q + 1] = fmaf(v, wv.y, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(v, wv.z, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(v, wv.w, acc[4 * q + 3]);
            }
          }
          off += 4 * gw;
          goff += gw;
        }
      }
    }
    if (n0 >= a.npad) continue;
    if (gi < a.hh && gj < a.ww) {
      float* out = a.y + ((size_t(bi) * a.hh + gi) * a.ww + gj) * size_t(n_out);
#pragma unroll
      for (int q = 0; q < SIMT_N; ++q) {
        const int n = n0 + q;
        if (n < n_out) {
          const float v = acc[q] + a.bias[n % a.cout];
          out[n] = RELU ? fmaxf(v, 0.f) : v;
        }
      }
    }
  }
}

}  // namespace

// bf16 on `stream`; returns cudaGetLastError() after the launch. w: the
// (ncb, nchunks, 4, 16, np) weight chunks in wgmma B layout
// (wconv.py::wgmma_weight_chunks), np in {16, 32, 64, 128, 256} and
// ncb = ceil(4*Cout / 256) column blocks; bias4: (4*Cout,) f32; table: the
// (nchunks, 4) int32 chunk table in device memory; tma: every group width a
// multiple of 16 (the halo by TMA), else 0 (by cp.async).
extern "C" int mgu_wconv3x3_wgmma(const void* x, const void* w, const float* bias4, void* y, int b, int hh, int ww,
                                  int cin, int cout, int np, int ncb, int nchunks, const int* table, int tma, int relu,
                                  void* stream) {
  if (nchunks < 1) return int(cudaErrorInvalidValue);
  WgArgs a{static_cast<const bf16*>(x), static_cast<const unsigned char*>(w), bias4, static_cast<bf16*>(y),
           reinterpret_cast<const int4*>(table), b, hh, ww, 4 * cin, 4 * cout, nchunks, ncb, 0, 0, 0, 0, tma != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return relu ? launch_wgmma<true>(a, np, s) : launch_wgmma<false>(a, np, s);
}

// f32 on `stream`: weights (16*Cin, npad) f32, `groups` the (ngroups,) int32
// table of group widths in device memory.
extern "C" int mgu_wconv3x3_simt(const void* x, const void* w, const float* bias, void* y, int b, int hh, int ww,
                                 int cin, int cout, int npad, int ngroups, const int* groups, int relu, void* stream) {
  if (ngroups < 1) return int(cudaErrorInvalidValue);
  const int c4 = 4 * cin, kch = c4 <= 512 ? c4 : 512;
  SimtArgs a{static_cast<const float*>(x), static_cast<const float*>(w), bias, static_cast<float*>(y), b, hh, ww,
             cin, cout, npad, ngroups, groups, kch};
  const size_t bytes = size_t(HALO_PIX) * simt_stride(kch) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return relu ? mgu::launch(wconv_simt_kernel<true>, a, bytes, s) : mgu::launch(wconv_simt_kernel<false>, a, bytes, s);
}
