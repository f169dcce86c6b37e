// Whether a TMA box with the 128-byte swizzle may land in shared memory at
// an offset that is a multiple of 128 bytes but not of 1024, and whether it
// then lands in the layout of mingraph_unet_tpu_torch/csrc/hopper.cuh::swz128
// counted from the 1024-byte-aligned base (the swizzle taken from the
// absolute address bits). psel_conv.cu stages the rows of a tile's halo at
// HALO_W * 128 = 2304-byte steps, one box a row where a shard's neighbour
// row takes the place of a row of x.
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O2 \
//          -I mingraph_unet_tpu_torch/csrc -o outputs/tma_row_probe tools/tma_row_probe.cu \
//       && outputs/tma_row_probe
//
// Prints one line a case ("ok" or the first mismatch) and exits 0 only when
// every case lands where swz128 says; then the host µs of one tensor-map
// encode (hopper.cuh::nhwc_map, as a launch of the psel kernel makes one to
// four) over 100000 encodes.
#include <chrono>
#include <cstdio>
#include <vector>

#include "hopper.cuh"

namespace sm90 = mgu::sm90;
using bf16 = __nv_bfloat16;

constexpr int HALO_W = 18, C = 64, H = 12, W = 40;
constexpr int SMEM = 16 * 1024;

// One box of `rows` rows x HALO_W pixels x 64 channels from (row0, col0)
// into byte `dst_off` of a 1024-aligned buffer; the buffer, read back
// through swz128 from pixel dst_off / 128 on, is written to `out`.
__global__ void probe(const __grid_constant__ CUtensorMap map, int rows, int row0, int col0, int dst_off,
                      bf16* out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + SMEM - 64);  // past every box
  if (threadIdx.x == 0 && (sm90::smem_u32(smem) & 1023)) __trap();
  for (int i = threadIdx.x; i < SMEM / 16; i += blockDim.x) reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(bar, rows * HALO_W * 128);
    sm90::tma_load_4d(smem + dst_off, &map, 0, col0, row0, 0, bar);
  }
  sm90::mbar_wait(bar, 0);
  const int p0 = dst_off / 128;
  for (int i = threadIdx.x; i < rows * HALO_W * 8; i += blockDim.x) {
    const int ck = i & 7, pix = i >> 3;
    reinterpret_cast<uint4*>(out)[i] = *reinterpret_cast<const uint4*>(smem + sm90::swz128(p0 + pix, ck));
  }
}

int main() {
  std::vector<bf16> host(H * W * C);
  for (int i = 0; i < H * W * C; ++i) host[i] = __float2bfloat16(float(i % 4093));
  bf16 *x, *out;
  cudaMalloc(&x, host.size() * 2);
  cudaMalloc(&out, 8 * HALO_W * C * 2);
  cudaMemcpy(x, host.data(), host.size() * 2, cudaMemcpyHostToDevice);
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  struct Case {
    int rows, dst_off;
  } cases[] = {{1, 0}, {1, 2304}, {1, 4608}, {1, 6912}, {1, 9216}, {5, 2304}, {3, 128}};
  int bad = 0;
  for (const Case& cs : cases) {
    CUtensorMap map;
    const cuuint32_t box[4] = {64, HALO_W, cuuint32_t(cs.rows), 1};
    if (!sm90::nhwc_map(&map, x, 1, H, W, C, box, CU_TENSOR_MAP_SWIZZLE_128B)) {
      std::printf("rows %d at %d: cuTensorMapEncodeTiled refused the map\n", cs.rows, cs.dst_off);
      return 2;
    }
    const int row0 = 3, col0 = 5;
    cudaMemset(out, 0, 8 * HALO_W * C * 2);
    probe<<<1, 128, SMEM>>>(map, cs.rows, row0, col0, cs.dst_off, out);
    cudaError_t err = cudaDeviceSynchronize();
    if (err != cudaSuccess) {
      std::printf("rows %d at byte %d: %s\n", cs.rows, cs.dst_off, cudaGetErrorString(err));
      return 3;  // the context is lost: no later case can run
    }
    std::vector<bf16> got(cs.rows * HALO_W * C);
    cudaMemcpy(got.data(), out, got.size() * 2, cudaMemcpyDeviceToHost);
    int first = -1;
    for (int i = 0; i < int(got.size()) && first < 0; ++i) {
      const int c = i % C, px = i / C % HALO_W, r = i / C / HALO_W;
      const float want = __bfloat162float(host[((row0 + r) * W + col0 + px) * C + c]);
      if (__bfloat162float(got[i]) != want) first = i;
    }
    if (first < 0) {
      std::printf("rows %d at byte %d: ok\n", cs.rows, cs.dst_off);
    } else {
      ++bad;
      std::printf("rows %d at byte %d: element %d differs\n", cs.rows, cs.dst_off, first);
    }
  }
  std::printf("%s\n", bad ? "MISMATCH" : "ALL OK");
  const cuuint32_t box[4] = {64, HALO_W, 6, 1};
  CUtensorMap map;
  constexpr int N = 100000;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < N; ++i) sm90::nhwc_map(&map, x, 1 + (i & 1), H, W, C, box, CU_TENSOR_MAP_SWIZZLE_128B);
  const double us = std::chrono::duration<double, std::micro>(std::chrono::steady_clock::now() - t0).count() / N;
  std::printf("encode: %.3f us a map\n", us);
  return bad ? 1 : 0;
}
