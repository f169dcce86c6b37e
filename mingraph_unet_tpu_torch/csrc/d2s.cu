// Depth-to-space of a phase-major s2d tensor: (B, Hh, Ww, 4C) -> (B, 2Hh, 2Ww, C),
// out[b, 2i+py, 2j+px, c] = in[b, i, j, (2*py+px)*C + c]. A pure permutation.
// Replaces mingraph_unet_tpu/ops/pallas/pool.py::depth_to_space_pallas.
//
// Bound: memory. It reads each input byte once and writes each output byte
// once and computes nothing.
// Design: one thread per 16-byte vector of the output, threads numbered in
// output order, so a warp writes 512 contiguous bytes. Output row (b, 2i+py)
// is laid out as (j, px, chunk); for one j the two phases px = 0, 1 are the
// adjacent groups 2*py and 2*py+1 of input pixel (b, i, j), so a warp's reads
// are 2C-contiguous runs. The copy is in units of 16 bytes and does not look
// at the element type: C*itemsize must be a multiple of 16 and both pointers
// 16-byte aligned (the wrapper checks).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void depth_to_space_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                                      long long rows, int ww, int nv) {
  // nv: 16-byte vectors per phase group (C*itemsize / 16).
  const long long per_row = 2LL * ww * nv;  // vectors in one output row
  const long long total = rows * per_row;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long row = t / per_row;      // (b*Hh + i)*2 + py
    const long long r = t - row * per_row;  // (2j + px)*nv + v
    const long long bi = row >> 1;          // b*Hh + i
    const int py = int(row & 1);
    const long long col = r / nv;           // 2j + px
    const int v = int(r - col * nv);
    const long long j = col >> 1;
    const int px = int(col & 1);
    y[t] = x[(bi * ww + j) * 4 * nv + (2 * py + px) * nv + v];
  }
}

}  // namespace

extern "C" int mgu_depth_to_space(const void* x, void* y, int b, int hh, int ww, int nv, void* stream) {
  const long long rows = 2LL * b * hh;
  const long long total = rows * 2LL * ww * nv;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 blocks per SM
  if (blocks < 1) blocks = 1;
  depth_to_space_kernel<<<unsigned(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), rows, ww, nv);
  return int(cudaGetLastError());
}
