// The second launch of conv_moments, shared by fused_conv.cu (its f32 and
// bf16 mma.sync forms) and fused_conv_wgmma.cu (the bf16 wgmma form): the
// per-channel sums of the conv kernels' [tiles, 2, O] partial rows, one
// row per pixel tile, added in a fixed order so that the moments are the
// same from run to run (no atomics).
#pragma once

#include <cuda_runtime.h>

namespace {

// sums[c] = sum over tiles of partial[t, c], c < cols = 2 * O. A block of 32
// warps covers 32 columns: warp w sums tiles w, w + 32, ... (lanes read
// neighbouring columns), then warp 0 adds the warps in order.
__global__ void __launch_bounds__(1024)
moments_reduce(const float* __restrict__ partial, float* __restrict__ sums,
               int tiles, int cols) {
  __shared__ float red[32][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < cols)
    for (int t = warp; t < tiles; t += 32)
      s += partial[(long long)t * cols + c];
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || c >= cols) return;
  float tot = 0.f;
  for (int i = 0; i < 32; ++i) tot += red[i][lane];
  sums[c] = tot;
}

// launch moments_reduce over `tiles` partial rows of 2 * O columns
inline cudaError_t launch_moments_reduce(const float* partial, float* sums,
                                         int tiles, int O, cudaStream_t s) {
  const int cols = 2 * O;
  moments_reduce<<<(cols + 31) / 32, 1024, 0, s>>>(partial, sums, tiles,
                                                   cols);
  return cudaGetLastError();
}

}  // namespace
