// LayerNorm backward over the last axis for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel _bwd_kernel of
// paddle_tpu/ops/fused_layer_norm.py (:57, driven by _bwd_impl :142). From
// the forward's saved per-row mean and biased variance:
//   rstd = 1 / sqrt(var + eps), xhat = (x - mean) * rstd,
//   g    = dy * gamma (dy when gamma is absent),
//   dx   = rstd * (g - mean(g) - xhat * mean(g * xhat)),
//   dgamma = sum over rows of dy * xhat, dbeta = sum over rows of dy.
//
// What bounds it on the card: bytes. x and dy are read once and dx written
// once per element, with a dozen f32 operations each. The design:
//   * dx: one warp per row, as the forward; the two row means are warp
//     shuffles, and the second and third passes over the row re-read x and
//     dy through the read-only cache where the first pass left them;
//   * dgamma/dbeta are sums over every row, and blocks run in no order, so
//     the TPU kernel's accumulation across its sequential grid becomes two
//     launches: (1) each block walks a contiguous range of rows and each
//     warp adds its rows' dy * xhat and dy into its own row of shared
//     memory (a lane owns columns lane, lane + 32, ...: no atomics), then
//     the block sums its warps into one partial row of [nblocks, D];
//     (2) the partials are summed per column in a fixed order.
//     The result is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// partial: [gridDim.x, 2, d] (dgamma partials, then dbeta partials)
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_bwd_rows(const float* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ dy,
                    const float* __restrict__ mean,
                    const float* __restrict__ var, float* __restrict__ dx,
                    float* __restrict__ partial, int rows, int d,
                    int rows_per_block, float eps) {
  extern __shared__ float acc[];  // [WARPS][2][d]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ag = acc + warp * 2 * d;
  float* ab = ag + d;
  for (int c = lane; c < d; c += 32) ag[c] = ab[c] = 0.f;

  const int r_begin = blockIdx.x * rows_per_block;
  const int r_end = min(rows, r_begin + rows_per_block);
  const float inv_d = 1.f / d;
  for (int row = r_begin + warp; row < r_end; row += WARPS) {
    const float* xr = x + (long long)row * d;
    const float* dyr = dy + (long long)row * d;
    const float mu = __ldg(mean + row);
    const float rstd = 1.f / sqrtf(__ldg(var + row) + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float xh = (__ldg(xr + c) - mu) * rstd;
      const float dyv = __ldg(dyr + c);
      const float g = gamma ? dyv * __ldg(gamma + c) : dyv;
      s1 += g;
      s2 = fmaf(g, xh, s2);
      ag[c] = fmaf(dyv, xh, ag[c]);
      ab[c] += dyv;
    }
    const float m1 = warp_sum(s1) * inv_d, m2 = warp_sum(s2) * inv_d;
    float* dxr = dx + (long long)row * d;
    for (int c = lane; c < d; c += 32) {
      const float xh = (__ldg(xr + c) - mu) * rstd;
      const float dyv = __ldg(dyr + c);
      const float g = gamma ? dyv * __ldg(gamma + c) : dyv;
      dxr[c] = rstd * (g - m1 - xh * m2);
    }
  }
  __syncthreads();
  float* out = partial + (long long)blockIdx.x * 2 * d;
  for (int c = threadIdx.x; c < 2 * d; c += WARPS * 32) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += acc[w * 2 * d + c];
    out[c] = s;
  }
}

// grid: one block per 32 columns of the [nblocks, 2 * d] partials; warp w
// sums partial rows w, w + WARPS, ... and the block adds its warps in order
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_bwd_params(const float* __restrict__ partial,
                      float* __restrict__ dgamma, float* __restrict__ dbeta,
                      int nblocks, int d) {
  __shared__ float red[WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < 2 * d)
    for (int i = warp; i < nblocks; i += WARPS)
      s += partial[(long long)i * 2 * d + c];
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || c >= 2 * d) return;
  for (int w = 1; w < WARPS; ++w) s += red[w][lane];
  if (c < d) {
    if (dgamma) dgamma[c] = s;
  } else if (dbeta) {
    dbeta[c - d] = s;
  }
}

}  // namespace

extern "C" {

// f32 only. x, dy, dx: contiguous [rows, d]; gamma: [d] or null;
// mean, var: [rows]; dgamma, dbeta: [d] or null; partial: scratch of
// nblocks * 2 * d floats. Two launches on `stream`.
int layer_norm_bwd(const void* x, const void* gamma, const void* dy,
                   const void* mean, const void* var, void* dx, void* dgamma,
                   void* dbeta, void* partial, int rows, int d, int nblocks,
                   float eps, void* stream) {
  if (rows <= 0 || d <= 0 || nblocks <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * WARPS * 2 * d;
  cudaError_t err = cudaFuncSetAttribute(
      layer_norm_bwd_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const int rows_per_block = (rows + nblocks - 1) / nblocks;
  layer_norm_bwd_rows<<<nblocks, WARPS * 32, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(dy), static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<float*>(dx),
      static_cast<float*>(partial), rows, d, rows_per_block, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layer_norm_bwd_params<<<(2 * d + 31) / 32, WARPS * 32, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), nblocks, d);
  return cudaGetLastError();
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
