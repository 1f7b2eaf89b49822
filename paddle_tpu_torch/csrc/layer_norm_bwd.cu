// LayerNorm backward over the last axis for Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernel _bwd_kernel of
// paddle_tpu/ops/fused_layer_norm.py (:57, driven by _bwd_impl :142). From
// the forward's saved per-row mean and biased variance:
//   rstd = 1 / sqrt(var + eps), xhat = (x - mean) * rstd,
//   g    = dy * gamma (dy when gamma is absent),
//   dx   = rstd * (g - mean(g) - xhat * mean(g * xhat)),
//   dgamma = sum over rows of dy * xhat, dbeta = sum over rows of dy.
// bf16 x and dy (AMP): everything is computed in f32 and dx is rounded to
// bf16 once (the reference's dx in x's dtype, :71, :194, :219); mean, var,
// gamma, dgamma and dbeta are f32.
//
// What bounds it on the card: bytes. x and dy are read once and dx written
// once per element, with a dozen f32 operations each. The design:
//   * dx: one warp per row, as the forward; the two row means are warp
//     shuffles, and the second pass over the row re-reads x and dy through
//     the read-only cache where the first pass left them;
//   * a lane moves VEC elements at a time: 8 bf16 in one 16-byte load or
//     store where D % 8 == 0 and the rows are 16-byte aligned (x, dy and dx
//     come from the allocator; the wrapper passes them whole), else one;
//     f32 moves one (its form predates the bf16 one and is kept as timed);
//   * dgamma/dbeta are sums over every row, and blocks run in no order, so
//     the TPU kernel's accumulation across its sequential grid becomes two
//     launches: (1) each block walks a contiguous range of rows and each
//     warp adds its rows' dy * xhat and dy into its own row of shared
//     memory (a lane owns its VEC columns of each 32 * VEC: no atomics;
//     with VEC = 8 column 8v + i sits at i * D / 8 + v, so the lanes of a
//     warp touch consecutive words), then the block sums its warps into
//     one partial row of [nblocks, D];
//     (2) the partials are summed per column in a fixed order.
//     The result is deterministic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// VEC consecutive elements of a row as f32, and back
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  static_assert(VEC == 1, "f32 moves one element");
  v[0] = __ldg(p);
}
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 8) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    static_assert(VEC == 1, "bf16 moves 8 elements or one");
    v[0] = __bfloat162float(p[0]);
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  p[0] = v[0];
}
template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC == 8) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// the shared-memory slot of column c of a row of d accumulators: VEC = 8
// stores element i of vector v at i * d / 8 + v (d % 8 == 0), so lane v's
// accesses to element i are consecutive across the warp
template <int VEC>
__device__ __forceinline__ int acc_slot(int c, int d) {
  if constexpr (VEC == 8) return (c & 7) * (d >> 3) + (c >> 3);
  return c;
}

// partial: [gridDim.x, 2, d] (dgamma partials, then dbeta partials)
template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_bwd_rows(const T* __restrict__ x, const float* __restrict__ gamma,
                    const T* __restrict__ dy, const float* __restrict__ mean,
                    const float* __restrict__ var, T* __restrict__ dx,
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
    const T* xr = x + (long long)row * d;
    const T* dyr = dy + (long long)row * d;
    const float mu = __ldg(mean + row);
    const float rstd = 1.f / sqrtf(__ldg(var + row) + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      float xv[VEC], dyv[VEC];
      load_vec<VEC>(xr + c, xv);
      load_vec<VEC>(dyr + c, dyv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xh = (xv[i] - mu) * rstd;
        const float g = gamma ? dyv[i] * __ldg(gamma + c + i) : dyv[i];
        s1 += g;
        s2 = fmaf(g, xh, s2);
        const int k = acc_slot<VEC>(c + i, d);
        ag[k] = fmaf(dyv[i], xh, ag[k]);
        ab[k] += dyv[i];
      }
    }
    const float m1 = warp_sum(s1) * inv_d, m2 = warp_sum(s2) * inv_d;
    T* dxr = dx + (long long)row * d;
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      float xv[VEC], dyv[VEC], out[VEC];
      load_vec<VEC>(xr + c, xv);
      load_vec<VEC>(dyr + c, dyv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xh = (xv[i] - mu) * rstd;
        const float g = gamma ? dyv[i] * __ldg(gamma + c + i) : dyv[i];
        out[i] = rstd * (g - m1 - xh * m2);
      }
      store_vec<VEC>(dxr + c, out);
    }
  }
  __syncthreads();
  float* out = partial + (long long)blockIdx.x * 2 * d;
  for (int c = threadIdx.x; c < 2 * d; c += WARPS * 32) {
    const int k = c < d ? acc_slot<VEC>(c, d) : d + acc_slot<VEC>(c - d, d);
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += acc[w * 2 * d + k];
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

template <typename T, int VEC>
cudaError_t launch_rows(const void* x, const void* gamma, const void* dy,
                        const void* mean, const void* var, void* dx,
                        void* partial, int rows, int d, int nblocks,
                        float eps, cudaStream_t s) {
  const size_t smem = sizeof(float) * WARPS * 2 * d;
  cudaError_t err = cudaFuncSetAttribute(
      layer_norm_bwd_rows<T, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int rows_per_block = (rows + nblocks - 1) / nblocks;
  layer_norm_bwd_rows<T, VEC><<<nblocks, WARPS * 32, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const T*>(dy), static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<T*>(dx),
      static_cast<float*>(partial), rows, d, rows_per_block, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dy and dx). x, dy, dx: contiguous
// [rows, d]; gamma: f32 [d] or null; mean, var: f32 [rows]; dgamma,
// dbeta: f32 [d] or null; partial: scratch of nblocks * 2 * d floats. Two
// launches on `stream`.
int layer_norm_bwd(const void* x, const void* gamma, const void* dy,
                   const void* mean, const void* var, void* dx, void* dgamma,
                   void* dbeta, void* partial, int dtype, int rows, int d,
                   int nblocks, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || nblocks <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_rows<float, 1>(x, gamma, dy, mean, var, dx, partial, rows,
                                d, nblocks, eps, s);
  } else if (dtype == 1) {
    const bool wide = d % 8 == 0 && aligned16(x) && aligned16(dy) &&
                      aligned16(dx);
    err = wide ? launch_rows<__nv_bfloat16, 8>(x, gamma, dy, mean, var, dx,
                                               partial, rows, d, nblocks,
                                               eps, s)
               : launch_rows<__nv_bfloat16, 1>(x, gamma, dy, mean, var, dx,
                                               partial, rows, d, nblocks,
                                               eps, s);
  } else {
    return cudaErrorInvalidValue;
  }
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
