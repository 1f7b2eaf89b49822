// LayerNorm forward over the last axis for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _fwd_kernel of
// paddle_tpu/ops/fused_layer_norm.py (:42, driven by _fwd_impl :95): per
// row, the f32 mean and the biased variance (two passes: mean first, then
// the mean of squared deviations), y = (x - mean) / sqrt(var + eps),
// times gamma, plus beta (either may be absent). y is written in x's dtype,
// mean and var in f32.
//
// What bounds it on the card: bytes. Each element is read once and written
// once with a handful of f32 operations, far below the card's operations
// per byte. The design gives each row to one warp (8 rows per 256-thread
// block) so the two row reductions are warp shuffles with no shared memory
// and no block barrier; lanes walk the row with a stride of 32 so every
// warp load is one contiguous segment. The second and third passes re-read
// the row through the read-only cache, where the first pass left it (a
// row of D = 768 f32 is 3 KB), so device memory sees about one read and
// one write per element.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ var,
                      int rows, int d, float eps) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  const T* xr = x + (long long)row * d;
  T* yr = y + (long long)row * d;

  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += to_f32(__ldg(xr + c));
  const float mu = warp_sum(s) / d;

  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float xc = to_f32(__ldg(xr + c)) - mu;
    ss = fmaf(xc, xc, ss);
  }
  const float v = warp_sum(ss) / d;
  const float rstd = 1.f / sqrtf(v + eps);

  for (int c = lane; c < d; c += 32) {
    float o = (to_f32(__ldg(xr + c)) - mu) * rstd;
    if (g) o *= __ldg(g + c);
    if (b) o += __ldg(b + c);
    yr[c] = from_f32<T>(o);
  }
  if (lane == 0) {
    mean[row] = mu;
    var[row] = v;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x and y are contiguous [rows, d];
// gamma/beta are f32 [d] or null; mean/var are f32 [rows].
int layer_norm_fwd(const void* x, const void* gamma, const void* beta,
                   void* y, void* mean, void* var, int dtype, int rows,
                   int d, float eps, void* stream) {
  const dim3 grid((rows + WARPS - 1) / WARPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* mu = static_cast<float*>(mean);
  float* vr = static_cast<float*>(var);
  if (dtype == 0) {
    layer_norm_fwd_kernel<float><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const float*>(x), g, b, static_cast<float*>(y), mu, vr,
        rows, d, eps);
  } else if (dtype == 1) {
    layer_norm_fwd_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, b,
        static_cast<__nv_bfloat16*>(y), mu, vr, rows, d, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
