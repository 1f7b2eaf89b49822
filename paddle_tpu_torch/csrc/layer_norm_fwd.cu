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
// per byte. One warp takes one row, so the two row reductions are warp
// shuffles with no shared memory and no block barrier. The design, so
// that the memory system stays busy even when the rows are few (a served
// batch of 1,024 rows is about 8 warps an SM):
//
// * The row in registers. Each lane holds VPL vectors of the row, lane j
//   the vectors j, j + 32, ... (so every warp load is one contiguous
//   segment), all loaded before the first is used, together with its
//   vectors of gamma and beta where those fit (24 floats a lane each;
//   wider rows load them after the statistics, from the cache). Both
//   passes of the statistics run from
//   registers, and y is written from them: x is read from memory once.
// * 16-byte traffic. Where D is a multiple of the vector (4 f32 or 8
//   bf16) and x, y, gamma and beta are 16-byte aligned (VEC), a vector is
//   16 bytes: one 128-bit load or store a lane. Any other D runs the same
//   code on single elements.
// * A row wider than 8 vectors a lane (VPL = 0) is walked three times, as
//   the register-resident form would hold too much: sum, squared
//   deviations, output, re-reading the row through the read-only cache.
// * Statistics of the shifted row. Both passes run on x - c, c the row's
//   first element: x - c is exact where x is within a factor two of c,
//   so a mean that is large against the row's spread rounds at the scale
//   of the spread, not of the mean, before x - mean is formed; mean = c +
//   the shifted mean, and y = ((x - c) - shifted mean) * rstd.
//
// The plan (element width, VPL, warps a block, grid) comes from
// ops/fused_layer_norm.py ln_fwd_plan; the C entry refuses an inconsistent
// one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// A vector of E elements of T as it sits in memory (S), and its floats.
template <typename T, bool VEC> struct Pack;
template <> struct Pack<float, false> {
  static constexpr int E = 1;
  using S = float;
  static __device__ __forceinline__ void unpack(S s, float (&f)[E]) {
    f[0] = s;
  }
  static __device__ __forceinline__ S pack(const float (&f)[E]) {
    return f[0];
  }
};
template <> struct Pack<__nv_bfloat16, false> {
  static constexpr int E = 1;
  using S = __nv_bfloat16;
  static __device__ __forceinline__ void unpack(S s, float (&f)[E]) {
    f[0] = __bfloat162float(s);
  }
  static __device__ __forceinline__ S pack(const float (&f)[E]) {
    return __float2bfloat16(f[0]);
  }
};
template <> struct Pack<float, true> {
  static constexpr int E = 4;
  using S = float4;
  static __device__ __forceinline__ void unpack(S s, float (&f)[E]) {
    f[0] = s.x;
    f[1] = s.y;
    f[2] = s.z;
    f[3] = s.w;
  }
  static __device__ __forceinline__ S pack(const float (&f)[E]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Pack<__nv_bfloat16, true> {
  static constexpr int E = 8;
  using S = uint4;
  // a bf16 is the high half of the f32 with the same bits
  static __device__ __forceinline__ void unpack(S s, float (&f)[E]) {
    const unsigned w[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ S pack(const float (&f)[E]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16(f[2 * i])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1]))
              << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// E consecutive f32 of gamma or beta starting at element e0 (16-byte
// aligned when VEC)
template <int E>
__device__ __forceinline__ void load_param(const float* __restrict__ p,
                                           int e0, float (&f)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + e0 + i));
      f[i] = t.x;
      f[i + 1] = t.y;
      f[i + 2] = t.z;
      f[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) f[i] = __ldg(p + e0 + i);
  }
}

template <int E>
__device__ __forceinline__ void normalize(float (&f)[E], float c, float ms,
                                          float rstd, const float (&g)[E],
                                          const float (&b)[E], bool has_g,
                                          bool has_b) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    float o = ((f[i] - c) - ms) * rstd;
    if (has_g) o *= g[i];
    if (has_b) o += b[i];
    f[i] = o;
  }
}

// A block of 1-8 warps, one row a warp. Gamma and beta are loaded beside
// x where they fit in 24 floats a lane each, else after the statistics.
template <typename T, bool VEC, int VPL>
__global__ void __launch_bounds__(256)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ var,
                      int rows, int d, float eps) {
  using P = Pack<T, VEC>;
  using S = typename P::S;
  constexpr int E = P::E;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  const int nv = d / E;     // vectors in the row (E divides d when VEC)
  const S* __restrict__ xr =
      reinterpret_cast<const S*>(x + (long long)row * d);
  S* __restrict__ yr = reinterpret_cast<S*>(y + (long long)row * d);
  const bool has_g = g != nullptr, has_b = b != nullptr;
  float c = 0.f;  // the shift: the row's first element (one broadcast load)
  if (d > 0) {
    float f0[1];
    Pack<T, false>::unpack(__ldg(x + (long long)row * d), f0);
    c = f0[0];
  }
  float ms, v, rstd;  // ms: the mean of x - c

  if constexpr (VPL > 0) {
    constexpr bool PRE = VPL * E <= 24;
    S r[VPL];
    float gv[PRE ? VPL : 1][E], bv[PRE ? VPL : 1][E];
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (lane + 32 * i < nv) r[i] = __ldg(xr + lane + 32 * i);
    if constexpr (PRE) {
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int j = lane + 32 * i;
        if (j < nv && has_g) load_param<E>(g, j * E, gv[i]);
        if (j < nv && has_b) load_param<E>(b, j * E, bv[i]);
      }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (lane + 32 * i >= nv) continue;
      float f[E];
      P::unpack(r[i], f);
#pragma unroll
      for (int e = 0; e < E; ++e) s += f[e] - c;
    }
    ms = warp_sum(s) / d;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (lane + 32 * i >= nv) continue;
      float f[E];
      P::unpack(r[i], f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float t = (f[e] - c) - ms;
        ss = fmaf(t, t, ss);
      }
    }
    v = warp_sum(ss) / d;
    rstd = 1.f / sqrtf(v + eps);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int j = lane + 32 * i;
      if (j >= nv) continue;
      float f[E];
      P::unpack(r[i], f);
      if constexpr (PRE) {
        normalize<E>(f, c, ms, rstd, gv[i], bv[i], has_g, has_b);
      } else {
        float gl[E], bl[E];
        if (has_g) load_param<E>(g, j * E, gl);
        if (has_b) load_param<E>(b, j * E, bl);
        normalize<E>(f, c, ms, rstd, gl, bl, has_g, has_b);
      }
      yr[j] = P::pack(f);
    }
  } else {
    float s = 0.f;
    for (int j = lane; j < nv; j += 32) {
      float f[E];
      P::unpack(__ldg(xr + j), f);
#pragma unroll
      for (int e = 0; e < E; ++e) s += f[e] - c;
    }
    ms = warp_sum(s) / d;
    float ss = 0.f;
    for (int j = lane; j < nv; j += 32) {
      float f[E];
      P::unpack(__ldg(xr + j), f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float t = (f[e] - c) - ms;
        ss = fmaf(t, t, ss);
      }
    }
    v = warp_sum(ss) / d;
    rstd = 1.f / sqrtf(v + eps);
    for (int j = lane; j < nv; j += 32) {
      float f[E], gv[E], bv[E];
      P::unpack(__ldg(xr + j), f);
      if (has_g) load_param<E>(g, j * E, gv);
      if (has_b) load_param<E>(b, j * E, bv);
      normalize<E>(f, c, ms, rstd, gv, bv, has_g, has_b);
      yr[j] = P::pack(f);
    }
  }
  if (lane == 0) {
    mean[row] = c + ms;
    var[row] = v;
  }
}

template <typename T, bool VEC>
cudaError_t launch(int vpl, int warps, int blocks, cudaStream_t s,
                   const void* x, const float* g, const float* b, void* y,
                   float* mu, float* vr, int rows, int d, float eps) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const dim3 grid(blocks), block(32 * warps);
#define PTT_LN_CASE(N)                                                     \
  case N:                                                                  \
    layer_norm_fwd_kernel<T, VEC, N><<<grid, block, 0, s>>>(               \
        xt, g, b, yt, mu, vr, rows, d, eps);                               \
    break;
  switch (vpl) {
    PTT_LN_CASE(0)
    PTT_LN_CASE(1)
    PTT_LN_CASE(2)
    PTT_LN_CASE(3)
    PTT_LN_CASE(4)
    PTT_LN_CASE(6)
    PTT_LN_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PTT_LN_CASE
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x and y are contiguous [rows, d];
// gamma/beta are f32 [d] or null; mean/var are f32 [rows]. The plan
// (ops/fused_layer_norm.py ln_fwd_plan): vec, the elements of a vector, 1
// or 16 bytes' worth (4 f32, 8 bf16; then d % vec == 0 and x, y, gamma,
// beta 16-byte aligned); vpl 0 (the looped form) or one of 1, 2, 3, 4, 6,
// 8 with 32 * vpl * vec >= d; warps a block 1, 2, 4 or 8, one row each;
// blocks = ceil(rows / warps).
int layer_norm_fwd(const void* x, const void* gamma, const void* beta,
                   void* y, void* mean, void* var, int dtype, int rows,
                   int d, float eps, int vec, int vpl, int warps, int blocks,
                   void* stream) {
  if ((dtype != 0 && dtype != 1) || rows <= 0 || d < 0)
    return cudaErrorInvalidValue;
  const int wide = dtype == 0 ? 4 : 8;
  if (vec == wide) {
    if (d % vec != 0 || !aligned16(x) || !aligned16(y) ||
        !aligned16(gamma) || !aligned16(beta))
      return cudaErrorInvalidValue;
  } else if (vec != 1) {
    return cudaErrorInvalidValue;
  }
  if (vpl < 0 || (vpl > 0 && 32LL * vpl * vec < d) ||
      (warps != 1 && warps != 2 && warps != 4 && warps != 8) ||
      blocks != (rows + warps - 1) / warps)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* mu = static_cast<float*>(mean);
  float* vr = static_cast<float*>(var);
  if (dtype == 0)
    return vec == 1 ? launch<float, false>(vpl, warps, blocks, s, x, g, b, y,
                                           mu, vr, rows, d, eps)
                    : launch<float, true>(vpl, warps, blocks, s, x, g, b, y,
                                          mu, vr, rows, d, eps);
  return vec == 1
             ? launch<__nv_bfloat16, false>(vpl, warps, blocks, s, x, g, b, y,
                                            mu, vr, rows, d, eps)
             : launch<__nv_bfloat16, true>(vpl, warps, blocks, s, x, g, b, y,
                                           mu, vr, rows, d, eps);
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
