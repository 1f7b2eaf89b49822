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
// once per element, with a dozen f32 operations each. dgamma/dbeta are
// sums over every row, and blocks run in no order, so the TPU kernel's
// accumulation across its sequential grid becomes two launches: (1) each
// block walks a contiguous range of rows and writes its sums into one
// partial row of [blocks, 2, D]; (2) layer_norm_bwd_params sums the
// partials per column in a fixed order. The result is deterministic. Two
// forms, chosen by the plan (ops/fused_layer_norm.py ln_bwd_plan; the C
// entry refuses one that does not fit the call):
//   * bf16 with D a multiple of 8, 16-byte aligned rows and D <= 1024: the
//     row in registers (layer_norm_bwd_regs<VPL>). A lane holds VPL
//     16-byte vectors of x and of dy (lane l the vectors l, l + 32, ...:
//     each warp load one contiguous segment); xhat and g = dy * gamma are
//     formed once, the two row means come from one shuffle tree over the
//     pair, and dx is written from registers, so x and dy are read once.
//     The lane's columns are the same in every row it takes, so its
//     dgamma/dbeta sums are 16 VPL f32 registers and no shared memory is
//     touched per element; the next row's loads go out before this
//     row's arithmetic (two register buffers a warp). A block is 8 warps
//     and the grid 1-2 blocks an SM, each walking a long range of rows, so
//     the partials are few; at the end the block adds its warps' sums
//     through shared memory in a fixed order into its partial row. Its
//     second launch runs 32 warps a block (the looped forms' runs 8).
//   * every other call (f32; bf16 with D not a multiple of 8, rows not
//     16-byte aligned or D wider than 32 x 8 x 4): the looped form
//     (layer_norm_bwd_rows<T, VEC>). One warp per row at a time; the two
//     row means are warp shuffles, and the second pass over the row
//     re-reads x and dy through the read-only cache where the first pass
//     left them. A lane moves VEC elements at a time: 8 bf16 in one
//     16-byte load or store where D % 8 == 0 and the rows are 16-byte
//     aligned, else one; f32 moves one. Each warp adds its rows' dy * xhat
//     and dy into its own row of shared memory (a lane owns its VEC
//     columns of each 32 * VEC: no atomics; with VEC = 8 column 8v + i sits
//     at i * D / 8 + v, so the lanes of a warp touch consecutive words),
//     then the block sums its warps into its partial row.

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

// A row of the register form: VPL 16-byte vectors of x and of dy a lane
// (vector lane + 32 i, columns 8 (lane + 32 i) .. + 7), and its mean and
// variance
template <int VPL>
struct RegRow {
  uint4 x[VPL], dy[VPL];
  float mu, var;
};

template <int VPL>
__device__ __forceinline__ void load_row(RegRow<VPL>& r,
                                         const __nv_bfloat16* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ dy,
                                         const float* __restrict__ mean,
                                         const float* __restrict__ var,
                                         int row, int d, int lane) {
  const uint4* xr = reinterpret_cast<const uint4*>(x + (long long)row * d);
  const uint4* dr = reinterpret_cast<const uint4*>(dy + (long long)row * d);
  const int nv = d >> 3;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = lane + 32 * i;
    r.x[i] = v < nv ? __ldg(xr + v) : make_uint4(0u, 0u, 0u, 0u);
    r.dy[i] = v < nv ? __ldg(dr + v) : make_uint4(0u, 0u, 0u, 0u);
  }
  r.mu = __ldg(mean + row);
  r.var = __ldg(var + row);
}

// 8 bf16 of a 16-byte vector as f32 (a bf16 is the high half of the f32
// with the same bits)
__device__ __forceinline__ void unpack8(uint4 s, float (&f)[8]) {
  const unsigned w[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// dx of one row from registers, and the row's dy * xhat and dy added into
// the lane's column sums ag, ab
template <int VPL>
__device__ __forceinline__ void row_bwd(const RegRow<VPL>& r,
                                        const float* __restrict__ gamma,
                                        __nv_bfloat16* __restrict__ dx,
                                        int row, int d, int lane, float eps,
                                        float (&ag)[VPL][8],
                                        float (&ab)[VPL][8]) {
  const int nv = d >> 3;
  const float rstd = 1.f / sqrtf(r.var + eps);
  float xh[VPL][8], dv[VPL][8], gm[VPL][8];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = lane + 32 * i;
    unpack8(r.x[i], xh[i]);
    unpack8(r.dy[i], dv[i]);
    if (gamma != nullptr && v < nv) {
      const float4 g0 = __ldg(reinterpret_cast<const float4*>(gamma) + 2 * v);
      const float4 g1 =
          __ldg(reinterpret_cast<const float4*>(gamma) + 2 * v + 1);
      const float t[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) gm[i][e] = t[e];
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) gm[i][e] = 1.f;
    }
    if (v >= nv) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      xh[i][e] = (xh[i][e] - r.mu) * rstd;
      const float g = dv[i][e] * gm[i][e];
      s1 += g;
      s2 = fmaf(g, xh[i][e], s2);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {  // the pair's shuffle tree
    s1 += __shfl_xor_sync(FULL, s1, o);
    s2 += __shfl_xor_sync(FULL, s2, o);
  }
  const float inv_d = 1.f / d;
  const float m1 = s1 * inv_d, m2 = s2 * inv_d;
  uint4* dxr = reinterpret_cast<uint4*>(dx + (long long)row * d);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = lane + 32 * i;
    if (v >= nv) continue;
    unsigned w[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float o[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float xv = xh[i][e + k], dyv = dv[i][e + k];
        o[k] = rstd * (dyv * gm[i][e + k] - m1 - xv * m2);
        ag[i][e + k] = fmaf(dyv, xv, ag[i][e + k]);
        ab[i][e + k] += dyv;
      }
      const __nv_bfloat162 h = __floats2bfloat162_rn(o[0], o[1]);
      w[e / 2] = *reinterpret_cast<const unsigned*>(&h);
    }
    dxr[v] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// partial: [gridDim.x, 2, d] (dgamma partials, then dbeta partials). Warp
// w of block b takes rows b * rows_per_block + w, + WARPS, ..., holding
// the next row's loads in flight over this row's arithmetic.
template <int VPL>
__global__ void __launch_bounds__(WARPS * 32, VPL <= 2 ? 2 : 1)
layer_norm_bwd_regs(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ gamma,
                    const __nv_bfloat16* __restrict__ dy,
                    const float* __restrict__ mean,
                    const float* __restrict__ var,
                    __nv_bfloat16* __restrict__ dx,
                    float* __restrict__ partial, int rows, int d,
                    int rows_per_block, float eps) {
  extern __shared__ float acc[];  // [WARPS][2][d], once at the end
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_begin = blockIdx.x * rows_per_block;
  const int r_end = min(rows, r_begin + rows_per_block);
  float ag[VPL][8], ab[VPL][8];
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) ag[i][e] = ab[i][e] = 0.f;

  RegRow<VPL> a, b;
  int row = r_begin + warp;
  if (row < r_end) load_row(a, x, dy, mean, var, row, d, lane);
  while (row < r_end) {
    if (row + WARPS < r_end)
      load_row(b, x, dy, mean, var, row + WARPS, d, lane);
    row_bwd(a, gamma, dx, row, d, lane, eps, ag, ab);
    row += WARPS;
    if (row >= r_end) break;
    if (row + WARPS < r_end)
      load_row(a, x, dy, mean, var, row + WARPS, d, lane);
    row_bwd(b, gamma, dx, row, d, lane, eps, ag, ab);
    row += WARPS;
  }

  // the warps' column sums through shared memory, added in warp order
  const int nv = d >> 3;
  float* mine = acc + warp * 2 * d;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = lane + 32 * i;
    if (v >= nv) continue;
    float4* pg = reinterpret_cast<float4*>(mine + 8 * v);
    float4* pb = reinterpret_cast<float4*>(mine + d + 8 * v);
    pg[0] = make_float4(ag[i][0], ag[i][1], ag[i][2], ag[i][3]);
    pg[1] = make_float4(ag[i][4], ag[i][5], ag[i][6], ag[i][7]);
    pb[0] = make_float4(ab[i][0], ab[i][1], ab[i][2], ab[i][3]);
    pb[1] = make_float4(ab[i][4], ab[i][5], ab[i][6], ab[i][7]);
  }
  __syncthreads();
  float* out = partial + (long long)blockIdx.x * 2 * d;
  for (int c = threadIdx.x; c < 2 * d; c += WARPS * 32) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += acc[w * 2 * d + c];
    out[c] = s;
  }
}

// grid: one block of PW warps per 32 columns of the [nblocks, 2 * d]
// partials; warp w sums partial rows w, w + PW, ... and the block adds its
// warps in order. The looped forms take PW = WARPS; the register form, 32
// (its second launch has 32 blocks at D = 512, so each warp's chain of
// loads is what it waits on)
template <int PW>
__global__ void __launch_bounds__(PW * 32)
layer_norm_bwd_params(const float* __restrict__ partial,
                      float* __restrict__ dgamma, float* __restrict__ dbeta,
                      int nblocks, int d) {
  __shared__ float red[PW][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < 2 * d)
    for (int i = warp; i < nblocks; i += PW)
      s += partial[(long long)i * 2 * d + c];
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || c >= 2 * d) return;
  for (int w = 1; w < PW; ++w) s += red[w][lane];
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

template <int VPL>
cudaError_t launch_regs(const void* x, const void* gamma, const void* dy,
                        const void* mean, const void* var, void* dx,
                        void* partial, int rows, int d, int nblocks,
                        float eps, cudaStream_t s) {
  typedef __nv_bfloat16 bf16;
  const size_t smem = sizeof(float) * WARPS * 2 * d;
  cudaError_t err = cudaFuncSetAttribute(
      layer_norm_bwd_regs<VPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const int rows_per_block = (rows + nblocks - 1) / nblocks;
  layer_norm_bwd_regs<VPL><<<nblocks, WARPS * 32, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const bf16*>(dy), static_cast<const float*>(mean),
      static_cast<const float*>(var), static_cast<bf16*>(dx),
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
// dbeta: f32 [d] or null, every column written; partial: scratch of
// blocks * 2 * d floats. The plan (ops/fused_layer_norm.py ln_bwd_plan):
// vec, the elements a lane moves at once, 1 or 8 (bf16 only; then d % 8
// == 0 and x, dy, dx and gamma 16-byte aligned); vpl 0 (the looped form)
// or one of 1, 2, 3, 4 (bf16 with vec 8 and 32 * 8 * vpl >= d: the row in
// registers); warps a block, 8; blocks >= 1, each a contiguous range of
// ceil(rows / blocks) rows. Two launches on `stream`.
int layer_norm_bwd(const void* x, const void* gamma, const void* dy,
                   const void* mean, const void* var, void* dx, void* dgamma,
                   void* dbeta, void* partial, int dtype, int rows, int d,
                   float eps, int vec, int vpl, int warps, int blocks,
                   void* stream) {
  if (rows <= 0 || d <= 0 || blocks <= 0 || warps != WARPS)
    return cudaErrorInvalidValue;
  if (vec == 8) {
    if (dtype != 1 || d % 8 != 0 || !aligned16(x) || !aligned16(dy) ||
        !aligned16(dx) || (gamma != nullptr && !aligned16(gamma)))
      return cudaErrorInvalidValue;
  } else if (vec != 1) {
    return cudaErrorInvalidValue;
  }
  if (vpl < 0 || (vpl > 0 && (vec != 8 || 32LL * 8 * vpl < d)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    if (vpl != 0) return cudaErrorInvalidValue;
    err = launch_rows<float, 1>(x, gamma, dy, mean, var, dx, partial, rows,
                                d, blocks, eps, s);
  } else if (dtype == 1) {
#define PTT_LN_BWD_CASE(N)                                                 \
  case N:                                                                  \
    err = launch_regs<N>(x, gamma, dy, mean, var, dx, partial, rows, d,    \
                         blocks, eps, s);                                  \
    break;
    switch (vpl) {
      case 0:
        err = vec == 8 ? launch_rows<__nv_bfloat16, 8>(x, gamma, dy, mean,
                                                       var, dx, partial,
                                                       rows, d, blocks, eps,
                                                       s)
                       : launch_rows<__nv_bfloat16, 1>(x, gamma, dy, mean,
                                                       var, dx, partial,
                                                       rows, d, blocks, eps,
                                                       s);
        break;
      PTT_LN_BWD_CASE(1)
      PTT_LN_BWD_CASE(2)
      PTT_LN_BWD_CASE(3)
      PTT_LN_BWD_CASE(4)
      default:
        return cudaErrorInvalidValue;
    }
#undef PTT_LN_BWD_CASE
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const dim3 pgrid((2 * d + 31) / 32);
  const float* pp = static_cast<const float*>(partial);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  if (vpl > 0)
    layer_norm_bwd_params<32><<<pgrid, 32 * 32, 0, s>>>(pp, dg, db, blocks,
                                                        d);
  else
    layer_norm_bwd_params<WARPS><<<pgrid, WARPS * 32, 0, s>>>(pp, dg, db,
                                                             blocks, d);
  return cudaGetLastError();
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
