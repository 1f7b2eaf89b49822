// Fused vocabulary projection + label-smoothed softmax cross-entropy,
// forward, for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel _fwd_kernel of paddle_tpu/ops/fused_ce.py
// (:57, driven by _fwd_impl :106). For each row t of x [T, D]:
//   z    = x[t] . W + b                    (W [D, V], b [V] or absent)
//   lse  = log sum_v exp(z_v)
//   loss = lse - (1 - eps) * z[y_t] - eps * mean_v(z_v)
// The [T, V] logits never reach device memory: each tile of z lives in
// registers and is consumed at once by an online (max, sum exp, sum z,
// z[y]) accumulation.
//
// What bounds it on the card: operations. The product is 2*T*D*V FLOPs
// (about 1.0 TFLOP for Transformer-base's loss head at 32,768 tokens),
// here on the f32 FMA pipes (TF32 off, no tensor cores); the bytes (x, W,
// b, y once each, loss and lse out) are small beside it. The design is a
// register-tiled SGEMM whose epilogue is the online softmax:
//   * a block owns BT = 64 rows and walks its share of the vocabulary in
//     tiles of BV = 128 columns; x and W are staged through shared memory
//     in chunks of BK = 16 along D (x transposed, so both operands are read
//     as broadcast float4s); each of the 256 threads holds a 4 x 8 tile of
//     z in registers, about ten FMAs per shared load;
//   * each thread keeps its own running (max, sum exp, sum z, z[y]) for its
//     4 rows over its columns, rescaling its sum when its max grows; the 16
//     threads sharing a row combine theirs with shuffles once, at the end;
//   * when the row tiles alone cannot fill the SMs, the vocabulary is split
//     over gridDim.y: each split writes its partial statistics, and a
//     second launch of this library combines them per row into loss and
//     lse (ragged V: columns past the split's end are masked).
// Labels are not checked against padding: a row's loss is masked by the
// model, not here; a label outside [0, V) contributes z[y] = 0.

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>

namespace {

constexpr int BT = 64, BV = 128, BK = 16;
constexpr int THREADS = 256;
constexpr int TM = 4, TN = 8;  // z per thread: 4 rows x (4 + 4) columns
constexpr int XP = BT + 4;     // padded row of the transposed x chunk
constexpr unsigned FULL = 0xffffffffu;

// partial: [nsplit, T, 4] = (max, sum exp(z - max), sum z, z[y])
__global__ void __launch_bounds__(THREADS)
fused_ce_partial(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, const int* __restrict__ y,
                 float4* __restrict__ partial, int T, int D, int V,
                 int cols_per_split) {
  __shared__ __align__(16) float xs[BK * XP];
  __shared__ __align__(16) float ws[BK * BV];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int t0 = blockIdx.x * BT;
  const int v_begin = blockIdx.y * cols_per_split;
  const int v_end = min(V, v_begin + cols_per_split);

  int lbl[TM];
  float m[TM], s[TM], sz[TM], zy[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int t = t0 + ty * TM + i;
    lbl[i] = t < T ? y[t] : -1;
    m[i] = -INFINITY;
    s[i] = sz[i] = zy[i] = 0.f;
  }

  for (int v0 = v_begin; v0 < v_end; v0 += BV) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += BK) {
      __syncthreads();  // the previous chunk is consumed
#pragma unroll
      for (int e = tid; e < BT * BK; e += THREADS) {
        const int r = e / BK, k = e % BK;
        xs[k * XP + r] = (t0 + r < T && k0 + k < D)
                             ? x[(long long)(t0 + r) * D + k0 + k] : 0.f;
      }
#pragma unroll
      for (int e = tid; e < BK * BV; e += THREADS) {
        const int k = e / BV, c = e % BV;
        ws[e] = (k0 + k < D && v0 + c < v_end)
                    ? w[(long long)(k0 + k) * V + v0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(xs + k * XP + ty * TM);
        const float4 b0 = *reinterpret_cast<const float4*>(ws + k * BV + tx * 4);
        const float4 b1 =
            *reinterpret_cast<const float4*>(ws + k * BV + 64 + tx * 4);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    // online statistics over this tile's valid columns
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int v = v0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (v >= v_end) continue;
      const float bj = bias ? bias[v] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float z = acc[i][j] + bj;
        if (z > m[i]) {
          s[i] = s[i] * expf(m[i] - z) + 1.f;  // exp(-inf) = 0 at the start
          m[i] = z;
        } else {
          s[i] += expf(z - m[i]);
        }
        sz[i] += z;
        if (v == lbl[i]) zy[i] += z;
      }
    }
  }

  // combine the 16 threads of each row (lanes of one half-warp)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float mi = m[i], si = s[i], szi = sz[i], zyi = zy[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float mo = __shfl_xor_sync(FULL, mi, o);
      const float so = __shfl_xor_sync(FULL, si, o);
      szi += __shfl_xor_sync(FULL, szi, o);
      zyi += __shfl_xor_sync(FULL, zyi, o);
      const float mn = fmaxf(mi, mo);
      si = (mn == -INFINITY) ? 0.f
                             : si * expf(mi - mn) + so * expf(mo - mn);
      mi = mn;
    }
    const int t = t0 + ty * TM + i;
    if (tx == 0 && t < T)
      partial[(long long)blockIdx.y * T + t] = make_float4(mi, si, szi, zyi);
  }
}

__global__ void fused_ce_combine(const float4* __restrict__ partial,
                                 float* __restrict__ loss,
                                 float* __restrict__ lse, int T, int V,
                                 int nsplit, float eps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float m = -INFINITY;
  for (int k = 0; k < nsplit; ++k) m = fmaxf(m, partial[(long long)k * T + t].x);
  float s = 0.f, sz = 0.f, zy = 0.f;
  for (int k = 0; k < nsplit; ++k) {
    const float4 p = partial[(long long)k * T + t];
    if (p.y > 0.f) s += p.y * expf(p.x - m);
    sz += p.z;
    zy += p.w;
  }
  const float l = m + logf(s);
  float out = l - (1.f - eps) * zy;
  if (eps != 0.f) out -= eps * sz / V;
  loss[t] = out;
  lse[t] = l;
}

}  // namespace

extern "C" {

// f32 only. x: contiguous [T, D]; w: contiguous [D, V]; bias: [V] or null;
// y: int32 [T]; loss, lse: f32 [T]; partial: scratch of nsplit * T * 4
// floats (16-byte aligned). Two launches on `stream`.
int fused_ce_fwd(const void* x, const void* w, const void* bias,
                 const void* y, void* loss, void* lse, void* partial, int T,
                 int D, int V, int nsplit, float eps, void* stream) {
  if (T <= 0 || D <= 0 || V <= 0 || nsplit <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (V + BV - 1) / BV;
  const int cols_per_split = ((tiles + nsplit - 1) / nsplit) * BV;
  nsplit = (V + cols_per_split - 1) / cols_per_split;  // no empty split
  dim3 grid((T + BT - 1) / BT, nsplit);
  fused_ce_partial<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(y),
      static_cast<float4*>(partial), T, D, V, cols_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_ce_combine<<<(T + 255) / 256, 256, 0, s>>>(
      static_cast<const float4*>(partial), static_cast<float*>(loss),
      static_cast<float*>(lse), T, V, nsplit, eps);
  return cudaGetLastError();
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
