// Flash-attention forward for Hopper (sm_90a), scalar f32 arithmetic.
//
// Replaces the Pallas TPU forward kernels of paddle_tpu/ops/flash_attention.py:
//   _fwd_kernel (:127, driven by _flash_fwd_impl :394),
//   _packed_fwd_kernel (:567, driven by _packed_stream_fwd_impl :770),
//   _dense_fwd_kernel (:1001, driven by _dense_fwd_impl :1151).
// One kernel covers all three: it reads q/k/v in the packed [B, T, H*D]
// layout through strides (row stride, head offset h*D), so no head-split
// copy is made, and it streams K/V tiles with an online softmax, so no
// sequence length limit applies.
//
// What it computes is paddle_tpu's mha_reference (:56-73):
//   logits = q . k^T / sqrt(D) + key_bias[b, j]
//   causal: key j is allowed for query t iff j <= t + (Tk - Tq)
//           (the end-anchored tril(k = Tk - Tq), for every Tq/Tk);
//   a masked logit is FLT_MAX's negative (finfo(f32).min, not -inf), so a
//   query with no allowed key averages V uniformly over all Tk keys;
//   out = softmax(logits) . v in the input dtype, lse = logsumexp(logits)
//   in f32 ([B, H, Tq], saved for flash_attention_bwd.cu).
// Attention dropout (paddle_tpu's _dropout_keep, :80) drops weights after
// the softmax: weight (t, j) of head (b, h) is kept iff the counter-based
// hash of flash_dropout.cuh, keyed by (seed, b*H + h, t*Tk + j), falls
// below the keep threshold, and kept weights are scaled by 1/(1 - rate).
// The hash needs no state, so the backward regenerates the same mask, and
// the plain PyTorch version computes the same bits.
//
// What bounds it on the card: at BERT-base serving shapes (T = 128, D = 64)
// the operations (4*T*Tk*D per head, here on the f32 FMA pipes) outweigh the
// bytes (q, k, v and out, each read or written once). The design keeps
// every intermediate out of device memory and feeds the FMA pipes from
// shared memory at about four FMAs per load:
//   * a block owns BQ = 32 query rows of one (batch, head) and streams K/V
//     tiles of BK = 64 keys through shared memory, reused by all its rows;
//   * each of its 4 warps owns 8 rows for the whole sequence: their output
//     accumulators, running max and running sum stay in registers;
//   * scores: lane i computes keys i and i + 32 for all 8 rows at once, so
//     each K value (K stored transposed, [D][BK + 1], conflict-free) serves
//     8 FMAs and each Q load is a broadcast float4;
//   * P.V: probabilities go through a per-warp [8][BK] shared buffer read
//     back as broadcast float4s; lane i owns output columns i, i + 32, ...,
//     so each V value serves 8 FMAs.
// Tiles a causal block cannot see are skipped. Tensor cores (mma/wgmma),
// TMA and asynchronous copies are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "flash_dropout.cuh"

namespace {

constexpr int BQ = 32;              // query rows per block
constexpr int BK = 64;              // keys per shared-memory tile
constexpr int NWARPS = 4;           // 128 threads
constexpr int RW = BQ / NWARPS;     // query rows per warp
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  // Q [BQ][D], K^T [D][BK+1], V [BK][D], P [NWARPS][RW][BK], bias [BK]
  return sizeof(float) * (size_t(BQ) * D + size_t(D) * (BK + 1) +
                          size_t(BK) * D + size_t(NWARPS) * RW * BK + BK);
}

struct Args {
  const void* q; const void* k; const void* v; const float* bias;
  void* out; float* lse;
  int H, Tq, Tk;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st, bias_sb;
  float scale; int causal;
  const long long* seed;  // null: no dropout
  unsigned keep_thresh; float inv_keep;
};

template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_kernel(Args a) {
  constexpr int DS = D / 32;  // output columns per lane
  constexpr int KT = BK + 1;  // K^T row stride (odd: conflict-free stores)
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Kt = Qs + BQ * D;
  float* Vs = Kt + D * KT;
  float* Ps = Vs + BK * D;  // 16-byte aligned: D is a multiple of 32
  float* Bs = Ps + NWARPS * RW * BK;

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * RW;       // this warp's first row in the block
  const int shift = a.Tk - a.Tq;  // causal: key j allowed iff j <= t + shift
  float* Pw = Ps + warp * RW * BK;

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * D;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * D;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * D;
  const float* biasb = a.bias ? a.bias + b * a.bias_sb : nullptr;
  const uint32_t dkey = a.seed ? dropout_key(*a.seed, bh) : 0u;

  for (int i = tid; i < BQ * D; i += NWARPS * 32) {
    const int r = i / D, c = i % D, t = q0 + r;
    Qs[i] = t < a.Tq ? to_f32(qb[t * a.q_st + c]) : 0.f;
  }
  float o[RW][DS], m[RW], l[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DS; ++d) o[r][d] = 0.f;
  }

  // Skip key tiles every row of this block masks out. Only exact when each
  // row keeps at least one key (q0 + shift >= 0): a row with none averages
  // V over all Tk keys, so then every tile is visited.
  const int q_last = min(q0 + BQ, a.Tq) - 1;
  int k_end = a.Tk;
  if (a.causal && q0 + shift >= 0) k_end = min(a.Tk, q_last + shift + 1);

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    const int nk = min(BK, k_end - k0);
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BK * D; i += NWARPS * 32) {
      const int j = i / D, c = i % D;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        kv = to_f32(kb[(k0 + j) * a.k_st + c]);
        vv = to_f32(vb[(k0 + j) * a.v_st + c]);
      }
      Kt[c * KT + j] = kv;
      Vs[j * D + c] = vv;
    }
    for (int j = tid; j < BK; j += NWARPS * 32)
      Bs[j] = (biasb && j < nk) ? biasb[k0 + j] : 0.f;
    __syncthreads();

    // scores of keys lane and lane + 32 for the warp's RW rows
    float s[RW][2];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float k0v[4], k1v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        k0v[u] = Kt[(c + u) * KT + lane];
        k1v[u] = Kt[(c + u) * KT + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 q4 =
            *reinterpret_cast<const float4*>(Qs + (r0 + r) * D + c);
        s[r][0] = fmaf(q4.x, k0v[0], s[r][0]);
        s[r][0] = fmaf(q4.y, k0v[1], s[r][0]);
        s[r][0] = fmaf(q4.z, k0v[2], s[r][0]);
        s[r][0] = fmaf(q4.w, k0v[3], s[r][0]);
        s[r][1] = fmaf(q4.x, k1v[0], s[r][1]);
        s[r][1] = fmaf(q4.y, k1v[1], s[r][1]);
        s[r][1] = fmaf(q4.z, k1v[2], s[r][1]);
        s[r][1] = fmaf(q4.w, k1v[3], s[r][1]);
      }
    }

    // online softmax per row; probabilities to the warp's P buffer
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int t = q0 + r0 + r;
      float v2[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        if (j < nk) {
          float x = s[r][u] * a.scale + Bs[j];
          if (a.causal && k0 + j > t + shift) x = -FLT_MAX;
          v2[u] = x;
        } else {
          v2[u] = -INFINITY;  // beyond Tk: not a key at all
        }
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(v2[0], v2[1])));
      float p0 = expf(v2[0] - m_new), p1 = expf(v2[1] - m_new);
      const float alpha = expf(m[r] - m_new);  // 0 on the first tile
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int d = 0; d < DS; ++d) o[r][d] *= alpha;
      if (a.seed) {  // the normaliser l keeps every weight; P.V drops
        const long long ctr = (long long)t * a.Tk + k0;
        p0 = dropout_keep(dkey, ctr + lane, a.keep_thresh) ? p0 * a.inv_keep
                                                          : 0.f;
        p1 = dropout_keep(dkey, ctr + lane + 32, a.keep_thresh)
                 ? p1 * a.inv_keep : 0.f;
      }
      Pw[r * BK + lane] = p0;
      Pw[r * BK + lane + 32] = p1;
    }
    __syncwarp();

    // o += P . V; keys past nk have p = 0 and zero-filled V rows
    const int nk4 = (nk + 3) & ~3;
    for (int j = 0; j < nk4; j += 4) {
      float vv[4][DS];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int d = 0; d < DS; ++d) vv[u][d] = Vs[(j + u) * D + lane + 32 * d];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(Pw + r * BK + j);
#pragma unroll
        for (int d = 0; d < DS; ++d) {
          o[r][d] = fmaf(p4.x, vv[0][d], o[r][d]);
          o[r][d] = fmaf(p4.y, vv[1][d], o[r][d]);
          o[r][d] = fmaf(p4.z, vv[2][d], o[r][d]);
          o[r][d] = fmaf(p4.w, vv[3][d], o[r][d]);
        }
      }
    }
    __syncwarp();  // P is rewritten on the next tile
  }

  T* ob = static_cast<T*>(a.out) + b * a.o_sb + h * D;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int t = q0 + r0 + r;
    if (t >= a.Tq) break;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int d = 0; d < DS; ++d)
      ob[t * a.o_st + lane + 32 * d] = from_f32<T>(o[r][d] * inv);
    if (lane == 0) a.lse[(long long)bh * a.Tq + t] = m[r] + logf(l[r]);
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + BQ - 1) / BQ, B * a.H);
  flash_fwd_kernel<T, D><<<grid, NWARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// (feature) dimension of q/k/v/out must be contiguous. bias is f32
// [B or 1, Tk] with batch stride bias_sb (0 broadcasts), or null. seed is
// one int64 on the device (null: no dropout); keep_thresh and inv_keep
// come from the dropout rate (flash_dropout.cuh).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* bias, void* out, void* lse, int dtype,
                        int B, int H, int Tq, int Tk, int D,
                        long long q_sb, long long q_st, long long k_sb,
                        long long k_st, long long v_sb, long long v_st,
                        long long o_sb, long long o_st, long long bias_sb,
                        float scale, int causal, const void* seed,
                        unsigned keep_thresh, float inv_keep, void* stream) {
  Args a{q, k, v, static_cast<const float*>(bias), out,
         static_cast<float*>(lse), H, Tq, Tk, q_sb, q_st, k_sb, k_st, v_sb,
         v_st, o_sb, o_st, bias_sb, scale, causal,
         static_cast<const long long*>(seed), keep_thresh, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(a, B, D, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(a, B, D, s);
  return cudaErrorInvalidValue;
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
