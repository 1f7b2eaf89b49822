// Flash-attention backward for Hopper (sm_90a), scalar f32 arithmetic.
//
// Replaces the Pallas TPU backward kernels of paddle_tpu/ops/flash_attention.py:
//   _bwd_dkv_kernel (:211, driven by _flash_bwd_impl :449),
//   _packed_bwd_kernel (:644, driven by _packed_stream_bwd_impl :825),
//   _dense_bwd_kernel (:1058, driven by _dense_bwd_impl :1207).
// Like flash_attention_fwd.cu it reads q/k/v/dO in the packed [B, T, H*D]
// layout through strides and writes dQ/dK/dV in the same layout.
//
// What it computes is the gradient of paddle_tpu's mha_reference (:56-73)
// as autodiff gives it, from the forward's saved row lse and
// delta = rowsum(dO * O) (computed by the wrapper):
//   P   = exp(logits - lse), recomputed per tile, never stored;
//         masked logits give P = 0, except in a row with no allowed key
//         (causal, t + Tk - Tq < 0), where the forward averaged V
//         uniformly: there P = 1/Tk;
//   Pd  = P * keep / (1 - rate), dP = keep * (dO . V) / (1 - rate)
//         (keep from flash_dropout.cuh, the forward's mask);
//   dS  = P * (dP - delta), and 0 at every masked logit (the mask's
//         where() passes no gradient);
//   dV  = Pd^T dO, dK = scale * dS^T Q, dQ = scale * dS K,
//   dBias[b, h, j] = sum_t dS (per head; the wrapper sums the heads).
//
// Design. One block per (batch, head, tile of BK keys) loops over all query
// tiles of BQ = 32 rows, as the TPU kernel looped its sequential grid:
//   * each of the 4 warps owns KW keys; their dK and dV accumulators stay
//     in registers for the whole loop (lane i holds columns i, i + 32, ...);
//   * per query tile: lane i computes the scores and dO.V of query i for
//     the warp's KW keys (K and V rows read as broadcast float4s, Q and dO
//     rows from a padded, conflict-free layout); P and dS go through shared
//     memory; dV += Pd^T dO and dK += dS^T Q read them back as broadcast
//     float4s, about five FMAs per shared load;
//   * dQ needs a sum over key tiles, which run on different blocks in no
//     order: each block adds its partial dQ tile into an f32 buffer with
//     atomicAdd (red.global.add.f32). dQ is therefore not bitwise
//     reproducible: its summation order changes from run to run, by a few
//     f32 ulps of the largest partial. dK, dV and dBias are deterministic.
// Query tiles a causal key tile cannot see are skipped, with the forward's
// rule: only when every row of the tile keeps at least one key.
//
// What bounds it on the card: operations. A query-key pair costs 5*D FMAs
// (S, dP, dV, dK, dQ) on the f32 FMA pipes (no tensor cores); the bytes
// (q, k, v, dO, dQ, dK, dV once each) are far fewer.

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "flash_dropout.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int BQ = 32;  // query rows per tile: one per lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int D>
struct Cfg {
  static constexpr int KW = D <= 64 ? 16 : 8;  // keys per warp
  static constexpr int BK = NWARPS * KW;       // keys per block
  static constexpr int DS = D / 32;            // columns per lane
  static constexpr int QP = D + 1;             // padded Q/dO row stride
  // K [BK][D], V [BK][D], Q [BQ][QP], dO [BQ][QP], Pd [BK][BQ], dS [BK][BQ],
  // lse [BQ], delta [BQ], bias [BK]
  static constexpr size_t smem_floats =
      2 * size_t(BK) * D + 2 * size_t(BQ) * QP + 2 * size_t(BK) * BQ +
      2 * BQ + BK;
};

struct Args {
  const float* q; const float* k; const float* v; const float* dout;
  const float* lse; const float* delta; const float* bias;
  const long long* seed;
  float* dq; float* dk; float* dv; float* dbias;
  int H, Tq, Tk;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st, bias_sb;
  float scale; int causal; unsigned keep_thresh; float inv_keep;
};

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_bwd_kernel(Args a) {
  using C = Cfg<D>;
  constexpr int KW = C::KW, BK = C::BK, DS = C::DS, QP = C::QP;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * D;
  float* Qs = Vs + BK * D;
  float* dOs = Qs + BQ * QP;
  float* Ps = dOs + BQ * QP;  // 16-byte aligned: BQ * QP is a multiple of 4
  float* dSs = Ps + BK * BQ;
  float* Ls = dSs + BK * BQ;
  float* Dl = Ls + BQ;
  float* Bs = Dl + BQ;

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int shift = a.Tk - a.Tq;  // causal: key j allowed iff j <= t + shift
  const int HD = a.H * D;
  const float inv_tk = 1.f / a.Tk;
  const uint32_t dkey = a.seed ? dropout_key(*a.seed, bh) : 0u;

  const float* qb = a.q + b * a.q_sb + h * D;
  const float* kb = a.k + b * a.k_sb + h * D;
  const float* vb = a.v + b * a.v_sb + h * D;
  const float* dob = a.dout + b * a.do_sb + h * D;
  const float* lseb = a.lse + (long long)bh * a.Tq;
  const float* deltab = a.delta + (long long)bh * a.Tq;

  for (int i = tid; i < BK * D; i += NWARPS * 32) {
    const int j = i / D, c = i % D;
    const bool in = k0 + j < a.Tk;
    Ks[i] = in ? kb[(k0 + j) * a.k_st + c] : 0.f;
    Vs[i] = in ? vb[(k0 + j) * a.v_st + c] : 0.f;
  }
  for (int j = tid; j < BK; j += NWARPS * 32)
    Bs[j] = (a.bias && k0 + j < a.Tk) ? a.bias[b * a.bias_sb + k0 + j] : 0.f;

  float dk[KW][DS], dv[KW][DS];
#pragma unroll
  for (int j = 0; j < KW; ++j)
#pragma unroll
    for (int d = 0; d < DS; ++d) dk[j][d] = dv[j][d] = 0.f;
  float db = 0.f;  // lane j < KW: dBias of the warp's key j

  const int kw0 = warp * KW;  // the warp's first key in the tile

  for (int q0 = 0; q0 < a.Tq; q0 += BQ) {
    const int q_last = min(q0 + BQ, a.Tq) - 1;
    // every pair of this (q tile, k tile) is masked and no row of the
    // q tile is fully masked: its contributions are exactly zero
    if (a.causal && q0 + shift >= 0 && q_last + shift < k0) continue;

    __syncthreads();  // the previous tile's shared buffers are consumed
    for (int i = tid; i < BQ * D; i += NWARPS * 32) {
      const int r = i / D, c = i % D, t = q0 + r;
      const bool in = t < a.Tq;
      Qs[r * QP + c] = in ? qb[t * a.q_st + c] : 0.f;
      dOs[r * QP + c] = in ? dob[t * a.do_st + c] : 0.f;
    }
    for (int r = tid; r < BQ; r += NWARPS * 32) {
      const bool in = q0 + r < a.Tq;
      Ls[r] = in ? lseb[q0 + r] : 0.f;
      Dl[r] = in ? deltab[q0 + r] : 0.f;
    }
    __syncthreads();

    // scores and dO.V of query `lane` for the warp's KW keys
    float s[KW], dp[KW];
#pragma unroll
    for (int j = 0; j < KW; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      float qv[4], ov[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        qv[u] = Qs[lane * QP + c + u];
        ov[u] = dOs[lane * QP + c + u];
      }
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        const float4 k4 = *reinterpret_cast<const float4*>(
            Ks + (kw0 + j) * D + c);
        const float4 v4 = *reinterpret_cast<const float4*>(
            Vs + (kw0 + j) * D + c);
        s[j] = fmaf(qv[0], k4.x, s[j]);
        s[j] = fmaf(qv[1], k4.y, s[j]);
        s[j] = fmaf(qv[2], k4.z, s[j]);
        s[j] = fmaf(qv[3], k4.w, s[j]);
        dp[j] = fmaf(ov[0], v4.x, dp[j]);
        dp[j] = fmaf(ov[1], v4.y, dp[j]);
        dp[j] = fmaf(ov[2], v4.z, dp[j]);
        dp[j] = fmaf(ov[3], v4.w, dp[j]);
      }
    }

    const int t = q0 + lane;
    const bool row_in = t < a.Tq;
    const bool row_dead = a.causal && t + shift < 0;  // no allowed key
    const float lse = Ls[lane], delta = Dl[lane];
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      const int kk = k0 + kw0 + j;
      float p = 0.f, ds = 0.f;
      if (row_in && kk < a.Tk) {
        const bool masked = a.causal && kk > t + shift;
        if (masked) {
          p = row_dead ? inv_tk : 0.f;
        } else {
          p = expf(s[j] * a.scale + Bs[kw0 + j] - lse);
        }
        float pd = p, dpv = dp[j];
        if (a.seed) {
          const bool keep = dropout_keep(dkey, (long long)t * a.Tk + kk,
                                         a.keep_thresh);
          pd = keep ? p * a.inv_keep : 0.f;
          dpv = keep ? dpv * a.inv_keep : 0.f;
        }
        ds = masked ? 0.f : p * (dpv - delta);
        p = pd;
      }
      Ps[(kw0 + j) * BQ + lane] = p;
      dSs[(kw0 + j) * BQ + lane] = ds;
      if (a.dbias) {
        const float sum = warp_sum(ds);
        if (lane == j) db += sum;
      }
    }
    __syncwarp();

    // dV += Pd^T dO and dK += dS^T Q over the tile's queries
    for (int r = 0; r < BQ; r += 4) {
      float ov[4][DS], qv[4][DS];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int d = 0; d < DS; ++d) {
          ov[u][d] = dOs[(r + u) * QP + lane + 32 * d];
          qv[u][d] = Qs[(r + u) * QP + lane + 32 * d];
        }
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        const float4 p4 = *reinterpret_cast<const float4*>(
            Ps + (kw0 + j) * BQ + r);
        const float4 s4 = *reinterpret_cast<const float4*>(
            dSs + (kw0 + j) * BQ + r);
#pragma unroll
        for (int d = 0; d < DS; ++d) {
          dv[j][d] = fmaf(p4.x, ov[0][d], dv[j][d]);
          dv[j][d] = fmaf(p4.y, ov[1][d], dv[j][d]);
          dv[j][d] = fmaf(p4.z, ov[2][d], dv[j][d]);
          dv[j][d] = fmaf(p4.w, ov[3][d], dv[j][d]);
          dk[j][d] = fmaf(s4.x, qv[0][d], dk[j][d]);
          dk[j][d] = fmaf(s4.y, qv[1][d], dk[j][d]);
          dk[j][d] = fmaf(s4.z, qv[2][d], dk[j][d]);
          dk[j][d] = fmaf(s4.w, qv[3][d], dk[j][d]);
        }
      }
    }
    __syncthreads();  // every warp's dS is in shared memory

    // dQ[r] += scale * dS[:, r] . K for this warp's 8 query rows
    constexpr int RW = BQ / NWARPS;
    const int r0 = warp * RW;
    float dq[RW][DS];
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int d = 0; d < DS; ++d) dq[i][d] = 0.f;
    for (int j = 0; j < BK; ++j) {
      float kv[DS];
#pragma unroll
      for (int d = 0; d < DS; ++d) kv[d] = Ks[j * D + lane + 32 * d];
      const float4 sa = *reinterpret_cast<const float4*>(dSs + j * BQ + r0);
      const float4 sb = *reinterpret_cast<const float4*>(dSs + j * BQ + r0 + 4);
      const float sv[RW] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int d = 0; d < DS; ++d) dq[i][d] = fmaf(sv[i], kv[d], dq[i][d]);
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int tq = q0 + r0 + i;
      if (tq >= a.Tq) break;
      float* dqr = a.dq + ((long long)b * a.Tq + tq) * HD + h * D;
#pragma unroll
      for (int d = 0; d < DS; ++d)
        atomicAdd(dqr + lane + 32 * d, dq[i][d] * a.scale);
    }
  }

#pragma unroll
  for (int j = 0; j < KW; ++j) {
    const int kk = k0 + kw0 + j;
    if (kk >= a.Tk) break;
    const long long row = ((long long)b * a.Tk + kk) * HD + h * D;
#pragma unroll
    for (int d = 0; d < DS; ++d) {
      a.dk[row + lane + 32 * d] = dk[j][d] * a.scale;
      a.dv[row + lane + 32 * d] = dv[j][d];
    }
  }
  if (a.dbias && lane < KW && k0 + kw0 + lane < a.Tk)
    a.dbias[(long long)bh * a.Tk + k0 + kw0 + lane] = db;
}

template <int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = Cfg<D>::smem_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tk + Cfg<D>::BK - 1) / Cfg<D>::BK, B * a.H);
  flash_bwd_kernel<D><<<grid, NWARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 only. q/k/v/dout: [B, T, H*D] with element strides (batch, row) and
// a contiguous feature dim; lse/delta: [B, H, Tq] contiguous; bias: f32
// [B or 1, Tk] with batch stride bias_sb (0 broadcasts), or null; seed: one
// int64 on the device, or null for no dropout. dq: [B, Tq, H*D] f32,
// contiguous and ZEROED by the caller (blocks add into it); dk/dv:
// [B, Tk, H*D] contiguous; dbias: [B, H, Tk] per-head partials, or null.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        const void* bias, const void* seed, void* dq,
                        void* dk, void* dv, void* dbias, int B, int H,
                        int Tq, int Tk, int D, long long q_sb,
                        long long q_st, long long k_sb, long long k_st,
                        long long v_sb, long long v_st, long long do_sb,
                        long long do_st, long long bias_sb, float scale,
                        int causal, unsigned keep_thresh, float inv_keep,
                        void* stream) {
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(dout),
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<const float*>(bias),
         static_cast<const long long*>(seed), static_cast<float*>(dq),
         static_cast<float*>(dk), static_cast<float*>(dv),
         static_cast<float*>(dbias), H, Tq, Tk, q_sb, q_st, k_sb, k_st,
         v_sb, v_st, do_sb, do_st, bias_sb, scale, causal, keep_thresh,
         inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(a, B, s);
    case 64: return launch<64>(a, B, s);
    case 128: return launch<128>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
