// Flash-attention backward for Hopper (sm_90a), on the tensor cores.
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
// delta = rowsum(dO * O) (computed by the wrapper, as the reference's
// _packed_stream_bwd_impl computes it outside its kernel, :840-843):
//   P   = exp(logits - lse), recomputed per tile, never stored;
//         masked logits give P = 0, except in a row with no allowed key
//         (causal, t + Tk - Tq < 0), where the forward averaged V
//         uniformly: there P = 1/Tk;
//   Pd  = P * keep / (1 - rate), dP = keep * (dO . V) / (1 - rate)
//         (keep from flash_dropout.cuh, the forward's mask);
//   dS  = P * (dP - delta), and 0 at every masked logit (the mask's
//         where() passes no gradient);
//   dV  = Pd^T dO, dK = scale * dS^T Q, dQ = scale * dS K,
//   dBias[b, h, t, j] = dS; for a padding mask (one row of keys per batch
//   and head) its sum over t, per head (the wrapper sums what the bias
//   broadcasts over).
//
// What bounds it on the card: operations. A query-key pair costs 5*D
// multiply-adds (S, dP, dV, dK, dQ): at Transformer-base's training shape
// (B = 128, T = 256, H = 8, D = 64) 10 * 4.3 GFLOP, run as 3xTF32 (three
// TF32 tensor-core products per f32 product, mma_tf32.cuh) at 495 TFLOP/s.
// The bytes (q, k, v, dO, dQ, dK, dV once each) are far fewer.
//
// Design. One block per (batch, head, tile of BK = 16 * RW keys) loops over
// the query tiles of BQ rows, as the TPU kernel looped its sequential grid;
// the tiles stream through a 2-stage cp.async ring (Q, dO, lse and delta;
// 16-byte copies, zero-filled past Tq and past the head dim by src-size 0).
// The kernel waits on latency more than it issues: for head dims up to
// 64, 16-query tiles and registers held to three blocks an SM timed best
// on the card.
// All five products are 3xTF32 mma.sync m16n8k8 fragment products:
//   * S^T = K Q^T and dP^T = V dO^T: each of RW warps owns 16 keys (the M
//     rows); K and V stay in shared memory for the whole loop. Where the
//     head dim is 128 or more, DW = 2 or 4 warps split its columns (dK and
//     dV, 16 rows by 512 columns, would not fit one warp's registers): each
//     computes partial S^T and dP^T over its columns, summed through shared
//     memory in a fixed order, so every warp of a key group holds the same
//     P and dS;
//     S^T and dP^T take each k-step's three products from zero and add
//     them in on the FMA pipe (mma_3xtf32_add): chained on the tensor
//     cores, which truncate each addition, the error of S reaches dS and
//     so dQ and dK;
//   * P and dS are computed on the accumulator fragments, each element with
//     the dropout bit of its own (t, j);
//   * dV += Pd^T dO and dK += dS^T Q take the accumulators as A fragments
//     as they stand: the product runs its 8 queries in the order 0, 2, 4,
//     6, 1, 3, 5, 7 (mma k-index t is query 2t, t + 4 is 2t + 1), so the
//     accumulator (row g, queries 2t, 2t + 1) is the A fragment and dO's
//     and Q's B fragments read rows 2t and 2t + 1. dK and dV sum over all
//     Tq queries; the tensor cores round their additions toward zero, so
//     each query tile's sum goes into a fresh accumulator that is added
//     into the f32 dK / dV on the FMA pipe;
//   * dQ += scale * dS K needs dS with queries as rows: dS^T goes to shared
//     memory, and the block's warps split the [BQ, D] dQ tile between
//     them, keeping 3xTF32's small terms in accumulators of their own
//     (mma_3xtf32_sep). dQ sums over key tiles, which run on different
//     blocks in no
//     order: each block adds its tile into the f32 dQ with one atomicAdd
//     (red.global.add.f32) per element per key tile, straight from the
//     accumulators. dQ is therefore not bitwise reproducible: its
//     summation order changes from run to run, by a few f32 ulps of the
//     largest partial. dK, dV and dBias are deterministic.
// Head dims: every multiple of 8 up to 512, rounded up to an instantiated
// width DP of 16, 32, 64, 128, 256 or 512 (zero columns add nothing; the
// wrappers pad any other head dim to a multiple of 8 the same way). A
// padding mask rides the ring with K and V; any other bias is read per
// (query, key) by its strides, and its gradient dS written per element,
// in instantiations of their own (ROWS), so the padding-mask path carries
// no branch for it.
// Shared-memory rows are padded to DP + 4 floats (dS^T to BQ + 4) so the
// fragment loads are free of bank conflicts. Query tiles a causal key tile
// cannot see are skipped, with the forward's rule: only when every row of
// the tile keeps at least one key.

#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "flash_dropout.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGES = 2;

struct Args {
  const float* q; const float* k; const float* v; const float* dout;
  const float* lse; const float* delta; const float* bias;
  const long long* seed;
  float* dq; float* dk; float* dv; float* dbias;
  int H, Tq, Tk, d;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st;
  long long bias_sb, bias_sh, bias_st;  // bias_st == 0: one row per head
  float scale; int causal; unsigned keep_thresh; float inv_keep;
};

// DP: instantiated head-dim width; RW warps of 16 keys; DW warps over the
// head dim; BQ queries per tile. Shared memory, in floats: K, V [BK][LD];
// STAGES x (Q, dO [BQ][LD], lse, delta [BQ]); dS^T [BK][LDS]; bias [BK];
// for DW > 1 the partial S^T and dP^T, [NW][NQ][4][32] each.
template <int DP, int RW, int DW, int BQ>
struct Cfg {
  static constexpr int NW = RW * DW, NTH = 32 * NW;
  static constexpr int BK = 16 * RW;   // keys per block
  static constexpr int LD = DP + 4;
  static constexpr int DSL = DP / DW;  // columns per warp
  static constexpr int KD = DSL / 8;   // k-steps of S^T and dP^T
  static constexpr int NQ = BQ / 8;    // query n-tiles
  static constexpr int NO = DSL / 8;   // column n-tiles of dK, dV
  static constexpr int NC = NO < 8 ? NO : 8;  // n-tiles per pass
  static constexpr int LDS = BQ + 4;
  // dQ: m-tiles, column groups (warps past MQ * CG sit it out), columns
  // per warp, n-tiles per pass
  static constexpr int MQ = BQ / 16;
  static constexpr int CG = NW / MQ < DP / 8 ? NW / MQ : DP / 8;
  static constexpr int DQC = DP / CG;
  static constexpr int DQN = (DQC < 64 ? DQC : 64) / 8;
  static constexpr int kv_f = BK * LD;
  static constexpr int stage_off = 2 * kv_f;
  static constexpr int stage_f = 2 * BQ * LD + 2 * BQ;
  static constexpr int ds_off = stage_off + STAGES * stage_f;
  static constexpr int bias_off = ds_off + BK * LDS;
  static constexpr int sp_off = bias_off + BK;
  static constexpr int sp_f = NW * NQ * 4 * 32;
  static constexpr size_t smem =
      sizeof(float) * (size_t(sp_off) + (DW > 1 ? 2 * sp_f : 0));
  static_assert(NW % MQ == 0 && DQC % (8 * DQN) == 0 && DQN > 0,
                "dQ work split");
};

// acc[n] += A . X[rows, c + 8n ...] over the tile's queries, where the
// accumulator fragments frag[j] (rows: the warp's 16 keys, columns:
// queries 8j + 2t, 2t + 1) are the A fragments with the queries in the
// order 2t, 2t + 1, and X is Q or dO in shared memory; each tile's sum is
// added into acc on the FMA pipe
template <int NQ, int NO, int NC, int LD>
__device__ __forceinline__ void accumulate_t(float (&acc)[NO][4],
                                             const float (&frag)[NQ][4],
                                             const float* X, int c, int g,
                                             int tq) {
#pragma unroll
  for (int n0 = 0; n0 < NO; n0 += NC) {
    float part[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      unsigned ab[4], as[4];
      split_tf32(frag[j][0], ab[0], as[0]);
      split_tf32(frag[j][2], ab[1], as[1]);
      split_tf32(frag[j][1], ab[2], as[2]);
      split_tf32(frag[j][3], ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float* xp = X + (j * 8 + 2 * tq) * LD + c + (n0 + n) * 8 + g;
        unsigned bb[2], bs[2];
        split_tf32(xp[0], bb[0], bs[0]);
        split_tf32(xp[LD], bb[1], bs[1]);
        mma_3xtf32(part[n], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

// MINB: blocks an SM must hold (caps the registers); ROWS: the bias has
// a row per query (read, and its gradient written, per pair), else at
// most one row of keys per head
template <int DP, int RW, int DW, int BQ, int MINB, bool ROWS>
__global__ void __launch_bounds__(32 * RW * DW, MINB)
flash_bwd_kernel(Args a) {
  using C = Cfg<DP, RW, DW, BQ>;
  constexpr int NTH = C::NTH, BK = C::BK, LD = C::LD, KD = C::KD;
  constexpr int NQ = C::NQ, NO = C::NO, NC = C::NC, LDS = C::LDS;
  constexpr int CPR = DP / 4;  // 16-byte chunks per row
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + C::kv_f;
  float* dSs = smem + C::ds_off;
  float* Bk = smem + C::bias_off;
  float* Sp = smem + C::sp_off;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp / DW, dw = warp % DW;
  const int g = lane >> 2, tq = lane & 3;  // quad, lane in quad
  const int kr0 = rw * 16, c0 = dw * C::DSL;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * BK;
  const int shift = a.Tk - a.Tq;  // causal: key j allowed iff j <= t + shift
  const long long HD = (long long)a.H * a.d;
  const float inv_tk = 1.f / a.Tk;
  const uint32_t dkey = a.seed ? dropout_key(*a.seed, bh) : 0u;

  const float* qb = a.q + b * a.q_sb + (long long)h * a.d;
  const float* kb = a.k + b * a.k_sb + (long long)h * a.d;
  const float* vb = a.v + b * a.v_sb + (long long)h * a.d;
  const float* dob = a.dout + b * a.do_sb + (long long)h * a.d;
  const float* lseb = a.lse + (long long)bh * a.Tq;
  const float* deltab = a.delta + (long long)bh * a.Tq;
  const float* biasb =
      a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;

  // K, V and the bias travel in the ring's first group
  for (int i = tid; i < BK * CPR; i += NTH) {
    const int j = i / CPR, c = (i % CPR) * 4, key = k0 + j;
    const bool ok = key < a.Tk && c < a.d;
    cp16(Ks + j * LD + c, ok ? kb + key * a.k_st + c : kb, ok);
    cp16(Vs + j * LD + c, ok ? vb + key * a.v_st + c : vb, ok);
  }
  if (!ROWS && biasb) {
    for (int j = tid; j < BK; j += NTH) {
      const bool ok = k0 + j < a.Tk;
      cp4(Bk + j, ok ? biasb + k0 + j : biasb, ok);
    }
  }

  auto stage = [&](int st) { return smem + C::stage_off + st * C::stage_f; };
  auto load_q = [&](int st, int q0) {
    float* Qs = stage(st);
    float* dOs = Qs + BQ * LD;
    float* Ls = dOs + BQ * LD;
    float* Dl = Ls + BQ;
    for (int i = tid; i < BQ * CPR; i += NTH) {
      const int r = i / CPR, c = (i % CPR) * 4, t = q0 + r;
      const bool ok = t < a.Tq && c < a.d;
      cp16(Qs + r * LD + c, ok ? qb + t * a.q_st + c : qb, ok);
      cp16(dOs + r * LD + c, ok ? dob + t * a.do_st + c : dob, ok);
    }
    for (int r = tid; r < BQ; r += NTH) {
      const bool ok = q0 + r < a.Tq;
      cp4(Ls + r, ok ? lseb + q0 + r : lseb, ok);
      cp4(Dl + r, ok ? deltab + q0 + r : deltab, ok);
    }
  };

  // A causal key tile skips the query tiles whose every pair is masked and
  // whose every row keeps a key: those contribute exactly zero. They form
  // one run [lo, hi) (the first test holds from some tile on, the second
  // up to some tile), so the ring walks the tiles outside it.
  const int n_qt = (a.Tq + BQ - 1) / BQ;
  auto skippable = [&](int qt) {
    const int q0 = qt * BQ, q_last = min(q0 + BQ, a.Tq) - 1;
    return a.causal && q0 + shift >= 0 && q_last + shift < k0;
  };
  int lo = 0;
  while (lo < n_qt && !skippable(lo)) ++lo;
  int hi = lo;
  while (hi < n_qt && skippable(hi)) ++hi;
  const int n_visit = n_qt - (hi - lo);
  auto tile_q0 = [&](int it) { return (it < lo ? it : it + hi - lo) * BQ; };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_visit) load_q(s, tile_q0(s));
    cp_commit();
  }

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  float db[2] = {0.f, 0.f};  // dBias of keys kr0 + g, kr0 + g + 8 (partial)

  for (int it = 0; it < n_visit; ++it) {
    cp_wait<STAGES - 2>();  // tile it (and K, V) landed
    __syncthreads();        // ... for all threads; tile it - 1 consumed
    {
      const int pf = it + STAGES - 1;
      if (pf < n_visit) load_q(pf % STAGES, tile_q0(pf));
      cp_commit();
    }
    const int q0 = tile_q0(it);
    const float* Qs = stage(it % STAGES);
    const float* dOs = Qs + BQ * LD;
    const float* Ls = dOs + BQ * LD;
    const float* Dl = Ls + BQ;

    // S^T = K . Q^T and dP^T = V . dO^T over this warp's columns
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned kbg[4], ksm[4], vbg[4], vsm[4];
      const int off = (kr0 + g) * LD + c0 + kk * 8 + tq;
      split_tf32(Ks[off], kbg[0], ksm[0]);
      split_tf32(Ks[off + 8 * LD], kbg[1], ksm[1]);
      split_tf32(Ks[off + 4], kbg[2], ksm[2]);
      split_tf32(Ks[off + 8 * LD + 4], kbg[3], ksm[3]);
      split_tf32(Vs[off], vbg[0], vsm[0]);
      split_tf32(Vs[off + 8 * LD], vbg[1], vsm[1]);
      split_tf32(Vs[off + 4], vbg[2], vsm[2]);
      split_tf32(Vs[off + 8 * LD + 4], vbg[3], vsm[3]);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int qo = (j * 8 + g) * LD + c0 + kk * 8 + tq;
        unsigned bb[2], bs[2];
        split_tf32(Qs[qo], bb[0], bs[0]);
        split_tf32(Qs[qo + 4], bb[1], bs[1]);
        mma_3xtf32_add(st[j], kbg, ksm, bb, bs);
        split_tf32(dOs[qo], bb[0], bs[0]);
        split_tf32(dOs[qo + 4], bb[1], bs[1]);
        mma_3xtf32_add(dpt[j], vbg, vsm, bb, bs);
      }
    }
    if constexpr (DW > 1) {  // sum the column groups' partials in order
      float* Sd = Sp + C::sp_f;
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          Sp[((warp * NQ + j) * 4 + e) * 32 + lane] = st[j][e];
          Sd[((warp * NQ + j) * 4 + e) * 32 + lane] = dpt[j][e];
        }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int w = 0; w < DW; ++w) {
            const int i = (((rw * DW + w) * NQ + j) * 4 + e) * 32 + lane;
            s1 += Sp[i];
            s2 += Sd[i];
          }
          st[j][e] = s1;
          dpt[j][e] = s2;
        }
    }

    // Pd into st, dS into dpt: element (j, e) is key k0 + kr0 + g +
    // 8 * (e / 2), query q0 + 8 * j + 2 * tq + e % 2
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = kr0 + g + 8 * (e >> 1), key = k0 + kl;
        const int ql = j * 8 + 2 * tq + (e & 1), t = q0 + ql;
        float p = 0.f, ds = 0.f;
        if (t < a.Tq && key < a.Tk) {
          const bool masked = a.causal && key > t + shift;
          if (masked) {
            p = t + shift < 0 ? inv_tk : 0.f;  // a row with no allowed key
          } else {
            const float bv = ROWS ? __ldg(biasb + t * a.bias_st + key)
                                  : (biasb ? Bk[kl] : 0.f);
            p = expf(st[j][e] * a.scale + bv - Ls[ql]);
          }
          float pd = p, dpv = dpt[j][e];
          if (a.seed) {
            const bool keep = dropout_keep(dkey, (long long)t * a.Tk + key,
                                           a.keep_thresh);
            pd = keep ? p * a.inv_keep : 0.f;
            dpv = keep ? dpv * a.inv_keep : 0.f;
          }
          ds = masked ? 0.f : p * (dpv - Dl[ql]);
          p = pd;
          if (ROWS && a.dbias && dw == 0)
            a.dbias[((long long)bh * a.Tq + t) * a.Tk + key] = ds;
        }
        st[j][e] = p;
        dpt[j][e] = ds;
        db[e >> 1] += ds;
      }

    // dV += Pd^T . dO and dK += dS^T . Q
    accumulate_t<NQ, NO, NC, LD>(dv, st, dOs, c0, g, tq);
    accumulate_t<NQ, NO, NC, LD>(dk, dpt, Qs, c0, g, tq);

    // dS^T to shared memory (one warp per key group) for dQ
    if (dw == 0) {
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(dSs + (kr0 + g + 8 * hh) * LDS + j * 8 +
                                     2 * tq) =
              make_float2(dpt[j][2 * hh], dpt[j][2 * hh + 1]);
    }
    __syncthreads();

    // dQ[q0 + 16 mi ..] += scale * dS . K over the block's keys, in the
    // order 2t, 2t + 1 within each 8: warp -> (m-tile mi, column group cg)
    if (warp < C::MQ * C::CG) {
      const int mi = warp % C::MQ, cg = warp / C::MQ;
#pragma unroll
      for (int cq = 0; cq < C::DQC; cq += 8 * C::DQN) {
        const int cb = cg * C::DQC + cq;
        float acc[C::DQN][4], asm_[C::DQN][4];  // asm_: the small terms
#pragma unroll
        for (int n = 0; n < C::DQN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = asm_[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          const float* sp = dSs + (kk * 8 + 2 * tq) * LDS + mi * 16 + g;
          unsigned ab[4], as[4];
          split_tf32(sp[0], ab[0], as[0]);
          split_tf32(sp[8], ab[1], as[1]);
          split_tf32(sp[LDS], ab[2], as[2]);
          split_tf32(sp[LDS + 8], ab[3], as[3]);
#pragma unroll
          for (int n = 0; n < C::DQN; ++n) {
            const float* kp = Ks + (kk * 8 + 2 * tq) * LD + cb + n * 8 + g;
            unsigned bb[2], bs[2];
            split_tf32(kp[0], bb[0], bs[0]);
            split_tf32(kp[LD], bb[1], bs[1]);
            mma_3xtf32_sep(acc[n], asm_[n], ab, as, bb, bs);
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = q0 + mi * 16 + g + 8 * hh;
          if (t >= a.Tq) continue;
          float* dqr = a.dq + ((long long)b * a.Tq + t) * HD +
                       (long long)h * a.d;
#pragma unroll
          for (int n = 0; n < C::DQN; ++n) {
            const int col = cb + n * 8 + 2 * tq;
            if (col < a.d) {
              atomicAdd(dqr + col,
                        (acc[n][2 * hh] + asm_[n][2 * hh]) * a.scale);
              atomicAdd(dqr + col + 1, (acc[n][2 * hh + 1] +
                                        asm_[n][2 * hh + 1]) * a.scale);
            }
          }
        }
      }
    }
  }
  cp_wait<0>();  // a block that skipped every tile still waits for K, V

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + kr0 + g + 8 * hh;
    db[hh] += __shfl_xor_sync(FULL, db[hh], 1);
    db[hh] += __shfl_xor_sync(FULL, db[hh], 2);
    if (key >= a.Tk) continue;
    const long long row = ((long long)b * a.Tk + key) * HD +
                          (long long)h * a.d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = c0 + n * 8 + 2 * tq;
      if (col < a.d) {
        *reinterpret_cast<float2*>(a.dk + row + col) = make_float2(
            dk[n][2 * hh] * a.scale, dk[n][2 * hh + 1] * a.scale);
        *reinterpret_cast<float2*>(a.dv + row + col) =
            make_float2(dv[n][2 * hh], dv[n][2 * hh + 1]);
      }
    }
    if (!ROWS && a.dbias && dw == 0 && tq == 0)
      a.dbias[(long long)bh * a.Tk + key] = db[hh];
  }
}

template <int DP, int RW, int DW, int BQ, int MINB, bool ROWS>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<DP, RW, DW, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<DP, RW, DW, BQ, MINB, ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tk + C::BK - 1) / C::BK, B * a.H);
  flash_bwd_kernel<DP, RW, DW, BQ, MINB, ROWS>
      <<<grid, C::NTH, C::smem, stream>>>(a);
  return cudaGetLastError();
}

// the instantiated width for head dim d (a multiple of 8, at most 512):
// ops/flash_attention.py _WIDTHS lists the same widths
template <bool ROWS>
cudaError_t dispatch_width(const Args& a, int B, cudaStream_t s) {
  if (a.d <= 16) return launch<16, 4, 1, 16, 3, ROWS>(a, B, s);
  if (a.d <= 32) return launch<32, 4, 1, 16, 3, ROWS>(a, B, s);
  if (a.d <= 64) return launch<64, 4, 1, 16, 3, ROWS>(a, B, s);
  if (a.d <= 128) return launch<128, 2, 2, 32, 1, ROWS>(a, B, s);
  if (a.d <= 256) return launch<256, 1, 4, 32, 1, ROWS>(a, B, s);
  if (a.d <= 512) return launch<512, 1, 4, 16, 1, ROWS>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// f32 only. D: the head dim, a multiple of 8 up to 512. q/k/v/dout:
// [B, T, H*D] with element strides (batch, row), a contiguous feature dim,
// and pointers and strides that are multiples of 16 bytes; lse/delta:
// [B, H, Tq] contiguous; bias: null or f32, read as [B, H, Tq, Tk] through
// the element strides bias_sb, bias_sh, bias_st and 1 (0 broadcasts), as
// the forward reads it; seed: one int64 on the device, or null for no
// dropout. dq: [B, Tq, H*D] f32, contiguous and ZEROED by the caller
// (blocks add into it); dk/dv: [B, Tk, H*D] contiguous; dbias: null, or
// for bias_st == 0 the [B, H, Tk] sums over the queries, else dS itself,
// [B, H, Tq, Tk] contiguous and ZEROED by the caller (pairs of query and
// key tiles a causal block skips are not written).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        const void* bias, const void* seed, void* dq,
                        void* dk, void* dv, void* dbias, int B, int H,
                        int Tq, int Tk, int D, long long q_sb,
                        long long q_st, long long k_sb, long long k_st,
                        long long v_sb, long long v_st, long long do_sb,
                        long long do_st, long long bias_sb,
                        long long bias_sh, long long bias_st, float scale,
                        int causal, unsigned keep_thresh, float inv_keep,
                        void* stream) {
  if (D % 8 != 0 || D < 8 || D > 512) return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(dout),
         static_cast<const float*>(lse), static_cast<const float*>(delta),
         static_cast<const float*>(bias),
         static_cast<const long long*>(seed), static_cast<float*>(dq),
         static_cast<float*>(dk), static_cast<float*>(dv),
         static_cast<float*>(dbias), H, Tq, Tk, D, q_sb, q_st, k_sb, k_st,
         v_sb, v_st, do_sb, do_st, bias_sb, bias_sh, bias_st, scale, causal,
         keep_thresh, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bias && bias_st != 0 ? dispatch_width<true>(a, B, s)
                              : dispatch_width<false>(a, B, s);
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
