// Flash-attention backward for Hopper (sm_90a), on the tensor cores, for
// f32 and bf16 q/k/v/dO.
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
//
// bf16 (AMP; the reference's _packed_bwd_kernel under bf16 operands,
// :724-736, :898-899). Every product is ONE bf16 mma.sync m16n8k16 with
// f32 accumulators instead of three TF32 ones: the operands are bf16
// already, and their products are exact in f32. The rounding points are
// the reference's: S^T and dP^T accumulate in f32 from the bf16 K, Q, V
// and dO; P and dS are computed in f32, and P after dropout and dS are
// rounded to bf16 as the A fragments of dV += Pd^T dO and dK += dS^T Q
// (the accumulator layout of m16n8 is the A layout of m16n8k16, so two
// query n-tiles pack into one k-step with no shuffle); dS^T goes to shared
// memory as bf16 for dQ += dS K, whose A fragment pairs keys 2t, 2t + 1
// (two 16-bit loads). dQ sums in f32 with the same atomics (the wrapper
// rounds it to bf16 once); dK and dV are summed in f32 per query tile and
// stored as bf16. Shared memory holds K, V, Q, dO and dS^T in bf16, rows
// padded to DP + 8 and BQ + 8 elements; lse, delta and the bias stay f32.
// The dropout hash (flash_dropout.cuh) is the f32 form's, so both draw the
// same mask. Bounded by operations: 10 * 4.3 GFLOP at the training shape
// at 989 TFLOP/s.
//
// bf16 on wgmma (flash_bwd_wgmma_kernel). The route (ops/flash_attention.py
// bwd_form) sends it every bf16 call with a padded head dim dp that is a
// multiple of 16 up to 128 and no bias or one row of keys per (b, h), at
// any Tq and Tk: the AMP training step's 18 launches. Every other call
// keeps the mma.sync form above. It computes what that form computes, with
// the same rounding points; what differs is how the products are fed:
//   * A block is one warpgroup owning 64 keys of one (b, h) as the M rows
//     of its products; dK and dV stay in registers (238 a thread at DP
//     64); two blocks an SM. At the training shape two warpgroups a
//     block (128 keys, one block an SM, their dQ partials summed in
//     shared memory before the reductions) ran slower over the training
//     path's mix of calls, most on the causal ones.
//     One thread loads K and V once by TMA (3-d maps of the packed
//     [B, T, H*D] layout, box {64 columns, keys}, the 128-byte swizzle,
//     as flash_fwd_wgmma_kernel loads them), and Q and dO of each 64-query
//     tile through a 2-stage mbarrier ring, the next tile in flight while
//     this one is computed; lse and delta ride beside them in shared
//     memory, the per-key bias once a block.
//   * A prep kernel first computes delta = rowsum(dO * O) from the bf16
//     rows (16-byte loads, f32 sums) and zeroes dq: in torch delta took
//     0.248 ms at the training shape (PERF.md), half this backward.
//   * S^T = K . Q^T and dP^T = V . dO^T: m64n64k16 with both operands
//     K-major in shared memory. P and dS are computed on the accumulators
//     (element 4 j + e: key row 16 w + g + 8 (e / 2), query column 8 j +
//     2 tq + e % 2; the dropout bit of each (t, j) from flash_dropout.cuh),
//     P as exp2 of the logit in log2 units (bias and lse scaled by log2(e)
//     once, as they are loaded); a tile whose every pair is in range and
//     allowed takes a loop without tests.
//   * dV += Pd^T . dO and dK += dS^T . Q: Pd and dS rounded to bf16 are the
//     register A operands as they stand (the accumulator layout is the A
//     fragment's, 16 queries a k-step), dO and Q the N-contiguous B. dK and
//     dV sum on the tensor cores over every query: their bf16 rounding at
//     the end lies far above what the truncated additions lose.
//   * dQ = dS . K needs dS with queries as rows: dS^T goes to shared memory
//     as bf16 in the 128-byte swizzle ([keys][queries], written by each
//     thread's 4-byte pairs, conflict-free), and dQ's product reads it as
//     an M-contiguous A (the transpose bit of A) against K read
//     N-contiguous.
//   * dQ's reduction traffic. dQ is f32 [B, Tq, H*D]: 67 MB at the
//     training shape. Blocks of 64 keys add into each element 4 times at
//     Tk = 256 (268 MB of reductions, as many bytes as the kernel's whole
//     bound), blocks of 128 keys twice. The f32 partial of a block goes
//     through shared memory and out as one 16-byte reduction
//     (red.global.add.v4.f32) per 4 columns. They are the largest single
//     phase of the time (PERF.md), yet blocks of 128 keys, which halve
//     them, ran slower: the overlap of two blocks an SM sets the tile.
//     dQ stays non-deterministic (blocks run in no order); dK, dV and
//     dBias are deterministic.
//   * Head dims: instantiated widths DP 64 and 128 (one or two 64-column
//     slabs). A narrower head reads the next head's columns (or zeros
//     past H*D) into the slab; the products over the head dim stop at dp,
//     and the columns past dp are not stored.
// Bounded by bytes at the training shape (0.080 ms: q, k, v, dO, dq, dk,
// dv once each), operations at 0.043 ms.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "flash_dropout.cuh"
#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGES = 2;

struct Args {
  const void* q; const void* k; const void* v; const void* dout;
  const float* lse; const float* delta; const float* bias;
  const long long* seed;
  float* dq; void* dk; void* dv; float* dbias;
  int H, Tq, Tk, d;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st;
  long long bias_sb, bias_sh, bias_st;  // bias_st == 0: one row per head
  float scale; int causal; unsigned keep_thresh; float inv_keep;
};

// T: f32 or bf16; DP: instantiated head-dim width; RW warps of 16 keys;
// DW warps over the head dim; BQ queries per tile. Shared memory, in
// bytes: K, V [BK][LD] of T; STAGES x (Q, dO [BQ][LD] of T, lse, delta
// [BQ] f32); dS^T [BK][LDS] of T; bias [BK] f32; for DW > 1 the partial
// S^T and dP^T, f32 [NW][NQ][4][32] each.
template <typename T, int DP, int RW, int DW, int BQ>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int NW = RW * DW, NTH = 32 * NW;
  static constexpr int BK = 16 * RW;   // keys per block
  static constexpr int LD = DP + (F32 ? 4 : 8);
  static constexpr int DSL = DP / DW;  // columns per warp
  static constexpr int KSTEP = F32 ? 8 : 16;  // k of one mma
  static constexpr int KD = DSL / KSTEP;  // k-steps of S^T and dP^T
  static constexpr int NQ = BQ / 8;    // query n-tiles
  static constexpr int NO = DSL / 8;   // column n-tiles of dK, dV
  static constexpr int NC = NO < 8 ? NO : 8;  // n-tiles per pass
  static constexpr int LDS = BQ + (F32 ? 4 : 8);
  // dQ: m-tiles, column groups (warps past MQ * CG sit it out), columns
  // per warp, n-tiles per pass
  static constexpr int MQ = BQ / 16;
  static constexpr int CG = NW / MQ < DP / 8 ? NW / MQ : DP / 8;
  static constexpr int DQC = DP / CG;
  static constexpr int DQN = (DQC < 64 ? DQC : 64) / 8;
  static constexpr size_t kv_bytes = sizeof(T) * BK * LD;
  static constexpr size_t stage_off = 2 * kv_bytes;
  static constexpr size_t stage_bytes =
      sizeof(T) * 2 * BQ * LD + sizeof(float) * 2 * BQ;
  static constexpr size_t ds_off = stage_off + STAGES * stage_bytes;
  static constexpr size_t bias_off = ds_off + sizeof(T) * BK * LDS;
  static constexpr size_t sp_off = bias_off + sizeof(float) * BK;
  static constexpr int sp_f = NW * NQ * 4 * 32;
  static constexpr size_t smem =
      sp_off + (DW > 1 ? 2 * sizeof(float) * sp_f : 0);
  static_assert(NW % MQ == 0 && DQC % (8 * DQN) == 0 && DQN > 0,
                "dQ work split");
  static_assert(F32 || (KD > 0 && NQ % 2 == 0 && BK % 16 == 0),
                "bf16 k-steps of 16");
  static_assert(stage_off % 16 == 0 && stage_bytes % 16 == 0 &&
                    ds_off % 16 == 0 && bias_off % 16 == 0,
                "16-byte aligned regions");
};

// acc[n] += A . X[rows, c + 8n ...] over the tile's queries, where the
// accumulator fragments frag[j] (rows: the warp's 16 keys, columns:
// queries 8j + 2t, 2t + 1) are the A fragments, and X is Q or dO in
// shared memory; each tile's sum is added into acc on the FMA pipe.
// f32 (3xTF32 m16n8k8): the product runs its 8 queries in the order 2t,
// 2t + 1, so the accumulator is the A fragment as it stands. bf16
// (m16n8k16): n-tiles 2kk and 2kk + 1 are the A fragment of k-step kk,
// rounded to bf16, and X's B fragment pairs rows 2t, 2t + 1 (+ 8).
template <typename T, int NQ, int NO, int NC, int LD>
__device__ __forceinline__ void accumulate_t(float (&acc)[NO][4],
                                             const float (&frag)[NQ][4],
                                             const T* X, int c, int g,
                                             int tq) {
#pragma unroll
  for (int n0 = 0; n0 < NO; n0 += NC) {
    float part[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
    if constexpr (sizeof(T) == 4) {
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
    } else {
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        const unsigned pa[4] = {
            pack_bf16(frag[2 * kk][0], frag[2 * kk][1]),
            pack_bf16(frag[2 * kk][2], frag[2 * kk][3]),
            pack_bf16(frag[2 * kk + 1][0], frag[2 * kk + 1][1]),
            pack_bf16(frag[2 * kk + 1][2], frag[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const T* xp = X + (kk * 16 + 2 * tq) * LD + c + (n0 + n) * 8 + g;
          const unsigned bw[2] = {pack_bf16(xp[0], xp[LD]),
                                  pack_bf16(xp[8 * LD], xp[9 * LD])};
          mma_bf16(part[n], pa, bw);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// MINB: blocks an SM must hold (caps the registers); ROWS: the bias has
// a row per query (read, and its gradient written, per pair), else at
// most one row of keys per head
template <typename T, int DP, int RW, int DW, int BQ, int MINB, bool ROWS>
__global__ void __launch_bounds__(32 * RW * DW, MINB)
flash_bwd_kernel(Args a) {
  using C = Cfg<T, DP, RW, DW, BQ>;
  constexpr int NTH = C::NTH, BK = C::BK, LD = C::LD, KD = C::KD;
  constexpr int NQ = C::NQ, NO = C::NO, NC = C::NC, LDS = C::LDS;
  constexpr int CH = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int CPR = DP / CH;        // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BK * LD;
  T* dSs = reinterpret_cast<T*>(smem + C::ds_off);
  float* Bk = reinterpret_cast<float*>(smem + C::bias_off);
  float* Sp = reinterpret_cast<float*>(smem + C::sp_off);

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

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + (long long)h * a.d;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + (long long)h * a.d;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + (long long)h * a.d;
  const T* dob =
      static_cast<const T*>(a.dout) + b * a.do_sb + (long long)h * a.d;
  const float* lseb = a.lse + (long long)bh * a.Tq;
  const float* deltab = a.delta + (long long)bh * a.Tq;
  const float* biasb =
      a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;

  // K, V and the bias travel in the ring's first group
  for (int i = tid; i < BK * CPR; i += NTH) {
    const int j = i / CPR, c = (i % CPR) * CH, key = k0 + j;
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

  auto stage = [&](int st) {
    return reinterpret_cast<T*>(smem + C::stage_off + st * C::stage_bytes);
  };
  auto load_q = [&](int st, int q0) {
    T* Qs = stage(st);
    T* dOs = Qs + BQ * LD;
    float* Ls = reinterpret_cast<float*>(dOs + BQ * LD);
    float* Dl = Ls + BQ;
    for (int i = tid; i < BQ * CPR; i += NTH) {
      const int r = i / CPR, c = (i % CPR) * CH, t = q0 + r;
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
    const T* Qs = stage(it % STAGES);
    const T* dOs = Qs + BQ * LD;
    const float* Ls = reinterpret_cast<const float*>(dOs + BQ * LD);
    const float* Dl = Ls + BQ;

    // S^T = K . Q^T and dP^T = V . dO^T over this warp's columns
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if constexpr (C::F32) {
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
      } else {
        const int off = (kr0 + g) * LD + c0 + kk * 16 + 2 * tq;
        const unsigned ka[4] = {ld32(Ks + off), ld32(Ks + off + 8 * LD),
                                ld32(Ks + off + 8),
                                ld32(Ks + off + 8 * LD + 8)};
        const unsigned va[4] = {ld32(Vs + off), ld32(Vs + off + 8 * LD),
                                ld32(Vs + off + 8),
                                ld32(Vs + off + 8 * LD + 8)};
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int qo = (j * 8 + g) * LD + c0 + kk * 16 + 2 * tq;
          const unsigned qw[2] = {ld32(Qs + qo), ld32(Qs + qo + 8)};
          mma_bf16(st[j], ka, qw);
          const unsigned dw2[2] = {ld32(dOs + qo), ld32(dOs + qo + 8)};
          mma_bf16(dpt[j], va, dw2);
        }
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
    accumulate_t<T, NQ, NO, NC, LD>(dv, st, dOs, c0, g, tq);
    accumulate_t<T, NQ, NO, NC, LD>(dk, dpt, Qs, c0, g, tq);

    // dS^T to shared memory (one warp per key group) for dQ; bf16 rounds
    // it here, as the reference rounds dS for its dQ product
    if (dw == 0) {
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          store2(dSs + (kr0 + g + 8 * hh) * LDS + j * 8 + 2 * tq,
                 dpt[j][2 * hh], dpt[j][2 * hh + 1]);
    }
    __syncthreads();

    // dQ[q0 + 16 mi ..] += scale * dS . K over the block's keys: warp ->
    // (m-tile mi, column group cg)
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
        if constexpr (C::F32) {
          // keys in the order 2t, 2t + 1 within each 8
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
        } else {
          // A: dS rows (queries) g, g + 8 by keys 2t, 2t + 1 (+ 8) of dS^T
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const T* sp = dSs + (kk * 16 + 2 * tq) * LDS + mi * 16 + g;
            const unsigned af[4] = {pack_bf16(sp[0], sp[LDS]),
                                    pack_bf16(sp[8], sp[LDS + 8]),
                                    pack_bf16(sp[8 * LDS], sp[9 * LDS]),
                                    pack_bf16(sp[8 * LDS + 8],
                                              sp[9 * LDS + 8])};
#pragma unroll
            for (int n = 0; n < C::DQN; ++n) {
              const T* kp = Ks + (kk * 16 + 2 * tq) * LD + cb + n * 8 + g;
              const unsigned bw[2] = {pack_bf16(kp[0], kp[LD]),
                                      pack_bf16(kp[8 * LD], kp[9 * LD])};
              mma_bf16(acc[n], af, bw);
            }
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

  T* dkb = static_cast<T*>(a.dk);
  T* dvb = static_cast<T*>(a.dv);
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
        store2(dkb + row + col, dk[n][2 * hh] * a.scale,
               dk[n][2 * hh + 1] * a.scale);
        store2(dvb + row + col, dv[n][2 * hh], dv[n][2 * hh + 1]);
      }
    }
    if (!ROWS && a.dbias && dw == 0 && tq == 0)
      a.dbias[(long long)bh * a.Tk + key] = db[hh];
  }
}

template <typename T, int DP, int RW, int DW, int BQ, int MINB, bool ROWS>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<T, DP, RW, DW, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, DP, RW, DW, BQ, MINB, ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tk + C::BK - 1) / C::BK, B * a.H);
  flash_bwd_kernel<T, DP, RW, DW, BQ, MINB, ROWS>
      <<<grid, C::NTH, C::smem, stream>>>(a);
  return cudaGetLastError();
}

// the instantiated width for head dim d (a multiple of 8, at most 512):
// ops/flash_attention.py _WIDTHS lists the same widths
template <typename T, bool ROWS>
cudaError_t dispatch_width(const Args& a, int B, cudaStream_t s) {
  if (a.d <= 16) return launch<T, 16, 4, 1, 16, 3, ROWS>(a, B, s);
  if (a.d <= 32) return launch<T, 32, 4, 1, 16, 3, ROWS>(a, B, s);
  if (a.d <= 64) return launch<T, 64, 4, 1, 16, 3, ROWS>(a, B, s);
  if (a.d <= 128) return launch<T, 128, 2, 2, 32, 1, ROWS>(a, B, s);
  if (a.d <= 256) return launch<T, 256, 1, 4, 32, 1, ROWS>(a, B, s);
  if (a.d <= 512) return launch<T, 512, 1, 4, 16, 1, ROWS>(a, B, s);
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// bf16 on warpgroup products (see "bf16 on wgmma" in the header)
// ---------------------------------------------------------------------------
namespace wgfb {

constexpr int BK = 64;       // keys a block: one warpgroup's rows
constexpr int BQ = 64;       // queries a tile
constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

struct WArgs {
  const float* lse; const float* delta; const float* bias;
  const long long* seed;
  float* dq; __nv_bfloat16* dk; __nv_bfloat16* dv; float* dbias;
  int H, Tq, Tk, d;
  long long bias_sb, bias_sh;
  float scale; int causal; unsigned keep_thresh; float inv_keep;
};

// Shared memory, in bytes from a 1024-aligned base: K and V [BK keys] x NA
// 64-column slabs each; two stages of Q and dO [BQ] x NA slabs each; dS^T
// [BK keys][BQ queries] bf16; the f32 dQ partial [BQ][DP + 8]; the
// per-key bias; lse and delta [2 stages][BQ]; the barriers.
template <int DP>
struct WCfg {
  static constexpr int NA = DP / 64;
  static constexpr int KV_SLAB = BK * 128;
  static constexpr int Q_SLAB = BQ * 128;
  static constexpr int STAGE = 2 * NA * Q_SLAB;  // Q slabs, then dO slabs
  static constexpr int STG_LD = DP + 8;  // floats: conflict-free float2s
  static constexpr size_t K_OFF = 0;
  static constexpr size_t V_OFF = K_OFF + size_t(NA) * KV_SLAB;
  static constexpr size_t ST_OFF = V_OFF + size_t(NA) * KV_SLAB;
  static constexpr size_t DS_OFF = ST_OFF + 2 * size_t(STAGE);
  static constexpr size_t STG_OFF = DS_OFF + size_t(BK) * 128;
  static constexpr size_t BIAS_OFF =
      STG_OFF + sizeof(float) * BQ * STG_LD;
  static constexpr size_t LD_OFF = BIAS_OFF + sizeof(float) * BK;
  static constexpr size_t BAR_OFF = LD_OFF + sizeof(float) * 2 * 2 * BQ;
  static constexpr size_t SMEM = 1024 + BAR_OFF + 3 * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(DS_OFF % 1024 == 0 && ST_OFF % 1024 == 0,
                "swizzle atoms 1024-aligned");
};

}  // namespace wgfb

// One block: one warpgroup, 64 keys of one (b, h), walking the query
// tiles its keys can see; thread 0 issues every TMA load.
template <int DP>
__global__ void __launch_bounds__(wgfb::THREADS, 2)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                       const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv,
                       const __grid_constant__ CUtensorMap tmdo,
                       wgfb::WArgs a) {
  using C = wgfb::WCfg<DP>;
  constexpr int NA = C::NA, BK = wgfb::BK, BQ = wgfb::BQ;
  constexpr int NTH = wgfb::THREADS, LD = C::STG_LD;
  constexpr float LOG2E = wgfb::LOG2E;
  extern __shared__ __align__(1024) unsigned char fb_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fb_smem) + 1023) & ~uintptr_t(1023));
  unsigned char* ks = base + C::K_OFF;
  unsigned char* vs = base + C::V_OFF;
  unsigned char* dst = base + C::DS_OFF;
  float* stg = reinterpret_cast<float*>(base + C::STG_OFF);
  float* bias_s = reinterpret_cast<float*>(base + C::BIAS_OFF);
  float* ld_s = reinterpret_cast<float*>(base + C::LD_OFF);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);

  const int tid = threadIdx.x;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * BK;
  const int col0 = h * a.d;  // the head's first column in [B, T, H*D]
  const int shift = a.Tk - a.Tq;  // causal: key j allowed iff j <= t + shift
  const long long HD = (long long)a.H * a.d;
  const float inv_tk = 1.f / a.Tk;

  // the query tiles outside the run a causal block skips (every pair
  // masked and every row keeping a key: they add exactly zero)
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
  auto stage = [&](int st) { return base + C::ST_OFF + st * C::STAGE; };
  auto load_tile = [&](int it) {  // thread 0: Q and dO of tile it
    const int st = it & 1, q0 = tile_q0(it);
    unsigned char* qs = stage(st);
    mbar_expect_tx(&bar[1 + st], C::STAGE);
    for (int at = 0; at < NA; ++at) {
      tma_load_3d(qs + at * C::Q_SLAB, &tmq, &bar[1 + st], col0 + 64 * at,
                  q0, b);
      tma_load_3d(qs + (NA + at) * C::Q_SLAB, &tmdo, &bar[1 + st],
                  col0 + 64 * at, q0, b);
    }
  };
  auto load_rows = [&](int it) {  // threads < 2 BQ: lse and delta
    if (tid < 2 * BQ) {
      const int r = tid % BQ, t = tile_q0(it) + r;
      const float* src = tid < BQ ? a.lse : a.delta;
      // lse in log2 units (for exp2), delta as it is
      ld_s[((it & 1) * 2 + tid / BQ) * BQ + r] =
          t < a.Tq ? src[(long long)bh * a.Tq + t] * (tid < BQ ? LOG2E : 1.f)
                   : 0.f;
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
    mbar_expect_tx(&bar[0], 2 * NA * C::KV_SLAB);
    for (int at = 0; at < NA; ++at) {
      tma_load_3d(ks + at * C::KV_SLAB, &tmk, &bar[0], col0 + 64 * at, k0, b);
      tma_load_3d(vs + at * C::KV_SLAB, &tmv, &bar[0], col0 + 64 * at, k0, b);
    }
    if (n_visit > 0) load_tile(0);
  }
  const float* biasb =
      a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
  for (int j = tid; j < BK; j += NTH)
    bias_s[j] =  // in log2 units
        (biasb != nullptr && k0 + j < a.Tk) ? biasb[k0 + j] * LOG2E : 0.f;
  if (n_visit > 0) load_rows(0);
  const uint32_t dkey = a.seed ? dropout_key(*a.seed, bh) : 0u;

  // this thread's key rows (local to the block): kr and kr + 8
  const int kr = 16 * warp + g;
  float dk[NA][32], dv[NA][32];
#pragma unroll
  for (int at = 0; at < NA; ++at)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[at][i] = dv[at][i] = 0.f;
  float db[2] = {0.f, 0.f};  // dBias of keys kr, kr + 8 (partial)

  __syncthreads();  // the barriers' init, the bias, tile 0's rows
  mbar_wait(&bar[0], 0);
  for (int it = 0; it < n_visit; ++it) {
    const int st = it & 1;
    if (it > 0) __syncthreads();  // tile it - 1 done: its stage, dS^T and
                                  // partials are free, tile it's rows seen
    if (it + 1 < n_visit) {
      if (tid == 0) load_tile(it + 1);
      load_rows(it + 1);
    }
    const int q0 = tile_q0(it);
    unsigned char* qs = stage(st);
    unsigned char* dos = qs + NA * C::Q_SLAB;
    const float* Ls = ld_s + st * 2 * BQ;
    const float* Dl = Ls + BQ;
    mbar_wait(&bar[1 + st], (it >> 1) & 1);

    // S^T = K . Q^T and dP^T = V . dO^T: this warpgroup's 64 keys by the
    // tile's 64 queries, both operands K-major
    float s[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dpt[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      if (kk * 16 < a.d) {
        const int at = kk / 4, off = (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(
            s, wg_desc(ks + at * C::KV_SLAB + off, 16, 1024),
            wg_desc(qs + at * C::Q_SLAB + off, 16, 1024), kk > 0);
      }
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      if (kk * 16 < a.d) {
        const int at = kk / 4, off = (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(
            dpt, wg_desc(vs + at * C::KV_SLAB + off, 16, 1024),
            wg_desc(dos + at * C::Q_SLAB + off, 16, 1024), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(s);
    wgmma_hold(dpt);

    // Pd into s, dS into dpt: element 4 j + e is key k0 + kr + 8 (e / 2),
    // query q0 + 8 j + 2 tq + e % 2. P = exp2(S scale log2(e) + bias
    // log2(e) - lse log2(e)). A tile whose every pair lies in range and is
    // allowed (this warpgroup's keys, the tile's queries) takes the loop
    // without tests; the others test each pair.
    const float scale2 = a.scale * LOG2E;
    auto pd_ds = [&](int j, int e, bool tests) {
      const int kl = kr + 8 * (e >> 1), key = k0 + kl;
      const int ql = j * 8 + 2 * tq + (e & 1), t = q0 + ql;
      float p = 0.f, ds = 0.f;
      if (!tests || (t < a.Tq && key < a.Tk)) {
        const bool masked = tests && a.causal && key > t + shift;
        if (masked) {
          p = t + shift < 0 ? inv_tk : 0.f;  // a row with no allowed key
        } else {
          p = exp2f(fmaf(s[4 * j + e], scale2, bias_s[kl]) - Ls[ql]);
        }
        float pd = p, dpv = dpt[4 * j + e];
        if (a.seed) {
          const bool keep = dropout_keep(dkey, (long long)t * a.Tk + key,
                                         a.keep_thresh);
          pd = keep ? p * a.inv_keep : 0.f;
          dpv = keep ? dpv * a.inv_keep : 0.f;
        }
        ds = masked ? 0.f : p * (dpv - Dl[ql]);
        p = pd;
      }
      s[4 * j + e] = p;
      dpt[4 * j + e] = ds;
      db[e >> 1] += ds;
    };
    const int kmax = k0 + BK - 1;  // the block's last key
    if (q0 + BQ <= a.Tq && kmax < a.Tk && !(a.causal && kmax > q0 + shift)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pd_ds(j, e, false);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pd_ds(j, e, true);
    }

    // Pd and dS rounded to bf16: register r of query step kk is key row
    // kr + 8 (r & 1), queries 16 kk + 8 (r >> 1) + 2 tq and + 1
    unsigned pa[4][4], sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
        pa[kk][r] = pack_bf16(s[i], s[i + 1]);
        sa[kk][r] = pack_bf16(dpt[i], dpt[i + 1]);
      }
    // dS^T to shared memory, [keys][queries] in the 128-byte swizzle, as
    // the MN-major A operand of dQ = dS . K
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<unsigned*>(dst + (kr + 8 * hh) * 128 +
                                     ((j ^ g) << 4) + 4 * tq) =
            sa[j >> 1][2 * (j & 1) + hh];
    fence_proxy_async();

    // dV += Pd^T . dO and dK += dS^T . Q: A from registers, B (dO, Q)
    // N-contiguous; dK and dV sum on the tensor cores over every query
    wgmma_fence();
#pragma unroll
    for (int at = 0; at < NA; ++at)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n64<1>(dv[at], pa[kk],
                        wg_desc(dos + at * C::Q_SLAB + kk * 2048, C::Q_SLAB,
                                1024), 1);
#pragma unroll
    for (int at = 0; at < NA; ++at)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n64<1>(dk[at], sa[kk],
                        wg_desc(qs + at * C::Q_SLAB + kk * 2048, C::Q_SLAB,
                                1024), 1);
    wgmma_commit();
    __syncthreads();  // the dS^T rows are written

    // dQ over this warpgroup's 64 keys: A = dS^T (M-contiguous), B = K
    // (N-contiguous); the f32 partial goes to shared memory
#pragma unroll
    for (int at = 0; at < NA; ++at) {
      // not zeroed: the first product overwrites it, and an ordinary
      // write here, inside the dK / dV products' stage, would make ptxas
      // serialize every product (C7515)
      float dq[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64<1, 1>(
            dq, wg_desc(dst + kk * 2048, 8192, 1024),
            wg_desc(ks + at * C::KV_SLAB + kk * 2048, C::KV_SLAB,
                    1024),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(dq);
      float* sp = stg + (16 * warp + g) * LD + at * 64 + 2 * tq;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(sp + 8 * hh * LD + 8 * j) =
              make_float2(dq[4 * j + 2 * hh], dq[4 * j + 2 * hh + 1]);
    }
    wgmma_hold(dk[0]);
    wgmma_hold(dv[0]);
    if constexpr (NA > 1) {
      wgmma_hold(dk[NA - 1]);
      wgmma_hold(dv[NA - 1]);
    }
    __syncthreads();  // the partial is staged

    // dQ[q0 + row] += scale * partial: one 16-byte reduction per 4 columns
    // per block
    for (int i = tid; i < BQ * DP / 4; i += NTH) {
      const int row = i / (DP / 4), c = 4 * (i % (DP / 4));
      const int t = q0 + row;
      if (t < a.Tq && c < a.d) {
        const float4 x = *reinterpret_cast<const float4*>(stg + row * LD + c);
        atomicAdd(reinterpret_cast<float4*>(
                      a.dq + ((long long)b * a.Tq + t) * HD + col0 + c),
                  make_float4(x.x * a.scale, x.y * a.scale, x.z * a.scale,
                              x.w * a.scale));
      }
    }
  }

  // dK (scaled) and dV, rounded to bf16 once; the per-key dBias sums
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + kr + 8 * hh;
    db[hh] += __shfl_xor_sync(FULL, db[hh], 1);
    db[hh] += __shfl_xor_sync(FULL, db[hh], 2);
    if (key >= a.Tk) continue;
    const long long row = ((long long)b * a.Tk + key) * HD + col0;
#pragma unroll
    for (int at = 0; at < NA; ++at)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = at * 64 + 8 * j + 2 * tq;
        if (col < a.d) {
          store2(a.dk + row + col, dk[at][4 * j + 2 * hh] * a.scale,
                 dk[at][4 * j + 2 * hh + 1] * a.scale);
          store2(a.dv + row + col, dv[at][4 * j + 2 * hh],
                 dv[at][4 * j + 2 * hh + 1]);
        }
      }
    if (a.dbias && tq == 0) a.dbias[(long long)bh * a.Tk + key] = db[hh];
  }
}

// delta[b, h, t] = sum_c dO[b, t, h*D + c] O[b, t, h*D + c] in f32 from the
// bf16 rows (as paddle_tpu's _packed_stream_bwd_impl computes it outside
// its kernel, :840-843), and dq[b, t, h*D ..] = 0: one thread per (b, t,
// h), 16-byte loads (D a multiple of 8, rows 16-byte aligned)
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ dout,
                      const __nv_bfloat16* __restrict__ out,
                      float* __restrict__ delta, float* __restrict__ dq,
                      int B, int H, int T, int D, long long do_sb,
                      long long do_st, long long o_sb, long long o_st) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * T * H) return;
  const int h = int(i % H), t = int((i / H) % T), b = int(i / H / T);
  const uint4* x = reinterpret_cast<const uint4*>(dout + b * do_sb +
                                                  t * do_st + (long long)h * D);
  const uint4* y = reinterpret_cast<const uint4*>(out + b * o_sb + t * o_st +
                                                  (long long)h * D);
  float acc = 0.f;
  for (int c = 0; c < D / 8; ++c) {
    const uint4 u = __ldg(x + c), v = __ldg(y + c);
    const unsigned uw[4] = {u.x, u.y, u.z, u.w}, vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 uf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&uw[k]));
      const float2 vf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&vw[k]));
      acc = fmaf(uf.x, vf.x, acc);
      acc = fmaf(uf.y, vf.y, acc);
    }
  }
  delta[((long long)b * H + h) * T + t] = acc;
  float4* z = reinterpret_cast<float4*>(dq + (((long long)b * T + t) * H + h) *
                                                 D);
  for (int c = 0; c < D / 4; ++c) z[c] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The prep kernel (delta, dq zeroed), then the products. q/k/v/dO
// [B, T, H*D] bf16 through 3-d tensor maps {H*D, T, B}: box {64, rows, 1}
// at column h*D + 64*slab, key row k0 (K, V, BK rows) or query row q0 (Q,
// dO, BQ rows), batch b
template <int DP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* out, const void* dout,
                         const wgfb::WArgs& a, int B,
                         const long long (&st)[8], long long o_sb,
                         long long o_st, cudaStream_t stream) {
  using C = wgfb::WCfg<DP>;
  const uint64_t hd = uint64_t(a.H) * a.d;
  const uint64_t qdims[3] = {hd, uint64_t(a.Tq), uint64_t(B)};
  const uint64_t kdims[3] = {hd, uint64_t(a.Tk), uint64_t(B)};
  const uint32_t qbox[3] = {64, wgfb::BQ, 1};
  const uint32_t kbox[3] = {64, wgfb::BK, 1};
  uint64_t str[4][2];
  for (int i = 0; i < 4; ++i) {
    str[i][0] = uint64_t(st[2 * i + 1]) * 2;  // row stride, bytes
    str[i][1] = uint64_t(st[2 * i]) * 2;      // batch stride
  }
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = encode_bf16_map(&mq, q, 3, qdims, str[0], qbox);
  if (err == cudaSuccess) err = encode_bf16_map(&mk, k, 3, kdims, str[1], kbox);
  if (err == cudaSuccess) err = encode_bf16_map(&mv, v, 3, kdims, str[2], kbox);
  if (err == cudaSuccess)
    err = encode_bf16_map(&mdo, dout, 3, qdims, str[3], qbox);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_wgmma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(C::SMEM));
  if (err != cudaSuccess) return err;
  const long long rows = (long long)B * a.Tq * a.H;
  flash_bwd_prep_kernel<<<unsigned((rows + 255) / 256), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const __nv_bfloat16*>(out), const_cast<float*>(a.delta),
      a.dq, B, a.H, a.Tq, a.d, st[6], st[7], o_sb, o_st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tk + wgfb::BK - 1) / wgfb::BK, B * a.H);
  flash_bwd_wgmma_kernel<DP><<<grid, wgfb::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, mdo, a);
  return cudaGetLastError();
}

// The product form of dQ on its own, for the card tests: d [64][64] f32 =
// a^T . b for a [64 k][64 m] and b [64 k][64 n] bf16 row-major, both
// written by ordinary stores into the 128-byte swizzle and read
// MN-major (transpose bits A and B set), as the kernel reads dS^T and K.
__global__ void __launch_bounds__(128)
wgmma_mn_major_probe_kernel(const __nv_bfloat16* a, const __nv_bfloat16* b,
                            float* d) {
  __shared__ __align__(1024) unsigned char sm[2 * 8192];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < 2 * 64 * 8; i += 128) {  // 16-byte pieces
    const int m = i / 512, r = (i / 8) % 64, c = i % 8;
    const uint4 x = reinterpret_cast<const uint4*>(m ? b : a)[r * 8 + c];
    *reinterpret_cast<uint4*>(sm + m * 8192 + r * 128 + ((c ^ (r & 7)) << 4)) =
        x;
  }
  fence_proxy_async();
  __syncthreads();
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64<1, 1>(acc, wg_desc(sm + kk * 2048, 8192, 1024),
                       wg_desc(sm + 8192 + kk * 2048, 8192, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_hold(acc);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      d[(16 * warp + g + 8 * (e >> 1)) * 64 + 8 * j + 2 * tq + (e & 1)] =
          acc[4 * j + e];
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q/k/v/dout/dk/dv). D: the head dim, a
// multiple of 8 up to 512. q/k/v/dout: [B, T, H*D] with element strides
// (batch, row), a contiguous feature dim, and pointers and strides that
// are multiples of 16 bytes; lse/delta: f32 [B, H, Tq] contiguous; bias:
// null or f32, read as [B, H, Tq, Tk] through the element strides
// bias_sb, bias_sh, bias_st and 1 (0 broadcasts), as the forward reads it;
// seed: one int64 on the device, or null for no dropout. dq: f32
// [B, Tq, H*D], contiguous and ZEROED by the caller (blocks add into it);
// dk/dv: [B, Tk, H*D] contiguous; dbias: null, or f32, for bias_st == 0
// the [B, H, Tk] sums over the queries, else dS itself, [B, H, Tq, Tk]
// contiguous and ZEROED by the caller (pairs of query and key tiles a
// causal block skips are not written).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        const void* bias, const void* seed, void* dq,
                        void* dk, void* dv, void* dbias, int dtype, int B,
                        int H, int Tq, int Tk, int D, long long q_sb,
                        long long q_st, long long k_sb, long long k_st,
                        long long v_sb, long long v_st, long long do_sb,
                        long long do_st, long long bias_sb,
                        long long bias_sh, long long bias_st, float scale,
                        int causal, unsigned keep_thresh, float inv_keep,
                        void* stream) {
  if (D % 8 != 0 || D < 8 || D > 512) return cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const float*>(bias),
         static_cast<const long long*>(seed), static_cast<float*>(dq), dk,
         dv, static_cast<float*>(dbias), H, Tq, Tk, D, q_sb, q_st, k_sb,
         k_st, v_sb, v_st, do_sb, do_st, bias_sb, bias_sh, bias_st, scale,
         causal, keep_thresh, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rows = bias && bias_st != 0;
  if (dtype == 0)
    return rows ? dispatch_width<float, true>(a, B, s)
                : dispatch_width<float, false>(a, B, s);
  if (dtype == 1)
    return rows ? dispatch_width<__nv_bfloat16, true>(a, B, s)
                : dispatch_width<__nv_bfloat16, false>(a, B, s);
  return cudaErrorInvalidValue;
}

// The bf16 form on warpgroup products (flash_bwd_wgmma_kernel): q/k/v/out/
// dout bf16 with 16-byte aligned pointers and positive batch and row
// strides that are multiples of 16 bytes, D (the padded head dim) a
// multiple of 16 up to 128, any Tq and Tk, and no bias or one row of keys
// per (b, h) (bias_st == 0; dbias, if given, gets its per-head sums over
// the queries). delta: f32 [B, H, Tq] scratch, written here with
// rowsum(dO * O); dq: f32 [B, Tq, H*D] contiguous, zeroed here, then
// summed into; dk/dv bf16 [B, Tk, H*D] contiguous. The other arguments as
// flash_attention_bwd's. Two launches on `stream`.
int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const void* lse, void* delta, const void* bias,
                              const void* seed, void* dq, void* dk, void* dv,
                              void* dbias, int B, int H, int Tq, int Tk,
                              int D, long long q_sb, long long q_st,
                              long long k_sb, long long k_st, long long v_sb,
                              long long v_st, long long o_sb, long long o_st,
                              long long do_sb, long long do_st,
                              long long bias_sb, long long bias_sh,
                              float scale, int causal, unsigned keep_thresh,
                              float inv_keep, void* stream) {
  const long long st[8] = {q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st};
  for (long long x : st)
    if (x <= 0 || (x * 2) % 16 != 0) return cudaErrorInvalidValue;
  if (o_sb <= 0 || o_st <= 0 || (o_sb * 2) % 16 != 0 || (o_st * 2) % 16 != 0)
    return cudaErrorInvalidValue;
  if (D % 16 != 0 || D < 16 || D > 128 || Tq < 1 || Tk < 1 || B < 1 ||
      H < 1 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq)) %
              16 != 0)
    return cudaErrorInvalidValue;
  const wgfb::WArgs a{static_cast<const float*>(lse),
                      static_cast<const float*>(delta),
                      static_cast<const float*>(bias),
                      static_cast<const long long*>(seed),
                      static_cast<float*>(dq),
                      static_cast<__nv_bfloat16*>(dk),
                      static_cast<__nv_bfloat16*>(dv),
                      static_cast<float*>(dbias), H, Tq, Tk, D, bias_sb,
                      bias_sh, scale, causal, keep_thresh, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_wgmma<64>(q, k, v, out, dout, a, B, st, o_sb, o_st, s);
  return launch_wgmma<128>(q, k, v, out, dout, a, B, st, o_sb, o_st, s);
}

// d = a^T . b through the MN-major product form (see the probe kernel):
// a, b bf16 [64][64], d f32 [64][64], all contiguous on the device.
int wgmma_mn_major_probe(const void* a, const void* b, void* d,
                         void* stream) {
  wgmma_mn_major_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(
                                               stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<float*>(d));
  return cudaGetLastError();
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
