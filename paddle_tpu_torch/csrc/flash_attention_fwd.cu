// Flash-attention forward for Hopper (sm_90a), on the tensor cores.
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
//   logits = q . k^T / sqrt(D) + bias[b, h, t, j]
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
// Each accumulator element draws the bit of its own (t, j), so the
// backward and the plain PyTorch version draw the same mask.
//
// What bounds it on the card. At Transformer-base's training shape
// (B = 128, T = 256, H = 8, D = 64) the operations: 4*T*Tk*D per head, run
// as 3xTF32 (three TF32 tensor-core products per f32 product, see
// mma_tf32.cuh), 3 x 17.2 GFLOP at 495 TFLOP/s. At BERT-base's served shape
// (B = 8, T = 128) the 3xTF32 bound and the bytes (q, k, v, out once each)
// are both a few microseconds, below the cost of a launch and of one pass
// of loads; there the card has to be kept busy.
//
// Design (the TPU kernels' VMEM-shaped blocks do not carry over):
//   * f32 runs every product as 3xTF32 mma.sync m16n8k8 (a single TF32
//     pass would keep 11 bits of each operand; the port is f32 with TF32
//     off); bf16 runs mma.sync m16n8k16 with f32 accumulators and P rounded
//     to bf16 for P.V.
//   * A block owns BQ = 16 * RW query rows of one (b, h): RW warps of 16
//     rows, times DW warps that split the head dim. It streams K/V tiles of
//     BK keys through a 2-stage cp.async ring in dynamic shared memory
//     (16-byte copies; the wrapper copies rows that are not 16-byte
//     aligned), zero-filled past Tk and past the head dim by cp.async's
//     src-size 0, so one tile loads while the previous one is computed.
//   * S = Q.K^T and O += P.V are fragment products. The online softmax runs
//     on S's accumulator fragments: a row's max over the 4 lanes of a quad
//     by __shfl_xor_sync, its sum per lane until the end. For f32 the S
//     accumulator (row g, keys 2t, 2t+1) is not the A fragment of P.V (row
//     g, keys t, t+4); instead of shuffles the P.V product runs its 8 keys
//     in the order 0, 2, 4, 6, 1, 3, 5, 7: mma k-index t is key 2t and t+4
//     is key 2t+1, so the accumulator is the A fragment as it stands, and
//     V's B fragment reads rows 2t and 2t+1. For bf16 the layouts line up.
//   * Accuracy: the tensor cores round their additions toward zero, three
//     times a k-step in 3xTF32. Chained on them, O lies 2.5x further from
//     an f64 attention than the f32 plain version's (relative L2, at the
//     training shape; PERF.md). So S takes each k-step's three
//     products from zero and adds them in on the FMA pipe
//     (mma_3xtf32_add), and P.V keeps the small terms in accumulators of
//     their own (mma_3xtf32_sep) and sums one tile's keys into a fresh
//     accumulator that is added into O, rescaled by the softmax's alpha,
//     on the FMA pipe.
//   * Head dims: every multiple of 8 up to 512, rounded up to an
//     instantiated width DP of 16, 32, 64, 128, 256 or 512 (zero columns
//     change no score and no kept column; the wrappers pad any other head
//     dim to a multiple of 8 the same way). DP = 128 reads Q's fragments
//     from shared memory and splits them per tile: O takes 64 registers a
//     lane, and ptxas fits the rest in 168 without spilling, so Q kept
//     pre-split in shared memory would buy no registers. DP = 256 and 512
//     cannot keep a 16-row O in one warp's registers (512 columns is 256
//     a lane), so DW = 2 or 4 warps split the columns: each computes a
//     partial S over its columns, the partials are summed through shared
//     memory in a fixed order (every warp of the row group then holds the
//     same S), and each keeps O for its own columns.
//   * Fill, for DP <= 64 (the tiles were timed on the card, PERF.md): the
//     served shape has 8 x 12 x 128 rows, only 192 blocks of 64 rows on
//     132 SMs, and a second wave of blocks when 64-key tiles of K and V
//     hold two blocks an SM. So where 64-row blocks would give fewer than
//     two an SM, a block takes 32 rows (2 warps), keeps Q's fragments in
//     registers for the whole sweep, and streams 32-key tiles: every block
//     is resident at once. Otherwise a block takes 64 rows and 32-key
//     tiles, reads Q's fragments from shared memory per tile and is held
//     to 128 registers a thread, so that four blocks (16 warps) share an
//     SM: the kernel waits on latency more than it issues, and the few
//     bytes this spills cost less than the warps gained.
//   * Bias: a padding mask (one row of keys per batch and head) rides the
//     ring as one float per key of the tile; any other bias (a [Tq, Tk]
//     mask, relative positions) is read by each logit from global memory
//     through its strides, in instantiations of its own (ROWS): a branch
//     per logit cost the padding-mask path 3-5% on the card (PERF.md).
// Shared-memory rows are padded to DP + 4 floats (bf16: DP + 8) so that the
// fragment loads (rows g, columns t and t+4; rows 2t and 2t+1, column g)
// are free of bank conflicts. Key tiles a causal block cannot see are
// skipped, only when every row of the block keeps at least one key.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "flash_dropout.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGES = 2;

struct Args {
  const void* q; const void* k; const void* v; const float* bias;
  void* out; float* lse;
  int H, Tq, Tk, d;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st, o_sb, o_st;
  long long bias_sb, bias_sh, bias_st;  // bias_st == 0: one row per head
  float scale; int causal;
  const long long* seed;  // null: no dropout
  unsigned keep_thresh; float inv_keep;
};

// DP: instantiated head-dim width; RW warps of 16 query rows; DW warps
// over the head dim; BK keys per tile; QREG: Q's fragments in registers
template <typename T, int DP, int RW, int DW, int BK, bool QREG_>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int NTH = 32 * RW * DW;
  static constexpr int BQ = 16 * RW;
  static constexpr int LD = DP + (F32 ? 4 : 8);  // smem row, in elements
  static constexpr int DSL = DP / DW;            // columns per warp
  static constexpr int KSTEP = F32 ? 8 : 16;     // k of one mma
  static constexpr int KQ = DSL / KSTEP;         // k-steps of Q.K^T
  static constexpr int NT = BK / 8;              // key n-tiles of S
  static constexpr int NO = DSL / 8;             // column n-tiles of O
  static constexpr int NCM = F32 ? 4 : 8;
  static constexpr int NC = NO < NCM ? NO : NCM;  // n-tiles per P.V pass
  static constexpr bool QREG = QREG_;
  static constexpr int CH = 16 / sizeof(T);      // elements per cp16
  static constexpr size_t q_bytes = size_t(BQ) * LD * sizeof(T);
  static constexpr size_t kv_bytes = size_t(BK) * LD * sizeof(T);
  static constexpr size_t bias_off = q_bytes + STAGES * 2 * kv_bytes;
  static constexpr size_t sp_off = bias_off + STAGES * BK * sizeof(float);
  static constexpr size_t smem =
      sp_off + (DW > 1 ? size_t(RW) * DW * NT * 4 * 32 * sizeof(float) : 0);
};

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return unsigned(__bfloat16_as_ushort(lo)) |
         (unsigned(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// MINB: blocks an SM must hold (caps the registers); ROWS: the bias has
// a row per query (read per logit), else at most one row of keys per head
template <typename T, int DP, int RW, int DW, int BK, bool QREG, int MINB,
          bool ROWS>
__global__ void __launch_bounds__(32 * RW * DW, MINB)
flash_fwd_kernel(Args a) {
  using C = Cfg<T, DP, RW, DW, BK, QREG>;
  constexpr int NTH = C::NTH, BQ = C::BQ, LD = C::LD, CH = C::CH;
  constexpr int KQ = C::KQ, NT = C::NT, NO = C::NO, NC = C::NC;
  constexpr int CPR = DP / CH;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  float* Sp = reinterpret_cast<float*>(smem + C::sp_off);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp / DW, dw = warp % DW;
  const int g = lane >> 2, tq = lane & 3;  // quad, lane in quad
  const int r0 = rw * 16, c0 = dw * C::DSL;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const int shift = a.Tk - a.Tq;  // causal: key j allowed iff j <= t + shift

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + (long long)h * a.d;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + (long long)h * a.d;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + (long long)h * a.d;
  const float* biasb =
      a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
  const uint32_t dkey = a.seed ? dropout_key(*a.seed, bh) : 0u;

  auto k_tile = [&](int stage) {
    return reinterpret_cast<T*>(smem + C::q_bytes + stage * 2 * C::kv_bytes);
  };
  auto b_tile = [&](int stage) {
    return reinterpret_cast<float*>(smem + C::bias_off) + stage * BK;
  };
  auto load_kv = [&](int stage, int k0) {
    T* Ks = k_tile(stage);
    T* Vs = Ks + BK * LD;
    for (int i = tid; i < BK * CPR; i += NTH) {
      const int j = i / CPR, c = (i % CPR) * CH, key = k0 + j;
      const bool ok = key < a.Tk && c < a.d;
      cp16(Ks + j * LD + c, ok ? kb + key * a.k_st + c : kb, ok);
      cp16(Vs + j * LD + c, ok ? vb + key * a.v_st + c : vb, ok);
    }
    if (!ROWS && biasb) {
      float* Bs = b_tile(stage);
      for (int j = tid; j < BK; j += NTH) {
        const bool ok = k0 + j < a.Tk;
        cp4(Bs + j, ok ? biasb + k0 + j : biasb, ok);
      }
    }
  };

  // Skip key tiles every row of this block masks out. Only exact when each
  // row keeps at least one key (q0 + shift >= 0): a row with none averages
  // V over all Tk keys, so then every tile is visited.
  const int q_last = min(q0 + BQ, a.Tq) - 1;
  int k_end = a.Tk;
  if (a.causal && q0 + shift >= 0) k_end = min(a.Tk, q_last + shift + 1);
  const int n_tiles = (k_end + BK - 1) / BK;

  for (int i = tid; i < BQ * CPR; i += NTH) {
    const int r = i / CPR, c = (i % CPR) * CH, t = q0 + r;
    const bool ok = t < a.Tq && c < a.d;
    cp16(Qs + r * LD + c, ok ? qb + t * a.q_st + c : qb, ok);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_kv(s, s * BK);
    cp_commit();  // Q travels in the first group
  }

  // Q's A fragments for the whole sweep (QREG): f32 big and small parts,
  // or bf16 pairs in qbig
  unsigned qbig[C::QREG ? KQ : 1][4], qsml[C::QREG ? KQ : 1][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // A fragment of Q for k-step kk (rows r0 + g, + 8)
  auto q_frag = [&](int kk, unsigned* ab, unsigned* as) {
    if constexpr (C::F32) {
      const float* qp = reinterpret_cast<const float*>(Qs) +
                        (r0 + g) * LD + c0 + kk * 8 + tq;
      split_tf32(qp[0], ab[0], as[0]);
      split_tf32(qp[8 * LD], ab[1], as[1]);
      split_tf32(qp[4], ab[2], as[2]);
      split_tf32(qp[8 * LD + 4], ab[3], as[3]);
    } else {
      const __nv_bfloat16* qp = reinterpret_cast<const __nv_bfloat16*>(Qs) +
                                (r0 + g) * LD + c0 + kk * 16 + 2 * tq;
      ab[0] = ld32(qp);
      ab[1] = ld32(qp + 8 * LD);
      ab[2] = ld32(qp + 8);
      ab[3] = ld32(qp + 8 * LD + 8);
    }
  };

  for (int it = 0; it < n_tiles; ++it) {
    cp_wait<STAGES - 2>();  // tile it (and Q) landed
    __syncthreads();        // ... for all threads; tile it - 1 consumed
    {
      const int pf = it + STAGES - 1;
      if (pf < n_tiles) load_kv(pf % STAGES, pf * BK);
      cp_commit();
    }
    if constexpr (C::QREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) q_frag(kk, qbig[kk], qsml[kk]);
      }
    }
    const int k0 = it * BK;
    const T* Ks = k_tile(it % STAGES);
    const T* Vs = Ks + BK * LD;
    const float* Bs = b_tile(it % STAGES);

    // S = Q . K^T over this warp's columns
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      unsigned ab[4], as[4];
      if constexpr (C::QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ab[e] = qbig[kk][e];
          if constexpr (C::F32) as[e] = qsml[kk][e];
        }
      } else {
        q_frag(kk, ab, as);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if constexpr (C::F32) {
          const float* kp = reinterpret_cast<const float*>(Ks) +
                            (j * 8 + g) * LD + c0 + kk * 8 + tq;
          unsigned bb[2], bs[2];
          split_tf32(kp[0], bb[0], bs[0]);
          split_tf32(kp[4], bb[1], bs[1]);
          mma_3xtf32_add(s[j], ab, as, bb, bs);
        } else {
          const __nv_bfloat16* kp =
              reinterpret_cast<const __nv_bfloat16*>(Ks) + (j * 8 + g) * LD +
              c0 + kk * 16 + 2 * tq;
          const unsigned bw[2] = {ld32(kp), ld32(kp + 8)};
          mma_bf16(s[j], ab, bw);
        }
      }
    }
    if constexpr (DW > 1) {  // sum the column groups' partial S in order
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Sp[((warp * NT + j) * 4 + e) * 32 + lane] = s[j][e];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float acc = 0.f;
#pragma unroll
          for (int w = 0; w < DW; ++w)
            acc += Sp[(((rw * DW + w) * NT + j) * 4 + e) * 32 + lane];
          s[j][e] = acc;
        }
    }

    // online softmax on the accumulator fragments: element (j, e) is row
    // r0 + g + 8 * (e / 2), key k0 + 8 * j + 2 * tq + e % 2
    const int ta = q0 + r0 + g;  // query of rows e = 0, 1; ta + 8: e = 2, 3
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * tq + (e & 1), key = k0 + col;
        const int t = ta + 8 * (e >> 1);
        float x;
        if (key >= a.Tk) {
          x = -INFINITY;  // beyond Tk: not a key at all
        } else {
          float bv = 0.f;
          if constexpr (ROWS) {
            if (t < a.Tq) bv = __ldg(biasb + t * a.bias_st + key);
          } else if (biasb) {
            bv = Bs[col];
          }
          x = s[j][e] * a.scale + bv;
          if (a.causal && key > t + shift) x = -FLT_MAX;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(FULL, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(FULL, mx[hh], 2));
      const float mn = fmaxf(m[hh], mx[hh]);
      alpha[hh] = expf(m[hh] - mn);  // 0 on the first tile
      m[hh] = mn;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += p;  // the normaliser keeps every weight; P.V drops
        if (a.seed) {
          const long long ctr =
              (long long)(ta + 8 * (e >> 1)) * a.Tk + k0 + j * 8 + 2 * tq +
              (e & 1);
          p = dropout_keep(dkey, ctr, a.keep_thresh) ? p * a.inv_keep : 0.f;
        }
        s[j][e] = p;
      }

    // O = alpha * O + P . V, the tile's sum taken apart on the tensor cores
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += NC) {
      float part[NC][4], psm[NC][4];  // psm: 3xTF32's small terms (f32)
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = psm[n][e] = 0.f;
      if constexpr (C::F32) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // keys in the order 2t, 2t + 1: the accumulator is the A fragment
          unsigned pb[4], ps[4];
          split_tf32(s[j][0], pb[0], ps[0]);
          split_tf32(s[j][2], pb[1], ps[1]);
          split_tf32(s[j][1], pb[2], ps[2]);
          split_tf32(s[j][3], pb[3], ps[3]);
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            const float* vp = reinterpret_cast<const float*>(Vs) +
                              (j * 8 + 2 * tq) * LD + c0 + (n0 + n) * 8 + g;
            unsigned bb[2], bs[2];
            split_tf32(vp[0], bb[0], bs[0]);
            split_tf32(vp[LD], bb[1], bs[1]);
            mma_3xtf32_sep(part[n], psm[n], pb, ps, bb, bs);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                  pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack_bf16(s[2 * kk + 1][2],
                                            s[2 * kk + 1][3])};
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            const __nv_bfloat16* vp =
                reinterpret_cast<const __nv_bfloat16*>(Vs) +
                (kk * 16 + 2 * tq) * LD + c0 + (n0 + n) * 8 + g;
            const unsigned bw[2] = {pack_bf16(vp[0], vp[LD]),
                                    pack_bf16(vp[8 * LD], vp[9 * LD])};
            mma_bf16(part[n], pa, bw);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n0 + n][e] =
              fmaf(o[n0 + n][e], alpha[e >> 1], part[n][e] + psm[n][e]);
    }
  }

  T* ob = static_cast<T*>(a.out) + b * a.o_sb + (long long)h * a.d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(FULL, l[hh], 1);
    l[hh] += __shfl_xor_sync(FULL, l[hh], 2);
    const int t = q0 + r0 + g + 8 * hh;
    if (t >= a.Tq) continue;
    const float inv = 1.f / l[hh];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = c0 + n * 8 + 2 * tq;
      if (col < a.d)
        store2(ob + t * a.o_st + col, o[n][2 * hh] * inv,
               o[n][2 * hh + 1] * inv);
    }
    if (dw == 0 && tq == 0)
      a.lse[(long long)bh * a.Tq + t] = m[hh] + logf(l[hh]);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <typename T, int DP, int RW, int DW, int BK, bool QREG, int MINB,
          bool ROWS>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<T, DP, RW, DW, BK, QREG>;
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP, RW, DW, BK, QREG, MINB, ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + C::BQ - 1) / C::BQ, B * a.H);
  flash_fwd_kernel<T, DP, RW, DW, BK, QREG, MINB, ROWS>
      <<<grid, C::NTH, C::smem, stream>>>(a);
  return cudaGetLastError();
}

// the instantiated width for head dim d (a multiple of 8, at most 512):
// ops/flash_attention.py _WIDTHS lists the same widths
template <typename T, bool ROWS>
cudaError_t dispatch_width(const Args& a, int B, cudaStream_t s) {
  // fewer than two 64-row blocks an SM: 32-row blocks fill the card better
  const bool narrow =
      (long long)B * a.H * ((a.Tq + 63) / 64) < 2LL * sm_count();
  if (a.d <= 16)
    return narrow ? launch<T, 16, 2, 1, 32, true, 1, ROWS>(a, B, s)
                  : launch<T, 16, 4, 1, 32, false, 4, ROWS>(a, B, s);
  if (a.d <= 32)
    return narrow ? launch<T, 32, 2, 1, 32, true, 1, ROWS>(a, B, s)
                  : launch<T, 32, 4, 1, 32, false, 4, ROWS>(a, B, s);
  if (a.d <= 64)
    return narrow ? launch<T, 64, 2, 1, 32, true, 1, ROWS>(a, B, s)
                  : launch<T, 64, 4, 1, 32, false, 4, ROWS>(a, B, s);
  if (a.d <= 128) return launch<T, 128, 4, 1, 32, false, 1, ROWS>(a, B, s);
  if (a.d <= 256) return launch<T, 256, 2, 2, 32, false, 1, ROWS>(a, B, s);
  if (a.d <= 512) return launch<T, 512, 1, 4, 16, false, 1, ROWS>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. D: the head dim, a multiple of 8 up to
// 512. Strides are in elements; the last (feature) dimension of q/k/v/out
// must be contiguous, and q/k/v's pointers and batch and row strides
// multiples of 16 bytes (16-byte row copies). bias is null or f32, read as
// [B, H, Tq, Tk] through the element strides bias_sb, bias_sh, bias_st and
// 1 (0 broadcasts): with bias_st == 0 (a padding mask, one row of keys per
// batch and head) each key tile's bias rides the K/V ring, otherwise each
// logit reads its own. seed is one int64 on
// the device (null: no dropout); keep_thresh and inv_keep come from the
// dropout rate (flash_dropout.cuh).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* bias, void* out, void* lse, int dtype,
                        int B, int H, int Tq, int Tk, int D,
                        long long q_sb, long long q_st, long long k_sb,
                        long long k_st, long long v_sb, long long v_st,
                        long long o_sb, long long o_st, long long bias_sb,
                        long long bias_sh, long long bias_st, float scale,
                        int causal, const void* seed,
                        unsigned keep_thresh, float inv_keep, void* stream) {
  if (D % 8 != 0 || D < 8 || D > 512) return cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const float*>(bias), out,
         static_cast<float*>(lse), H, Tq, Tk, D, q_sb, q_st, k_sb, k_st,
         v_sb, v_st, o_sb, o_st, bias_sb, bias_sh, bias_st, scale, causal,
         static_cast<const long long*>(seed), keep_thresh, inv_keep};
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

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
