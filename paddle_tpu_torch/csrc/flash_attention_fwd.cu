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
//     to bf16 for P.V. bf16 rounds P where paddle_tpu's whole-sequence
//     kernel does (_dense_fwd_kernel, :1043-1053): normalised, after
//     dropout. The online softmax knows the normaliser only at the end, so
//     bf16 walks the keys twice: pass 0 computes S and each row's max and
//     sum, pass 1 computes S again, p = exp(s - max) / sum, drops, rounds
//     and multiplies by V (1.5x the products of one pass). The plain
//     version, the CPU path and the backward (delta = rowsum(dO * O)) then
//     see the same out.
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
//
// bf16 on warpgroup products, one pass (flash_fwd_wgmma_kernel). The route
// (ops/flash_attention.py fwd_form) sends it every bf16 call with Tk <=
// 256 keys, a padded head dim dp that is a multiple of 16 up to 128, and
// no bias or one row of keys per (b, h) (a padding mask): the training
// path's 18 launches a step. Every other call keeps the kernel above.
// Bounded by bytes at the training shape (q, k, v and out once each:
// 0.040 ms), where the two-pass form took 0.344 ms. The two passes
// existed because P is rounded normalised, after dropout (paddle_tpu's
// _dense_fwd_kernel, :1034-1053, keeps the whole [T, Tk] score tile): at
// Tk <= 256 a 64-row warpgroup tile of every score fits the registers, so
// one pass gives the same rounding point:
//   * A block of one warpgroup (DP 64: two blocks an SM, so one block's
//     loads overlap the other's products) or two (DP 128: sharing one copy
//     of K and V) owns 64 or 128 query rows of one (b, h). One thread
//     loads Q's rows and every key's K (one mbarrier), then V (a second),
//     by TMA from the packed [B, T, H*D] layout through 3-d
//     tensor maps (box {64 columns, rows, 1}; the 128-byte swizzle; keys
//     past Tk and rows past Tq arrive as zeros), so K and V are read once
//     a block and V lands while the scores are computed. The padding mask
//     rides along as one float per key in shared memory.
//   * S = Q . K^T over all 256 key slots: wgmma m64n256k16, A and B from
//     shared memory, both K-major: 128 f32 a thread. Per row: max, sum,
//     then p * (1/l), the dropout, and rounding to bf16, as the plain
//     version and the reference do. lse = max + log(sum). The
//     exponentials are expf, as the plain version's: ex2.approx (__expf)
//     is 7% faster here and as close to f64, but moves a whole AMP step's
//     loss further from the CPU's (PERF.md).
//   * O = P . V: wgmma m64n{64,128}k16 with A from registers (the score
//     accumulator's layout is the bf16 A fragment's, 16 keys a step) and
//     B = V from shared memory, D-contiguous (the transpose bit). Each 64
//     keys sum into a fresh accumulator, added into O on the FMA pipe;
//     chunks past Tk are skipped. O is stored once, rounded to bf16.
//   * Registers: at most 256 threads a block and 65,536 registers an SM
//     leave 255 a thread, so no producer warp and no setmaxnreg are
//     needed; the scores (128) and then P (64), O and its chunk sum (2 x
//     32 or 2 x 64) fit.
//   * Head dims: instantiated widths DP 64 and 128 (one or two 64-column
//     slabs). A narrower head reads the next head's columns (or zeros
//     past H*D) into the slab; the products over k stop at dp, and the
//     output columns past dp are not stored.

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

  // bf16: pass 0 takes each row's max and sum over every key, pass 1
  // rounds the normalised weights to bf16 for P.V (f32: one pass)
  constexpr int PASSES = C::F32 ? 1 : 2;
  float inv_l[2] = {1.f, 1.f};
  for (int pass = 0; pass < PASSES; ++pass) {
  const bool stats = PASSES == 2 && pass == 0;
  if (pass > 0) {  // restart the ring over the same key tiles
    cp_wait<0>();
    __syncthreads();
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_tiles) load_kv(s, s * BK);
      cp_commit();
    }
  }
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
        if (PASSES == 1 || stats) {
          l[e >> 1] += p;  // the normaliser keeps every weight; P.V drops
          if (stats) continue;
        } else {
          p *= inv_l[e >> 1];  // m is the row's max: alpha is 1
        }
        if (a.seed) {
          const long long ctr =
              (long long)(ta + 8 * (e >> 1)) * a.Tk + k0 + j * 8 + 2 * tq +
              (e & 1);
          p = dropout_keep(dkey, ctr, a.keep_thresh) ? p * a.inv_keep : 0.f;
        }
        s[j][e] = p;
      }
    if (stats) continue;

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

  if (stats) {  // the rows' sums over the quad, for pass 1
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(FULL, l[hh], 1);
      l[hh] += __shfl_xor_sync(FULL, l[hh], 2);
      inv_l[hh] = 1.f / l[hh];
    }
  }
  }  // pass

  T* ob = static_cast<T*>(a.out) + b * a.o_sb + (long long)h * a.d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if constexpr (PASSES == 1) {
      l[hh] += __shfl_xor_sync(FULL, l[hh], 1);
      l[hh] += __shfl_xor_sync(FULL, l[hh], 2);
    }
    const int t = q0 + r0 + g + 8 * hh;
    if (t >= a.Tq) continue;
    const float inv = PASSES == 1 ? 1.f / l[hh] : 1.f;
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


// ---------------------------------------------------------------------------
// bf16 on warpgroup products, one pass (see the header)
// ---------------------------------------------------------------------------
namespace wgfa {

constexpr int TKP = 256;   // key slots a block holds: the route's Tk limit
constexpr int KC = 4;      // key steps (64 keys) per fresh P.V accumulator

struct WArgs {
  const float* bias; void* out; float* lse;
  int H, Tq, Tk, d;
  long long o_sb, o_st, bias_sb, bias_sh;
  float scale; int causal;
  const long long* seed;  // null: no dropout
  unsigned keep_thresh; float inv_keep;
};

// DP 64: one warpgroup (64 query rows) a block, two blocks an SM; DP 128:
// two warpgroups sharing one copy of K and V (the smem of two blocks)
template <int DP>
struct WCfg {
  static constexpr int NA = DP / 64;        // 64-column slabs of a head
  static constexpr int NWG = DP == 64 ? 1 : 2;
  static constexpr int BQ = 64 * NWG;       // query rows a block
  static constexpr int THREADS = 128 * NWG;
  static constexpr int Q_SLAB = BQ * 128;   // bytes of one slab of Q
  static constexpr int KV_SLAB = TKP * 128; // ... of K or V
  static constexpr size_t SMEM = 1024 + size_t(NA) * (Q_SLAB + 2 * KV_SLAB) +
                                 TKP * sizeof(float) + 2 * sizeof(uint64_t);
};

}  // namespace wgfa

template <int DP>
__global__ void __launch_bounds__(wgfa::WCfg<DP>::THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                       const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv,
                       wgfa::WArgs a) {
  using C = wgfa::WCfg<DP>;
  constexpr int TKP = wgfa::TKP, BQ = C::BQ, NTH = C::THREADS;
  constexpr int KC = wgfa::KC;
  extern __shared__ __align__(1024) unsigned char fa_smem[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fa_smem) + 1023) & ~uintptr_t(1023));
  unsigned char* ks = qs + C::NA * C::Q_SLAB;
  unsigned char* vs = ks + C::NA * C::KV_SLAB;
  float* bias_s = reinterpret_cast<float*>(vs + C::NA * C::KV_SLAB);
  uint64_t* bar = reinterpret_cast<uint64_t*>(bias_s + TKP);

  const int tid = threadIdx.x, cw = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const int col0 = h * a.d;  // the head's first column in [B, T, H*D]
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init_fence();
    mbar_expect_tx(&bar[0], C::NA * (C::Q_SLAB + C::KV_SLAB));
    for (int at = 0; at < C::NA; ++at) {
      tma_load_3d(qs + at * C::Q_SLAB, &tmq, &bar[0], col0 + 64 * at, q0, b);
      tma_load_3d(ks + at * C::KV_SLAB, &tmk, &bar[0], col0 + 64 * at, 0, b);
    }
    mbar_expect_tx(&bar[1], C::NA * C::KV_SLAB);
    for (int at = 0; at < C::NA; ++at)
      tma_load_3d(vs + at * C::KV_SLAB, &tmv, &bar[1], col0 + 64 * at, 0, b);
  }
  const float* biasb =
      a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
  for (int j = tid; j < TKP; j += NTH)
    bias_s[j] = (biasb != nullptr && j < a.Tk) ? biasb[j] : 0.f;
  __syncthreads();  // the barriers' init and the bias, for every thread
  const uint32_t dkey = a.seed ? dropout_key(*a.seed, bh) : 0u;

  // S = Q . K^T: this warpgroup's 64 rows against every key slot
  float s[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) s[i] = 0.f;
  mbar_wait(&bar[0], 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if (kk * 16 < a.d) {
      const int at = kk / 4, off = (kk % 4) * 32;
      wgmma_ss_n256<0>(
          s, wg_desc(qs + at * C::Q_SLAB + cw * 64 * 128 + off, 16, 1024),
          wg_desc(ks + at * C::KV_SLAB + off, 16, 1024), kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_hold(s);

  // the softmax of each row: s[4 j + e] is row ta + 8 (e / 2), key
  // 8 j + 2 tq + e % 2
  const int shift = a.Tk - a.Tq;  // causal: key j allowed iff j <= t + shift
  const int ta = q0 + cw * 64 + warp * 16 + g;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * tq + (e & 1);
      const int t = ta + 8 * (e >> 1);
      float x;
      if (key >= a.Tk) {
        x = -INFINITY;  // not a key at all
      } else {
        x = s[4 * j + e] * a.scale + bias_s[key];
        if (a.causal && key > t + shift) x = -FLT_MAX;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(FULL, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(FULL, mx[hh], 2));
  }
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[4 * j + e] - mx[e >> 1]);
      l[e >> 1] += p;
      s[4 * j + e] = p;
    }
  float inv_l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(FULL, l[hh], 1);
    l[hh] += __shfl_xor_sync(FULL, l[hh], 2);
    inv_l[hh] = 1.f / l[hh];
    const int t = ta + 8 * hh;
    if (tq == 0 && t < a.Tq)
      a.lse[(long long)bh * a.Tq + t] = mx[hh] + logf(l[hh]);
  }

  // P, normalised, dropped and rounded to bf16, as the A operand of P . V:
  // register r of key step kk is row ta + 8 (r & 1), keys 16 kk +
  // 8 (r >> 1) + 2 tq and + 1
  unsigned pa[16][4];
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 2 * kk + (r >> 1), hh = r & 1;
      float p0 = s[4 * j + 2 * hh] * inv_l[hh];
      float p1 = s[4 * j + 2 * hh + 1] * inv_l[hh];
      if (a.seed) {
        const long long ctr =
            (long long)(ta + 8 * hh) * a.Tk + 8 * j + 2 * tq;
        p0 = dropout_keep(dkey, ctr, a.keep_thresh) ? p0 * a.inv_keep : 0.f;
        p1 = dropout_keep(dkey, ctr + 1, a.keep_thresh) ? p1 * a.inv_keep
                                                        : 0.f;
      }
      pa[kk][r] = pack_bf16(p0, p1);
    }

  // O = P . V over the chunks of KC key steps that hold keys: each chunk
  // sums on the tensor cores into a fresh accumulator, added into O on the
  // FMA pipe, as the other forms add their tiles (the tensor cores round
  // their additions toward zero). Against f64 a chain over all 256 keys
  // reads the same once O is rounded to bf16; a whole AMP training step's
  // loss lands nearer the CPU's with these chunks (PERF.md).
  float o[DP / 2], part[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = part[i] = 0.f;
  mbar_wait(&bar[1], 0);
#pragma unroll
  for (int c = 0; c < 16 / KC; ++c) {
    if (c * KC * 16 < a.Tk) {
      wgmma_fence();
#pragma unroll
      for (int kk = c * KC; kk < (c + 1) * KC; ++kk) {
        const uint64_t db = wg_desc(vs + kk * 2048, C::KV_SLAB, 1024);
        if constexpr (DP == 64)
          wgmma_rs_n64<1>(part, pa[kk], db, kk > c * KC);
        else
          wgmma_rs_n128<1>(part, pa[kk], db, kk > c * KC);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(part);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] += part[i];
    }
  }

  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out) + b * a.o_sb + col0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = ta + 8 * hh;
    if (t >= a.Tq) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col < a.d)
        store2(ob + t * a.o_st + col, o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
    }
  }
}

// q/k/v [B, T, H*D] bf16 through 3-d tensor maps {H*D, T, B}: box {64, rows,
// 1} at column h*D + 64*slab, row q0 (Q) or 0 (K, V), batch b
template <int DP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const wgfa::WArgs& a, int B, long long q_sb,
                         long long q_st, long long k_sb, long long k_st,
                         long long v_sb, long long v_st, cudaStream_t stream) {
  using C = wgfa::WCfg<DP>;
  const uint64_t hd = uint64_t(a.H) * a.d;
  CUtensorMap mq, mk, mv;
  const uint64_t qdims[3] = {hd, uint64_t(a.Tq), uint64_t(B)};
  const uint64_t qstr[2] = {uint64_t(q_st) * 2, uint64_t(q_sb) * 2};
  const uint32_t qbox[3] = {64, C::BQ, 1};
  const uint64_t kdims[3] = {hd, uint64_t(a.Tk), uint64_t(B)};
  const uint64_t kstr[2] = {uint64_t(k_st) * 2, uint64_t(k_sb) * 2};
  const uint64_t vstr[2] = {uint64_t(v_st) * 2, uint64_t(v_sb) * 2};
  const uint32_t kbox[3] = {64, wgfa::TKP, 1};
  cudaError_t err = encode_bf16_map(&mq, q, 3, qdims, qstr, qbox);
  if (err == cudaSuccess) err = encode_bf16_map(&mk, k, 3, kdims, kstr, kbox);
  if (err == cudaSuccess) err = encode_bf16_map(&mv, v, 3, kdims, vstr, kbox);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(C::SMEM));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + C::BQ - 1) / C::BQ, B * a.H);
  flash_fwd_wgmma_kernel<DP><<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, a);
  return cudaGetLastError();
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

// The bf16 single-pass form (flash_fwd_wgmma_kernel): q/k/v bf16 with
// 16-byte aligned pointers and batch and row strides, D (the padded head
// dim) a multiple of 16 up to 128, 1 <= Tk <= 256, and no bias or one row
// of keys per (b, h) (bias_st == 0). The other arguments as
// flash_attention_fwd's.
int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                              const void* bias, void* out, void* lse, int B,
                              int H, int Tq, int Tk, int D, long long q_sb,
                              long long q_st, long long k_sb, long long k_st,
                              long long v_sb, long long v_st, long long o_sb,
                              long long o_st, long long bias_sb,
                              long long bias_sh, float scale, int causal,
                              const void* seed, unsigned keep_thresh,
                              float inv_keep, void* stream) {
  const long long strides[6] = {q_sb, q_st, k_sb, k_st, v_sb, v_st};
  for (long long st : strides)
    if (st <= 0 || (st * 2) % 16 != 0) return cudaErrorInvalidValue;
  if (D % 16 != 0 || D < 16 || D > 128 || Tk < 1 || Tk > wgfa::TKP ||
      Tq < 1 || B < 1 || H < 1 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return cudaErrorInvalidValue;
  const wgfa::WArgs a{static_cast<const float*>(bias), out,
                      static_cast<float*>(lse), H, Tq, Tk, D, o_sb, o_st,
                      bias_sb, bias_sh, scale, causal,
                      static_cast<const long long*>(seed), keep_thresh,
                      inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch_wgmma<64>(q, k, v, a, B, q_sb, q_st, k_sb, k_st, v_sb,
                            v_st, s);
  return launch_wgmma<128>(q, k, v, a, B, q_sb, q_st, k_sb, k_st, v_sb, v_st,
                           s);
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
