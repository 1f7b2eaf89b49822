// Fused vocabulary projection + label-smoothed softmax cross-entropy,
// forward, for Hopper (sm_90a): x and W in f32 (3xTF32) or bf16 (AMP),
// loss and lse in f32.
//
// Replaces the Pallas TPU kernel _fwd_kernel of paddle_tpu/ops/fused_ce.py
// (:57, driven by _fwd_impl :106). For each row t of x [T, D]:
//   z    = x[t] . W + b                    (W [D, V], b [V] or absent)
//   lse  = log sum_v exp(z_v)
//   loss = lse - (1 - eps) * z[y_t] - eps * mean_v(z_v)
// The [T, V] logits never reach device memory: each tile of z lives in the
// tensor cores' accumulator registers and is consumed at once by an online
// (max, sum exp, sum z, z[y]) accumulation. A label outside [0, V) adds
// z[y] = 0; a row's loss is masked by the model, not here.
//
// What bounds it on the card: operations. The product is 2*T*D*V FLOPs,
// 1.00663e12 for Transformer-base's loss head (T = 32768, D = 512,
// V = 30000). It runs as 3xTF32 on the tensor cores (below): 3 x 1.00663e12
// TF32 operations at 495 TFLOP/s = 6.101 ms, against 15.024 ms for the same
// f32 product on the FMA pipes (67 TFLOP/s). The bytes (x, W, b, y once
// each, loss and lse out: 128.9 MB) take 0.0385 ms at 3.35 TB/s.
//
// The TPU kernel walks a sequential (row block, vocabulary block) grid and
// carries the statistics in VMEM scratch across it; none of that carries
// over. Here the GEMM C[t, v] = sum_k x[t, k] W[k, v] is the conv kernel's
// (fused_conv.cu): A = x, row-major with k contiguous; B = W, k rows with v
// contiguous.
//   * 3xTF32 mma.sync m16n8k8. Each f32 operand splits in registers, after
//     its fragment load, into big = rna_tf32(a) and small = rna_tf32(a -
//     big); As*Bb + Ab*Bs + Ab*Bb accumulate (mma_tf32.cuh). Each chunk of
//     BK = 32 k sums into a fresh tensor-core accumulator, which is added
//     into the f32 sum on the FMA pipe: the tensor cores round their
//     additions toward zero, and a chain over all of D biases z toward zero
//     and lse with it (the flash kernels' chained S failed their f64 check).
//   * Tiles. A block of 8 warps owns BM = 128 rows and walks its split of
//     the vocabulary in tiles of BN = 128 columns, warp tiles 64 x 32 (2 x 4
//     warps), one block an SM (the acc and chunk sums take 128 registers a
//     thread). x and W both stream through the ring: per tile a block reads
//     its x rows (256 KB at D = 512) and one W tile (256 KB), so the L2
//     serves x 235 times (15.7 GB) and W 256 times (15.7 GB) at the
//     training shape, against 47 GB for the 64 x 128 tiles of the FMA
//     kernel this replaces. blockIdx.x runs over row tiles, so the blocks on
//     the card at one time share a split and walk the same W tiles together
//     (W, 61.4 MB, is larger than the 50 MB L2; each W tile comes from HBM
//     about once a wave).
//   * Loads. Chunks of BK = 32 along D through a ring of 4 stages in
//     dynamic shared memory, filled by cp.async with one barrier per chunk
//     and the next three chunks in flight; the ring runs on across tiles, so
//     the next tile's first chunks land while this tile's epilogue runs. x
//     rows go in 16-byte copies when D % 4 == 0 and x is 16-byte aligned, W
//     rows when V % 4 == 0 and W is (template XV, WV); 4-byte copies
//     otherwise. A ragged k chunk, rows past T and columns past the split's
//     end are zero-filled (cp.async's src-size 0). Rows are padded (A:
//     BK + 4, B: BN + 8 floats) so the fragment loads are free of bank
//     conflicts.
//   * The epilogue on the accumulator fragments. A thread holds rows g and
//     g + 8 of each 16-row tile and columns 2t, 2t + 1 of each 8-column
//     tile (g = lane / 4, t = lane % 4): 8 rows x 8 columns of each vocab
//     tile. Per row it adds the bias, masks columns past the split's end,
//     takes its max over its 8 columns, rescales its running sum once with
//     exp(m_old - m_new) and adds one exp(z - m_new) per element (no
//     per-element branch); it adds z into its sum of z, and the one thread
//     whose column is the row's label stores z[y] to shared memory. At the
//     end the 4 lanes of a quad combine by shuffles, then the 4 warp
//     columns through shared memory in a fixed order.
//   * The vocabulary split. ops/fused_ce.py plans it: when the row tiles
//     alone do not fill whole waves of the SMs, each of nsplit splits of
//     whole tiles writes its partial (max, sum exp, sum z, z[y]) per row
//     and a second launch combines the splits per row in a fixed order. No
//     atomics: two runs give bitwise-equal loss and lse.
//   * bf16 (AMP; the reference feeds its kernel bf16 x, W and b, its
//     nn_ops.py:588). One bf16 mma.sync m16n8k16 per product: a product of
//     two bf16 values is exact in f32, so there is nothing to split. The
//     tiles, the ring, the chunk sums added on the FMA pipe (BK = 32 is
//     two k-steps) and the epilogue are the f32 form's; the bias arrives in
//     f32. Bounded by operations: 2 * T * D * V at 989 TFLOP/s (1.018 ms
//     at the training shape). The smem rows are padded to BK + 8 and
//     BN + 8 bf16, so the A fragments (32-bit words of rows g, columns
//     2t, 2t + 8) and the B fragments (two 16-bit loads from rows 2t,
//     2t + 1) are free of bank conflicts. x and W rows go in 16-byte
//     copies (8 bf16) where D % 8 == 0 (V % 8 == 0) and the pointer is
//     16-byte aligned, element by element otherwise. The grid, the split
//     and one block an SM are the f32 form's, so ops/fused_ce.py
//     split_plan plans both.
//   * bf16 on warpgroup products (fused_ce_wgmma_kernel; the route,
//     ops/fused_ce.py ce_form, sends it every bf16 call whose D is a
//     multiple of 8 from a 16-byte aligned x, at any V: the tensor map of
//     x needs 16-byte rows. W's map reads W, or where V % 8 != 0 or W is
//     misaligned the wrapper's copy of it into rows of V rounded up to 8
//     (ops/fused_ce.py wgmma_w_operand): the map's dimensions stop at V,
//     so TMA reads zeros past it and no pad column reaches a logit; the
//     copy is 0.063 ms of BERT's W. Other bf16 calls keep the mma.sync
//     form above.) That form runs mma.sync m16n8k16 from B fragments
//     packed element by element, at 0.14 of the bound at D = 512 and 0.048
//     at BERT's MLM head (T = 16384, D = 768, V = 30522, bound 0.777 ms).
//     This one:
//       - A block of three warpgroups owns BM = 128 rows. Warpgroup 0 is
//         the producer: one thread issues the TMA loads of x's [128 rows x
//         64 k] slab and W's [64 k x 128 v] chunk (two 64-wide slabs) into
//         one stage of a 7-stage ring (32 KB a stage, 128-byte swizzle;
//         full/empty mbarriers), and the warpgroup gives its registers to
//         the consumers (setmaxnreg 40 / 232).
//       - Why x streams. The earlier form kept x's 128 rows resident (128 KB
//         at D <= 512) and streamed W alone; at D = 768 x takes 192 KB of
//         the 227 KB, leaving room for four 8 KB W stages only. Timed on
//         an H100 (tools/wgmma_variants.py --ce at the commit that built
//         the three plans, chunk depth 64): at BERT's shape x streamed
//         2.114 ms, x resident with four 32-deep W stages 2.704 ms (half
//         the L2 bytes: 6.0 GB against 12.0, but 32 KB in flight against
//         224); at Transformer-base's [32768, 512] x [512, 30000] x
//         streamed 2.579 ms against the resident form's 2.600 in the same
//         call. So one streamed form serves every D. The L2 serves W once
//         per row tile and x once per column tile: 12.0 GB at BERT's shape
//         in 2.114 ms, 15.7 GB at the Transformer's in 2.579 ms (6.1
//         TB/s), so this card's L2 reads at least that. The split plan is
//         the resident form's (WGMMA_TILE): one split of 128 row tiles at
//         BERT's shape, 4 of 132 SMs idle.
//       - Warpgroups 1 and 2 own 64 rows each and run wgmma m64n128k16
//         with A = x's slab from shared memory (K-major) and B = W's chunk
//         (V-contiguous: the transpose bit). Both read each stage; it is
//         refilled after both have retired it.
//       - Chunk sums: each `ksum` chunks of 64 k (the wrapper's depth)
//         sum into a fresh accumulator, added into the tile's f32 sum on
//         the FMA pipe, as the mma.sync forms do per 32 k: the tensor
//         cores round their additions toward zero, and the loss and lse
//         stay f32. ops/fused_ce.py WGMMA_CHUNK_K holds the depth, 128:
//         the deepest whose errors against f64 stay within 1.1x the plain
//         version's at D 768 and D 512 (tools/wgmma_variants.py --ce;
//         chip_smoke.py's fused_ce_f64 allows 1.5x; PERF.md).
//       - Overlap: warpgroup 2 starts LEAD chunks behind warpgroup 1, so
//         while one runs its softmax epilogue on its accumulator the
//         other's products keep the tensor cores busy; the ring (both
//         must release a stage) bounds how far apart they drift.
//       - The epilogue is the mma.sync forms': the bias, the column mask,
//         the online (max, sum exp, sum z, z[y]) per row, the quad's
//         lanes merged by shuffles in a fixed order; the label's test and
//         the mask run only in the tiles that need them (branches uniform
//         over the warp). The exponentials are expf, as the plain
//         version's (ex2.approx saved 3%, PERF.md). A warp owns whole
//         rows (16 of them), so no cross-warp combine is needed, and two
//         runs give bitwise-equal loss and lse. The splits and the
//         combine launch are shared with the other forms.
//       - ptxas: 168 registers (the cap of a 384-thread block, which
//         setmaxnreg redistributes), no spills.

#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256, STAGES = 4;
constexpr int WM = 64, WN = 32;           // warp tile: 2 x 4 warps
constexpr int MT = WM / 16, NT = WN / 8;  // m16n8 tiles per warp

// shared-memory rows in elements: the x chunk [BM][AS], the W chunk
// [BK][BS]; one stage holds both
template <typename T>
struct Smem {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int AS = BK + (F32 ? 4 : 8);
  static constexpr int BS = BN + 8;
  static constexpr int STAGE = BM * AS + BK * BS;
  static constexpr int BYTES = STAGES * STAGE * int(sizeof(T));
};
constexpr unsigned FULL = 0xffffffffu;

// (m, s) <- the statistics of the union of (m, s) and (mo, so); -inf - -inf
// (neither saw a valid column) gives s = 0, not NaN
__device__ __forceinline__ void merge(float& m, float& s, float mo,
                                      float so) {
  const float mn = fmaxf(m, mo);
  s = (mn == -INFINITY) ? 0.f : s * expf(m - mn) + so * expf(mo - mn);
  m = mn;
}

// partial: [nsplit, T] of (max, sum exp(z - max), sum z, z[y]) over the
// split's columns. Grid (row tiles, splits).
template <typename E, bool XV, bool WV>
__global__ void __launch_bounds__(THREADS, 1)
fused_ce_kernel(const E* __restrict__ x, const E* __restrict__ w,
                const float* __restrict__ bias, const int* __restrict__ y,
                float4* __restrict__ partial, int T, int D, int V,
                int cols_per_split) {
  using S = Smem<E>;
  constexpr int AS = S::AS, BS = S::BS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* smem = reinterpret_cast<E*>(smem_raw);
  __shared__ int lbl_s[BM];
  __shared__ float zy_s[BM];
  __shared__ float red[3][4][BM];  // (m, s, sum z) per (warp column, row)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;  // quad, lane in quad
  const int t0 = blockIdx.x * BM;
  const int v_begin = blockIdx.y * cols_per_split;
  const int v_end = min(V, v_begin + cols_per_split);

  if (tid < BM) {
    lbl_s[tid] = t0 + tid < T ? y[t0 + tid] : -1;
    zy_s[tid] = 0.f;
  }

  const int nk = (D + BK - 1) / BK;
  const int total = ((v_end - v_begin + BN - 1) / BN) * nk;
  constexpr int CH = 16 / sizeof(E);  // elements per 16-byte copy

  // chunk it: vocab tile it / nk of the split, k chunk it % nk. 16-byte
  // copies (XV, WV) by cp.async; otherwise f32 copies 4 bytes by cp.async
  // and bf16 one element by plain loads and stores (seen by all threads
  // after the barrier that precedes the chunk's use)
  auto load_chunk = [&](int stage, int it) {
    E* As = smem + stage * S::STAGE;
    E* Bs = As + BM * AS;
    const int tile = it / nk;
    const int k0 = (it - tile * nk) * BK, v0 = v_begin + tile * BN;
    if (XV) {
#pragma unroll
      for (int i = 0; i < BM * BK / CH / THREADS; ++i) {
        const int idx = tid + THREADS * i;
        const int row = idx / (BK / CH), col = (idx % (BK / CH)) * CH;
        const bool ok = t0 + row < T && k0 + col < D;
        cp16(As + row * AS + col,
             ok ? x + (long long)(t0 + row) * D + k0 + col : x, ok);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < BM * BK / THREADS; ++i) {
        const int row = (tid >> 5) + 8 * i, col = tid & 31;
        const bool ok = t0 + row < T && k0 + col < D;
        const E* src = ok ? x + (long long)(t0 + row) * D + k0 + col : x;
        if constexpr (S::F32) cp4(As + row * AS + col, src, ok);
        else As[row * AS + col] = ok ? *src : E(0.f);
      }
    }
    if (WV) {
#pragma unroll
      for (int i = 0; i < BK * BN / CH / THREADS; ++i) {
        const int idx = tid + THREADS * i;
        const int k = idx / (BN / CH), col = (idx % (BN / CH)) * CH;
        const bool ok = k0 + k < D && v0 + col < v_end;
        cp16(Bs + k * BS + col,
             ok ? w + (long long)(k0 + k) * V + v0 + col : w, ok);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < BK * BN / THREADS; ++i) {
        const int k = (tid >> 7) + 2 * i, col = tid & (BN - 1);
        const bool ok = k0 + k < D && v0 + col < v_end;
        const E* src = ok ? w + (long long)(k0 + k) * V + v0 + col : w;
        if constexpr (S::F32) cp4(Bs + k * BS + col, src, ok);
        else Bs[k * BS + col] = ok ? *src : E(0.f);
      }
    }
  };

  // acc: the tile's f32 sum; part: one chunk's tensor-core sum
  float acc[MT][NT][4], part[MT][NT][4];
  // the thread's running statistics for its 8 rows, q = 2 * i + h (row
  // wm * WM + 16 * i + 8 * h + gq), over its columns so far
  float m[2 * MT], s[2 * MT], sz[2 * MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int q = 0; q < 2 * MT; ++q) {
    m[q] = -INFINITY;
    s[q] = sz[q] = 0.f;
  }

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < total) load_chunk(st, st);
    cp_commit();
  }
  int kc = 0, v0 = v_begin;
  for (int it = 0; it < total; ++it) {
    cp_wait<STAGES - 2>();  // chunk it has landed
    __syncthreads();        // ... for all threads; chunk it - 1 is consumed
    const int pf = it + STAGES - 1;
    if (pf < total) load_chunk(pf % STAGES, pf);
    cp_commit();

    const E* As = smem + (it % STAGES) * S::STAGE;
    const E* Bs = As + BM * AS;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
    if constexpr (S::F32) {
#pragma unroll
      for (int ks = 0; ks < BK; ks += 8) {
        unsigned bb[NT][2], bs[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* b = Bs + (ks + tq) * BS + wn * WN + j * 8 + gq;
          split_tf32(b[0], bb[j][0], bs[j][0]);
          split_tf32(b[4 * BS], bb[j][1], bs[j][1]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          unsigned ab[4], as[4];
          const float* a = As + (wm * WM + i * 16 + gq) * AS + ks + tq;
          split_tf32(a[0], ab[0], as[0]);
          split_tf32(a[8 * AS], ab[1], as[1]);
          split_tf32(a[4], ab[2], as[2]);
          split_tf32(a[8 * AS + 4], ab[3], as[3]);
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_3xtf32(part[i][j], ab, as, bb[j], bs[j]);
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        unsigned bw[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const E* b = Bs + (ks + 2 * tq) * BS + wn * WN + j * 8 + gq;
          bw[j][0] = pack_bf16(b[0], b[BS]);
          bw[j][1] = pack_bf16(b[8 * BS], b[9 * BS]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const E* a = As + (wm * WM + i * 16 + gq) * AS + ks + 2 * tq;
          const unsigned af[4] = {ld32(a), ld32(a + 8 * AS), ld32(a + 8),
                                  ld32(a + 8 * AS + 8)};
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(part[i][j], af, bw[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];

    if (++kc < nk) continue;
    // the tile is complete: fold it into the statistics
    kc = 0;
    const int cb = v0 + wn * WN + 2 * tq;  // column of (j, c) = (0, 0)
    float bj[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = cb + j * 8 + c;
        bj[j][c] = (bias != nullptr && col < v_end) ? __ldg(bias + col) : 0.f;
      }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 2 * i + h, r = wm * WM + i * 16 + h * 8 + gq;
        const int lbl = lbl_s[r];
        float z[NT][2], tmax = -INFINITY, zsum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = cb + j * 8 + c;
            const float zz = acc[i][j][2 * h + c] + bj[j][c];
            const bool valid = col < v_end;
            if (valid && col == lbl) zy_s[r] = zz;
            z[j][c] = valid ? zz : -INFINITY;
            zsum += valid ? zz : 0.f;
            tmax = fmaxf(tmax, z[j][c]);
          }
        const float mn = fmaxf(m[q], tmax);
        const float mref = mn == -INFINITY ? 0.f : mn;  // exp(-inf) = 0
        float e = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) e += expf(z[j][c] - mref);
        s[q] = s[q] * expf(m[q] - mref) + e;
        m[q] = mn;
        sz[q] += zsum;
      }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    v0 += BN;
  }
  cp_wait<0>();

  // the 4 lanes of a quad (lanes xor 1, then xor 2), then the 4 warp
  // columns in order through shared memory
#pragma unroll
  for (int q = 0; q < 2 * MT; ++q) {
    float mq = m[q], sq = s[q], zq = sz[q];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float mo = __shfl_xor_sync(FULL, mq, o);
      const float so = __shfl_xor_sync(FULL, sq, o);
      zq += __shfl_xor_sync(FULL, zq, o);
      merge(mq, sq, mo, so);
    }
    if (tq == 0) {
      const int r = wm * WM + (q >> 1) * 16 + (q & 1) * 8 + gq;
      red[0][wn][r] = mq;
      red[1][wn][r] = sq;
      red[2][wn][r] = zq;
    }
  }
  __syncthreads();
  if (tid < BM && t0 + tid < T) {
    float mr = red[0][0][tid], sr = red[1][0][tid], zr = red[2][0][tid];
#pragma unroll
    for (int c = 1; c < 4; ++c) {
      merge(mr, sr, red[0][c][tid], red[1][c][tid]);
      zr += red[2][c][tid];
    }
    partial[(long long)blockIdx.y * T + t0 + tid] =
        make_float4(mr, sr, zr, zy_s[tid]);
  }
}

// loss and lse per row from its splits' partials, in split order
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One instantiation: its dynamic shared memory limit is raised once per
// device, then the grid of (row tiles, splits) launches.
template <typename E, bool XV, bool WV>
cudaError_t launch_one(dim3 grid, cudaStream_t s, const void* x,
                       const void* w, const float* bias, const int* y,
                       float4* partial, int T_, int D, int V,
                       int cols_per_split) {
  static std::atomic<unsigned> ready{0};
  auto* kern = fused_ce_kernel<E, XV, WV>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<E>::BYTES);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit);
  }
  kern<<<grid, THREADS, Smem<E>::BYTES, s>>>(
      static_cast<const E*>(x), static_cast<const E*>(w), bias, y, partial,
      T_, D, V, cols_per_split);
  return cudaGetLastError();
}

// the instantiation for the copies x and W allow: 16 bytes where the row
// holds whole 16-byte pieces (D, V multiples of `per16`) from an aligned
// pointer
template <typename E>
cudaError_t dispatch(dim3 grid, cudaStream_t s, const void* x,
                     const void* w, const float* bias, const int* y,
                     float4* partial, int T_, int D, int V,
                     int cols_per_split) {
  constexpr int per16 = 16 / sizeof(E);
  const bool xv = D % per16 == 0 && aligned16(x);
  const bool wv = V % per16 == 0 && aligned16(w);
  if (xv && wv)
    return launch_one<E, true, true>(grid, s, x, w, bias, y, partial, T_, D,
                                     V, cols_per_split);
  if (xv)
    return launch_one<E, true, false>(grid, s, x, w, bias, y, partial, T_,
                                      D, V, cols_per_split);
  if (wv)
    return launch_one<E, false, true>(grid, s, x, w, bias, y, partial, T_,
                                      D, V, cols_per_split);
  return launch_one<E, false, false>(grid, s, x, w, bias, y, partial, T_, D,
                                     V, cols_per_split);
}


// ---------------------------------------------------------------------------
// bf16 on warpgroup products (see the header): fused_ce_wgmma_kernel
// ---------------------------------------------------------------------------
namespace wgce {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 7;
constexpr int THREADS = 384;          // producer warpgroup + 2 consumers
constexpr int X_SLAB = BM * 128;      // x's 128 rows of one 64-wide k slab
constexpr int W_SLAB = BK * 128;      // 64 k rows of one 64-wide v slab
constexpr int STAGE = X_SLAB + 2 * W_SLAB;  // x's slab, W's chunk of a tile
constexpr int LEAD = 2;               // chunks warpgroup 1 starts ahead
constexpr size_t SMEM = 1024 + size_t(STAGES) * STAGE +
                        2 * STAGES * sizeof(uint64_t) +
                        BM * (sizeof(int) + sizeof(float));
static_assert(SMEM <= 232448, "over the 227 KB a block may use");

}  // namespace wgce

// partial as fused_ce_kernel's. tx: x [T, D] (box 64 k x 128 rows), tw: W
// [D, V] (box 64 v x 64 k); ksum: 64-deep chunks per fresh accumulator.
__global__ void __launch_bounds__(wgce::THREADS, 1)
fused_ce_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw,
                      const float* __restrict__ bias,
                      const int* __restrict__ y, float4* __restrict__ partial,
                      int T, int D, int V, int cols_per_split, int ksum) {
  // shadow the mma.sync forms' tile constants of the enclosing namespace
  constexpr int BM = wgce::BM, BN = wgce::BN, BK = wgce::BK;
  constexpr int STAGES = wgce::STAGES, LEAD = wgce::LEAD;
  constexpr int X_SLAB = wgce::X_SLAB, W_SLAB = wgce::W_SLAB;
  constexpr int STAGE = wgce::STAGE;
  extern __shared__ __align__(1024) unsigned char ce_smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(ce_smem) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  int* lbl_s = reinterpret_cast<int*>(empty + STAGES);
  float* zy_s = reinterpret_cast<float*>(lbl_s + BM);

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BM;
  const int v_begin = blockIdx.y * cols_per_split;
  const int v_end = min(V, v_begin + cols_per_split);
  const int nk = (D + BK - 1) / BK;
  const int ntile = (v_end - v_begin + BN - 1) / BN;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  if (tid < BM) {
    lbl_s[tid] = t0 + tid < T ? y[t0 + tid] : -1;
    zy_s[tid] = 0.f;
  }
  __syncthreads();

  if (tid < 128) {
    // producer: x's slab and W's chunk, chunk by chunk, tile by tile,
    // through the ring
    regs_dealloc<40>();
    if (tid == 0) {
      int stage = 0;
      unsigned phase = 0;
      for (int tile = 0; tile < ntile; ++tile) {
        const int v0 = v_begin + tile * BN;
        const bool two = v0 + 64 < V;  // else the second slab is all past V
        for (int c = 0; c < nk; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * STAGE;
          mbar_expect_tx(&full[stage], X_SLAB + (two ? 2 : 1) * W_SLAB);
          tma_load_2d(st, &tx, &full[stage], c * BK, t0);
          tma_load_2d(st + X_SLAB, &tw, &full[stage], v0, c * BK);
          if (two)
            tma_load_2d(st + X_SLAB + W_SLAB, &tw, &full[stage], v0 + 64,
                        c * BK);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    regs_alloc<232>();
    const int cw = tid / 128 - 1;  // consumer warpgroup: rows 64 cw ..
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int r0 = cw * 64 + warp * 16 + gq;  // block rows r0, r0 + 8
    const int lbl[2] = {lbl_s[r0], lbl_s[r0 + 8]};
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.f, 0.f},
          sz[2] = {0.f, 0.f};
    const int lead = min(LEAD, ntile * nk);
    if (cw == 1) named_sync(1, 256);  // start LEAD chunks behind
    int stage = 0, done = 0;
    unsigned phase = 0;
    for (int tile = 0; tile < ntile; ++tile) {
      const int v0 = v_begin + tile * BN;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int c = 0; c < nk; ++c) {
        mbar_wait(&full[stage], phase);
        const bool fresh = c % ksum == 0;
        // this warpgroup's 64 rows of x's slab, and W's chunk
        const unsigned char* xa = ring + stage * STAGE + cw * 64 * 128;
        const unsigned char* wb = ring + stage * STAGE + X_SLAB;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n128<1>(part, wg_desc(xa + 32 * kk, 16, 1024),
                           wg_desc(wb + 2048 * kk, W_SLAB, 1024),
                           (fresh && kk == 0) ? 0 : 1);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_hold(part);
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
        if (cw == 0 && ++done == lead) named_arrive(1, 256);
        if ((c + 1) % ksum == 0 || c + 1 == nk) {
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] += part[i];
        }
      }
      // the tile is complete: acc[4 j + 2 h + e] is row r0 + 8 h, column
      // v0 + 8 j + 2 tq + e. Bias, z[y] and the mask in place (each a
      // branch uniform over the warp, or rare), then the statistics.
      const bool whole = v0 + BN <= v_end;  // no column past the split
      if (bias != nullptr) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = v0 + 8 * j + 2 * tq + e;
            const float bv = (whole || col < v_end) ? __ldg(bias + col) : 0.f;
            acc[4 * j + e] += bv;
            acc[4 * j + 2 + e] += bv;
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (lbl[h] >= v0 && lbl[h] < min(v0 + BN, v_end)) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (v0 + 8 * j + 2 * tq + e == lbl[h])
                zy_s[r0 + 8 * h] = acc[4 * j + 2 * h + e];
        }
      float tmax[2] = {-INFINITY, -INFINITY}, zsum[2] = {0.f, 0.f};
      if (whole) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          zsum[(i >> 1) & 1] += acc[i];
          tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], acc[i]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool valid = v0 + 8 * j + 2 * tq + e < v_end;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float& z = acc[4 * j + 2 * h + e];
              zsum[h] += valid ? z : 0.f;
              z = valid ? z : -INFINITY;
              tmax[h] = fmaxf(tmax[h], z);
            }
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(m[h], tmax[h]);
        const float mref = mn == -INFINITY ? 0.f : mn;  // exp(-inf) = 0
        float ex = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            ex += expf(acc[4 * j + 2 * h + e] - mref);
        s[h] = s[h] * expf(m[h] - mref) + ex;
        m[h] = mn;
        sz[h] += zsum[h];
      }
    }
    // the 4 lanes of a quad (xor 1, then xor 2) hold a row between them
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mq = m[h], sq = s[h], zq = sz[h];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float mo = __shfl_xor_sync(FULL, mq, o);
        const float so = __shfl_xor_sync(FULL, sq, o);
        zq += __shfl_xor_sync(FULL, zq, o);
        merge(mq, sq, mo, so);
      }
      const int r = r0 + 8 * h;
      if (tq == 0 && t0 + r < T)
        partial[(long long)blockIdx.y * T + t0 + r] =
            make_float4(mq, sq, zq, zy_s[r]);
    }
  }
}

// W's map reads `ldw`-element rows (W itself, or its copy with 16-byte
// rows) as V columns, so TMA fills zeros past V
cudaError_t launch_wgmma(dim3 grid, cudaStream_t s, const void* x,
                         const void* w, const float* bias, const int* y,
                         float4* partial, int T_, int D, int V, int ldw,
                         int cols_per_split, int ksum) {
  CUtensorMap mx, mw;
  const uint64_t xdims[2] = {uint64_t(D), uint64_t(T_)};
  const uint64_t xstr[1] = {uint64_t(D) * 2};
  const uint32_t xbox[2] = {64, wgce::BM};
  const uint64_t wdims[2] = {uint64_t(V), uint64_t(D)};
  const uint64_t wstr[1] = {uint64_t(ldw) * 2};
  const uint32_t wbox[2] = {64, wgce::BK};
  cudaError_t err = encode_bf16_map(&mx, x, 2, xdims, xstr, xbox);
  if (err != cudaSuccess) return err;
  err = encode_bf16_map(&mw, w, 2, wdims, wstr, wbox);
  if (err != cudaSuccess) return err;
  static std::atomic<unsigned> ready{0};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(fused_ce_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(wgce::SMEM));
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit);
  }
  fused_ce_wgmma_kernel<<<grid, wgce::THREADS, wgce::SMEM, s>>>(
      mx, mw, bias, y, partial, T_, D, V, cols_per_split, ksum);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and w). x: contiguous [T, D]; w:
// contiguous [D, V]; bias: f32 [V] or null; y: int32 [T]; loss, lse: f32
// [T]; partial: scratch of nsplit * T * 4 floats (16-byte aligned). The
// plan (ops/fused_ce.py split_plan): rows_per_block must be 128,
// cols_per_split a positive multiple of 128, and nsplit = ceil(V /
// cols_per_split), so no split is empty. Two launches on `stream`.
int fused_ce_fwd(const void* x, const void* w, const void* bias,
                 const void* y, void* loss, void* lse, void* partial,
                 int dtype, int T, int D, int V, int rows_per_block,
                 int nsplit, int cols_per_split, float eps, void* stream) {
  if (T <= 0 || D <= 0 || V <= 0 || rows_per_block != BM ||
      cols_per_split <= 0 || cols_per_split % BN != 0 ||
      nsplit != (V + cols_per_split - 1) / cols_per_split)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + BM - 1) / BM, nsplit);
  const float* bf = static_cast<const float*>(bias);
  const int* yi = static_cast<const int*>(y);
  float4* p = static_cast<float4*>(partial);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(grid, s, x, w, bf, yi, p, T, D, V, cols_per_split);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(grid, s, x, w, bf, yi, p, T, D, V,
                                  cols_per_split);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  fused_ce_combine<<<(T + 255) / 256, 256, 0, s>>>(
      p, static_cast<float*>(loss), static_cast<float*>(lse), T, V, nsplit,
      eps);
  return cudaGetLastError();
}

// The bf16 form on warpgroup products (fused_ce_wgmma_kernel): x bf16
// [T, D], D a multiple of 8, 16-byte aligned; w bf16 with rows of `ldw`
// elements (ldw >= V, a multiple of 8; 16-byte aligned), of which the
// first V are W's; chunk_k: the k depth per fresh accumulator, a positive
// multiple of 64. The plan and the other arguments as fused_ce_fwd's. Two
// launches on `stream`.
int fused_ce_fwd_wgmma(const void* x, const void* w, const void* bias,
                       const void* y, void* loss, void* lse, void* partial,
                       int T, int D, int V, int ldw, int rows_per_block,
                       int nsplit, int cols_per_split, int chunk_k, float eps,
                       void* stream) {
  if (T <= 0 || D <= 0 || D % 8 != 0 || V <= 0 || ldw < V || ldw % 8 != 0 ||
      !aligned16(x) || !aligned16(w) || chunk_k < wgce::BK ||
      chunk_k % wgce::BK != 0 || rows_per_block != wgce::BM ||
      cols_per_split <= 0 || cols_per_split % wgce::BN != 0 ||
      nsplit != (V + cols_per_split - 1) / cols_per_split)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + wgce::BM - 1) / wgce::BM, nsplit);
  float4* p = static_cast<float4*>(partial);
  cudaError_t err = launch_wgmma(
      grid, s, x, w, static_cast<const float*>(bias),
      static_cast<const int*>(y), p, T, D, V, ldw, cols_per_split,
      chunk_k / wgce::BK);
  if (err != cudaSuccess) return err;
  fused_ce_combine<<<(T + 255) / 256, 256, 0, s>>>(
      p, static_cast<float*>(loss), static_cast<float*>(lse), T, V, nsplit,
      eps);
  return cudaGetLastError();
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
