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

#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>

#include "mma_tf32.cuh"

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

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
