// Fused conv + batch-norm epilogues for Hopper (sm_90a), f32 in and out,
// and their bf16 forms (ResNet-50 under fluid.amp; see "bf16" below).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/fused_conv.py:
//   conv_moments  <- _conv_moments_kernel (:159, driver _conv_moments :231):
//                    co = conv(x, w), and per output channel the sum and the
//                    sum of squares of the stored co (the BN statistics);
//   conv_apply    <- _conv_apply_kernel (:198, driver _conv_apply :292):
//                    y = conv(x, w) * scale[o] + shift[o] (+ res)(+ relu),
//                    co never stored (inference);
//   bn_apply      <- _apply_kernel (:187, driver _apply :260):
//                    y = co * scale[o] + shift[o] (+ res)(+ relu).
// Geometries: 1x1 stride 1 or 2 (stride 2 reads x[n, c, 2i, 2j] by strides,
// the reference's pre-slice without the copy) and 3x3 pad 1 stride 1.
//
// What bounds them on the card. The convs: operations, on the tensor cores.
// ResNet-50's 3x3 body at 56x56 and batch 128 is 29.6 GFLOP against 0.2 GB
// of input and output. The products run as 3xTF32 (below): three TF32
// tensor-core products per f32 product, 3 x 29.6 GFLOP at 495 TFLOP/s, with
// f32 accumulators, for f32-level accuracy (the port's convs are f32 with
// TF32 off). bn_apply: bytes; one read of co (and the residual) and one
// write of y, two flops each.
//
// The TPU kernel keeps one whole image [C, H*W] in VMEM per grid step as
// K*K shifted tap matmuls on the MXU and sums the moments across its
// sequential batch grid; none of that carries over. The convs here are one
// implicit GEMM, C[o, p] = sum_k W[o, k] X[k, p], p over the N*Ho*Wo output
// pixels, k over C*KH*KW, on mma.sync m16n8k8 TF32 tensor-core products:
//   * 3xTF32. Each f32 operand a splits in registers, after its fragment
//     load, into big = rna_tf32(a) and small = rna_tf32(a - big); the
//     products As*Bb + Ab*Bs + Ab*Bb (small terms first) accumulate, As*Bs
//     (about 2^-22 of the product) is dropped. A single TF32 product would
//     keep only 11 bits of each operand.
//   * f32 accumulation. The tensor cores round their additions toward
//     zero, and over K = 4608 that alone made the error against an f64 conv
//     ten times cuDNN's f32 one. So each chunk of BK = 32 k sums into a
//     fresh tensor-core accumulator, which is then added into the f32 sum
//     on the FMA pipe (twice the accumulator registers; error below
//     cuDNN's).
//   * Tiles. A block of 8 warps owns BM = 64 channels x BN = 128 pixels in
//     2 x 4 warp tiles of 32 x 32, two blocks an SM; stride-2 convs take BM =
//     128 (warp tiles 64 x 32, one block an SM), which gathers their strided
//     x for half as many channel tiles (launch_conv says why). Pixel tiles
//     cross image boundaries, so small images (7x7 = 49 pixels at stage 4)
//     still fill a tile.
//   * Loads. k walks in chunks of BK = 32 through a ring of 3 stages (4 for
//     BM = 128) in dynamic shared memory, filled by cp.async with one
//     barrier per chunk and the next chunks in flight. k runs tap-major,
//     k = (dy*KS + dx)*C + c, so when C % 16 == 0 a thread's 16 rows of a
//     chunk share one tap: one bounds test, then one address add and one
//     4-byte copy per row. Each
//     thread keeps one pixel and (c, dy, dx) counters for its next row (no
//     division per element); 3x3 zero padding is cp.async's src-size 0.
//     1x1 stride-1 convs with H*W % 4 == 0 copy 4 pixels in 16 bytes (four
//     aligned pixels then lie in one image), and their W rows in 16 bytes
//     when K % 4 == 0; 3x3 W is read at w[o, c, dy, dx] by 4-byte copies.
//     Rows are padded (A: BK + 4, B: BN + 8 floats) so the fragment loads
//     are free of bank conflicts.
//   * Two epilogues on one template, both through shared memory so that
//     the stores along pixels are 16 bytes wide where Ho*Wo % 4 == 0.
//     conv_moments stores co and sums co and co^2 per channel over the
//     tile's pixels: in registers, over the 4 lanes of a quad by shuffles,
//     then over the 4 warp columns through shared memory in a fixed order,
//     into a [tiles, 2, O] buffer; a second launch sums the tiles per
//     channel in a fixed order, so the moments are deterministic (no
//     atomics). conv_apply applies the folded BN affine, the residual and
//     relu, and stores y.
// bn_apply is a grid-stride elementwise pass, float4 wide when H*W is a
// multiple of 4 (then four neighbours share a channel) and the pointers are
// 16-byte aligned; scalar otherwise (stage 4: H*W = 49).
//
// bf16. The reference casts a fused site's x and w to bf16 under AMP and
// runs the same three kernels on them (nn_ops.py:282); co, the residual
// and y are bf16, scale, shift and the moments f32. What bounds them: the
// 3x3 body at 56x56 and batch 128 is 29.6 GFLOP (0.030 ms at 989 TFLOP/s)
// against 102.8 MB of x and co (0.031 ms at 3.35 TB/s): bytes, barely.
// The design:
//   * One mma.sync m16n8k16 bf16 product per product, f32 accumulators on
//     the tensor cores: a bf16 x bf16 product is exact in f32, and the
//     truncation of the tensor cores' additions (about 2^-23 of the sum)
//     lies far below the bf16 rounding of co, so no chunk sums on the FMA
//     pipe.
//   * Operands reach registers by ldmatrix: .x4 for the A (W) fragments
//     from a row-major [BM][BK + 8] tile, .x4.trans for two n8 B fragments
//     at once from the pixel-major [BK][BN + 8] X tile. The padded rows
//     (80 and 272 bytes) put the eight rows of each 8x8 matrix in eight
//     different 16-byte bank groups.
//   * Loads go through registers: cp.async copies 4 bytes at least, from an
//     aligned source, and a 3x3 tap shifted by dx = +-1 starts on a 2-byte
//     boundary. Each chunk (BK = 32) is loaded into registers before the
//     products of the chunk ahead of it and stored to the other of two
//     shared-memory stages after them: one barrier a chunk. X is gathered
//     one 2-byte element a row (a thread's 16 rows share one tap when C %
//     16 == 0), or 8 pixels in 16 bytes for 1x1 stride 1 when H*W % 8 ==
//     0. W is repacked by the wrapper once a call to the tap-major
//     [O, KH*KW*C] layout (the reference's _w_taps :224), read 8 columns in
//     16 bytes when K % 8 == 0.
//   * The epilogues round the accumulator to bf16 once. conv_moments stores
//     it as co and sums the rounded values (converted back to f32) per
//     channel into the same deterministic [tiles, 2, O] partials and
//     ordered second pass as f32. conv_apply applies the affine to the
//     rounded conv as a product, then a sum (each rounded to f32), rounds to
//     bf16, adds the residual (f32 sum of two bf16, rounded: a correctly
//     rounded bf16 add) and applies relu: the reference's rounding points
//     (:190-191, :205). The C tile goes through shared memory in bf16, so
//     the stores along pixels are 16 bytes (8 pixels) wide where Ho*Wo % 8
//     == 0.
//   * bn_apply (a bf16 overload of bn_apply_kernel) reads bf16 co and
//     residual in 16-byte vectors of 8 where H*W % 8 == 0 and the pointers
//     are aligned, one element otherwise (stage 4), with the same
//     arithmetic as conv_apply's epilogue.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "conv_epilogue_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int BN = 128, BK = 32, THREADS = 256;
constexpr int AS = BK + 4;  // row of the W chunk [BM][AS], in floats
constexpr int BS = BN + 8;  // row of the X chunk [BK][BS] and of the C tile

// depth of the cp.async ring: 3 stages keep two 64-channel blocks (80 KB
// each) on an SM with room left for L1, which the 4-byte gathers use
template <int BM>
__host__ __device__ constexpr int stages() {
  return BM == 64 ? 3 : 4;
}
template <int BM>
__host__ __device__ constexpr int stage_floats() {
  return BM * AS + BK * BS;
}
template <int BM>
__host__ __device__ constexpr int smem_bytes() {
  return stages<BM>() * stage_floats<BM>() * 4;
}

struct Geo {
  int N, C, H, W, O, Ho, Wo;
  int K;     // C * KS * KS
  int P;     // N * Ho * Wo
  int wvec;  // W rows in 16-byte copies: K % 4 == 0, w 16-byte aligned
  int ovec;  // out (and res) in 16-byte stores: Ho*Wo % 4 == 0, aligned
};

// One block: BM channels x BN pixels of C = W X. VEC: 1x1 stride 1 with
// H*W % 4 == 0 and x 16-byte aligned (X in 16-byte copies).
template <int BM, int KS, int STRIDE, bool VEC, bool APPLY>
__global__ void __launch_bounds__(THREADS, BM == 64 ? 2 : 1)
conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ out, float* __restrict__ partial,
            const float* __restrict__ scale, const float* __restrict__ shift,
            const float* __restrict__ res, int relu, Geo g) {
  constexpr int PAD = (KS - 1) / 2, KK = KS * KS, STAGES = stages<BM>();
  constexpr int WM = BM / 2, WN = BN / 4;   // 2 x 4 warps
  constexpr int MT = WM / 16, NT = WN / 8;  // m16n8 tiles per warp
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[2][4][BM];  // moments per (warp column, channel)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;  // quad, lane in quad
  const int p0 = blockIdx.x * BN, o0 = blockIdx.y * BM;
  const int hw = g.H * g.W, hwo = g.Ho * g.Wo;

  // k runs tap-major, k = (dy * KS + dx) * C + c (for 1x1 it is c): W's
  // rows are read at w[o, c, dy, dx] by strides, and a chunk of X rows
  // shares one tap when C % 16 == 0.
  // X gather, VEC: pixels p0 + 4 * (tid % 32) .. + 3 at chunk rows
  // 4 * (tid / 32) .. + 3. Otherwise: pixel p0 + tid % 128 at chunk rows
  // 16 * (tid / 128) .. + 15, with the (c, dy, dx) of its next row kept as
  // counters.
  const int vq = tid & 31, vr = (tid >> 5) * 4;
  const int lp = tid & (BN - 1), lk = (tid >> 7) * 16;
  const float* xn = x;
  bool pv;
  int ih0 = 0, iw0 = 0, xc = lk, xdy = 0, xdx = 0;
  // W gather for 3x3: column tid % 32 of the chunk, at (c, tap) = (wc, wt)
  int wc = tid & 31, wt = 0;
  auto advance = [&](int& c, int& dy, int& dx, int by) {
    c += by;
    while (c >= g.C) {
      c -= g.C;
      if (++dx == KS) {
        dx = 0;
        ++dy;
      }
    }
  };
  auto advance_tap = [&](int& c, int& t, int by) {
    c += by;
    while (c >= g.C) {
      c -= g.C;
      ++t;
    }
  };
  if (VEC) {
    const int p = p0 + 4 * vq;
    pv = p < g.P;
    if (pv) {
      const int n = p / hw;
      xn = x + (long long)n * g.C * hw + (p - n * hw);
    }
  } else {
    const int p = p0 + lp;
    pv = p < g.P;
    if (pv) {
      const int n = p / hwo, r = p - n * hwo;
      const int oh = r / g.Wo, ow = r - oh * g.Wo;
      ih0 = oh * STRIDE - PAD;
      iw0 = ow * STRIDE - PAD;
      xn = x + (long long)n * g.C * hw;
    }
    advance(xc, xdy, xdx, 0);
  }
  if (KS == 3) advance_tap(wc, wt, 0);

  auto load_chunk = [&](int stage, int k0) {
    float* As = smem + stage * stage_floats<BM>();
    float* Bs = As + BM * AS;
    if (KS == 3) {  // 4-byte copies of w[o, wc, wt]
      const bool kok = k0 + (tid & 31) < g.K;
      const float* wk = w + (long long)o0 * g.K + wc * KK + wt;
#pragma unroll 4
      for (int i = 0; i < BM / 8; ++i) {
        const int row = (tid >> 5) + 8 * i;
        const bool ok = kok && o0 + row < g.O;
        cp4(As + row * AS + (tid & 31), ok ? wk + (long long)row * g.K : w,
            ok);
      }
      advance_tap(wc, wt, BK);
    } else if (g.wvec) {
#pragma unroll
      for (int i = 0; i < BM / 32; ++i) {
        const int e = tid + i * THREADS, row = e >> 3, col = (e & 7) * 4;
        const bool ok = o0 + row < g.O && k0 + col < g.K;
        cp16(As + row * AS + col,
             ok ? w + (long long)(o0 + row) * g.K + k0 + col : w, ok);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < BM / 8; ++i) {
        const int e = tid + i * THREADS, row = e >> 5, col = e & 31;
        const bool ok = o0 + row < g.O && k0 + col < g.K;
        cp4(As + row * AS + col,
            ok ? w + (long long)(o0 + row) * g.K + k0 + col : w, ok);
      }
    }
    if (VEC) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + vr + j;
        const bool ok = pv && k < g.K;
        cp16(Bs + (vr + j) * BS + 4 * vq, ok ? xn + (long long)k * hw : x,
             ok);
      }
    } else if (g.C % 16 == 0) {  // the thread's 16 rows share one tap
      const int ih = ih0 + xdy, iw = iw0 + xdx;
      const bool ok = pv && k0 + lk < g.K &&
                      (KS == 1 || ((unsigned)ih < (unsigned)g.H &&
                                   (unsigned)iw < (unsigned)g.W));
      const float* src = xn + ((long long)xc * g.H + ih) * g.W + iw;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        cp4(Bs + (lk + j) * BS + lp, ok ? src + (long long)j * hw : x, ok);
      advance(xc, xdy, xdx, BK);
    } else {
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        const int ih = ih0 + xdy, iw = iw0 + xdx;
        const bool ok = pv && k0 + lk + j < g.K &&
                        (KS == 1 || ((unsigned)ih < (unsigned)g.H &&
                                     (unsigned)iw < (unsigned)g.W));
        cp4(Bs + (lk + j) * BS + lp,
            ok ? xn + ((long long)xc * g.H + ih) * g.W + iw : x, ok);
        advance(xc, xdy, xdx, 1);
      }
      advance(xc, xdy, xdx, BK - 16);  // skip the other half's rows
    }
  };

  // acc: the f32 sum; part: one chunk's tensor-core sum, added into acc on
  // the FMA pipe after each chunk (the tensor cores round their additions
  // toward zero, which over K = 4608 costs ten times cuDNN's f32 error)
  float acc[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int nk = (g.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_chunk(s, s * BK);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();  // chunk kt has landed
    __syncthreads();        // ... for all threads; chunk kt - 1 is consumed
    const int pf = kt + STAGES - 1;
    if (pf < nk) load_chunk(pf % STAGES, pf * BK);
    cp_commit();

    const float* As = smem + (kt % STAGES) * stage_floats<BM>();
    const float* Bs = As + BM * AS;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) part[i][j][v] = 0.f;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 8) {
      unsigned ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* a = As + (wm * WM + i * 16 + gq) * AS + ks + tq;
        split_tf32(a[0], ab[i][0], as[i][0]);
        split_tf32(a[8 * AS], ab[i][1], as[i][1]);
        split_tf32(a[4], ab[i][2], as[i][2]);
        split_tf32(a[8 * AS + 4], ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* b = Bs + (ks + tq) * BS + wn * WN + j * 8 + gq;
        split_tf32(b[0], bb[j][0], bs[j][0]);
        split_tf32(b[4 * BS], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_3xtf32(part[i][j], ab[i], as[i], bb[j], bs[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] += part[i][j][v];
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it becomes the C tile

  // accumulator fragment (i, j, v): channel wm*WM + i*16 + gq + 8*(v/2),
  // pixel wn*WN + j*8 + 2*tq + v%2
  if (!APPLY) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int v = 2 * h; v < 2 * h + 2; ++v) {
            s1 += acc[i][j][v];
            s2 = fmaf(acc[i][j][v], acc[i][j][v], s2);
          }
        s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
        s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
        if (tq == 0) {
          const int row = wm * WM + i * 16 + h * 8 + gq;
          red[0][wn][row] = s1;
          red[1][wn][row] = s2;
        }
      }
  }
  float* Cs = smem;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * WM + i * 16 + h * 8 + gq;
        const int col = wn * WN + j * 8 + 2 * tq;
        *reinterpret_cast<float2*>(Cs + row * BS + col) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  __syncthreads();

  if (!APPLY && tid < BM && o0 + tid < g.O) {
    float* row = partial + (long long)blockIdx.x * 2 * g.O + o0 + tid;
    row[0] = ((red[0][0][tid] + red[0][1][tid]) + red[0][2][tid]) +
             red[0][3][tid];
    row[g.O] = ((red[1][0][tid] + red[1][1][tid]) + red[1][2][tid]) +
               red[1][3][tid];
  }

  // the residual's loads for all of a thread's rows go out before the
  // first store, so their latencies overlap
  if (g.ovec) {  // 4 pixels of one image a thread, rows 8 apart
    constexpr int R = BM / 8;
    const int q = tid & 31, p = p0 + 4 * q;
    if (p >= g.P) return;
    const int n = p / hwo;
    const long long rb = (long long)n * g.O * hwo + (p - n * hwo);
    float4 r[R];
    if (APPLY && res) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int o = o0 + (tid >> 5) + 8 * i;
        r[i] = o < g.O ? __ldg(reinterpret_cast<const float4*>(
                             res + rb + (long long)o * hwo))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = (tid >> 5) + 8 * i, o = o0 + row;
      if (o >= g.O) break;
      float4 v = *reinterpret_cast<const float4*>(Cs + row * BS + 4 * q);
      if (APPLY) {
        const float sc = __ldg(scale + o), sh = __ldg(shift + o);
        v.x = fmaf(v.x, sc, sh);
        v.y = fmaf(v.y, sc, sh);
        v.z = fmaf(v.z, sc, sh);
        v.w = fmaf(v.w, sc, sh);
        if (res) {
          v.x += r[i].x;
          v.y += r[i].y;
          v.z += r[i].z;
          v.w += r[i].w;
        }
        if (relu) {
          v.x = v.x < 0.f ? 0.f : v.x;
          v.y = v.y < 0.f ? 0.f : v.y;
          v.z = v.z < 0.f ? 0.f : v.z;
          v.w = v.w < 0.f ? 0.f : v.w;
        }
      }
      *reinterpret_cast<float4*>(out + rb + (long long)o * hwo) = v;
    }
  } else {  // one pixel a thread, rows 2 apart
    constexpr int R = BM / 2;
    const int p = p0 + lp;
    if (p >= g.P) return;
    const int n = p / hwo;
    const long long rb = (long long)n * g.O * hwo + (p - n * hwo);
    float r[R];
    if (APPLY && res) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int o = o0 + (tid >> 7) + 2 * i;
        r[i] = o < g.O ? __ldg(res + rb + (long long)o * hwo) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = (tid >> 7) + 2 * i, o = o0 + row;
      if (o >= g.O) break;
      float v = Cs[row * BS + lp];
      if (APPLY) {
        v = fmaf(v, __ldg(scale + o), __ldg(shift + o));
        if (res) v += r[i];
        if (relu && v < 0.f) v = 0.f;
      }
      out[rb + (long long)o * hwo] = v;
    }
  }
}

// sums[c] = sum over tiles of partial[t, c], c < cols = 2 * O. A block of 32
// warps covers 32 columns: warp w sums tiles w, w + 32, ... (lanes read
// neighbouring columns), then warp 0 adds the warps in order.
__global__ void __launch_bounds__(1024)
moments_reduce(const float* __restrict__ partial, float* __restrict__ sums,
               int tiles, int cols) {
  __shared__ float red[32][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < cols)
    for (int t = warp; t < tiles; t += 32)
      s += partial[(long long)t * cols + c];
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || c >= cols) return;
  float tot = 0.f;
  for (int i = 0; i < 32; ++i) tot += red[i][lane];
  sums[c] = tot;
}

__device__ __forceinline__ float apply1(float v, float sc, float sh,
                                        const float* res, int i, int relu) {
  v = fmaf(v, sc, sh);
  if (res) v += __ldg(res + i);
  return (relu && v < 0.f) ? 0.f : v;
}

template <bool VEC>
__global__ void __launch_bounds__(256)
bn_apply_kernel(const float* __restrict__ co, const float* __restrict__ scale,
                const float* __restrict__ shift, const float* __restrict__ res,
                float* __restrict__ y, int total, int hw, int O, int relu) {
  const int stride = gridDim.x * blockDim.x;
  if (VEC) {
    const float4* co4 = reinterpret_cast<const float4*>(co);
    const float4* res4 = reinterpret_cast<const float4*>(res);
    float4* y4 = reinterpret_cast<float4*>(y);
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total / 4;
         i += stride) {
      const int c = (i * 4 / hw) % O;
      const float sc = __ldg(scale + c), sh = __ldg(shift + c);
      float4 v = co4[i];
      v.x = fmaf(v.x, sc, sh);
      v.y = fmaf(v.y, sc, sh);
      v.z = fmaf(v.z, sc, sh);
      v.w = fmaf(v.w, sc, sh);
      if (res) {
        const float4 r = __ldg(res4 + i);
        v.x += r.x;
        v.y += r.y;
        v.z += r.z;
        v.w += r.w;
      }
      if (relu) {
        v.x = v.x < 0.f ? 0.f : v.x;
        v.y = v.y < 0.f ? 0.f : v.y;
        v.z = v.z < 0.f ? 0.f : v.z;
        v.w = v.w < 0.f ? 0.f : v.w;
      }
      y4[i] = v;
    }
  } else {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += stride) {
      const int c = (i / hw) % O;
      y[i] = apply1(co[i], __ldg(scale + c), __ldg(shift + c), res, i, relu);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forms (ResNet-50 under fluid.amp)
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int HK = 32;       // k chunk of the bf16 conv
constexpr int HA = HK + 8;   // row of the W chunk [BM][HA], in bf16 (80 B)
constexpr int HB = BN + 8;   // row of the X chunk [HK][HB] and of the C tile
                             // [BM][HB], in bf16 (272 B)

template <int BM>
__host__ __device__ constexpr int h_stage() {
  return BM * HA + HK * HB;  // bf16 elements
}
// two register-staged stages; the bf16 C tile fits in them
template <int BM>
__host__ __device__ constexpr int h_smem_bytes() {
  return 2 * h_stage<BM>() * 2;
}
static_assert(128 * HB <= 2 * h_stage<128>() && 64 * HB <= 2 * h_stage<64>(),
              "the C tile reuses the stages");

__device__ __forceinline__ unsigned short ldg_u16(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
// One block: BM channels x BN pixels of C = W X, bf16 operands, f32
// accumulators. w is tap-major [O, K] (k = (dy * KS + dx) * C + c). VEC:
// 1x1 stride 1 with H*W % 8 == 0 and x 16-byte aligned (X in 16-byte
// loads of 8 pixels).
template <int BM, int KS, int STRIDE, bool VEC, bool APPLY>
__global__ void __launch_bounds__(THREADS, BM == 64 ? 2 : 1)
conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
            bf16* __restrict__ out, float* __restrict__ partial,
            const float* __restrict__ scale, const float* __restrict__ shift,
            const bf16* __restrict__ res, int relu, Geo g) {
  constexpr int PAD = (KS - 1) / 2;
  constexpr int WM = BM / 2, WN = BN / 4;   // 2 x 4 warps
  constexpr int MT = WM / 16, NT = WN / 8;  // m16n8 tiles per warp
  constexpr int AV = BM * HK / 8 / THREADS; // 16-byte pieces of W a thread
  extern __shared__ __align__(16) unsigned char hsmem[];
  bf16* const sm = reinterpret_cast<bf16*>(hsmem);
  __shared__ float red[2][4][BM];  // moments per (warp column, channel)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;  // quad, lane in quad
  const int p0 = blockIdx.x * BN, o0 = blockIdx.y * BM;
  const int hw = g.H * g.W, hwo = g.Ho * g.Wo;

  // X gather, VEC: pixels p0 + 8 * (tid % 16) .. + 7 at chunk rows tid / 16
  // and + 16. Otherwise: pixel p0 + tid % 128 at chunk rows
  // 16 * (tid / 128) .. + 15, with the (c, dy, dx) of its next row kept as
  // counters (cp.async cannot copy a 2-byte element, so the chunk goes
  // through registers: loaded before the products of the chunk ahead of
  // it, stored to shared memory after them).
  const int vq = tid & 15, vr = tid >> 4;
  const int lp = tid & (BN - 1), lk = (tid >> 7) * 16;
  const bf16* xn = x;
  bool pv;
  int ih0 = 0, iw0 = 0, xc = lk, xdy = 0, xdx = 0;
  auto advance = [&](int& c, int& dy, int& dx, int by) {
    c += by;
    while (c >= g.C) {
      c -= g.C;
      if (++dx == KS) {
        dx = 0;
        ++dy;
      }
    }
  };
  if (VEC) {
    const int p = p0 + 8 * vq;
    pv = p < g.P;
    if (pv) {
      const int n = p / hw;
      xn = x + (long long)n * g.C * hw + (p - n * hw);
    }
  } else {
    const int p = p0 + lp;
    pv = p < g.P;
    if (pv) {
      const int n = p / hwo, r = p - n * hwo;
      const int oh = r / g.Wo, ow = r - oh * g.Wo;
      ih0 = oh * STRIDE - PAD;
      iw0 = ow * STRIDE - PAD;
      xn = x + (long long)n * g.C * hw;
    }
    advance(xc, xdy, xdx, 0);
  }

  uint4 ra[AV], rv[2];
  unsigned short rb[16];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int i = 0; i < AV; ++i) {
      const int e = tid + i * THREADS, row = e >> 2, col = (e & 3) * 8;
      const int o = o0 + row, k = k0 + col;
      const bf16* src = w + (long long)o * g.K + k;
      if (g.wvec) {  // K % 8 == 0: the 8 columns lie in range together
        ra[i] = o < g.O && k < g.K
                    ? __ldg(reinterpret_cast<const uint4*>(src))
                    : make_uint4(0u, 0u, 0u, 0u);
      } else {
        unsigned v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = o < g.O && k + j < g.K ? ldg_u16(src + j) : 0u;
        ra[i] = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16,
                           v[4] | v[5] << 16, v[6] | v[7] << 16);
      }
    }
    if (VEC) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = k0 + vr + 16 * j;
        rv[j] = pv && k < g.K ? __ldg(reinterpret_cast<const uint4*>(
                                    xn + (long long)k * hw))
                              : make_uint4(0u, 0u, 0u, 0u);
      }
    } else if (g.C % 16 == 0) {  // the thread's 16 rows share one tap
      const int ih = ih0 + xdy, iw = iw0 + xdx;
      const bool ok = pv && k0 + lk < g.K &&
                      (KS == 1 || ((unsigned)ih < (unsigned)g.H &&
                                   (unsigned)iw < (unsigned)g.W));
      const bf16* src = xn + ((long long)xc * g.H + ih) * g.W + iw;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        rb[j] = ok ? ldg_u16(src + (long long)j * hw) : (unsigned short)0;
      advance(xc, xdy, xdx, HK);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int ih = ih0 + xdy, iw = iw0 + xdx;
        const bool ok = pv && k0 + lk + j < g.K &&
                        (KS == 1 || ((unsigned)ih < (unsigned)g.H &&
                                     (unsigned)iw < (unsigned)g.W));
        rb[j] = ok ? ldg_u16(xn + ((long long)xc * g.H + ih) * g.W + iw)
                   : (unsigned short)0;
        advance(xc, xdy, xdx, 1);
      }
      advance(xc, xdy, xdx, HK - 16);  // skip the other half's rows
    }
  };
  auto store_chunk = [&](int stage) {
    bf16* As = sm + stage * h_stage<BM>();
    bf16* Bs = As + BM * HA;
#pragma unroll
    for (int i = 0; i < AV; ++i) {
      const int e = tid + i * THREADS;
      *reinterpret_cast<uint4*>(As + (e >> 2) * HA + (e & 3) * 8) = ra[i];
    }
    if (VEC) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<uint4*>(Bs + (vr + 16 * j) * HB + 8 * vq) = rv[j];
    } else {
      unsigned short* b = reinterpret_cast<unsigned short*>(Bs) + lp;
#pragma unroll
      for (int j = 0; j < 16; ++j) b[(lk + j) * HB] = rb[j];
    }
  };

  // the products accumulate in f32 on the tensor cores: each bf16 x bf16
  // product is exact, and what their rounded additions lose (about 2^-23
  // of the sum) lies far below the bf16 rounding of co that follows
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int nk = (g.K + HK - 1) / HK;
  load_chunk(0);
  store_chunk(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_chunk((kt + 1) * HK);  // in flight over the MMAs
    const bf16* As = sm + (kt & 1) * h_stage<BM>();
    const bf16* Bs = As + BM * HA;
#pragma unroll
    for (int ks = 0; ks < HK; ks += 16) {
      unsigned af[MT][4], bfr[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(af[i], As + (wm * WM + i * 16 + (lane & 15)) * HA + ks +
                           (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        unsigned r[4];
        ldsm_x4_trans(r, Bs + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * HB +
                             wn * WN + jp * 16 + (lane >> 4) * 8);
        bfr[2 * jp][0] = r[0];
        bfr[2 * jp][1] = r[1];
        bfr[2 * jp + 1][0] = r[2];
        bfr[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    if (kt + 1 < nk) store_chunk((kt + 1) & 1);
    __syncthreads();  // the next stage is full; this one is free
  }

  // co is the accumulator rounded to bf16 once; the moments and the apply
  // read the rounded value (the reference's :167-176 and :205)
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        acc[i][j][v] = __bfloat162float(__float2bfloat16_rn(acc[i][j][v]));
  // accumulator fragment (i, j, v): channel wm*WM + i*16 + gq + 8*(v/2),
  // pixel wn*WN + j*8 + 2*tq + v%2
  if (!APPLY) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int v = 2 * h; v < 2 * h + 2; ++v) {
            s1 += acc[i][j][v];
            s2 = fmaf(acc[i][j][v], acc[i][j][v], s2);
          }
        s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
        s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
        s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
        s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
        if (tq == 0) {
          const int row = wm * WM + i * 16 + h * 8 + gq;
          red[0][wn][row] = s1;
          red[1][wn][row] = s2;
        }
      }
  }
  bf16* Cs = sm;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * WM + i * 16 + h * 8 + gq;
        const int col = wn * WN + j * 8 + 2 * tq;
        *reinterpret_cast<unsigned*>(Cs + row * HB + col) =
            pack_bf16(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  __syncthreads();

  if (!APPLY && tid < BM && o0 + tid < g.O) {
    float* row = partial + (long long)blockIdx.x * 2 * g.O + o0 + tid;
    row[0] = ((red[0][0][tid] + red[0][1][tid]) + red[0][2][tid]) +
             red[0][3][tid];
    row[g.O] = ((red[1][0][tid] + red[1][1][tid]) + red[1][2][tid]) +
               red[1][3][tid];
  }

  if (g.ovec) {  // 8 pixels of one image a thread, rows 16 apart
    constexpr int R = BM / 16;
    const int q = tid & 15, p = p0 + 8 * q;
    if (p >= g.P) return;
    const int n = p / hwo;
    const long long rb = (long long)n * g.O * hwo + (p - n * hwo);
    uint4 r[R];
    if (APPLY && res) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int o = o0 + (tid >> 4) + 16 * i;
        r[i] = o < g.O ? __ldg(reinterpret_cast<const uint4*>(
                             res + rb + (long long)o * hwo))
                       : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = (tid >> 4) + 16 * i, o = o0 + row;
      if (o >= g.O) break;
      uint4 v = *reinterpret_cast<const uint4*>(Cs + row * HB + 8 * q);
      if (APPLY)
        v = affine_bf16x8(v, __ldg(scale + o), __ldg(shift + o),
                          res != nullptr, res ? r[i] : v, relu);
      *reinterpret_cast<uint4*>(out + rb + (long long)o * hwo) = v;
    }
  } else {  // one pixel a thread, rows 2 apart
    constexpr int R = BM / 2;
    const int p = p0 + lp;
    if (p >= g.P) return;
    const int n = p / hwo;
    const long long rb = (long long)n * g.O * hwo + (p - n * hwo);
    const unsigned short* cs = reinterpret_cast<const unsigned short*>(Cs);
    unsigned short* o16 = reinterpret_cast<unsigned short*>(out);
    unsigned short r[R];
    if (APPLY && res) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int o = o0 + (tid >> 7) + 2 * i;
        r[i] = o < g.O ? ldg_u16(res + rb + (long long)o * hwo)
                       : (unsigned short)0;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = (tid >> 7) + 2 * i, o = o0 + row;
      if (o >= g.O) break;
      unsigned short v = cs[row * HB + lp];
      if (APPLY)
        v = (unsigned short)(affine_bf16x2(v, __ldg(scale + o),
                                           __ldg(shift + o), res != nullptr,
                                           res ? r[i] : 0u, relu) &
                             0xffffu);
      o16[rb + (long long)o * hwo] = v;
    }
  }
}

// bf16 co, residual and y; f32 scale and shift. VEC: 8 elements a thread
// in 16-byte loads and stores when H*W % 8 == 0 (the 8 share a channel)
// and the pointers are 16-byte aligned; one element a thread otherwise
// (stage 4: H*W = 49).
template <bool VEC>
__global__ void __launch_bounds__(256)
bn_apply_kernel(const bf16* __restrict__ co, const float* __restrict__ scale,
                const float* __restrict__ shift, const bf16* __restrict__ res,
                bf16* __restrict__ y, int total, int hw, int O, int relu) {
  const int stride = gridDim.x * blockDim.x;
  if (VEC) {
    const uint4* co8 = reinterpret_cast<const uint4*>(co);
    const uint4* res8 = reinterpret_cast<const uint4*>(res);
    uint4* y8 = reinterpret_cast<uint4*>(y);
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total / 8;
         i += stride) {
      const int c = (i * 8 / hw) % O;
      const uint4 v = __ldg(co8 + i);
      y8[i] = affine_bf16x8(v, __ldg(scale + c), __ldg(shift + c),
                            res != nullptr, res ? __ldg(res8 + i) : v, relu);
    }
  } else {
    const unsigned short* c16 = reinterpret_cast<const unsigned short*>(co);
    unsigned short* y16 = reinterpret_cast<unsigned short*>(y);
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += stride) {
      const int c = (i / hw) % O;
      y16[i] = (unsigned short)(
          affine_bf16x2(__ldg(c16 + i), __ldg(scale + c), __ldg(shift + c),
                        res != nullptr, res ? ldg_u16(res + i) : 0u, relu) &
          0xffffu);
    }
  }
}

bool geo_of(int N, int C, int H, int W, int O, int ks, int stride, Geo* g) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || O <= 0) return false;
  if (!((ks == 1 && (stride == 1 || stride == 2)) || (ks == 3 && stride == 1)))
    return false;
  const int pad = (ks - 1) / 2;
  g->N = N; g->C = C; g->H = H; g->W = W; g->O = O;
  g->Ho = (H + 2 * pad - ks) / stride + 1;
  g->Wo = (W + 2 * pad - ks) / stride + 1;
  g->K = C * ks * ks;
  g->P = N * g->Ho * g->Wo;
  return true;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One template instantiation: its dynamic shared memory limit is raised
// once per device, then the grid of (pixel tiles, channel tiles) launches.
// T: float (3xTF32) or bf16; the two forms are overloads of conv_kernel.
template <typename T, int BM, int KS, int STRIDE, bool VEC, bool APPLY>
cudaError_t launch_one(const Geo& g, cudaStream_t s, const T* x, const T* w,
                       T* out, float* partial, const float* scale,
                       const float* shift, const T* res, int relu) {
  static std::atomic<unsigned> ready{0};
  void (*kern)(const T*, const T*, T*, float*, const float*, const float*,
               const T*, int, Geo) = conv_kernel<BM, KS, STRIDE, VEC, APPLY>;
  constexpr int bytes =
      std::is_same<T, float>::value ? smem_bytes<BM>() : h_smem_bytes<BM>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit);
  }
  const dim3 grid((g.P + BN - 1) / BN, (g.O + BM - 1) / BM);
  kern<<<grid, THREADS, bytes, s>>>(x, w, out, partial, scale, shift, res,
                                    relu, g);
  return cudaGetLastError();
}

// The tile. Stride-1 convs take 64 channels a block: at 126 registers two
// blocks share an SM, one's epilogue and ring fill overlapping the other's
// products, which beat the 128-channel tile (one block an SM) on most of
// ResNet-50's stride-1 geometries and by up to 1.5x where conv_apply reads a
// residual. Stride-2 1x1 convs take 128: their x gather reads every other
// element, and the wide tile gathers it for half as many channel tiles
// (bf16: 37,888 bytes of stages at BM = 128, 27,648 at 64). A vector is 16
// bytes: 4 f32 or 8 bf16.
template <typename T, bool APPLY>
cudaError_t launch_conv(Geo g, int ks, int stride, cudaStream_t s,
                        const T* x, const T* w, T* out, float* partial,
                        const float* scale, const float* shift, const T* res,
                        int relu) {
  constexpr int V = 16 / sizeof(T);
  g.wvec = g.K % V == 0 && aligned16(w);
  g.ovec = (g.Ho * g.Wo) % V == 0 && aligned16(out) &&
           (res == nullptr || aligned16(res));
  if (stride == 2)
    return launch_one<T, 128, 1, 2, false, APPLY>(g, s, x, w, out, partial,
                                                  scale, shift, res, relu);
  if (ks == 3)
    return launch_one<T, 64, 3, 1, false, APPLY>(g, s, x, w, out, partial,
                                                 scale, shift, res, relu);
  if ((g.H * g.W) % V == 0 && aligned16(x))
    return launch_one<T, 64, 1, 1, true, APPLY>(g, s, x, w, out, partial,
                                                scale, shift, res, relu);
  return launch_one<T, 64, 1, 1, false, APPLY>(g, s, x, w, out, partial,
                                               scale, shift, res, relu);
}

template <typename T>
int conv_moments_t(const void* x, const void* w, void* co, void* partial,
                   void* sums, int N, int C, int H, int W, int O, int ks,
                   int stride, int tiles, void* stream) {
  Geo g;
  if (!geo_of(N, C, H, W, O, ks, stride, &g) ||
      tiles != (g.P + BN - 1) / BN)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_conv<T, false>(
      g, ks, stride, s, static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(co), static_cast<float*>(partial), nullptr, nullptr,
      nullptr, 0);
  if (err != cudaSuccess) return err;
  const int cols = 2 * O;
  moments_reduce<<<(cols + 31) / 32, 1024, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(sums), tiles,
      cols);
  return cudaGetLastError();
}

template <typename T>
int conv_apply_t(const void* x, const void* w, const void* scale,
                 const void* shift, const void* res, void* y, int N, int C,
                 int H, int W, int O, int ks, int stride, int relu,
                 void* stream) {
  Geo g;
  if (!geo_of(N, C, H, W, O, ks, stride, &g)) return cudaErrorInvalidValue;
  return launch_conv<T, true>(
      g, ks, stride, static_cast<cudaStream_t>(stream),
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      nullptr, static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const T*>(res), relu);
}

// a grid-stride launch of bn_apply_kernel's f32 or bf16 overload, 16 bytes
// a thread where H*W holds whole vectors and the pointers are aligned
template <typename T>
int bn_apply_t(const void* co, const void* scale, const void* shift,
               const void* res, void* y, int total, int hw, int O, int relu,
               void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (total <= 0 || hw <= 0 || O <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(co) |
                          reinterpret_cast<uintptr_t>(res) |
                          reinterpret_cast<uintptr_t>(y);
  const bool vec = hw % V == 0 && align % 16 == 0;
  const int work = vec ? total / V : total;
  int blocks = (work + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  const T* c = static_cast<const T*>(co);
  const T* r = static_cast<const T*>(res);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (vec)
    bn_apply_kernel<true><<<blocks, 256, 0, s>>>(
        c, sc, sh, r, static_cast<T*>(y), total, hw, O, relu);
  else
    bn_apply_kernel<false><<<blocks, 256, 0, s>>>(
        c, sc, sh, r, static_cast<T*>(y), total, hw, O, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 (conv_moments) or bf16 (conv_moments_bf16), all contiguous. x:
// [N, C, H, W]; w: f32 [O, C, ks, ks], bf16 tap-major [O, ks * ks * C]; co:
// [N, O, Ho, Wo] in x's dtype; partial: f32 scratch of tiles * 2 * O, tiles
// = ceil(N * Ho * Wo / 128); sums: f32 [2, O] (sum co, then sum co^2). Two
// launches on `stream`.
int conv_moments(const void* x, const void* w, void* co, void* partial,
                 void* sums, int N, int C, int H, int W, int O, int ks,
                 int stride, int tiles, void* stream) {
  return conv_moments_t<float>(x, w, co, partial, sums, N, C, H, W, O, ks,
                               stride, tiles, stream);
}
int conv_moments_bf16(const void* x, const void* w, void* co, void* partial,
                      void* sums, int N, int C, int H, int W, int O, int ks,
                      int stride, int tiles, void* stream) {
  return conv_moments_t<bf16>(x, w, co, partial, sums, N, C, H, W, O, ks,
                              stride, tiles, stream);
}

// x, w as conv_moments; scale, shift: f32 [O]; res: [N, O, Ho, Wo] in x's
// dtype or null; y: [N, O, Ho, Wo] in x's dtype. One launch on `stream`.
int conv_apply(const void* x, const void* w, const void* scale,
               const void* shift, const void* res, void* y, int N, int C,
               int H, int W, int O, int ks, int stride, int relu,
               void* stream) {
  return conv_apply_t<float>(x, w, scale, shift, res, y, N, C, H, W, O, ks,
                             stride, relu, stream);
}
int conv_apply_bf16(const void* x, const void* w, const void* scale,
                    const void* shift, const void* res, void* y, int N,
                    int C, int H, int W, int O, int ks, int stride, int relu,
                    void* stream) {
  return conv_apply_t<bf16>(x, w, scale, shift, res, y, N, C, H, W, O, ks,
                            stride, relu, stream);
}

// all contiguous. co, res (or null), y: [N, O, H, W] with total = N * O * H
// * W elements and hw = H * W, f32 (bn_apply) or bf16 (bn_apply_bf16);
// scale, shift: f32 [O]. One launch on `stream`.
int bn_apply(const void* co, const void* scale, const void* shift,
             const void* res, void* y, int total, int hw, int O, int relu,
             void* stream) {
  return bn_apply_t<float>(co, scale, shift, res, y, total, hw, O, relu,
                           stream);
}
int bn_apply_bf16(const void* co, const void* scale, const void* shift,
                  const void* res, void* y, int total, int hw, int O,
                  int relu, void* stream) {
  return bn_apply_t<bf16>(co, scale, shift, res, y, total, hw, O, relu,
                          stream);
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
