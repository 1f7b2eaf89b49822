// Fused conv + batch-norm epilogues for Hopper (sm_90a), f32 in and out.
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

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 4 or 16 bytes; pred false writes zeros (src-size 0, nothing
// read from src)
__device__ __forceinline__ void cp4(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a = big + small, both TF32, each rounded to nearest with ties away from
// zero: cvt.rna.tf32.f32 for finite a, written as the add of half a TF32
// ulp that it compiles to, without its inf/NaN guard (4 instructions, not
// 8). The tensor cores ignore the low 13 bits of a .tf32 operand, so only
// the big part that is subtracted needs them cleared; an inf or NaN a
// still gives a NaN small part and so a NaN product, as cvt.rna does.
__device__ __forceinline__ void split_tf32(float a, unsigned& big,
                                           unsigned& small) {
  big = __float_as_uint(a) + 0x1000u;
  const float rest = a - __uint_as_float(big & 0xffffe000u);
  small = __float_as_uint(rest) + 0x1000u;
}

// d += a * b on the tensor cores: a 16x8 (row), b 8x8 (col), d 16x8 f32
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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
        for (int j = 0; j < NT; ++j) {
          mma_tf32(part[i][j], as[i], bb[j]);
          mma_tf32(part[i][j], ab[i], bs[j]);
          mma_tf32(part[i][j], ab[i], bb[j]);
        }
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
template <int BM, int KS, int STRIDE, bool VEC, bool APPLY>
cudaError_t launch_one(const Geo& g, cudaStream_t s, const float* x,
                       const float* w, float* out, float* partial,
                       const float* scale, const float* shift,
                       const float* res, int relu) {
  static std::atomic<unsigned> ready{0};
  auto* kern = conv_kernel<BM, KS, STRIDE, VEC, APPLY>;
  constexpr int bytes = smem_bytes<BM>();
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
// float, and the wide tile gathers it for half as many channel tiles.
template <bool APPLY>
cudaError_t launch_conv(Geo g, int ks, int stride, cudaStream_t s,
                        const float* x, const float* w, float* out,
                        float* partial, const float* scale,
                        const float* shift, const float* res, int relu) {
  g.wvec = g.K % 4 == 0 && aligned16(w);
  g.ovec = (g.Ho * g.Wo) % 4 == 0 && aligned16(out) &&
           (res == nullptr || aligned16(res));
  if (stride == 2)
    return launch_one<128, 1, 2, false, APPLY>(g, s, x, w, out, partial,
                                               scale, shift, res, relu);
  if (ks == 3)
    return launch_one<64, 3, 1, false, APPLY>(g, s, x, w, out, partial,
                                              scale, shift, res, relu);
  if ((g.H * g.W) % 4 == 0 && aligned16(x))
    return launch_one<64, 1, 1, true, APPLY>(g, s, x, w, out, partial, scale,
                                             shift, res, relu);
  return launch_one<64, 1, 1, false, APPLY>(g, s, x, w, out, partial, scale,
                                            shift, res, relu);
}

}  // namespace

extern "C" {

// f32 only, all contiguous. x: [N, C, H, W]; w: [O, C, ks, ks]; co:
// [N, O, Ho, Wo]; partial: scratch of tiles * 2 * O floats, tiles =
// ceil(N * Ho * Wo / 128); sums: [2, O] (sum co, then sum co^2). Two
// launches on `stream`.
int conv_moments(const void* x, const void* w, void* co, void* partial,
                 void* sums, int N, int C, int H, int W, int O, int ks,
                 int stride, int tiles, void* stream) {
  Geo g;
  if (!geo_of(N, C, H, W, O, ks, stride, &g) ||
      tiles != (g.P + BN - 1) / BN)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_conv<false>(
      g, ks, stride, s, static_cast<const float*>(x),
      static_cast<const float*>(w), static_cast<float*>(co),
      static_cast<float*>(partial), nullptr, nullptr, nullptr, 0);
  if (err != cudaSuccess) return err;
  const int cols = 2 * O;
  moments_reduce<<<(cols + 31) / 32, 1024, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(sums), tiles,
      cols);
  return cudaGetLastError();
}

// f32 only, all contiguous. scale, shift: [O]; res: [N, O, Ho, Wo] or null;
// y: [N, O, Ho, Wo]. One launch on `stream`.
int conv_apply(const void* x, const void* w, const void* scale,
               const void* shift, const void* res, void* y, int N, int C,
               int H, int W, int O, int ks, int stride, int relu,
               void* stream) {
  Geo g;
  if (!geo_of(N, C, H, W, O, ks, stride, &g)) return cudaErrorInvalidValue;
  return launch_conv<true>(
      g, ks, stride, static_cast<cudaStream_t>(stream),
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), nullptr, static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const float*>(res), relu);
}

// f32 only, all contiguous. co, res (or null), y: [N, O, H, W] with
// total = N * O * H * W elements and hw = H * W; scale, shift: [O].
int bn_apply(const void* co, const void* scale, const void* shift,
             const void* res, void* y, int total, int hw, int O, int relu,
             void* stream) {
  if (total <= 0 || hw <= 0 || O <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(co) |
                          reinterpret_cast<uintptr_t>(res) |
                          reinterpret_cast<uintptr_t>(y);
  const bool vec = hw % 4 == 0 && align % 16 == 0;
  const int work = vec ? total / 4 : total;
  int blocks = (work + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (vec)
    bn_apply_kernel<true><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(co), static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<const float*>(res),
        static_cast<float*>(y), total, hw, O, relu);
  else
    bn_apply_kernel<false><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(co), static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<const float*>(res),
        static_cast<float*>(y), total, hw, O, relu);
  return cudaGetLastError();
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
