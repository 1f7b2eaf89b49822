// Fused conv + batch-norm epilogues for Hopper (sm_90a), f32.
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
// What bounds them on the card. The convs: operations. ResNet-50's 3x3 body
// at 56x56 and batch 128 is 29.6 GFLOP against 0.2 GB of input and output,
// here on the f32 FMA pipes (TF32 off, no tensor cores). bn_apply: bytes;
// one read of co (and the residual) and one write of y, two flops each.
//
// The TPU kernel keeps one whole image [C, H*W] in VMEM per grid step and
// sums the moments across its sequential batch grid; neither carries over.
// The convs here are one implicit GEMM, C[o, p] = sum_k W[o, k] X[k, p]:
//   * p runs over the N*Ho*Wo output pixels and k over C*KH*KW. A block owns
//     BM = 64 channels x BN = 128 pixels; pixel tiles cross image
//     boundaries, so small images (7x7 = 49 pixels at stage 4) still fill
//     the tile. X[k, p] is gathered from NCHW x on the fly (zero padding for
//     3x3); W is x's weight [O, C*KH*KW] as it lies in memory.
//   * The reduction walks k in chunks of BK = 16, staged through two
//     shared-memory buffers: the next chunk is loaded into registers while
//     the current one is consumed, so one barrier per chunk suffices. Each
//     of the 256 threads holds a 4 x 8 tile of C in registers (the design of
//     fused_ce_fwd.cu): ten FMAs per shared load.
//   * Two epilogues on one template. conv_moments stores co, then sums the
//     stored values and their squares per channel over the tile's pixels
//     (registers, then shuffles over the 16 threads of a row) into a
//     [tiles, 2, O] buffer; a second launch sums the tiles per channel in a
//     fixed order, so the moments are deterministic (no atomics). conv_apply
//     applies the folded BN affine, the residual and relu, and stores y.
// bn_apply is a grid-stride elementwise pass, float4 wide when H*W is a
// multiple of 4 (then four neighbours share a channel) and the pointers are
// 16-byte aligned; scalar otherwise (stage 4: H*W = 49).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 64, BN = 128, BK = 16;
constexpr int THREADS = 256;
constexpr int TM = 4, TN = 8;  // C per thread: 4 channels x (4 + 4) pixels
constexpr int WP = BM + 4;     // padded row of the transposed weight chunk
constexpr unsigned FULL = 0xffffffffu;

struct Geo {
  int N, C, H, W, O, Ho, Wo;
  int K;  // C * KS * KS
  int P;  // N * Ho * Wo
};

template <int KS, int STRIDE, bool APPLY>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ out, float* __restrict__ partial,
            const float* __restrict__ scale, const float* __restrict__ shift,
            const float* __restrict__ res, int relu, Geo g) {
  constexpr int PAD = (KS - 1) / 2, KK = KS * KS;
  __shared__ __align__(16) float ws[2][BK * WP];
  __shared__ __align__(16) float xs[2][BK * BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int p0 = blockIdx.x * BN, o0 = blockIdx.y * BM;
  const int hwo = g.Ho * g.Wo;

  // the pixel this thread gathers for: p0 + lp, at chunk rows lk0 + 2i
  const int lp = tid % BN, lk0 = tid / BN;
  const bool pv = p0 + lp < g.P;
  int ih0 = 0, iw0 = 0;
  const float* xn = x;
  if (pv) {
    const int p = p0 + lp, n = p / hwo, r = p - n * hwo;
    const int oh = r / g.Wo, ow = r - oh * g.Wo;
    ih0 = oh * STRIDE - PAD;
    iw0 = ow * STRIDE - PAD;
    xn = x + (long long)n * g.C * g.H * g.W;
  }

  float xr[8], wr[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = k0 + lk0 + 2 * i;
      float v = 0.f;
      if (pv && k < g.K) {
        const int c = k / KK, t = k - c * KK;
        const int ih = ih0 + t / KS, iw = iw0 + t % KS;
        if (KS == 1 || ((unsigned)ih < (unsigned)g.H &&
                        (unsigned)iw < (unsigned)g.W))
          v = __ldg(xn + ((long long)c * g.H + ih) * g.W + iw);
      }
      xr[i] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * THREADS, o = o0 + e / BK, k = k0 + e % BK;
      wr[i] = (o < g.O && k < g.K) ? __ldg(w + (long long)o * g.K + k) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 8; ++i) xs[buf][(lk0 + 2 * i) * BN + lp] = xr[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * THREADS;
      ws[buf][(e % BK) * WP + e / BK] = wr[i];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nk = (g.K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * BK);  // in flight during the FMAs
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a =
          *reinterpret_cast<const float4*>(&ws[cur][k * WP + ty * TM]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&xs[cur][k * BN + tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&xs[cur][k * BN + 64 + tx * 4]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

  // epilogue: the 8 pixel columns of this thread, as (image, offset)
  int cn[TN], cr[TN];
  bool cv[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int p = p0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
    cv[j] = p < g.P;
    cn[j] = p / hwo;
    cr[j] = p - cn[j] * hwo;
  }
  float s1[TM], s2[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int o = o0 + ty * TM + i;
    s1[i] = s2[i] = 0.f;
    if (o >= g.O) continue;
    float sc = 0.f, sh = 0.f;
    if (APPLY) {
      sc = __ldg(scale + o);
      sh = __ldg(shift + o);
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (!cv[j]) continue;
      const long long idx = ((long long)cn[j] * g.O + o) * hwo + cr[j];
      float v = acc[i][j];
      if (APPLY) {
        v = fmaf(v, sc, sh);
        if (res) v += __ldg(res + idx);
        if (relu && v < 0.f) v = 0.f;
      } else {
        s1[i] += v;
        s2[i] = fmaf(v, v, s2[i]);
      }
      out[idx] = v;
    }
  }
  if (APPLY) return;
  // moments: the 16 threads of a channel row are one half-warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      s1[i] += __shfl_xor_sync(FULL, s1[i], off);
      s2[i] += __shfl_xor_sync(FULL, s2[i], off);
    }
    const int o = o0 + ty * TM + i;
    if (tx == 0 && o < g.O) {
      float* row = partial + (long long)blockIdx.x * 2 * g.O;
      row[o] = s1[i];
      row[g.O + o] = s2[i];
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

template <bool APPLY>
cudaError_t launch_conv(const Geo& g, int ks, int stride, cudaStream_t s,
                        const float* x, const float* w, float* out,
                        float* partial, const float* scale,
                        const float* shift, const float* res, int relu) {
  const dim3 grid((g.P + BN - 1) / BN, (g.O + BM - 1) / BM);
  if (ks == 1 && stride == 1)
    conv_kernel<1, 1, APPLY><<<grid, THREADS, 0, s>>>(
        x, w, out, partial, scale, shift, res, relu, g);
  else if (ks == 1)
    conv_kernel<1, 2, APPLY><<<grid, THREADS, 0, s>>>(
        x, w, out, partial, scale, shift, res, relu, g);
  else
    conv_kernel<3, 1, APPLY><<<grid, THREADS, 0, s>>>(
        x, w, out, partial, scale, shift, res, relu, g);
  return cudaGetLastError();
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
