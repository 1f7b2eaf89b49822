// The bf16 conv_apply on warpgroup products for Hopper (sm_90a): conv +
// folded batch-norm affine (+ residual)(+ relu) for ResNet-50's fused
// sites under fluid.amp.
//
// Replaces paddle_tpu/ops/fused_conv.py _conv_apply_kernel (:198, driver
// _conv_apply :292), as fused_conv.cu's bf16 conv_kernel<..., APPLY> does;
// the route (ops/fused_conv.py apply_form) sends here every bf16 call at
// the fused geometries (1x1 stride 1 or 2, 3x3 pad 1 stride 1) with C and
// O multiples of 64, Wo <= 256 and 16-byte aligned pointers: all 49 sites
// of ResNet-50's eval pass. It computes what that form computes, with its
// rounding points (conv_epilogue_bf16.cuh affine_bf16): the conv
// accumulated in f32 from bf16 products and rounded to bf16 once, the
// affine a product then a sum in f32 rounded to bf16, the residual add
// correctly rounded, relu last.
//
// What bounds it on the card: the 3x3 body at 56x56, batch 128 is 29.6
// GFLOP (0.030 ms at 989 TFLOP/s) against 102.8 MB of x and y (0.031 ms
// at 3.35 TB/s); the 49 sites together 1.76 ms. fused_conv.cu's form
// lost most where pixels are few and channels many: its X tile gathered
// one 2-byte element at a time wherever a tap shifts by dx = +-1 (NCHW
// puts pixels innermost, and cp.async cannot copy from a 2-byte
// boundary), through registers, with one barrier a 32-deep chunk.
//
// Design. One implicit GEMM, y[o, p] = sum_k W[o, k] X[k, p], M = output
// channels, N = output pixels, K = taps x C in 64-deep chunks (one
// 128-byte swizzle row):
//   * X by TMA. A 1x1 stride-1 conv with H*W a multiple of 8 reads x in
//     NCHW itself: boxes {64 pixels, 64 channels} of [N, C, H*W], read
//     N-contiguous (the B transpose bit), four to a tile of 256 pixels of
//     one image. Every other site first copies x channels last
//     (nchw_to_nhwc_kernel, launched by the same C entry: only the pixels
//     a 1x1 stride-2 conv reads), because NCHW cannot be read by TMA
//     there: a bf16 row at W = 28, 14 or 7 is 56, 28 or 14 bytes, and a
//     tensor map's strides are multiples of 16. PyTorch's own
//     channels-last copy ran at 0.86 TB/s on the card (0.120 ms for 51 MB,
//     0.702 ms at 256 channels @56, where the stride-2 conv needs a
//     quarter of it; PERF.md), so the copy is a kernel here. In
//     [N, H, W, C] the 64 channels of one pixel for one tap are one
//     128-byte K-major row.
//   * Taps by 4-d boxes (wgmma_bf16.cuh encode_nhwc_map): a tile is
//     256 pixel slots holding bh output rows (Wo wide) of bn images
//     (7x7: 5 images, 245 slots; 14x14: one image; 28x28: 7 rows; 56x56:
//     4 rows); tap (dy, dx) of channel chunk c0 is the box at {c0, dx -
//     pad, h0 + dy - pad, n0}, and the hardware fills the 3x3 zero
//     padding, per image, as out-of-range reads. W is the tap-major
//     [O, K] matrix (ops/fused_conv.py _w_taps) by 2-d boxes {64 k, 64 x
//     NWG channels}.
//   * Products: each consumer warpgroup owns 64 channels by the tile's
//     256 slots, wgmma m64n256k16 with W K-major in shared memory, 128 f32
//     accumulators a thread that sum on the tensor cores over all of K (a
//     bf16 output needs no chunk sums on the FMA pipe: PERF.md).
//     Two warpgroups (128 channels) share each X box where O % 128 == 0;
//     one where O = 64.
//   * The ring: 4 stages (3 with two warpgroups) of (W box, X boxes) with
//     full and empty mbarriers; thread 0 issues every load, STAGES chunks
//     ahead, and a stage is refilled once every consumer warp has arrived
//     on its empty barrier after wgmma_wait retired its products.
//   * Overlap: a persistent block per SM walks the tiles (channel tiles
//     fastest, so neighbouring blocks share X in L2). A 1x1 conv has 1-32
//     chunks a tile, and its epilogue is a large share of a tile; the
//     ring runs on into the next tile while the consumers run the
//     epilogue, so its first chunks' loads land under it. Two blocks an
//     SM would not fit: a stage is 40-48 KB.
//   * The epilogue: each warpgroup rounds its accumulators to bf16 into a
//     C tile in shared memory, then writes y in NCHW as runs of contiguous
//     pixels, 16 bytes a thread where the runs allow (a tile of whole
//     images writes each image's 64 channels as one run; a tile of rows
//     one run a channel: 8 elements at 56x56, 4 at 28x28), the residual
//     read the same way, 8 or 16 pieces a thread at once. On the
//     fragments, with 4-byte pieces and a division per pixel, the
//     epilogue had cost more than the mainloop.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "conv_epilogue_bf16.cuh"
#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NPIX = 256;             // pixel slots of a tile: the N
constexpr int X_BYTES = NPIX * 128;   // one X box: 256 slots x 64 channels
constexpr int W_BYTES = 64 * 128;     // W rows of one warpgroup x 64 k
constexpr int CLD = NPIX + 8;         // row of the C tile, in bf16

struct CArgs {
  const float* scale; const float* shift; const bf16* res; bf16* y;
  int N, O, Ho, Wo, hw, KS, pad, CC;  // the tiles' rows of Wo slots (the
                                      // output's, or rows of 256 pixels
                                      // for NCHW); hw: pixels an image;
                                      // CC: 64-channel chunks of C
  int bh, bn;                     // a tile: bh rows of bn images
  int tpi, tiles, ctiles, nk;     // row tiles an image group, all tiles,
                                  // channel tiles, k chunks a tile
  int x_bytes, vec, relu;         // bytes of X a chunk; the epilogue's
                                  // vector (8, 4, 2 or 1 elements)
};

// Shared memory: the ring's stages (W box, X boxes), one C tile [64][CLD]
// bf16 per warpgroup, the barriers. Two warpgroups keep 3 stages (the C
// tiles take the fourth's room).
template <int NWG>
struct CCfg {
  static constexpr int THREADS = 128 * NWG;
  static constexpr int STAGES = NWG == 2 ? 3 : 4;
  static constexpr int STAGE = NWG * W_BYTES + X_BYTES;
  static constexpr size_t C_OFF = size_t(STAGES) * STAGE;
  static constexpr size_t BAR_OFF = C_OFF + size_t(NWG) * 64 * CLD * 2;
  static constexpr size_t SMEM = 1024 + BAR_OFF + 2 * STAGES * 8;
  static_assert(SMEM <= 232448 && STAGE % 1024 == 0, "stages");
};

// V contiguous bf16 as one value
template <int V> struct Vec;
template <> struct Vec<8> { typedef uint4 T; };
template <> struct Vec<4> { typedef uint2 T; };
template <> struct Vec<2> { typedef unsigned T; };
template <> struct Vec<1> { typedef unsigned short T; };

// the affine (+ residual r)(+ relu) on V rounded conv values c
__device__ __forceinline__ uint4 apply_vec(uint4 c, uint4 r, float sc,
                                           float sh, bool has_res, int relu) {
  return affine_bf16x8(c, sc, sh, has_res, r, relu);
}
__device__ __forceinline__ uint2 apply_vec(uint2 c, uint2 r, float sc,
                                           float sh, bool has_res, int relu) {
  return make_uint2(affine_bf16x2(c.x, sc, sh, has_res, r.x, relu),
                    affine_bf16x2(c.y, sc, sh, has_res, r.y, relu));
}
__device__ __forceinline__ unsigned apply_vec(unsigned c, unsigned r,
                                              float sc, float sh,
                                              bool has_res, int relu) {
  return affine_bf16x2(c, sc, sh, has_res, r, relu);
}
__device__ __forceinline__ unsigned short apply_vec(unsigned short c,
                                                    unsigned short r,
                                                    float sc, float sh,
                                                    bool has_res, int relu) {
  return (unsigned short)(affine_bf16x2(c, sc, sh, has_res, r, relu) &
                          0xffffu);
}

// The second half of a warpgroup's epilogue: its 64 channels of the C
// tile written out as runs of contiguous pixels of y (one run per channel
// and image: a tile holds whole rows), V elements a thread, consecutive
// threads on consecutive pieces of a run; U pieces a thread at once, their
// residual loads issued together (a load a piece in turn left the
// expand convs, whose y and residual are 4x their x, waiting on memory)
template <int V>
__device__ __forceinline__ void write_tile(const bf16* ct, const CArgs& a,
                                           int o0, int n0, int h0, int t) {
  typedef typename Vec<V>::T T;
  constexpr int U = V >= 4 ? 8 : 16;
  const int runs = a.bn == 1 ? 1 : min(a.bn, a.N - n0);
  const int len = min(min(a.bh, a.Ho - h0) * a.Wo, a.hw - h0 * a.Wo);
  const int per_run = len / V, per_ch = runs * per_run;
  const int total = 64 * per_ch;
  const bool has_res = a.res != nullptr;
  for (int i0 = t; i0 < total; i0 += 128 * U) {
    long long off[U];
    int cs[U];
    float sc[U], sh[U];
    T r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = min(i0 + 128 * u, total - 1);
      const int c = i / per_ch, rem = i - c * per_ch;
      const int rr = rem / per_run, v = (rem - rr * per_run) * V;
      off[u] = ((long long)(n0 + rr) * a.O + o0 + c) * a.hw +
               (long long)h0 * a.Wo + v;
      cs[u] = c * CLD + rr * len + v;
      sc[u] = __ldg(a.scale + o0 + c);
      sh[u] = __ldg(a.shift + o0 + c);
      r[u] = has_res ? __ldg(reinterpret_cast<const T*>(a.res + off[u]))
                     : T();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + 128 * u >= total) break;
      const T c = *reinterpret_cast<const T*>(ct + cs[u]);
      *reinterpret_cast<T*>(a.y + off[u]) =
          apply_vec(c, r[u], sc[u], sh[u], has_res, a.relu);
    }
  }
}

// The same where a tile holds whole images: then the tile's 64 channels of
// one image are one contiguous run of 64 * hw elements of y, written 16
// bytes a thread whatever hw is (a piece may span two channels)
__device__ __forceinline__ void write_images(const bf16* ct, const CArgs& a,
                                             int o0, int n0, int t) {
  constexpr int U = 8;
  const int hw = a.hw, per = 8 * hw;  // 16-byte pieces of an image
  const int total = min(a.bn, a.N - n0) * per;
  const float inv_hw = 1.f / hw;
  const bool has_res = a.res != nullptr;
  const unsigned short* cs = reinterpret_cast<const unsigned short*>(ct);
  for (int i0 = t; i0 < total; i0 += 128 * U) {
    long long off[U];
    uint4 r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = min(i0 + 128 * u, total - 1), im = i / per;
      off[u] = ((long long)(n0 + im) * a.O + o0) * hw + (i - im * per) * 8;
      r[u] = has_res ? __ldg(reinterpret_cast<const uint4*>(a.res + off[u]))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 128 * u;
      if (i >= total) break;
      const int im = i / per, f0 = (i - im * per) * 8;
      const unsigned rw[4] = {r[u].x, r[u].y, r[u].z, r[u].w};
      unsigned yw[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float yv[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {  // element f: channel c, pixel f - c hw
          const int f = f0 + e + k, c = int((f + 0.5f) * inv_hw);
          const float cv = __bfloat162float(__ushort_as_bfloat16(
              cs[c * CLD + im * hw + f - c * hw]));
          const unsigned rr = rw[e / 2];
          yv[k] = affine_bf16(cv, __ldg(a.scale + o0 + c),
                              __ldg(a.shift + o0 + c), has_res,
                              k ? bf_hi(rr) : bf_lo(rr), a.relu);
        }
        yw[e / 2] = pack_bf16(yv[0], yv[1]);
      }
      *reinterpret_cast<uint4*>(a.y + off[u]) =
          make_uint4(yw[0], yw[1], yw[2], yw[3]);
    }
  }
}

// NCHW: X boxes {64 pixels, 64 channels} of the [N, C, H*W] input itself
// (a 1x1 stride-1 conv with H*W a multiple of 8), read N-contiguous; else
// the 4-d box of the channels-last copy, read K-major
template <int NWG, bool NCHW>
__global__ void __launch_bounds__(CCfg<NWG>::THREADS, 1)
conv_apply_wgmma_kernel(const __grid_constant__ CUtensorMap tmw,
                        const __grid_constant__ CUtensorMap tmx, CArgs a) {
  using Cf = CCfg<NWG>;
  constexpr int STAGES = Cf::STAGES;
  extern __shared__ __align__(1024) unsigned char cw_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(cw_smem) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Cf::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  bf16* ct = reinterpret_cast<bf16*>(base + Cf::C_OFF) + wg * 64 * CLD;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // thread 0's loads: the next (tile, chunk) and how many it has issued
  int p_tile = blockIdx.x, p_kc = 0;
  unsigned p_i = 0;
  // load chunks p_i < upto; wait for a free stage only below `must` (the
  // chunk its own warpgroup needs next), else stop at a stage still in use:
  // a thread 0 blocked here would stall its whole warpgroup
  auto produce_ahead = [&](unsigned upto, unsigned must) {
    while (p_i < upto && p_tile < a.tiles) {
      const int s = p_i % STAGES;
      const unsigned parity = ((p_i / STAGES) & 1) ^ 1;
      if (p_i < must)
        mbar_wait(&empty[s], parity);
      else if (!mbar_test(&empty[s], parity))
        break;
      unsigned char* st = base + s * Cf::STAGE;
      const int ct_ = p_tile % a.ctiles, pt = p_tile / a.ctiles;
      const int tap = p_kc / a.CC, c0 = (p_kc % a.CC) * 64;
      const int dy = tap / a.KS, dx = tap % a.KS;
      const int h0 = (pt % a.tpi) * a.bh, n0 = (pt / a.tpi) * a.bn;
      mbar_expect_tx(&full[s], NWG * W_BYTES + a.x_bytes);
      tma_load_2d(st, &tmw, &full[s], p_kc * 64, ct_ * 64 * NWG);
      if constexpr (NCHW) {
        for (int i = 0; i < NPIX / 64; ++i)
          tma_load_3d(st + NWG * W_BYTES + i * 8192, &tmx, &full[s],
                      h0 * a.Wo + 64 * i, c0, n0);
      } else {
        tma_load_4d(st + NWG * W_BYTES, &tmx, &full[s], c0, dx - a.pad,
                    h0 + dy - a.pad, n0);
      }
      ++p_i;
      if (++p_kc == a.nk) {
        p_kc = 0;
        p_tile += gridDim.x;
      }
    }
  };
  if (tid == 0) produce_ahead(STAGES, STAGES);

  unsigned c_i = 0;  // chunks consumed
  const int wt = tid & 127;  // this thread in its warpgroup
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int ctile = tile % a.ctiles, pt = tile / a.ctiles;
    const int h0 = (pt % a.tpi) * a.bh, n0 = (pt / a.tpi) * a.bn;
    const int o0 = ctile * 64 * NWG + wg * 64;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < a.nk; ++kc, ++c_i) {
      const int s = c_i % STAGES;
      if (tid == 0) produce_ahead(c_i + STAGES, c_i + 1);
      mbar_wait(&full[s], (c_i / STAGES) & 1);
      const unsigned char* st = base + s * Cf::STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = wg_desc(st + wg * W_BYTES + kk * 32, 16, 1024);
        if constexpr (NCHW)  // [64 channels][64 pixels] slabs, 8 KB apart
          wgmma_ss_n256<1>(acc, da,
                           wg_desc(st + NWG * W_BYTES + kk * 2048, 8192, 1024),
                           kc > 0 || kk > 0);
        else
          wgmma_ss_n256<0>(acc, da,
                           wg_desc(st + NWG * W_BYTES + kk * 32, 16, 1024),
                           kc > 0 || kk > 0);
      }
      wgmma_commit();
      if (kc > 0) {  // the chunk before this one is retired: free its stage
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(c_i - 1) % STAGES]);
      }
      if (tid == 0) produce_ahead(c_i + STAGES, 0);
    }
    wgmma_wait<0>();
    wgmma_hold(acc);
    if (lane == 0) mbar_arrive(&empty[(c_i - 1) % STAGES]);
    if (tid == 0) produce_ahead(c_i + STAGES, 0);  // the next tile's

    // epilogue: the conv rounded to bf16 into this warpgroup's C tile
    // (accumulator 4 j + e is channel row 16 warp + g + 8 (e / 2), slot
    // 8 j + 2 tq + e % 2; conflict-free 4-byte stores), then written out
    named_sync(1 + wg, 128);  // the previous tile's C tile is read
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<unsigned*>(ct + (16 * warp + g + 8 * hh) * CLD +
                                     8 * j + 2 * tq) =
            pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    named_sync(1 + wg, 128);
    if (a.bh == a.Ho) {  // whole images (h0 == 0)
      write_images(ct, a, o0, n0, wt);
    } else switch (a.vec) {
      case 8: write_tile<8>(ct, a, o0, n0, h0, wt); break;
      case 4: write_tile<4>(ct, a, o0, n0, h0, wt); break;
      case 2: write_tile<2>(ct, a, o0, n0, h0, wt); break;
      default: write_tile<1>(ct, a, o0, n0, h0, wt); break;
    }
  }
}

// x [N, C, H, W] -> xt [N, Hs, Ws, C] with Hs = ceil(H / s), Ws =
// ceil(W / s): the channels-last copy (s = 1), or that of the pixels a 1x1
// stride-2 conv reads (s = 2). A block moves 64 channels by 64 pixels of
// one image through shared memory: coalesced reads along the pixels,
// 16-byte writes of 8 channels.
__global__ void __launch_bounds__(256)
nchw_to_nhwc_kernel(const bf16* __restrict__ x, bf16* __restrict__ xt,
                    int C, int H, int W, int s) {
  __shared__ __align__(16) bf16 tile[64][72];  // [pixel][channel]
  const int Ws = (W + s - 1) / s, P = ((H + s - 1) / s) * Ws;
  const int p0 = blockIdx.x * 64, c0 = blockIdx.y * 64, n = blockIdx.z;
  const int tid = threadIdx.x, pl = tid & 63, cq = tid >> 6;
  // pixel pl of channels cq, cq + 4, ...: a warp reads 32 neighbouring
  // pixels of one channel, and each thread has its 16 loads in flight
  unsigned short v[16];
  const int p = p0 + pl;
  if (p < P) {
    const int h = p / Ws, w = p - h * Ws;
    const unsigned short* src = reinterpret_cast<const unsigned short*>(x) +
                                ((long long)n * C + c0 + cq) * H * W +
                                (long long)h * s * W + w * s;
#pragma unroll
    for (int m = 0; m < 16; ++m)
      v[m] = __ldg(src + (long long)(4 * m) * H * W);
  } else {
#pragma unroll
    for (int m = 0; m < 16; ++m) v[m] = 0;
  }
#pragma unroll
  for (int m = 0; m < 16; ++m)
    reinterpret_cast<unsigned short*>(&tile[pl][0])[cq + 4 * m] = v[m];
  __syncthreads();
  for (int i = tid; i < 64 * 8; i += 256) {
    const int pp = i >> 3, q = i & 7;
    if (p0 + pp < P)
      *reinterpret_cast<uint4*>(xt + ((long long)n * P + p0 + pp) * C + c0 +
                                8 * q) =
          *reinterpret_cast<const uint4*>(&tile[pp][8 * q]);
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <int NWG, bool NCHW>
cudaError_t launch(const CUtensorMap& mw, const CUtensorMap& mx,
                   const CArgs& a, cudaStream_t s) {
  using Cf = CCfg<NWG>;
  cudaError_t err = cudaFuncSetAttribute(
      conv_apply_wgmma_kernel<NWG, NCHW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(Cf::SMEM));
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = a.tiles < sms ? a.tiles : sms;
  conv_apply_wgmma_kernel<NWG, NCHW><<<grid, Cf::THREADS, Cf::SMEM, s>>>(
      mw, mx, a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Whether conv_apply_bf16_wgmma reads x in NCHW itself (a 1x1 stride-1
// conv with H * W a multiple of 8: a tensor map's strides are multiples
// of 16 bytes) and needs no channels-last copy.
int conv_apply_bf16_wgmma_reads_nchw(int H, int W, int ks, int stride) {
  return ks == 1 && stride == 1 && (H * W) % 8 == 0;
}

// x: bf16 [N, C, H, W]; xt: bf16 scratch of N * Ho * Wo * C elements for
// x's channels-last copy (the pixels the conv reads; Ho = H and Wo = W at
// stride 1), or null where conv_apply_bf16_wgmma_reads_nchw; w: bf16
// tap-major [O, ks * ks * C]; scale, shift: f32 [O]; res: bf16
// [N, O, Ho, Wo] or null; y: bf16 [N, O, Ho, Wo]; all contiguous and
// 16-byte aligned. ks 1 with stride 1 or 2, or ks 3 (pad 1) with stride 1;
// C and O multiples of 64, Wo <= 256. On `stream`: the copy (unless x is
// read in NCHW), then the conv.
int conv_apply_bf16_wgmma(const void* x, void* xt, const void* w,
                          const void* scale, const void* shift,
                          const void* res, void* y, int N, int C, int H,
                          int W, int O, int ks, int stride, int relu,
                          void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || C % 64 != 0 ||
      O % 64 != 0 ||
      !((ks == 1 && (stride == 1 || stride == 2)) || (ks == 3 && stride == 1)))
    return cudaErrorInvalidValue;
  const bool nchw = conv_apply_bf16_wgmma_reads_nchw(H, W, ks, stride);
  if (!aligned16(x) || (!nchw && !aligned16(xt)) || !aligned16(w) ||
      !aligned16(y) || (res != nullptr && !aligned16(res)) ||
      (!nchw && xt == nullptr))
    return cudaErrorInvalidValue;
  const int pad = (ks - 1) / 2;
  const int Ho = (H + 2 * pad - ks) / stride + 1;
  const int Wo = (W + 2 * pad - ks) / stride + 1;
  if (Wo > NPIX) return cudaErrorInvalidValue;
  const long long k = (long long)ks * ks * C;
  if ((long long)N * C * H * W >= (1LL << 31) ||
      (long long)N * O * Ho * Wo >= (1LL << 31) || k * O >= (1LL << 31) ||
      N > 65535)
    return cudaErrorInvalidValue;
  CArgs a{};
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.res = static_cast<const bf16*>(res);
  a.y = static_cast<bf16*>(y);
  a.N = N; a.O = O; a.hw = Ho * Wo; a.KS = ks; a.pad = pad;
  a.CC = C / 64;
  if (nchw) {  // rows of 256 pixels of one image
    a.Wo = NPIX;
    a.Ho = (a.hw + NPIX - 1) / NPIX;
    a.bh = 1;
    a.bn = 1;
    a.x_bytes = X_BYTES;
  } else {
    a.Ho = Ho;
    a.Wo = Wo;
    if (Ho * Wo <= NPIX) {  // whole images, as many as fit
      a.bh = Ho;
      a.bn = NPIX / (Ho * Wo) < N ? NPIX / (Ho * Wo) : N;
    } else {  // rows of one image, the row tiles of an image made even
      const int per = (Ho + NPIX / Wo - 1) / (NPIX / Wo);
      a.bh = (Ho + per - 1) / per;
      a.bn = 1;
    }
    a.x_bytes = 64 * Wo * a.bh * a.bn * 2;
  }
  a.tpi = (a.Ho + a.bh - 1) / a.bh;
  const int nwg = O % 128 == 0 ? 2 : 1;
  a.ctiles = O / (64 * nwg);
  const long long tiles =
      (long long)((N + a.bn - 1) / a.bn) * a.tpi * a.ctiles;
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  a.tiles = int(tiles);
  a.nk = int(k / 64);
  // the widest vector that divides every run of the tiles (whole images
  // or whole rows) and its start
  a.vec = 8;
  while (a.vec > 1 && (a.hw % a.vec != 0 ||
                       (a.bn == 1 && (a.bh * a.Wo) % a.vec != 0)))
    a.vec /= 2;
  a.relu = relu;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap mw, mx;
  const uint64_t wdims[2] = {uint64_t(k), uint64_t(O)};
  const uint64_t wstr[1] = {uint64_t(k) * 2};
  const uint32_t wbox[2] = {64, uint32_t(64 * nwg)};
  cudaError_t err = encode_bf16_map(&mw, w, 2, wdims, wstr, wbox);
  if (err != cudaSuccess) return err;
  if (nchw) {  // [N, C, H*W]: boxes {64 pixels, 64 channels, 1}
    const uint64_t dims[3] = {uint64_t(a.hw), uint64_t(C), uint64_t(N)};
    const uint64_t str[2] = {uint64_t(a.hw) * 2, uint64_t(a.hw) * C * 2};
    const uint32_t box[3] = {64, 64, 1};
    err = encode_bf16_map(&mx, x, 3, dims, str, box);
    if (err != cudaSuccess) return err;
    return nwg == 2 ? launch<2, true>(mw, mx, a, s)
                    : launch<1, true>(mw, mx, a, s);
  }
  // the copy: x channels last, of the pixels the conv reads (a 1x1
  // stride-2 conv reads every other row and column; the conv then reads
  // the copy at stride 1)
  const int Hs = stride == 2 ? Ho : H, Ws = stride == 2 ? Wo : W;
  const dim3 cgrid((Hs * Ws + 63) / 64, C / 64, N);
  nchw_to_nhwc_kernel<<<cgrid, 256, 0, s>>>(static_cast<const bf16*>(x),
                                            static_cast<bf16*>(xt), C, H, W,
                                            stride);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = encode_nhwc_map(&mx, xt, N, Hs, Ws, C, Wo, a.bh, a.bn);
  if (err != cudaSuccess) return err;
  return nwg == 2 ? launch<2, false>(mw, mx, a, s)
                  : launch<1, false>(mw, mx, a, s);
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
