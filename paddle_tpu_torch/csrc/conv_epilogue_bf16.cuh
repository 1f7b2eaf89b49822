// The bf16 epilogue arithmetic of the fused-conv kernels, shared by
// fused_conv.cu (conv_kernel's bf16 form, bn_apply's bf16 kernel) and
// fused_conv_wgmma.cu (conv_apply_wgmma_kernel): bf16 halves of a 32-bit
// word as f32, and the folded BN affine (+ residual)(+ relu) with the
// reference's rounding points.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_tf32.cuh"

__device__ __forceinline__ float bf_lo(unsigned u) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(u & 0xffffu)));
}
__device__ __forceinline__ float bf_hi(unsigned u) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(u >> 16)));
}

// y = bf16(c * sc + sh) (a product, then a sum, each rounded to f32), then
// bf16(y + r) (a correctly rounded bf16 add), then relu: the reference's
// rounding points (_apply_kernel :189-194)
__device__ __forceinline__ float affine_bf16(float c, float sc, float sh,
                                             bool has_res, float r,
                                             int relu) {
  float y = __bfloat162float(
      __float2bfloat16_rn(__fadd_rn(__fmul_rn(c, sc), sh)));
  if (has_res) y = __bfloat162float(__float2bfloat16_rn(y + r));
  return (relu && y < 0.f) ? 0.f : y;
}
__device__ __forceinline__ unsigned affine_bf16x2(unsigned c, float sc,
                                                  float sh, bool has_res,
                                                  unsigned r, int relu) {
  return pack_bf16(affine_bf16(bf_lo(c), sc, sh, has_res, bf_lo(r), relu),
                   affine_bf16(bf_hi(c), sc, sh, has_res, bf_hi(r), relu));
}
__device__ __forceinline__ uint4 affine_bf16x8(uint4 c, float sc, float sh,
                                               bool has_res, uint4 r,
                                               int relu) {
  return make_uint4(affine_bf16x2(c.x, sc, sh, has_res, r.x, relu),
                    affine_bf16x2(c.y, sc, sh, has_res, r.y, relu),
                    affine_bf16x2(c.z, sc, sh, has_res, r.z, relu),
                    affine_bf16x2(c.w, sc, sh, has_res, r.w, relu));
}
