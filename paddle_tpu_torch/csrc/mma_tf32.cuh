// Tensor-core, ldmatrix and asynchronous-copy helpers shared by
// fused_conv.cu, flash_attention_fwd.cu, flash_attention_bwd.cu and
// fused_ce_fwd.cu (sm_90a).
//
// 3xTF32: an f32 product a * b runs on the TF32 tensor cores as
// a_small * b_big + a_big * b_small + a_big * b_big (small terms first),
// each operand split by split_tf32 into big = rna_tf32(a) and
// small = rna_tf32(a - big); a_small * b_small (about 2^-22 of the
// product) is dropped. A single TF32 product keeps only 11 bits of each
// operand. The tensor cores round their additions toward zero, so a long
// sum is taken in pieces, each added into an f32 accumulator on the FMA
// pipe (mma_3xtf32_add, or per chunk by the caller), or keeps the small
// terms in an accumulator of their own (mma_3xtf32_sep).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 4 or 16 bytes; pred false writes zeros (src-size 0, nothing
// read from src)
__device__ __forceinline__ void cp4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp16(void* dst, const void* src,
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

// d += a * b in 3xTF32 from split operands (ab/as: a's big and small parts)
__device__ __forceinline__ void mma_3xtf32(float* d, const unsigned* ab,
                                           const unsigned* as,
                                           const unsigned* bb,
                                           const unsigned* bs) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

// d += a * b in 3xTF32 with one rounding: the three products are summed
// on the tensor cores from zero and added into d on the FMA pipe, so a
// long chain of k-steps rounds d to nearest once a step instead of
// truncating it three times
__device__ __forceinline__ void mma_3xtf32_add(float* d, const unsigned* ab,
                                               const unsigned* as,
                                               const unsigned* bb,
                                               const unsigned* bs) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(t, ab, as, bb, bs);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// d += a_big * b_big and ds += the two small terms, each on the tensor
// cores: ds (about 2^-11 of d) keeps its truncations far below d's, and d
// truncates once a k-step instead of three times; the caller adds ds in
__device__ __forceinline__ void mma_3xtf32_sep(float* d, float* ds,
                                               const unsigned* ab,
                                               const unsigned* as,
                                               const unsigned* bb,
                                               const unsigned* bs) {
  mma_tf32(ds, as, bb);
  mma_tf32(ds, ab, bs);
  mma_tf32(d, ab, bb);
}

// d += a * b on the bf16 tensor cores: a 16x16 (row), b 16x8 (col), each
// register two bf16 (the lower column / row in the low half), d 16x8 f32
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix: four 8x8 b16 matrices from shared memory, lane l giving the
// address of row l % 8 of matrix l / 8 (16 bytes each). Plain: lane t gets
// row t / 4, columns 2 (t % 4) and + 1 of each matrix, the A fragment of
// mma m16n8k16 when the matrices are (rows 0-7, k 0-7), (rows 8-15, k 0-7),
// (rows 0-7, k 8-15), (rows 8-15, k 8-15) of a row-major tile. .trans: lane
// t gets rows 2 (t % 4) and + 1 of column t / 4, the B fragment of two n8
// tiles when B is stored k-major (each row 8 consecutive n).
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// bf16 fragment registers: two consecutive bf16 read as one 32-bit word,
// or two values packed (lo in the low half), rounded to nearest from f32
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
