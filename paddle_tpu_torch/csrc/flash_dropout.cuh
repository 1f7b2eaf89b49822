// Attention-dropout keep mask shared by flash_attention_fwd.cu and
// flash_attention_bwd.cu: a counter-based hash, so the backward regenerates
// the forward's mask from (seed, b*H + h, t*Tk + j) with no stored state.
//
// mix32 is a 32-bit finaliser (xor-shift / multiply, full avalanche). The
// per-head key mixes the seed with b*H + h; the element hash mixes the
// counter t*Tk + j (taken mod 2^32) with the key twice. A weight is kept
// iff the top 24 bits of the hash fall below keep_thresh =
// round((1 - rate) * 2^24). paddle_tpu_torch/ops/flash_attention.py
// (dropout_keep) computes the same bits in torch integer arithmetic.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t dropout_key(long long seed, int bh) {
  return mix32(static_cast<uint32_t>(seed) ^
               mix32(static_cast<uint32_t>(bh) + 0x9e3779b9u));
}

__device__ __forceinline__ bool dropout_keep(uint32_t key, long long ctr,
                                             unsigned keep_thresh) {
  const uint32_t h = mix32(mix32(static_cast<uint32_t>(ctr) ^ key) + key);
  return (h >> 8) < keep_thresh;
}
