// Row scatter-add for Hopper (sm_90a): out[rows[i], :] += vals[i, :].
//
// Replaces the Pallas TPU kernel _scatter_kernel of paddle_tpu/ops/scatter.py
// (:163, driven by _scatter_packed_call :194): base.at[rows].add(vals,
// mode="drop") over a [V, K] f32 table. Duplicate rows accumulate; a row in
// [-V, 0) wraps python-style; any other out-of-range row is dropped (the
// sentinel V that merged duplicates and padded lookups park on included).
//
// What bounds it on the card: bytes. Each (row, value) slot is read once
// and added once into the table, a single f32 add per element, far below
// the card's operations per byte: the vals stream plus the rows plus one
// read-modify-write of the table. The TPU kernel folds the slots into a
// VMEM-resident packed table serially, one grid step after another; none
// of that carries over, because blocks here run in parallel and in no
// order. The design is flat instead: one thread per (slot, column) element
// in a grid-stride loop, so every warp reads a contiguous stretch of vals
// whatever K is (no idle lanes for K < 32), and adds it into the table with
// a fire-and-forget atomic (red.global.add.f32: the return value is unused).
// Neighbouring threads hit neighbouring columns of one row, so a warp's
// reductions coalesce into whole 32-byte sectors. At the DeepFM shape the
// table (100,000 x 32 f32, 12.8 MB) stays resident in the 50 MB L2, so the
// read-modify-writes are served there and device memory sees about one
// pass over vals. The sum order of duplicates varies from run to run (f32
// atomics), so a row with d duplicates differs from a sequential sum by a
// few ulp times d.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;

// I: the index type, 32-bit whenever every element offset fits (the
// division by k is then a 32-bit one)
template <typename I>
__global__ void __launch_bounds__(THREADS)
scatter_add_kernel(const int32_t* __restrict__ rows,
                   const float* __restrict__ vals, float* __restrict__ out,
                   I n_elems, int k, int v) {
  const I stride = (I)gridDim.x * THREADS;
  for (I e = (I)blockIdx.x * THREADS + threadIdx.x; e < n_elems;
       e += stride) {
    const I slot = e / k;
    const int col = (int)(e - slot * k);
    int r = __ldg(rows + slot);
    if (r < 0) r += v;                    // [-V, 0) wraps
    if (r < 0 || r >= v) continue;        // anything else drops
    atomicAdd(out + (I)r * k + col, __ldg(vals + e));
  }
}

}  // namespace

extern "C" {

// rows: int32 [n]; vals: f32 [n, k] contiguous; out: f32 [v, k]
// contiguous, added into in place. blocks: the grid size (the caller sizes
// it to a few waves of the card's SMs).
int scatter_add_rows_f32(const void* rows, const void* vals, void* out,
                         long long n, int k, int v, int blocks,
                         void* stream) {
  if (n < 0 || k <= 0 || v <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  const long long n_elems = n * (long long)k;
  if (n_elems == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const float* x = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  // the grid-stride loop may step one stride past n_elems before it stops
  const long long reach = n_elems + (long long)blocks * THREADS;
  if (reach <= INT_MAX && (long long)v * k <= INT_MAX) {
    scatter_add_kernel<int><<<blocks, THREADS, 0, s>>>(r, x, o, (int)n_elems,
                                                        k, v);
  } else {
    scatter_add_kernel<long long><<<blocks, THREADS, 0, s>>>(r, x, o,
                                                              n_elems, k, v);
  }
  return cudaGetLastError();
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
