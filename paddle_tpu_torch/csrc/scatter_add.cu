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
// order, so the sums meet in the table as reductions in the L2. What the
// design does about that:
//
// * 16-byte traffic. Where K % 4 == 0 and vals and out are 16-byte aligned
//   (VEC = 4), a lane owns float4 column groups: it reads vals with 128-bit
//   streaming loads (the table stays resident in the L2, vals passes
//   through) and adds with the sm_90 vector reduction (atomicAdd on a
//   float4 with its result unused: red.global.add.v4.f32), a quarter of the
//   scalar reductions. Any other K or alignment runs the VEC = 1
//   instantiation, the same code on single floats.
// * Duplicates summed inside a block first. A block takes a chunk of
//   up to MAX_CHUNK consecutive slots and sorts them by row in shared
//   memory: the rows go into an open-addressing hash table (each new row
//   gets a dense id), a warp-aggregated count gives each slot its rank
//   among its row's slots, a block scan turns the counts into offsets, and
//   each slot lands at offset + rank. Groups of lanes then walk equal
//   stretches of the sorted chunk, summing each run of one row in
//   registers and reducing it into the table once. A run that crosses
//   from one group's stretch into the next is summed in shared memory and
//   reduced once by the group where it starts. So a hot row costs one
//   vector reduction per chunk and column group, not one per slot: under
//   Zipf-skewed ids the hottest row holds a fifth of the slots, and the
//   L2 serialises reductions onto one line. Every chunk is sorted, since
//   the host cannot see the ids: on uniform ids, with few duplicates in a
//   chunk, the sort's phases ahead of the first load are its cost.
// * The plan (VEC, chunk size, lanes per group, grid, resident blocks an
//   SM) comes from ops/scatter.py scatter_plan; the C entry refuses an
//   inconsistent one.
//
// The sum order of duplicates varies from run to run (the hash table's
// ranks and the L2's reductions take atomics in no fixed order), so a row
// with d duplicates differs from a sequential sum by a few ulp times d.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
// resident blocks an SM: caps registers at 40 a thread (shared memory
// allows 7). The plan sizes its waves by it and passes it in; the C entry
// refuses another count.
constexpr int MIN_BLOCKS = 6;
constexpr int MAX_CHUNK = 1024;                  // ops/scatter.py _MAX_CHUNK
constexpr int SLOTS_PER_THREAD = MAX_CHUNK / THREADS;
constexpr int MAX_HASH = 2 * MAX_CHUNK;
constexpr int EMPTY = -1;
// loads in flight a lane: 2 keeps the float4 form inside 40 registers
// with no spills; 4 and 8 spill and run slower
constexpr int UNROLL = 2;
constexpr unsigned FULL = 0xffffffffu;

template <int VEC> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
  static __device__ __forceinline__ T load(const T* p) { return __ldcs(p); }
  static __device__ __forceinline__ void red(T* p, T a) { atomicAdd(p, a); }
  static __device__ __forceinline__ void red_shared(float* p, T a) {
    atomicAdd(p, a);
  }
};
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  static __device__ __forceinline__ T load(const T* p) { return __ldcs(p); }
  // sm_90: one 128-bit reduction (red.global.add.v4.f32)
  static __device__ __forceinline__ void red(T* p, T a) { atomicAdd(p, a); }
  static __device__ __forceinline__ void red_shared(float* p, T a) {
    atomicAdd(p, a.x);
    atomicAdd(p + 1, a.y);
    atomicAdd(p + 2, a.z);
    atomicAdd(p + 3, a.w);
  }
};

__device__ __forceinline__ int wrap_row(int r, int v) {
  if (r < 0) r += v;                    // [-V, 0) wraps
  return (r >= 0 && r < v) ? r : -1;    // anything else drops
}

// In place: off[0..nu) holds counts, becomes their exclusive prefix sums;
// off[nu] gets the total. nu <= MAX_CHUNK = 4 * THREADS.
__device__ __forceinline__ void block_exclusive_scan(int* off, int nu,
                                                     int* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int a[SLOTS_PER_THREAD];
  int s = 0;
#pragma unroll
  for (int q = 0; q < SLOTS_PER_THREAD; ++q) {
    const int i = tid * SLOTS_PER_THREAD + q;
    a[q] = i < nu ? off[i] : 0;
    s += a[q];
  }
  int inc = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    if (w < warp) before += warp_tot[w];
    total += warp_tot[w];
  }
  int run = before + inc - s;
#pragma unroll
  for (int q = 0; q < SLOTS_PER_THREAD; ++q) {
    const int i = tid * SLOTS_PER_THREAD + q;
    if (i < nu) off[i] = run;
    run += a[q];
  }
  if (tid == 0) off[nu] = total;
}

// One block, one chunk of `chunk` consecutive slots (the last may be
// shorter). `group` lanes (a power of two up to 32) walk one stretch of
// the chunk, each lane owning VEC-wide column groups c, c + group, ...
template <int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
scatter_add_kernel(const int32_t* __restrict__ rows,
                   const float* __restrict__ vals, float* __restrict__ out,
                   long long n, int k, int v, int chunk, int group) {
  using VT = Vec<VEC>;
  using T = typename VT::T;
  __shared__ int keys[MAX_HASH];            // row, or EMPTY
  __shared__ unsigned short uid_of[MAX_HASH];
  __shared__ int off[MAX_CHUNK + 1];        // counts -> offsets
  __shared__ int ukey[MAX_CHUNK];           // id -> row
  __shared__ unsigned short suid[MAX_CHUNK];   // sorted: id
  __shared__ unsigned short sslot[MAX_CHUNK];  // sorted: slot
  __shared__ __align__(16) float comb[THREADS * VEC];
  __shared__ int warp_tot[THREADS / 32];
  __shared__ int n_unique;

  const int tid = threadIdx.x, lane = tid & 31;
  const long long base = (long long)blockIdx.x * chunk;
  const int cn = (int)(n - base < chunk ? n - base : chunk);
  const int cols = k / VEC;
  const T* __restrict__ vv = reinterpret_cast<const T*>(vals);
  T* __restrict__ ov = reinterpret_cast<T*>(out);

  int hbits = 1;
  while ((1 << hbits) < 2 * cn) ++hbits;
  const int hsize = 1 << hbits, hmask = hsize - 1;
  for (int i = tid; i < hsize; i += THREADS) keys[i] = EMPTY;
  for (int i = tid; i <= cn; i += THREADS) off[i] = 0;
  for (int i = tid; i < THREADS * VEC; i += THREADS) comb[i] = 0.f;
  if (tid == 0) n_unique = 0;
  __syncthreads();

  // 1. each in-range row into the hash table; a new row gets an id
  int su[SLOTS_PER_THREAD];
#pragma unroll
  for (int j = 0; j < SLOTS_PER_THREAD; ++j) {
    const int i = tid + j * THREADS;
    su[j] = -1;
    if (i >= cn) continue;
    const int r = wrap_row(__ldg(rows + base + i), v);
    if (r < 0) continue;
    int h = (int)(((unsigned)r * 2654435761u) >> (32 - hbits));
    while (true) {
      const int cur = ((volatile int*)keys)[h];
      if (cur == r) break;
      if (cur == EMPTY) {
        const int prev = atomicCAS(&keys[h], EMPTY, r);
        if (prev == EMPTY) {
          const int u = atomicAdd(&n_unique, 1);
          uid_of[h] = (unsigned short)u;
          ukey[u] = r;
          break;
        }
        if (prev == r) break;
      }
      h = (h + 1) & hmask;
    }
    su[j] = h;
  }
  __syncthreads();

  // 2. count each id's slots; a slot's rank among them, one shared
  // atomic per distinct id of a warp
  int rk[SLOTS_PER_THREAD];
#pragma unroll
  for (int j = 0; j < SLOTS_PER_THREAD; ++j) {
    const int u = su[j] >= 0 ? (int)uid_of[su[j]] : -1;
    const unsigned peers = __match_any_sync(FULL, u);
    const int leader = __ffs(peers) - 1;
    int first = 0;
    if (lane == leader && u >= 0) first = atomicAdd(&off[u], __popc(peers));
    first = __shfl_sync(FULL, first, leader);
    rk[j] = first + __popc(peers & ((1u << lane) - 1u));
    su[j] = u;
  }
  __syncthreads();

  // 3. counts -> offsets
  const int nu = n_unique;
  block_exclusive_scan(off, nu, warp_tot);
  __syncthreads();

  // 4. each slot to its place in the sorted chunk
#pragma unroll
  for (int j = 0; j < SLOTS_PER_THREAD; ++j) {
    if (su[j] < 0) continue;
    const int p = off[su[j]] + rk[j];
    suid[p] = (unsigned short)su[j];
    sslot[p] = (unsigned short)(tid + j * THREADS);
  }
  __syncthreads();
  const int npos = off[nu];

  // 5. each group walks its stretch [beg, end) of the (sorted) chunk
  const int ngroups = THREADS / group;
  const int g = tid / group, lig = tid % group;
  int per = (npos + ngroups - 1) / ngroups;
  if (per < 1) per = 1;
  const int beg = min(g * per, npos), end = min(beg + per, npos);

  for (int c0 = 0; c0 < cols; c0 += group) {
    const int c = c0 + lig;
    const bool live = c < cols;
    const T* __restrict__ cv = vv + base * cols + c;  // 32-bit offsets below
    T acc = VT::zero();
    int cur = -1;
    auto flush = [&](int key, T a) {
      const int s = off[key], e = off[key + 1];
      if (s >= beg && e <= end) {
        VT::red(ov + (long long)ukey[key] * cols + c, a);
      } else {  // a run crossing stretches: summed where it starts
        VT::red_shared(comb + ((s / per) * group + lig) * VEC, a);
      }
    };
    for (int p0 = beg; p0 < end; p0 += UNROLL) {
      T x[UNROLL];
      int key[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int p = p0 + u;
        key[u] = -1;
        x[u] = VT::zero();
        if (p < end) {
          key[u] = suid[p];
          if (live) x[u] = VT::load(cv + sslot[p] * cols);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (key[u] < 0) continue;
        if (key[u] != cur) {
          if (cur >= 0 && live) flush(cur, acc);
          cur = key[u];
          acc = x[u];
        } else {
          acc = VT::add(acc, x[u]);
        }
      }
    }
    if (cur >= 0 && live) flush(cur, acc);
    __syncthreads();
    // the group where a crossing run starts adds its shared sum once
    if (end > beg && live) {
      const int u = suid[end - 1];
      if (off[u] >= beg && off[u + 1] > end) {
        float* cp = comb + (g * group + lig) * VEC;
        T a;
        if constexpr (VEC == 4) {
          a = *reinterpret_cast<float4*>(cp);
          *reinterpret_cast<float4*>(cp) = VT::zero();
        } else {
          a = *cp;
          *cp = 0.f;
        }
        VT::red(ov + (long long)ukey[u] * cols + c, a);
      }
    }
    __syncthreads();
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int VEC>
cudaError_t launch(int blocks, cudaStream_t s, const int32_t* r,
                   const float* x, float* o, long long n, int k, int v,
                   int chunk, int group) {
  scatter_add_kernel<VEC><<<blocks, THREADS, 0, s>>>(r, x, o, n, k, v,
                                                     chunk, group);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// rows: int32 [n]; vals: f32 [n, k] contiguous; out: f32 [v, k]
// contiguous, added into in place. The plan (ops/scatter.py scatter_plan):
// vec 4 only where k % 4 == 0 and vals and out are 16-byte aligned, else
// 1; chunk in [1, 1024]; group = min(32, the power of two at or above
// k / vec); blocks = ceil(n / chunk), so no block is empty; per_sm, the
// resident blocks an SM the plan sized its waves by, = MIN_BLOCKS.
int scatter_add_rows_f32(const void* rows, const void* vals, void* out,
                         long long n, int k, int v, int vec, int chunk,
                         int group, int blocks, int per_sm, void* stream) {
  if (n < 0 || k <= 0 || k > INT_MAX / MAX_CHUNK || v <= 0 ||
      per_sm != MIN_BLOCKS || chunk < 1 || chunk > MAX_CHUNK)
    return cudaErrorInvalidValue;
  if (vec == 4) {
    if (k % 4 != 0 || !aligned16(vals) || !aligned16(out))
      return cudaErrorInvalidValue;
  } else if (vec != 1) {
    return cudaErrorInvalidValue;
  }
  const int cols = k / vec;
  int want_group = 1;
  while (want_group < cols && want_group < 32) want_group <<= 1;
  if (group != want_group || (n + chunk - 1) / chunk != blocks)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const float* x = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  return vec == 4 ? launch<4>(blocks, s, r, x, o, n, k, v, chunk, group)
                  : launch<1>(blocks, s, r, x, o, n, k, v, chunk, group);
}

const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
