// In-place sorted row update for Hopper (sm_90a):
//
//   table[key] += scale * upd[k]     for each slot k, in the keys' order
//                                    (duplicates accumulate, no atomics)
//
// Replaces the TPU kernels `_row_update_kernel` and `_row_update_kernel_v2`
// in dlrm_flexflow_tpu/ops/pallas_scatter.py (wrapper `_row_update_pallas`,
// reached from `sparse_row_update`): the row-sparse SGD step on the
// embedding tables and the dense table gradient's scatter.  It computes the
// same function.  The prepare-and-sort kernel (row_update_prep.cu) hands it
// the stably sorted int32 keys, dropped slots last with the key R, and the
// int32 permutation `order` that took the original slots there.  Each
// duplicate run accumulates in that stable order, starting from the row as
// it was, ((t + s*u1) + s*u2) + ..., and writes the row once: bit for bit
// what `.at[].add` on the CPU and the TPU kernel give.  The scale is
// multiplied in as each update row is loaded, rounded as the plain version
// forms it: f32(scale) * f32(u) in f32, then rounded to the update's own
// dtype (bf16) and widened again.  The multiply and the add are
// __fmul_rn and __fadd_rn, so the compiler cannot contract them into an FMA.
//
// Tables are f32 or bf16.  A bf16 table follows the TPU kernel on bf16
// storage (`sparse_row_update` rounds `scale * upd` to the table's dtype,
// pallas_scatter.py:573, and the kernel's fetched row, accumulator and
// carry are in that dtype, :89-106): the scaled update is rounded to bf16,
// and every add of the run, acc = fetched + u0, acc + u1, ..., is done in
// f32 and rounded to bf16 with __float2bfloat16_rn before the next one.
// The sum of two bf16 values is exact in f32 unless their exponents differ
// by more than 16, and then the smaller is below half a bf16 ulp of the
// larger, so f32-then-bf16 is the correctly rounded bf16 sum: no double
// rounding.  The bf16 table moves half the row bytes of the f32 one.
//
// Bound: memory, with a floor from the add chain.  Per call the kernel
// reads each touched row once, the n updates, keys and order, and writes
// each touched row once.  At the run_random.sh training step (n = 256 * 8 =
// 2048 updates of d = 64 f32, nearly all rows distinct) that is about
// 2048 * 256 B * 3 + 2048 * 8 B = 1.59 MB, 0.47 us at 3.35 TB/s, so the
// launch dominates (bf16 table and updates: 0.80 MB, 0.24 us).
// Bit-exactness keeps each column's adds serial in slot order, so a run
// of L rows costs at least L dependent FADDs (4 cycles each; on a bf16
// table each add also carries a round to bf16): the zipf case's longest
// run at n = 2048 (about 200 rows) is about 800 cycles, 0.4 us at 1.98
// GHz; the one-id case at n = 65,536 is 262,144 cycles, 130 us, a
// correctness case and not a timing one.
//
// Design: one warp per run.  The grid has a warp per sorted slot; a warp
// whose slot is dropped (key >= R) or does not start a run (its key equals
// the previous slot's) exits after its first loads.  The run-start warp
// walks its run in chunks of 32 slots: each lane loads one key and one
// `order` entry (coalesced), a ballot of key == run key says how many of
// the chunk's slots are in the run (the keys are sorted, so they form a
// prefix), and each lane turns its order entry into a 32-bit row offset
// that reaches the other lanes by __shfl_sync.  A run within one chunk
// (every run at uniform ids) loads its rows together, then adds them.  A
// longer run keeps a ring of 32 update rows in registers (unrolled, so the
// ring's indices are static): while chunk c is added, row by row, each
// ring entry refills with its slot of chunk c + 1, without a branch, so 32
// row loads stay in flight ahead of the add chain; chunk c + 1's keys and
// order are loaded a chunk ahead, chunk c + 2's rows are prefetched into
// L2.  Lanes hold V columns: four when d >= 128, two when d >= 64 (all
// 32 lanes busy at d = 64; a float2, or an __nv_bfloat162 of a bf16 row),
// one otherwise; wider rows loop over column groups of 32 lanes.  Runs
// are distinct rows, so no two warps touch one row.
//
// Measured on an H100 (chip_smoke.py phase 9, one run of L slots among
// uniform ids): about 27 ns per row of a long run, some 50 cycles, against
// the add chain's 4: the ring waits on its loads, 32 rows deep.  Tried and
// dropped: keys and order four or eight chunks ahead with L2 prefetches of
// their rows (slower), and two rings of 32 rows (the compiler put them on
// the stack).  Not done: giving a long run a whole block with warps
// prefetching into shared memory.  The TPU kernel's 16-slot blocks, the
// cross-block carry, the DMA double-buffering and the 128-lane packing of
// d < 128 rows are TPU artefacts and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// a value in f32 rounded to the storage type Tab and widened again
template <typename Tab>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename Tab>
__device__ __forceinline__ Tab narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// s * u rounded as the plain version: once in f32, then to T's precision
template <typename T>
__device__ __forceinline__ float scaled(float s, T u);
template <>
__device__ __forceinline__ float scaled<float>(float s, float u) {
  return __fmul_rn(s, u);
}
template <>
__device__ __forceinline__ float scaled<__nv_bfloat16>(float s,
                                                       __nv_bfloat16 u) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(s, widen(u))));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// acc += s * u, the term and the sum each rounded to the table's dtype Tab
// (the identity for an f32 table)
template <typename Tab, typename T, int V>
__device__ __forceinline__ void add_row(float* acc, float s,
                                        const Pack<T, V>& u) {
#pragma unroll
  for (int i = 0; i < V; ++i)
    acc[i] = round_to<Tab>(
        __fadd_rn(acc[i], round_to<Tab>(scaled<T>(s, u.v[i]))));
}

// Tab: the table dtype; T: the update dtype; V: columns per lane.  The
// ring holds one chunk: 32 rows, loaded a chunk ahead of the add chain.
template <typename Tab, typename T, int V>
__global__ void __launch_bounds__(kThreads) row_update_kernel(
    Tab* __restrict__ table, const int32_t* __restrict__ keys,
    const int32_t* __restrict__ order, const T* __restrict__ upd,
    const float* __restrict__ scale_ptr, float scale_value, int n, int dim,
    int rows) {
  using P = Pack<T, V>;
  // A kernel with a bf16 table or bf16 updates loads every ring entry
  // without a predicate: each address is a valid slot's row, and an entry
  // past the run is never added.  Predicated, a bf16 table's whole call
  // (sort included) took 25.1 us at zipf ids against 18.0 unpredicated
  // (H100 80GB HBM3, 700 W; tools/row_update_calls.py).  The
  // likely cause: a predicated load keeps the entry's old value on one
  // path, the compiler widens the bf16 values where they are loaded, and
  // each refill then waits for its load.  Rounding in integer
  // instructions, a raw-bits ring and a build without spills did not help.
  // The f32 kernel keeps its predicates: unpredicated, its uniform call
  // was 0.9 us slower.
  constexpr bool kAll =
      !(std::is_same<Tab, float>::value && std::is_same<T, float>::value);
  const int lane = threadIdx.x & 31;
  const long long k =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= n) return;
  // first loads, all in flight together: chunk 0's keys and order, the
  // previous slot's key, the scale
  int kc0 = -1, oc0 = 0;
  if (k + lane < n) {
    kc0 = __ldg(keys + k + lane);
    oc0 = __ldg(order + k + lane);
  }
  const int prev = k > 0 ? __ldg(keys + k - 1) : -1;
  const float s = scale_ptr ? __ldg(scale_ptr) : scale_value;
  const int key = __shfl_sync(kFull, kc0, 0);
  if (key >= rows || key == prev) return;  // dropped, or inside a run
  const int m0 = __popc(__ballot_sync(kFull, kc0 == key));
  // chunks 1 and 2, if the run fills chunk 0 (what lies past the run is
  // fetched for nothing and ignored)
  int kc1 = -1, oc1 = 0, kc2 = -1, oc2 = 0;
  if (m0 == 32) {
    if (k + 32 + lane < n) {
      kc1 = __ldg(keys + k + 32 + lane);
      oc1 = __ldg(order + k + 32 + lane);
    }
    if (k + 64 + lane < n) {
      kc2 = __ldg(keys + k + 64 + lane);
      oc2 = __ldg(order + k + 64 + lane);
    }
  }
  const int row_bytes = dim * static_cast<int>(sizeof(T));
  Tab* row = table + static_cast<long long>(key) * dim;
  const int groups = dim / V;
  // a row's offset in P units: 32 bits, as n * dim < 2^32 (the wrapper
  // checks), so a load's address is one multiply-add off the lane's base
  const unsigned stride = static_cast<unsigned>(groups);
  const unsigned off0 = static_cast<unsigned>(oc0) * stride;
  for (int g0 = 0; g0 < groups; g0 += 32) {
    const int cg = g0 + lane;
    const bool act = cg < groups;
    const P* ub = reinterpret_cast<const P*>(upd) + (act ? cg : 0);
    float acc[V];
    if (act) {
      const Pack<Tab, V> t = reinterpret_cast<const Pack<Tab, V>*>(row)[cg];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = widen(t.v[i]);
    }
    // ring[t] holds slot t of the chunk being added
    P ring[32];
    if (m0 < 32) {
      // a run within one chunk (all of them at uniform ids): its rows'
      // loads, then its adds
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        if (t >= m0) break;
        const unsigned o = __shfl_sync(kFull, off0, t);
        if (kAll || act) ring[t] = ub[o];
      }
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        if (t >= m0) break;
        add_row<Tab, T, V>(acc, s, ring[t]);
      }
    } else {
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const unsigned o = __shfl_sync(kFull, off0, t);
        if (kAll || act) ring[t] = ub[o];
      }
      // chunk c is being added; chunks c + 1 (k1, o1) and c + 2 (k2, o2)
      // have their keys and order
      int m = 32, k1 = kc1, o1 = oc1, k2 = kc2, o2 = oc2;
      for (long long base = k; m == 32; base += 32) {
        // a full chunk: how much of the next one is in the run
        const int m_nxt = __popc(__ballot_sync(kFull, k1 == key));
        int k3 = -1, o3 = 0;
        if (m_nxt == 32) {
          // chunk c + 2's rows into L2, each lane its own slot's row, so
          // that the ring's loads of them during chunk c + 1 hit; then
          // chunk c + 3's keys and order
          if (k2 == key) {
            const char* r = reinterpret_cast<const char*>(
                upd + static_cast<long long>(o2) * dim);
            for (int b = 0; b < row_bytes; b += 128) prefetch_l2(r + b);
          }
          if (base + 96 + lane < n) {
            k3 = __ldg(keys + base + 96 + lane);
            o3 = __ldg(order + base + 96 + lane);
          }
        }
        const unsigned off1 = static_cast<unsigned>(o1) * stride;
        // add slot t, then refill its ring entry with slot t of the next
        // chunk: no branch, so the loads stay in flight across the adds
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          add_row<Tab, T, V>(acc, s, ring[t]);
          const unsigned o = __shfl_sync(kFull, off1, t);
          if (kAll || (act && t < m_nxt)) ring[t] = ub[o];
        }
        m = m_nxt;
        k1 = k2;
        o1 = o2;
        k2 = k3;
        o2 = o3;
      }
      // the last chunk, m < 32 slots, all in the ring already
#pragma unroll
      for (int t = 0; t < 32; ++t)
        if (t < m) add_row<Tab, T, V>(acc, s, ring[t]);
    }
    if (act) {
      Pack<Tab, V> t;
#pragma unroll
      for (int i = 0; i < V; ++i) t.v[i] = narrow<Tab>(acc[i]);
      reinterpret_cast<Pack<Tab, V>*>(row)[cg] = t;
    }
  }
}

template <typename Tab, typename T, int V>
int launch(void* table, const void* keys, const void* order, const void* upd,
           const void* scale_ptr, float scale_value, int n, int dim,
           int rows, cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  row_update_kernel<Tab, T, V><<<blocks, kThreads, 0, stream>>>(
      static_cast<Tab*>(table), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(order), static_cast<const T*>(upd),
      static_cast<const float*>(scale_ptr), scale_value, n, dim, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tab, typename T>
int dispatch(int vec, void* table, const void* keys, const void* order,
             const void* upd, const void* scale_ptr, float scale_value, int n,
             int dim, int rows, cudaStream_t stream) {
  switch (vec) {
    case 4:
      return launch<Tab, T, 4>(table, keys, order, upd, scale_ptr,
                               scale_value, n, dim, rows, stream);
    case 2:
      return launch<Tab, T, 2>(table, keys, order, upd, scale_ptr,
                               scale_value, n, dim, rows, stream);
    default:
      return launch<Tab, T, 1>(table, keys, order, upd, scale_ptr,
                               scale_value, n, dim, rows, stream);
  }
}

template <typename Tab>
int dispatch_upd(int dtype, int vec, void* table, const void* keys,
                 const void* order, const void* upd, const void* scale_ptr,
                 float scale_value, int n, int dim, int rows,
                 cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return dispatch<Tab, float>(vec, table, keys, order, upd, scale_ptr,
                                  scale_value, n, dim, rows, stream);
    case 1:
      return dispatch<Tab, __nv_bfloat16>(vec, table, keys, order, upd,
                                          scale_ptr, scale_value, n, dim,
                                          rows, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  The caller checks devices, dtypes and shapes:
// table (rows, dim) contiguous, f32 (table_dtype 0) or bf16 (1); keys (n,)
// int32 ascending, rows for a dropped slot; order (n,) int32, the original
// slot of each sorted slot; upd (n, dim) contiguous in the ORIGINAL slot
// order, f32 (dtype 0) or bf16 (1); the scale is *scale_ptr (one f32 on
// the card) when scale_ptr is not null, else scale_value.  `vec` (4, 2 or
// 1) columns per lane: dim % vec == 0 and table and upd aligned to vec
// elements.
int ff_row_update(void* table, int table_dtype, const void* keys,
                  const void* order, const void* upd, int dtype,
                  const void* scale_ptr, float scale_value, int n, int dim,
                  int rows, int vec, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_dtype) {
    case 0:
      return dispatch_upd<float>(dtype, vec, table, keys, order, upd,
                                 scale_ptr, scale_value, n, dim, rows, s);
    case 1:
      return dispatch_upd<__nv_bfloat16>(dtype, vec, table, keys, order, upd,
                                         scale_ptr, scale_value, n, dim, rows,
                                         s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
