// In-place row set for Hopper (sm_90a):
//
//   table[ids[k]] = rows[k]          (distinct ids; ids < 0 or >= R dropped)
//
// Replaces the TPU kernel `_row_set_kernel` in
// dlrm_flexflow_tpu/ops/pallas_scatter.py (wrapper `_row_set_pallas`,
// reached from model.py's `_cache_writeback`): every writeback of the
// epoch row cache, from a ladder block cache into its parent cache and
// from the epoch cache into the table.  It computes the same function: a
// slot whose id is negative or at least the table's row count (the
// writeback plans pad with the sentinel R) is neither read nor written.
// Distinct ids are the caller's contract (ops/slotting.py gives them); the
// kernel does not check it, and duplicate ids would race, as on the TPU.
//
// Bound: memory.  Each live slot reads its d floats and writes them once,
// plus the n ids.  At the run_random.sh epilogue (n = 131,072 rows of
// d = 64 f32 into the 8M-row table) that is 2 * n * 256 B + 4 n = 67.6 MB,
// 20.2 us at 3.35 TB/s; a ladder block writeback (n = 16,384 into the
// 131,072-row epoch cache) moves 8.45 MB, 2.52 us.
//
// Design: one warp per slot, a coalesced copy of the row (16-byte loads
// and stores when d % 4 == 0 and both pointers are 16-byte aligned), no
// atomics and no shared memory.  The TPU kernel's 16-slot blocks of
// per-row async DMAs and their semaphores are TPU artefacts and are not
// carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

__global__ void __launch_bounds__(kThreads) row_set_kernel(
    float* __restrict__ table, const int32_t* __restrict__ ids,
    const float* __restrict__ rows, int n, int dim, long long num_rows,
    int vec4) {
  const int lane = threadIdx.x & 31;
  const long long k =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= n) return;
  const int32_t id = __ldg(ids + k);
  if (id < 0 || id >= num_rows) return;  // dropped
  float* dst = table + static_cast<long long>(id) * dim;
  const float* src = rows + k * dim;
  if (vec4) {
    const int nvec = dim >> 2;
    for (int c = lane; c < nvec; c += 32)
      reinterpret_cast<float4*>(dst)[c] =
          __ldg(reinterpret_cast<const float4*>(src) + c);
  } else {
    for (int c = lane; c < dim; c += 32) dst[c] = __ldg(src + c);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  The caller checks devices, dtypes and shapes:
// table (num_rows, dim) f32 contiguous; ids (n,) int32; rows (n, dim) f32
// contiguous.  `vec4` may be set only when dim % 4 == 0 and table and rows
// are 16-byte aligned.
int ff_row_set(void* table, const void* ids, const void* rows, int n, int dim,
               long long num_rows, int vec4, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  row_set_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), static_cast<const int32_t*>(ids),
      static_cast<const float*>(rows), n, dim, num_rows, vec4);
  return static_cast<int>(cudaGetLastError());
}

const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
