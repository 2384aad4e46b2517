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
// 131,072-row epoch cache) moves 8.45 MB, 2.52 us.  bf16 rows halve both:
// 33.8 MB (10.1 us) and 4.26 MB (1.27 us).
//
// The rows are f32 or bf16, in the table's dtype (JAX casts them to it,
// pallas_scatter.py:538, and so does the wrapper): a pure data move of
// 4- or 2-byte elements, bit-exact, so the kernel copies a row as words
// and never looks at an element.  A bf16 table moves half the bytes.
//
// Design: one warp per slot, a coalesced copy of the row in the widest
// words the row's bytes and both pointers allow (16 bytes at d = 64 of
// either dtype, then 4, then 2), no atomics and no shared memory.  The
// TPU kernel's 16-slot blocks of per-row async DMAs and their semaphores
// are TPU artefacts and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

// W: the copy word (uint4, uint32_t or uint16_t); a row is `words` of them
template <typename W>
__global__ void __launch_bounds__(kThreads) row_set_kernel(
    W* __restrict__ table, const int32_t* __restrict__ ids,
    const W* __restrict__ rows, int n, int words, long long num_rows) {
  const int lane = threadIdx.x & 31;
  const long long k =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= n) return;
  const int32_t id = __ldg(ids + k);
  if (id < 0 || id >= num_rows) return;  // dropped
  W* dst = table + static_cast<long long>(id) * words;
  const W* src = rows + k * words;
  for (int c = lane; c < words; c += 32) dst[c] = __ldg(src + c);
}

template <typename W>
int launch(void* table, const void* ids, const void* rows, int n,
           int row_bytes, long long num_rows, cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  row_set_kernel<W><<<blocks, kThreads, 0, stream>>>(
      static_cast<W*>(table), static_cast<const int32_t*>(ids),
      static_cast<const W*>(rows), n,
      row_bytes / static_cast<int>(sizeof(W)), num_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  The caller checks devices, dtypes and shapes:
// table (num_rows, d) contiguous; ids (n,) int32; rows (n, d) contiguous
// in the table's dtype; a row is `row_bytes` bytes.  `word` (16, 4 or 2)
// must divide row_bytes and both pointers' addresses.
int ff_row_set(void* table, const void* ids, const void* rows, int n,
               int row_bytes, long long num_rows, int word, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (word) {
    case 16:
      return launch<uint4>(table, ids, rows, n, row_bytes, num_rows, s);
    case 4:
      return launch<uint32_t>(table, ids, rows, n, row_bytes, num_rows, s);
    case 2:
      return launch<uint16_t>(table, ids, rows, n, row_bytes, num_rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
