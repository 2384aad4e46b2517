// In-place sorted row update for Hopper (sm_90a):
//
//   table[ids[k]] += upd[k]          (duplicates accumulate, no atomics)
//
// Replaces the TPU kernels `_row_update_kernel` and `_row_update_kernel_v2`
// in dlrm_flexflow_tpu/ops/pallas_scatter.py (wrapper `_row_update_pallas`,
// reached from `sparse_row_update`): the row-sparse SGD step on the
// embedding tables and the dense table gradient's scatter.  It computes the
// same function.  The wrapper (ops/row_update_kernel.py) scales the updates,
// wraps ids in [-R, 0) by adding R, maps every other id outside [0, R) to
// -1, and sorts the ids stably; the kernel receives the sorted ids and the
// permutation `order` that took the original slots there.  Each duplicate
// run then accumulates in the ids' stable order, starting from the row as
// it was, ((t + u1) + u2) + ..., and writes the row once: bit for bit what
// `.at[].add` on the CPU and the TPU kernel give.  A slot whose id is -1
// (dropped) is neither read nor written.
//
// Bound: memory.  Per call the kernel reads each touched row once, the n
// updates and the n ids and the permutation, and writes each touched row
// once.  At the run_random.sh training step (n = 256 * 8 = 2048 updates of
// d = 64 f32, nearly all rows distinct) that is about 2048 * 256 B * 3 +
// 2048 * 12 B = 1.6 MB, about 0.47 us at 3.35 TB/s, so the launch latency
// (a few us) dominates.  A zipf run of thousands of duplicates serialises
// on one warp; both are left for later work.
//
// Design: one warp per slot.  A warp whose slot does not start a run (its
// id equals the previous slot's) or whose id is dropped exits at once, so
// the run starts are found here rather than by a compaction in the wrapper,
// which would need a device-to-host sync to size its output.  The warp that
// owns a run has its lanes stride over the row's d floats (16-byte loads
// when d % 4 == 0 and the pointers are aligned); each lane walks the run
// serially down its columns and writes them once.  Runs are distinct rows,
// so no two warps touch one row.  The TPU kernel's 16-slot blocks, the
// cross-block carry, the DMA double-buffering and the 128-lane packing of
// d < 128 rows are TPU artefacts and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

__global__ void __launch_bounds__(kThreads) row_update_kernel(
    float* __restrict__ table, const int32_t* __restrict__ ids,
    const int64_t* __restrict__ order, const float* __restrict__ upd,
    int n, int dim, long long num_rows, int vec4) {
  const int lane = threadIdx.x & 31;
  const long long k =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (k >= n) return;
  const int32_t id = __ldg(ids + k);
  if (id < 0 || id >= num_rows) return;  // dropped
  if (k > 0 && __ldg(ids + k - 1) == id) return;  // inside a run
  float* row = table + static_cast<long long>(id) * dim;
  if (vec4) {
    float4* row4 = reinterpret_cast<float4*>(row);
    const int nvec = dim >> 2;
    for (int c = lane; c < nvec; c += 32) {
      float4 acc = row4[c];
      for (long long j = k; j < n && __ldg(ids + j) == id; ++j) {
        const float4 u = __ldg(
            reinterpret_cast<const float4*>(upd + __ldg(order + j) * dim) + c);
        acc.x = acc.x + u.x;
        acc.y = acc.y + u.y;
        acc.z = acc.z + u.z;
        acc.w = acc.w + u.w;
      }
      row4[c] = acc;
    }
  } else {
    for (int c = lane; c < dim; c += 32) {
      float acc = row[c];
      for (long long j = k; j < n && __ldg(ids + j) == id; ++j)
        acc = acc + __ldg(upd + __ldg(order + j) * dim + c);
      row[c] = acc;
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  The caller checks devices, dtypes and shapes:
// table (num_rows, dim) f32 contiguous; sorted_ids (n,) int32 ascending,
// -1 for dropped slots; order (n,) int64, the original slot of each sorted
// slot; upd (n, dim) f32 contiguous in the ORIGINAL slot order.  `vec4`
// may be set only when dim % 4 == 0 and table and upd are 16-byte aligned.
int ff_row_update(void* table, const void* sorted_ids, const void* order,
                  const void* upd, int n, int dim, long long num_rows,
                  int vec4, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  row_update_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), static_cast<const int32_t*>(sorted_ids),
      static_cast<const int64_t*>(order), static_cast<const float*>(upd), n,
      dim, num_rows, vec4);
  return static_cast<int>(cudaGetLastError());
}

const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
