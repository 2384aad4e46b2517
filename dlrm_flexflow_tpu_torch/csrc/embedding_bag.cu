// Embedding bag for Hopper (sm_90a):
//
//   out[b] = ((table[ids[b, 0]] + table[ids[b, 1]]) + ...) [/ bag for avg]
//
// Replaces the TPU kernel `_bag_kernel` in
// dlrm_flexflow_tpu/ops/pallas_embedding.py (wrapper `embedding_bag_pallas`,
// reached from `Embedding(use_pallas=True)`'s forward).  It computes the
// same function: the rows of a bag are summed in bag order, as the TPU
// kernel sums them, and `avg` then divides by the bag (a true division).
// The id rule is `jnp.take`'s, as the port's plain forward reads it: an id
// in [-R, 0) wraps to id + R, any other id outside [0, R) reads a row of
// NaN.  The TPU kernel has no rule of its own there (it DMAs whatever row
// it is given).  The ids are read as they come, int32 or int64.
//
// The table is f32 or bf16, and the output is in the table's dtype, as
// the TPU kernel's scratch and sum are (pallas_embedding.py:61-66, its
// out_shape): on a bf16 table each add of the bag is done in f32 and
// rounded to bf16 before the next, and `avg` divides in f32 and rounds
// (warp_pool.cuh's Elem<bf16x4>).  A bf16 row of d = 128 is 256 bytes, one
// 8-byte load per lane.
//
// Bound: memory.  Per call the kernel reads B * bag rows of d floats and
// the B * bag ids once, and writes B * d floats.  At the JAX docstring's
// shape (a 1M x 128 f32 table, B = 256, bag 8, int64 ids) that is about
// 1.20 MB, 0.36 us at 3.35 TB/s, so latency, not bytes, sets the time; a
// bf16 table halves the rows and the output, 0.61 MB, 0.18 us.
//
// Design: one warp per sample, a block of 32 threads each (B = 256: 256
// blocks over the 132 SMs).  The warp loads its bag's ids once,
// coalesced, and stages their rows in shared memory; then every lane
// issues all of its bag's row loads into registers (csrc/warp_pool.cuh:
// 16-byte loads where d % 4 == 0 and the pointers are aligned, 8 float4
// or 16 floats a lane in flight, chunked for longer bags) before it adds
// them in bag order.  A sample costs two
// round trips to device memory, the ids' and its rows', where the earlier
// design made one per row.  No shared-memory reduction tree: the order of
// the adds is part of the result.  The TPU kernel's 8-sample blocks (the
// f32 sublane tile), its scalar-prefetched ids and per-row DMAs are TPU
// artefacts and are not carried over; the kernel has no B % 8 rule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_pool.cuh"

namespace {

// S: the table's storage vector (float4 or float for f32, bf16x4 or
// __nv_bfloat16 for bf16); the output is stored in the same type
template <typename S, typename IdT>
__global__ void __launch_bounds__(32) embedding_bag_kernel(
    const S* __restrict__ table, const IdT* __restrict__ ids,
    S* __restrict__ out, int bag, int nvec, long long num_rows, int avg) {
  using E = ffk::Elem<S>;
  using V = typename E::V;
  extern __shared__ int32_t rows[];
  const int lane = threadIdx.x;
  const long long b = blockIdx.x;
  const IdT* my_ids = ids + b * bag;
  for (int s = lane; s < bag; s += 32) {
    long long id = static_cast<long long>(my_ids[s]);
    if (id < 0) id += num_rows;
    rows[s] = (id >= 0 && id < num_rows) ? static_cast<int32_t>(id) : -1;
  }
  __syncwarp();
  S* my_out = out + b * nvec;
  ffk::warp_gather_pool<S>(table, rows, 1, bag, nvec,
                           __int_as_float(0x7fffffff), avg != 0,
                           static_cast<float>(bag), lane,
                           [&](int o, V v) { E::store(my_out + o, v); });
}

template <typename S, typename IdT>
int launch(const void* table, const void* ids, void* out, int bsz, int bag,
           int dim, long long num_rows, int avg, cudaStream_t stream) {
  const size_t smem = sizeof(int32_t) * bag;
  auto kernel = embedding_bag_kernel<S, IdT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int lanes = static_cast<int>(sizeof(typename ffk::Elem<S>::V) /
                                     sizeof(float));
  kernel<<<bsz, 32, smem, stream>>>(
      static_cast<const S*>(table), static_cast<const IdT*>(ids),
      static_cast<S*>(out), bag, dim / lanes, num_rows, avg);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_ids(const void* table, const void* ids, int ids64, void* out,
               int bsz, int bag, int dim, long long num_rows, int avg,
               cudaStream_t stream) {
  return ids64 ? launch<S, long long>(table, ids, out, bsz, bag, dim,
                                      num_rows, avg, stream)
               : launch<S, int32_t>(table, ids, out, bsz, bag, dim,
                                    num_rows, avg, stream);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  The caller checks devices, dtypes and shapes:
// table (num_rows, dim) contiguous, f32 (`bf16` 0) or bf16 (1), num_rows <
// 2^31; ids (bsz, bag) contiguous, int64 when `ids64` else int32; out
// (bsz, dim) contiguous in the table's dtype.  `vec4` may be set only when
// dim % 4 == 0 and table and out are aligned to four elements.
int ff_embedding_bag(const void* table, int bf16, const void* ids, int ids64,
                     void* out, int bsz, int bag, int dim,
                     long long num_rows, int avg, int vec4, void* stream) {
  if (bsz <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return vec4 ? launch_ids<ffk::bf16x4>(table, ids, ids64, out, bsz, bag,
                                          dim, num_rows, avg, s)
                : launch_ids<__nv_bfloat16>(table, ids, ids64, out, bsz, bag,
                                            dim, num_rows, avg, s);
  return vec4 ? launch_ids<float4>(table, ids, ids64, out, bsz, bag, dim,
                                   num_rows, avg, s)
              : launch_ids<float>(table, ids, ids64, out, bsz, bag, dim,
                                  num_rows, avg, s);
}

const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
