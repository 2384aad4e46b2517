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
// it is given).
//
// Bound: memory.  Per call the kernel reads B * bag rows of d floats and
// the B * bag ids once, and writes B * d floats.  At the JAX docstring's
// shape (a 1M x 128 f32 table, B = 256, bag 8) that is about 1.19 MB, 0.36
// us at 3.35 TB/s, so launch latency dominates.
//
// Design: one warp per sample.  Its lanes stride over the d columns
// (16-byte loads when d % 4 == 0 and the pointers are aligned), and each
// lane walks the bag in order for its columns, accumulating in registers:
// no shared-memory reduction tree, because the order of the adds is part
// of the result.  The TPU kernel's 8-sample blocks (the f32 sublane tile),
// its scalar-prefetched ids and per-row DMAs are TPU artefacts and are not
// carried over; the kernel has no B % 8 rule.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;

// The row an id reads under jnp.take's rule, or nullptr for a NaN row.
__device__ __forceinline__ const float* bag_row(const float* table,
                                                long long id,
                                                long long num_rows,
                                                int dim) {
  if (id < 0) id += num_rows;
  if (id < 0 || id >= num_rows) return nullptr;
  return table + id * dim;
}

__global__ void __launch_bounds__(kThreads) embedding_bag_kernel(
    const float* __restrict__ table, const long long* __restrict__ ids,
    float* __restrict__ out, int bsz, int bag, int dim, long long num_rows,
    int avg, int vec4) {
  const int lane = threadIdx.x & 31;
  const long long b =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= bsz) return;
  const long long* bag_ids = ids + b * bag;
  const float nan = __int_as_float(0x7fffffff);
  const float div = static_cast<float>(bag);
  if (vec4) {
    const int nvec = dim >> 2;
    float4* out4 = reinterpret_cast<float4*>(out + b * dim);
    for (int c = lane; c < nvec; c += 32) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < bag; ++j) {
        const float* row = bag_row(table, __ldg(bag_ids + j), num_rows, dim);
        const float4 r = row ? __ldg(reinterpret_cast<const float4*>(row) + c)
                             : make_float4(nan, nan, nan, nan);
        if (j == 0) {
          acc = r;
        } else {
          acc.x = acc.x + r.x;
          acc.y = acc.y + r.y;
          acc.z = acc.z + r.z;
          acc.w = acc.w + r.w;
        }
      }
      if (avg) {
        acc.x = acc.x / div;
        acc.y = acc.y / div;
        acc.z = acc.z / div;
        acc.w = acc.w / div;
      }
      out4[c] = acc;
    }
  } else {
    for (int c = lane; c < dim; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < bag; ++j) {
        const float* row = bag_row(table, __ldg(bag_ids + j), num_rows, dim);
        const float r = row ? __ldg(row + c) : nan;
        acc = j == 0 ? r : acc + r;
      }
      if (avg) acc = acc / div;
      out[b * dim + c] = acc;
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  The caller checks devices, dtypes and shapes:
// table (num_rows, dim) f32 contiguous; ids (bsz, bag) int64 contiguous;
// out (bsz, dim) f32 contiguous.  `vec4` may be set only when dim % 4 == 0
// and table and out are 16-byte aligned.
int ff_embedding_bag(const void* table, const void* ids, void* out, int bsz,
                     int bag, int dim, long long num_rows, int avg, int vec4,
                     void* stream) {
  if (bsz <= 0) return 0;
  const int blocks = (bsz + kWarpsPerBlock - 1) / kWarpsPerBlock;
  embedding_bag_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const long long*>(ids),
      static_cast<float*>(out), bsz, bag, dim, num_rows, avg, vec4);
  return static_cast<int>(cudaGetLastError());
}

const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
