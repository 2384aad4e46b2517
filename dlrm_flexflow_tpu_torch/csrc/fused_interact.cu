// Fused embedding-bag -> feature-interaction forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_kernel` in
// dlrm_flexflow_tpu/ops/pallas_fused_interact.py (wrapper
// `fused_interact_pallas`).  It computes the same function: gather rows of
// the fused (R, d) table by pre-masked flat ids (an id < 0 or >= R reads
// nothing and pools as exact 0.0), pool each bag (sum, or sum then divide
// by the bag for avg; an empty bag pools to 0.0), then interact with the
// bottom-MLP output:
//   cat: out = [bottom, pooled.flat]                      width bot + T*d
//   dot: out = [bottom, flat(z z^T)], z = [bottom; pooled] width d + (T+1)^2
// with the dot operands optionally rounded to bf16 and f32 accumulation.
// The pooled (B, T, d) intermediate never reaches device memory.
//
// Bound: memory.  Per sample the kernel reads T*bag rows of d floats, the
// bottom row and T*bag int32 ids, and writes one output row; the dot
// product adds 2*d*(T+1)^2 flops, far below the card's rate.  At the
// serving bucket of the run_random.sh model (B=256, T=8, bag=1, d=64,
// bottom 64, width 576) that is 524,288 B of rows + 65,536 B of bottom +
// 8,192 B of ids read and 589,824 B written, about 1.19 MB: 0.35 us at
// 3.35 TB/s, so the launch latency (a few us) dominates at every bucket.
//
// Design: one thread block per sample.  The block stages its own ids in
// shared memory (the TPU kernel's scalar prefetch), then its threads stride
// over the T*d pooled outputs; neighbouring threads read neighbouring
// floats of one row, so each row read is coalesced.  Each thread sums its
// bag in order j = 0..bag-1 in f32.  `cat` writes straight into the output
// row; `dot` stages z in shared memory (rows padded to d+1 floats so the
// column reads of z z^T hit distinct banks) and each thread computes whole
// dot products.  The TPU kernel's 8-sample blocks, per-row DMA semaphores
// and batch padding to a multiple of 8 are TPU artefacts and are not
// carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kThreads) fused_interact_kernel(
    const float* __restrict__ table, const int32_t* __restrict__ gids,
    const float* __restrict__ bottom, float* __restrict__ out,
    int num_tables, int bag, int dim, int bot_dim, long long num_rows,
    int width, int dot, int avg, int bf16) {
  extern __shared__ float smem[];
  const int nslots = num_tables * bag;
  int32_t* ids = reinterpret_cast<int32_t*>(smem);  // nslots ids
  float* z = smem + nslots;                         // (T+1) x (d+1), dot only
  const int zstride = dim + 1;
  const long long b = blockIdx.x;

  const int32_t* my_ids = gids + b * nslots;
  for (int s = threadIdx.x; s < nslots; s += blockDim.x) ids[s] = my_ids[s];
  const float* my_bottom = bottom + b * bot_dim;
  float* my_out = out + b * width;
  // the bottom row leads the output of both interactions
  for (int k = threadIdx.x; k < bot_dim; k += blockDim.x) {
    const float v = my_bottom[k];
    my_out[k] = v;
    if (dot) z[k] = v;
  }
  __syncthreads();

  const int pooled_n = num_tables * dim;
  for (int i = threadIdx.x; i < pooled_n; i += blockDim.x) {
    const int t = i / dim;
    const int k = i - t * dim;
    float acc = 0.f;
    for (int j = 0; j < bag; ++j) {
      const long long g = ids[t * bag + j];
      if (g >= 0 && g < num_rows) acc += __ldg(table + g * dim + k);
    }
    if (avg && bag > 0) acc = acc / static_cast<float>(bag);
    if (dot) {
      z[(t + 1) * zstride + k] = acc;
    } else {
      my_out[bot_dim + i] = acc;
    }
  }
  if (!dot) return;
  __syncthreads();

  const int f = num_tables + 1;
  for (int p = threadIdx.x; p < f * f; p += blockDim.x) {
    const int r = p / f;
    const int c = p - r * f;
    const float* zr = z + r * zstride;
    const float* zc = z + c * zstride;
    float acc = 0.f;
    if (bf16) {
      // bf16 * bf16 is exact in f32, so the fma is the product plus an add
      for (int k = 0; k < dim; ++k)
        acc = fmaf(round_bf16(zr[k]), round_bf16(zc[k]), acc);
    } else {
      for (int k = 0; k < dim; ++k) acc = fmaf(zr[k], zc[k], acc);
    }
    my_out[dim + p] = acc;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  The caller checks shapes, dtypes and contiguity:
// table (num_rows, dim) f32, gids (batch, num_tables, bag) int32, bottom
// (batch, bot_dim) f32 with bot_dim == dim for dot, out (batch, width) f32.
int ff_fused_interact_fwd(const void* table, const void* gids,
                          const void* bottom, void* out, int batch,
                          int num_tables, int bag, int dim, int bot_dim,
                          long long num_rows, int dot, int avg, int bf16,
                          void* stream) {
  const int f = num_tables + 1;
  const int width = dot ? dim + f * f : bot_dim + num_tables * dim;
  const size_t smem = sizeof(int32_t) * num_tables * bag +
                      (dot ? sizeof(float) * f * (dim + 1) : 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_interact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_interact_kernel<<<batch, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(gids),
      static_cast<const float*>(bottom), static_cast<float*>(out),
      num_tables, bag, dim, bot_dim, num_rows, width, dot, avg, bf16);
  return static_cast<int>(cudaGetLastError());
}

const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
