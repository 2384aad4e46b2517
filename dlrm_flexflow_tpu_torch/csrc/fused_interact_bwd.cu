// Fused embedding-bag -> feature-interaction BACKWARD for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_bwd_kernel` in
// dlrm_flexflow_tpu/ops/pallas_fused_interact.py (wrapper
// `fused_interact_bwd_pallas`), the backward of the forward kernel in
// fused_interact.cu.  It computes the same function, at f32: given the
// interaction's output cotangent g (B, width), the bottom-MLP output and
// the pre-masked flat ids (an id < 0 or >= R is dropped), it returns
// dbottom (B, bot) and the per-slot row grads (B, T, bag, d), exact 0.0 at
// dropped slots, for the caller's one deterministic scatter into the
// table gradient:
//   cat: dbottom = g[:, :bot]; the row grads are g[:, bot:] as (T, d),
//        broadcast over the bag (divided by the bag for avg).  No table
//        read.
//   dot: re-gather the live rows and pool them as the forward does,
//        z = [bottom; pooled] (F x d, F = T + 1), G = g[:, d:] as F x F,
//        dz = G z + (z^T G)^T (the two transposes autodiff emits for
//        z z^T), dbottom = g[:, :d] + dz[0], row grads from dz[1:].
//
// Bound: memory.  At the run_random.sh shape (B = 256, cat, T = 8, d = 64,
// bag 1, bottom 64, width 576) the kernel reads g (589,824 B) and the ids
// (8,192 B) and writes the row grads (524,288 B) and dbottom (65,536 B),
// about 1.19 MB: 0.35 us at 3.35 TB/s, so the launch latency dominates.
// For dot it also reads the live rows and the bottom row again, and does
// 4 * F^2 * d flops per sample, far below the card's rate.
//
// Design: one thread block per sample, as the forward.  The block stages
// its ids in shared memory; for dot also z (rows padded to d + 1 floats so
// the column reads hit distinct banks), G and dz.  Each thread computes
// whole dot products of dz in f32 with fmaf, in the order j = 0..F-1, then
// the threads stride over the T * bag * d row grads so that neighbouring
// threads write neighbouring floats.  The TPU kernel's 8-sample blocks,
// its per-row DMA semaphores and its batch padding are TPU artefacts and
// are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) fused_interact_bwd_kernel(
    const float* __restrict__ table, const int32_t* __restrict__ gids,
    const float* __restrict__ bottom, const float* __restrict__ g,
    float* __restrict__ rowg, float* __restrict__ dbot, int num_tables,
    int bag, int dim, int bot_dim, long long num_rows, int width, int dot,
    int avg) {
  extern __shared__ float smem[];
  const int nslots = num_tables * bag;
  const int f = num_tables + 1;
  const int zs = dim + 1;
  int32_t* ids = reinterpret_cast<int32_t*>(smem);  // nslots
  float* z = smem + nslots;                         // f x zs   (dot)
  float* gm = z + f * zs;                           // f x f    (dot)
  float* dz = gm + f * f;                           // f x zs   (dot)
  const long long b = blockIdx.x;
  const float* my_g = g + b * width;
  float* my_rowg = rowg + b * nslots * dim;
  const float bag_f = static_cast<float>(bag);

  for (int s = threadIdx.x; s < nslots; s += blockDim.x)
    ids[s] = gids[b * nslots + s];

  if (!dot) {
    for (int k = threadIdx.x; k < bot_dim; k += blockDim.x)
      dbot[b * bot_dim + k] = my_g[k];
    __syncthreads();
    const int total = nslots * dim;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int s = i / dim;
      const int k = i - s * dim;
      const int t = s / bag;
      const long long id = ids[s];
      float v = my_g[bot_dim + t * dim + k];
      if (avg) v = v / bag_f;
      my_rowg[i] = (id >= 0 && id < num_rows) ? v : 0.f;
    }
    return;
  }

  // dot: bot_dim == dim
  const float* my_bottom = bottom + b * dim;
  for (int k = threadIdx.x; k < dim; k += blockDim.x) z[k] = my_bottom[k];
  for (int p = threadIdx.x; p < f * f; p += blockDim.x) gm[p] = my_g[dim + p];
  __syncthreads();

  // re-pool the live rows in the forward kernel's order
  for (int i = threadIdx.x; i < num_tables * dim; i += blockDim.x) {
    const int t = i / dim;
    const int k = i - t * dim;
    float acc = 0.f;
    for (int j = 0; j < bag; ++j) {
      const long long id = ids[t * bag + j];
      if (id >= 0 && id < num_rows) acc += __ldg(table + id * dim + k);
    }
    if (avg && bag > 0) acc = acc / bag_f;
    z[(t + 1) * zs + k] = acc;
  }
  __syncthreads();

  // dz = G z + (z^T G)^T
  for (int p = threadIdx.x; p < f * dim; p += blockDim.x) {
    const int i = p / dim;
    const int k = p - i * dim;
    float a1 = 0.f;
    float a2 = 0.f;
    for (int j = 0; j < f; ++j) {
      const float zjk = z[j * zs + k];
      a1 = fmaf(gm[i * f + j], zjk, a1);
      a2 = fmaf(zjk, gm[j * f + i], a2);
    }
    const float v = a1 + a2;
    if (i == 0) {
      dbot[b * dim + k] = my_g[k] + v;
    } else {
      dz[i * zs + k] = v;
    }
  }
  __syncthreads();

  const int total = nslots * dim;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int s = i / dim;
    const int k = i - s * dim;
    const int t = s / bag;
    const long long id = ids[s];
    float v = dz[(t + 1) * zs + k];
    if (avg) v = v / bag_f;
    my_rowg[i] = (id >= 0 && id < num_rows) ? v : 0.f;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  The caller checks shapes, dtypes and contiguity:
// table (num_rows, dim) f32, gids (batch, num_tables, bag) int32, bottom
// (batch, bot_dim) f32 with bot_dim == dim for dot, g (batch, width) f32;
// rowg (batch, num_tables, bag, dim) and dbot (batch, bot_dim) f32 outputs.
int ff_fused_interact_bwd(const void* table, const void* gids,
                          const void* bottom, const void* g, void* rowg,
                          void* dbot, int batch, int num_tables, int bag,
                          int dim, int bot_dim, long long num_rows, int dot,
                          int avg, void* stream) {
  if (batch <= 0) return 0;
  const int f = num_tables + 1;
  const int width = dot ? dim + f * f : bot_dim + num_tables * dim;
  const size_t smem =
      sizeof(int32_t) * num_tables * bag +
      (dot ? sizeof(float) * (2 * f * (dim + 1) + f * f) : 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_interact_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_interact_bwd_kernel<<<batch, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(gids),
      static_cast<const float*>(bottom), static_cast<const float*>(g),
      static_cast<float*>(rowg), static_cast<float*>(dbot), num_tables, bag,
      dim, bot_dim, num_rows, width, dot, avg);
  return static_cast<int>(cudaGetLastError());
}

const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
