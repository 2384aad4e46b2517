// Fused embedding-bag -> feature-interaction forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_kernel` in
// dlrm_flexflow_tpu/ops/pallas_fused_interact.py (wrapper
// `fused_interact_pallas`).  It computes the same function: gather rows of
// the fused (R, d) table by flat ids (an id < 0 or >= R reads nothing and
// pools as exact 0.0), pool each bag (sum, or sum then divide by the bag
// for avg; an empty bag pools to 0.0), then interact with the bottom-MLP
// output:
//   cat: out = [bottom, pooled.flat]                      width bot + T*d
//   dot: out = [bottom, flat(z z^T)], z = [bottom; pooled] width d + (T+1)^2
// with the dot operands optionally rounded to bf16 and f32 accumulation.
// The pooled (B, T, d) intermediate never reaches device memory.
//
// The ids come in one of two forms.  Pre-masked int32 flat ids (the
// wrapper `fused_interact_cuda`), or the op's own per-table local ids,
// int32 or int64, with the per-table offsets and row counts
// (`fused_embed_interact_cuda`): the kernel then applies
// `mask_local_ids`' rule itself, a local id is live iff
// 0 <= id < counts[t] and its flat id is id + offsets[t], and on request
// writes those masked int32 ids for the backward.  That folds the op's
// seven ATen launches of masking and casting into this one.
//
// Bound: memory.  A call reads the ids at their own width, the offsets
// and counts, the live rows of d floats and the bottom rows, and writes
// the output rows and any masked ids.  At the top serving bucket of the
// run_random.sh model (B = 256, T = 8, bag 1, d = 64, bottom 64, cat to
// 576, int64 local ids) that is 16,384 B of ids + 128 B of offsets and
// counts + 524,288 B of rows + 65,536 B of bottom read and 589,824 B
// written, about 1.20 MB: 0.36 us at 3.35 TB/s.  The dot product adds
// 2 d (T+1)^2 flops a sample, far below the card's f32 rate.
//
// Design: what costs time at these sizes is latency, so the kernel keeps
// a sample's loads in flight together.  One warp per sample, a block of
// 32 threads each (B = 256: 256 blocks over the 132 SMs).  The warp
// issues its ids' load (one coalesced load of T*bag ids, with the offsets
// and counts) and its bottom row's load together, stages the masked slot
// rows in shared memory, then issues every row of the sample before the
// first add waits on one (csrc/warp_pool.cuh: 16-byte loads where
// d % 4 == 0, a register chunk of 8 float4 or 16 floats a lane, chunked
// above that), and sums each bag in order j = 0..bag-1 in f32.  `cat`
// stores the pooled vectors straight into the output row; `dot` stages
// z in shared memory (rows padded to d+1 floats, so lanes reading
// different rows hit different banks, and rounded to bf16 there under
// bf16 compute) and each lane computes whole dot products of the upper
// triangle, two at a time, writing each to both halves.  The TPU
// kernel's 8-sample blocks, per-row DMA semaphores and batch padding are
// TPU artefacts and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_pool.cuh"

namespace {

// bottom floats a lane loads before its ids arrive (a bottom of <= 128)
constexpr int kBotEarly = 4;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_z(float* zrow, int c, float v,
                                        bool bf16) {
  zrow[c] = bf16 ? round_bf16(v) : v;
}

__device__ __forceinline__ void store_z(float* zrow, int c, float4 v,
                                        bool bf16) {
  float* p = zrow + 4 * c;
  p[0] = bf16 ? round_bf16(v.x) : v.x;
  p[1] = bf16 ? round_bf16(v.y) : v.y;
  p[2] = bf16 ? round_bf16(v.z) : v.z;
  p[3] = bf16 ? round_bf16(v.w) : v.w;
}

// pair p of the upper triangle (r <= c) of an f x f matrix, row-major
__device__ __forceinline__ void tri_pair(int p, int f, int& r, int& c) {
  r = 0;
  while (p >= f - r) {
    p -= f - r;
    ++r;
  }
  c = r + p;
}

template <typename V, typename IdT>
__global__ void __launch_bounds__(32) fused_interact_kernel(
    const float* __restrict__ table, const IdT* __restrict__ ids,
    const long long* __restrict__ offsets,
    const long long* __restrict__ counts, const float* __restrict__ bottom,
    float* __restrict__ out, int32_t* __restrict__ gids_out,
    int num_tables, int bag, int dim, int bot_dim, long long num_rows,
    int width, int dot, int avg, int bf16) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const long long b = blockIdx.x;
  const int nslots = num_tables * bag;
  int32_t* rows = reinterpret_cast<int32_t*>(smem);
  float* z = smem + nslots;  // (T+1) x (d+1), dot only
  const int zs = dim + 1;
  const IdT* my_ids = ids + b * nslots;
  const float* my_bottom = bottom + b * bot_dim;
  float* my_out = out + b * width;

  // 1. the first 32 slots' ids (with their tables' offsets and counts)
  //    and the first 128 bottom floats, all in flight together
  long long id0 = 0, off0 = 0, cnt0 = 0;
  if (lane < nslots) {
    id0 = static_cast<long long>(my_ids[lane]);
    if (offsets) {
      const int t = lane / bag;
      off0 = offsets[t];
      cnt0 = counts[t];
    }
  }
  float bv[kBotEarly];
#pragma unroll
  for (int i = 0; i < kBotEarly; ++i) {
    const int k = lane + 32 * i;
    bv[i] = k < bot_dim ? __ldg(my_bottom + k) : 0.f;
  }

  // 2. stage the slot rows: local ids masked by their table's count, or
  //    pre-masked flat ids; a slot reads a row iff 0 <= id < R
  auto stage = [&](int s, long long id, long long off, long long cnt) {
    long long g = id;
    if (offsets) g = (id >= 0 && id < cnt) ? id + off : -1;
    if (gids_out) gids_out[b * nslots + s] = static_cast<int32_t>(g);
    rows[s] = (g >= 0 && g < num_rows) ? static_cast<int32_t>(g) : -1;
  };
  if (lane < nslots) stage(lane, id0, off0, cnt0);
  for (int s = lane + 32; s < nslots; s += 32) {
    const int t = s / bag;
    stage(s, static_cast<long long>(my_ids[s]), offsets ? offsets[t] : 0,
          offsets ? counts[t] : 0);
  }

  // 3. the bottom row leads the output of both interactions
#pragma unroll
  for (int i = 0; i < kBotEarly; ++i) {
    const int k = lane + 32 * i;
    if (k < bot_dim) {
      my_out[k] = bv[i];
      if (dot) z[k] = bf16 ? round_bf16(bv[i]) : bv[i];
    }
  }
  for (int k = lane + 32 * kBotEarly; k < bot_dim; k += 32) {
    const float v = __ldg(my_bottom + k);
    my_out[k] = v;
    if (dot) z[k] = bf16 ? round_bf16(v) : v;
  }
  __syncwarp();

  // 4. gather and pool every bag, all of a sample's rows in flight
  const int nvec = sizeof(V) == 16 ? dim / 4 : dim;
  const bool pool_avg = avg && bag > 0;
  if (!dot) {
    V* pooled = reinterpret_cast<V*>(my_out + bot_dim);
    ffk::warp_gather_pool<V>(table, rows, num_tables, bag, nvec, 0.f,
                             pool_avg, static_cast<float>(bag), lane,
                             [&](int o, V v) { pooled[o] = v; });
    return;
  }
  ffk::warp_gather_pool<V>(
      table, rows, num_tables, bag, nvec, 0.f, pool_avg,
      static_cast<float>(bag), lane, [&](int o, V v) {
        const int t = o / nvec;
        store_z(z + (t + 1) * zs, o - t * nvec, v, bf16);
      });
  __syncwarp();

  // 5. z z^T: the upper triangle, two dot products a lane at a time
  const int f = num_tables + 1;
  const int npairs = f * (f + 1) / 2;
  float* zz = my_out + dim;
  for (int p0 = lane; p0 < npairs; p0 += 64) {
    const bool two = p0 + 32 < npairs;
    int r0, c0, r1, c1;
    tri_pair(p0, f, r0, c0);
    if (two) {
      tri_pair(p0 + 32, f, r1, c1);
    } else {
      r1 = r0;
      c1 = c0;
    }
    const float* a0 = z + r0 * zs;
    const float* b0 = z + c0 * zs;
    const float* a1 = z + r1 * zs;
    const float* b1 = z + c1 * zs;
    float s0 = 0.f, s1 = 0.f;
    // bf16 operands were rounded in z; bf16 * bf16 is exact in f32, so
    // the fma is the product plus an add
    for (int k = 0; k < dim; ++k) {
      s0 = fmaf(a0[k], b0[k], s0);
      s1 = fmaf(a1[k], b1[k], s1);
    }
    zz[r0 * f + c0] = s0;
    zz[c0 * f + r0] = s0;
    if (two) {
      zz[r1 * f + c1] = s1;
      zz[c1 * f + r1] = s1;
    }
  }
}

__global__ void empty_kernel() {}

template <typename V, typename IdT>
int launch(const void* table, const void* ids, const void* offsets,
           const void* counts, const void* bottom, void* out, void* gids_out,
           int batch, int num_tables, int bag, int dim, int bot_dim,
           long long num_rows, int dot, int avg, int bf16,
           cudaStream_t stream) {
  const int f = num_tables + 1;
  const int width = dot ? dim + f * f : bot_dim + num_tables * dim;
  const size_t smem =
      sizeof(float) * (num_tables * bag + (dot ? f * (dim + 1) : 0));
  auto kernel = fused_interact_kernel<V, IdT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<batch, 32, smem, stream>>>(
      static_cast<const float*>(table), static_cast<const IdT*>(ids),
      static_cast<const long long*>(offsets),
      static_cast<const long long*>(counts),
      static_cast<const float*>(bottom), static_cast<float*>(out),
      static_cast<int32_t*>(gids_out), num_tables, bag, dim, bot_dim,
      num_rows, width, dot, avg, bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  The caller checks shapes, dtypes and contiguity:
// table (num_rows, dim) f32; ids (batch, num_tables, bag), int64 when
// `ids64` else int32; bottom (batch, bot_dim) f32 with bot_dim == dim for
// dot; out (batch, width) f32.  With `offsets` and `counts` (num_tables
// int64 each) the ids are local and masked here, else they are flat ids;
// `gids_out` (batch, num_tables, bag) int32, or null, receives the masked
// flat ids.  `vec4` may be set only when dim % 4 == 0, the table is
// 16-byte aligned and, for cat, bot_dim % 4 == 0 and out is aligned.
int ff_fused_interact_fwd(const void* table, const void* ids, int ids64,
                          const void* offsets, const void* counts,
                          const void* bottom, void* out, void* gids_out,
                          int batch, int num_tables, int bag, int dim,
                          int bot_dim, long long num_rows, int dot, int avg,
                          int bf16, int vec4, void* stream) {
  if (batch <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
#define FF_FWD_LAUNCH(V, IdT)                                             \
  launch<V, IdT>(table, ids, offsets, counts, bottom, out, gids_out,      \
                 batch, num_tables, bag, dim, bot_dim, num_rows, dot, avg, \
                 bf16, s)
  if (vec4) return ids64 ? FF_FWD_LAUNCH(float4, long long)
                         : FF_FWD_LAUNCH(float4, int32_t);
  return ids64 ? FF_FWD_LAUNCH(float, long long)
               : FF_FWD_LAUNCH(float, int32_t);
#undef FF_FWD_LAUNCH
}

// An empty kernel of this library, one block of one warp: the floor under
// any launch of the forward, for timing.
int ff_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
