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
// On request it also writes the scatter's ids, max(id, 0) as int32
// (B, T, bag): the JAX package's `safe` ids, from the ids it already
// holds, so the caller launches no clamp of its own.
//
// Bound: memory.  At the run_random.sh shape (B = 256, cat, T = 8, d = 64,
// bag 1, bottom 64, width 576) the kernel reads g (589,824 B) and the ids
// (8,192 B) and writes the row grads (524,288 B) and dbottom (65,536 B),
// about 1.19 MB: 0.36 us at 3.35 TB/s, below one launch's latency.  For
// dot it also reads the live rows and the bottom row again, and does
// 4 * F^2 * d flops per sample, far below the card's rate.
//
// Design: latency is what costs time at these sizes, so the kernel keeps
// a sample's loads in flight together, as the forward does
// (csrc/warp_pool.cuh).  One warp per sample, a block of 32 threads each.
//   cat: one round trip.  A lane issues its id load (slots lane, lane +
//   32, ...), every float4 of g[:, bot:] it owns (outputs lane, lane + 32,
//   ...: at d = 64, T = 8, four a lane) and its float4s of g[:, :bot]
//   before its first store.  The ids reach the other lanes as live bits,
//   one warp ballot per 32 slots (a register word for the first 32, a
//   shared word for each later pass), not through shared memory behind a
//   block barrier.  Each g vector is then stored `bag` times, output-major
//   and bag-minor, with its slot's live bit applied; a cursor walks
//   (table, vector) with no integer division.  16-byte accesses where
//   d % 4 == 0, bot % 4 == 0 and the pointers are 16-byte aligned, and the
//   same code on single floats otherwise.
//   dot: the ids, the bottom row, g[:, :d] and G load together; the masked
//   slot rows go to shared memory and ffk::warp_gather_pool re-pools z's
//   table rows with every row of the sample in flight, summing each bag in
//   the forward's order.  z sits in shared memory with rows padded by four
//   floats (16-byte float4 stores, column reads on distinct banks), and G
//   twice, as is and transposed, rows padded to a multiple of 12.  Each
//   lane then forms the dz entries of two of z's columns, 12 rows in one
//   pass over j, from float4 broadcast reads of G: 48 independent fma
//   chains (dz_columns), each in the order j = 0..F-1 with fmaf, then
//   a1 + a2, into shared memory, from where they go out as vectors
//   through the cat stores' loop.  One warp runs a sample's code alone,
//   so the instruction count on its path, not bytes, sets the dot time.
//   Only __syncwarp() separates the phases.
// The TPU kernel's 8-sample blocks, its per-row DMA semaphores and its
// batch padding are TPU artefacts and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_pool.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// floats (dot: bottom, g[:, :d], G) or vectors (cat: g[:, :bot]) a lane
// loads before its ids arrive; longer rows finish in a loop
constexpr int kEarly = 4;

__device__ __forceinline__ void store_z(float* zrow, int c, float v) {
  zrow[c] = v;
}
__device__ __forceinline__ void store_z(float* zrow, int c, float4 v) {
  reinterpret_cast<float4*>(zrow)[c] = v;
}

// z's row stride in floats: a multiple of 4 (aligned float4 stores), four
// floats past the row so that consecutive rows start on other banks
__host__ __device__ __forceinline__ int z_stride(int dim) {
  return (dim + 3) / 4 * 4 + 4;
}

// Rows of dz a lane forms in one pass over j, and the multiple G's rows
// are padded to in shared memory (three float4s): at T = 8 (F = 9) one
// pass forms every row.
constexpr int kRows = 12;

__host__ __device__ __forceinline__ int g_stride(int f) {
  return (f + kRows - 1) / kRows * kRows;
}

// dz = G z + (z^T G)^T for one sample, F x d.  A lane takes columns c and
// c + 32 of z (c = lane, lane + 64, ...) and kRows rows i of dz at a time:
// for each j it reads z[j][c], z[j][c + 32] and, by broadcast,
// G[j][i..i+kRows) (gm) and G[i..i+kRows)[j] (gt, G transposed) as float4s,
// and advances 4 * kRows independent fma chains.  Each entry is
// sum_j fmaf(G[i][j], z[j][c]) and sum_j fmaf(z[j][c], G[j][i]) in the
// order j = 0..F-1, then their sum, as the plain version's two products
// are formed, into dz (F x zs, shared).  Rows past F (the padding of gm
// and gt) are computed and dropped.
__device__ __forceinline__ void dz_columns(const float* z, const float* gm,
                                           const float* gt, float* dz, int f,
                                           int zs, int dim, int lane) {
  constexpr int kQ = kRows / 4;
  const int gs4 = g_stride(f) / 4;
  const float4* gm4 = reinterpret_cast<const float4*>(gm);
  const float4* gt4 = reinterpret_cast<const float4*>(gt);
  for (int c0 = lane; c0 < dim; c0 += 64) {
    const int c1 = c0 + 32;
    const bool has1 = c1 < dim;
    for (int i0 = 0; i0 < f; i0 += kRows) {
      float a1[kRows], a2[kRows], b1[kRows], b2[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) a1[r] = a2[r] = b1[r] = b2[r] = 0.f;
#pragma unroll 3
      for (int j = 0; j < f; ++j) {
        const float x0 = z[j * zs + c0];
        const float x1 = has1 ? z[j * zs + c1] : 0.f;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float4 r4 = gt4[j * gs4 + i0 / 4 + q];  // G[i0 + 4q + r][j]
          const float4 c4 = gm4[j * gs4 + i0 / 4 + q];  // G[j][i0 + 4q + r]
          const float gr[4] = {r4.x, r4.y, r4.z, r4.w};
          const float gc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = 4 * q + r;
            a1[e] = fmaf(gr[r], x0, a1[e]);
            a2[e] = fmaf(x0, gc[r], a2[e]);
            b1[e] = fmaf(gr[r], x1, b1[e]);
            b2[e] = fmaf(x1, gc[r], b2[e]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (i0 + r < f) {
          dz[(i0 + r) * zs + c0] = a1[r] + a2[r];
          if (has1) dz[(i0 + r) * zs + c1] = b1[r] + b2[r];
        }
      }
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(32) fused_interact_bwd_kernel(
    const float* __restrict__ table, const int32_t* __restrict__ gids,
    const float* __restrict__ bottom, const float* __restrict__ g,
    float* __restrict__ rowg, float* __restrict__ dbot,
    int32_t* __restrict__ safe, int num_tables, int bag, int dim,
    int bot_dim, long long num_rows, int width, int dot, int avg) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int kVec = sizeof(V) / sizeof(float);
  const int lane = threadIdx.x;
  const long long b = blockIdx.x;
  const int nslots = num_tables * bag;
  const int npass = (nslots + 31) / 32;
  const int f = num_tables + 1;
  const int zs = z_stride(dim);
  // dot: z and dz (f x zs each), G and G transposed (f x gs each),
  // g[:, :d] (d), the slot rows (nslots), then the live words; cat: the
  // live words only.  Word p holds pass p (p >= 1) when there is more
  // than one pass.
  const int gs = g_stride(f);
  float* z = smem;
  float* dz = z + f * zs;
  float* gm = dz + f * zs;
  float* gt = gm + f * gs;
  float* gh = gt + f * gs;
  int32_t* rows = reinterpret_cast<int32_t*>(gh + dim);
  uint32_t* words = dot ? reinterpret_cast<uint32_t*>(rows + nslots)
                        : reinterpret_cast<uint32_t*>(smem);
  const int32_t* my_ids = gids + b * nslots;
  const float* my_g = g + b * width;
  const float bag_f = static_cast<float>(bag);

  // 1. the first 32 slots' ids, in flight with the loads below
  const int32_t id0 = lane < nslots ? my_ids[lane] : 0;

  // The live bits of slots 32p .. 32p + 31, one ballot per pass: the
  // first word stays in a register, later ones go to shared memory.  A
  // slot reads (dot) or receives a gradient iff 0 <= id < R.  Each lane
  // writes its slots' safe ids and, for dot, the masked slot rows.
  uint32_t live0 = 0;
  auto vote = [&]() {
    for (int p = 0; p < npass; ++p) {
      const int s = 32 * p + lane;
      const int32_t id = p == 0 ? id0 : (s < nslots ? my_ids[s] : 0);
      const bool lv = s < nslots && id >= 0 && id < num_rows;
      const uint32_t w = __ballot_sync(kFull, lv);
      if (p == 0) live0 = w;
      else if (lane == 0) words[p] = w;
      if (s < nslots) {
        if (safe) safe[b * nslots + s] = id > 0 ? id : 0;
        if (dot) rows[s] = lv ? id : -1;
      }
    }
    __syncwarp();
  };
  auto live = [&](int s) -> bool {
    const uint32_t w = s < 32 ? live0 : words[s >> 5];
    return (w >> (s & 31)) & 1u;
  };
  // The row grads go out output-major and bag-minor: this lane's output
  // vectors o = lane, lane + 32, ... (table t, vector c of its row), in
  // order, each to its bag's rows, divided by the bag under avg, exact
  // 0.0 at dropped slots.  A cursor walks (t, c) with no integer division.
  const int nvec = dim / kVec;  // vectors of one table row
  V* rv = reinterpret_cast<V*>(rowg + b * nslots * dim);
  int ct = lane / nvec, cc = lane - (lane / nvec) * nvec;
  auto store_next = [&](V v) {
    const V w = avg ? ffk::vdiv(v, bag_f) : v;
    const int s0 = ct * bag;
#pragma unroll 1
    for (int j = 0; j < bag; ++j)
      rv[static_cast<long long>(s0 + j) * nvec + cc] =
          live(s0 + j) ? w : ffk::splat<V>(0.f);
    cc += 32;
    while (cc >= nvec) {
      cc -= nvec;
      ++ct;
    }
  };

  if (!dot) {
    // 2. cat: every g vector of the first chunk and the first dbottom
    //    vectors in flight with the ids
    constexpr int K = ffk::Chunk<V>::K;
    const int nout = num_tables * nvec;        // this sample's g[:, bot:]
    const int nbv = bot_dim / kVec;            // vectors of g[:, :bot]
    const V* gv = reinterpret_cast<const V*>(my_g);
    const V* gp = gv + nbv;
    V* dv = reinterpret_cast<V*>(dbot + b * bot_dim);
    const int mine = nout > lane ? (nout - lane + 31) / 32 : 0;
    const int chunk0 = bag > 0 ? (mine < K ? mine : K) : 0;
    V r[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < chunk0) r[k] = __ldg(gp + lane + 32 * k);
    V bv[kEarly];
#pragma unroll
    for (int i = 0; i < kEarly; ++i)
      if (lane + 32 * i < nbv) bv[i] = __ldg(gv + lane + 32 * i);

    vote();
#pragma unroll
    for (int i = 0; i < kEarly; ++i)
      if (lane + 32 * i < nbv) dv[lane + 32 * i] = bv[i];
    for (int o = lane + 32 * kEarly; o < nbv; o += 32) dv[o] = __ldg(gv + o);
    if (bag == 0) return;

    // 3. each g vector to its bag's row grads
    for (int base = 0; base < mine; base += K) {
      if (base > 0) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (base + k < mine) r[k] = __ldg(gp + lane + 32 * (base + k));
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (base + k < mine) store_next(r[k]);
      }
    }
    return;
  }

  // 2. dot: the bottom row, g[:, :d] and G in flight with the ids
  const float* my_bottom = bottom + b * dim;
  const int ff = f * f;
  float bv[kEarly], hv[kEarly], gvv[kEarly];
#pragma unroll
  for (int i = 0; i < kEarly; ++i) {
    const int k = lane + 32 * i;
    bv[i] = k < dim ? __ldg(my_bottom + k) : 0.f;
    hv[i] = k < dim ? __ldg(my_g + k) : 0.f;
    gvv[i] = k < ff ? __ldg(my_g + dim + k) : 0.f;
  }
  // G[r][c] (entry k = r * f + c) to gm[r][c] and gt[c][r], walked by a
  // cursor (r, c) with no division past the first
  int gr = lane / f, gc = lane - (lane / f) * f;
  auto stage_g = [&](float v) {
    gm[gr * gs + gc] = v;
    gt[gc * gs + gr] = v;
    gc += 32;
    while (gc >= f) {
      gc -= f;
      ++gr;
    }
  };
#pragma unroll
  for (int i = 0; i < kEarly; ++i) {
    const int k = lane + 32 * i;
    if (k < dim) {
      z[k] = bv[i];
      gh[k] = hv[i];
    }
    if (k < ff) stage_g(gvv[i]);
  }
  for (int k = lane + 32 * kEarly; k < dim; k += 32) {
    z[k] = __ldg(my_bottom + k);
    gh[k] = __ldg(my_g + k);
  }
  for (int k = lane + 32 * kEarly; k < ff; k += 32)
    stage_g(__ldg(my_g + dim + k));
  vote();

  // 3. re-pool z's table rows, every row of the sample in flight
  int st = lane / nvec, sc = lane - (lane / nvec) * nvec;  // sink cursor
  ffk::warp_gather_pool<V>(
      table, rows, num_tables, bag, nvec, 0.f, avg && bag > 0, bag_f, lane,
      [&](int, V v) {
        store_z(z + (st + 1) * zs, sc, v);
        sc += 32;
        while (sc >= nvec) {
          sc -= nvec;
          ++st;
        }
      });
  __syncwarp();

  // 4. dz = G z + (z^T G)^T into shared memory (dz_columns)
  dz_columns(z, gm, gt, dz, f, zs, dim, lane);
  __syncwarp();

  // 5. dbottom = g[:, :d] + dz[0]; dz's rows 1..T to the row grads
  const V* ghv = reinterpret_cast<const V*>(gh);
  const V* dzv = reinterpret_cast<const V*>(dz);
  V* dv = reinterpret_cast<V*>(dbot + b * dim);
  for (int o = lane; o < nvec; o += 32) dv[o] = ffk::vadd(ghv[o], dzv[o]);
  const int zsv = zs / kVec;
#pragma unroll 1
  for (int o = lane; o < num_tables * nvec; o += 32)
    store_next(dzv[(ct + 1) * zsv + cc]);
}

template <typename V>
int launch(const void* table, const void* gids, const void* bottom,
           const void* g, void* rowg, void* dbot, void* safe, int batch,
           int num_tables, int bag, int dim, int bot_dim, long long num_rows,
           int dot, int avg, cudaStream_t stream) {
  const int f = num_tables + 1;
  const int nslots = num_tables * bag;
  const int width = dot ? dim + f * f : bot_dim + num_tables * dim;
  const int words = nslots > 32 ? (nslots + 31) / 32 : 0;  // word 0 unused
  const size_t smem =
      dot ? sizeof(float) * (2 * f * z_stride(dim) + 2 * f * g_stride(f) +
                             dim + nslots + words)
          : sizeof(uint32_t) * words;
  auto kernel = fused_interact_bwd_kernel<V>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<batch, 32, smem, stream>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(gids),
      static_cast<const float*>(bottom), static_cast<const float*>(g),
      static_cast<float*>(rowg), static_cast<float*>(dbot),
      static_cast<int32_t*>(safe), num_tables, bag, dim, bot_dim, num_rows,
      width, dot, avg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  The caller checks shapes, dtypes and contiguity:
// table (num_rows, dim) f32, gids (batch, num_tables, bag) int32, bottom
// (batch, bot_dim) f32 with bot_dim == dim for dot, g (batch, width) f32;
// rowg (batch, num_tables, bag, dim) and dbot (batch, bot_dim) f32
// outputs; `safe` (batch, num_tables, bag) int32, or null, receives
// max(gids, 0).  `vec4` may be set only when dim % 4 == 0 and, for dot,
// the table is 16-byte aligned, or, for cat, bot_dim % 4 == 0 and g, rowg
// and dbot are 16-byte aligned.
int ff_fused_interact_bwd(const void* table, const void* gids,
                          const void* bottom, const void* g, void* rowg,
                          void* dbot, void* safe, int batch, int num_tables,
                          int bag, int dim, int bot_dim, long long num_rows,
                          int dot, int avg, int vec4, void* stream) {
  if (batch <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (vec4)
    return launch<float4>(table, gids, bottom, g, rowg, dbot, safe, batch,
                          num_tables, bag, dim, bot_dim, num_rows, dot, avg,
                          s);
  return launch<float>(table, gids, bottom, g, rowg, dbot, safe, batch,
                       num_tables, bag, dim, bot_dim, num_rows, dot, avg, s);
}

const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
