// One warp gathers and pools one sample's bags: the core shared by the
// fused forward (csrc/fused_interact.cu) and the embedding bag
// (csrc/embedding_bag.cu).
//
// A sample has T bags of `bag` rows of a (R, d) f32 table.  Its slot rows
// (T * bag of them, table-major) are staged by the caller in shared
// memory, from one coalesced load of its ids: a row index, or -1 for a
// slot that fetches nothing and reads `fill`.  The T * d pooled outputs,
// counted in vectors of Vec (float4 when d % 4 == 0 and the table is
// 16-byte aligned, float otherwise), are dealt to the lanes round robin:
// lane l owns outputs l, l + 32, ...  At d = 64 with float4, lanes 0-15
// read 256 bytes of one row and lanes 16-31 the next row's, coalesced.
//
// Latency is what bounds these kernels at the main path's shapes (a few
// hundred KB per call): each dependent round trip to memory costs about
// as much as the whole call's bytes, and a warp's serial instruction
// chain counts too (rows resident in L2 save little over rows in device
// memory, chip_smoke.py's l2_table_ms).  So a lane walks its
// (output, j) items, output-major and bag-minor, in chunks of K: all K
// row loads of a chunk are issued into a register array before the first
// add waits on one, and the chunk's adds then run in bag order
// j = 0..bag-1 in f32, ((r0 + r1) + r2) + ..., as the plain versions sum.
// A bag longer than a chunk carries its partial sum into the next chunk.
// At the main path's shapes (T = 8, bag 1, d = 64: 4 items a lane; T = 1,
// bag 8, d = 128: 8 items) one chunk holds every row of the sample, so a
// sample costs two round trips: its ids, then all of its rows at once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ffk {

template <typename V>
__device__ __forceinline__ V splat(float x);
template <>
__device__ __forceinline__ float splat<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float4 splat<float4>(float x) {
  return make_float4(x, x, x, x);
}

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
// a true division, as the plain versions divide by the bag
__device__ __forceinline__ float vdiv(float a, float d) { return a / d; }
__device__ __forceinline__ float4 vdiv(float4 a, float d) {
  return make_float4(a.x / d, a.y / d, a.z / d, a.w / d);
}

// Row loads a lane keeps in flight: 8 float4 (32 registers) or 16 floats.
template <typename V>
struct Chunk {
  static constexpr int K = sizeof(V) == 16 ? 8 : 16;
};

// Pools one sample and calls sink(o, v) once for each output vector
// o in [0, T * nvec) that this lane owns, in increasing o: v is the sum
// of the bag's rows (or `fill`s) in bag order, divided by `div` when
// `avg`.  An empty bag (bag == 0) pools to 0.0 (then / div under avg).
template <typename V, typename Sink>
__device__ __forceinline__ void warp_gather_pool(
    const float* __restrict__ table, const int32_t* rows, int num_tables,
    int bag, int nvec, float fill, bool avg, float div, int lane,
    Sink sink) {
  constexpr int K = Chunk<V>::K;
  const int nout = num_tables * nvec;
  if (bag == 0) {
    for (int o = lane; o < nout; o += 32) {
      const V zero = splat<V>(0.f);
      sink(o, avg ? vdiv(zero, div) : zero);
    }
    return;
  }
  const int nitems = (nout > lane ? (nout - lane + 31) / 32 : 0) * bag;
  const V* tab = reinterpret_cast<const V*>(table);
  // issue cursor: the table and vector of its output, its bag slot
  int it = lane / nvec, ic = lane - (lane / nvec) * nvec, ij = 0;
  // consume cursor: the output and its bag slot
  int co = lane, cj = 0;
  V acc = splat<V>(0.f);
  for (int base = 0; base < nitems; base += K) {
    V r[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      r[k] = splat<V>(fill);
      if (base + k < nitems) {
        const int g = rows[it * bag + ij];
        if (g >= 0) r[k] = __ldg(tab + static_cast<long long>(g) * nvec + ic);
        if (++ij == bag) {
          ij = 0;
          ic += 32;
          while (ic >= nvec) {  // no division on the issue path
            ic -= nvec;
            ++it;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (base + k < nitems) {
        acc = cj == 0 ? r[k] : vadd(acc, r[k]);
        if (++cj == bag) {
          cj = 0;
          sink(co, avg ? vdiv(acc, div) : acc);
          co += 32;
        }
      }
    }
  }
}

}  // namespace ffk
