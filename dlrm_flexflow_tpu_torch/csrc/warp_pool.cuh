// One warp gathers and pools one sample's bags: the core shared by the
// fused forward (csrc/fused_interact.cu) and the embedding bag
// (csrc/embedding_bag.cu).
//
// A sample has T bags of `bag` rows of a (R, d) table, f32 or (the bag
// only) bf16.  Its slot rows
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
// A bf16 table is read as four bf16 values (8 bytes) a lane, widened to
// f32, and its sum is rounded to bf16 after every add and after the avg
// division, as the TPU bag kernel sums a bf16 bag in its bf16 scratch
// (pallas_embedding.py:61-66); f32 tables take no rounding step, so their
// instantiations are the code they were.
// At the main path's shapes (T = 8, bag 1, d = 64: 4 items a lane; T = 1,
// bag 8, d = 128: 8 items) one chunk holds every row of the sample, so a
// sample costs two round trips: its ids, then all of its rows at once.

#pragma once

#include <cuda_bf16.h>
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

// four bf16 values of a row, one 8-byte load
struct alignas(8) bf16x4 {
  __nv_bfloat162 lo, hi;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float4 round_bf16(float4 x) {
  return make_float4(round_bf16(x.x), round_bf16(x.y), round_bf16(x.z),
                     round_bf16(x.w));
}

// A table's storage vector S: the raw bits a load brings (Raw), the f32
// vector V they widen to and are summed in, the add and the avg division
// (rounded to S's precision), and the store.  The loads keep their raw
// bits in the lane's register chunk and widen only when added, so every
// load of a chunk is a plain load issued before the first add, for bf16
// as for f32 (for f32, Raw is V and widen is the identity).
template <typename S>
struct Elem;
template <>
struct Elem<float> {
  using V = float;
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ Raw raw_splat(float x) { return x; }
  static __device__ __forceinline__ V widen(Raw r) { return r; }
  static __device__ __forceinline__ V add(V a, V b) { return vadd(a, b); }
  static __device__ __forceinline__ V div(V a, float d) { return vdiv(a, d); }
  static __device__ __forceinline__ void store(float* p, V v) { *p = v; }
};
template <>
struct Elem<float4> {
  using V = float4;
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float4* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ Raw raw_splat(float x) {
    return splat<float4>(x);
  }
  static __device__ __forceinline__ V widen(Raw r) { return r; }
  static __device__ __forceinline__ V add(V a, V b) { return vadd(a, b); }
  static __device__ __forceinline__ V div(V a, float d) { return vdiv(a, d); }
  static __device__ __forceinline__ void store(float4* p, V v) { *p = v; }
};

// a bf16 value's f32, from its 16 bits in the low or the high half
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <>
struct Elem<__nv_bfloat16> {
  using V = float;
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ Raw raw_splat(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ V widen(Raw r) {
    return bf16_lo(static_cast<uint32_t>(r));
  }
  static __device__ __forceinline__ V add(V a, V b) {
    return round_bf16(a + b);
  }
  static __device__ __forceinline__ V div(V a, float d) {
    return round_bf16(a / d);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, V v) {
    *p = __float2bfloat16_rn(v);
  }
};
template <>
struct Elem<bf16x4> {
  using V = float4;
  using Raw = uint2;  // four bf16 values, the first in x's low half
  static __device__ __forceinline__ Raw load(const bf16x4* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ Raw raw_splat(float x) {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(x));
    return make_uint2(b | (b << 16), b | (b << 16));
  }
  static __device__ __forceinline__ V widen(Raw r) {
    return make_float4(bf16_lo(r.x), bf16_hi(r.x), bf16_lo(r.y),
                       bf16_hi(r.y));
  }
  static __device__ __forceinline__ V add(V a, V b) {
    return round_bf16(vadd(a, b));
  }
  static __device__ __forceinline__ V div(V a, float d) {
    return round_bf16(vdiv(a, d));
  }
  static __device__ __forceinline__ void store(bf16x4* p, V v) {
    bf16x4 h;
    h.lo = __floats2bfloat162_rn(v.x, v.y);
    h.hi = __floats2bfloat162_rn(v.z, v.w);
    *p = h;
  }
};

// Row loads a lane keeps in flight: 8 float4 (32 registers) or 16 floats.
template <typename V>
struct Chunk {
  static constexpr int K = sizeof(V) == 16 ? 8 : 16;
};

// Pools one sample and calls sink(o, v) once for each output vector
// o in [0, T * nvec) that this lane owns, in increasing o: v is the sum
// of the bag's rows (or `fill`s) in bag order, divided by `div` when
// `avg`.  An empty bag (bag == 0) pools to 0.0 (then / div under avg).
// S is the table's storage vector (float, float4, __nv_bfloat16 or
// bf16x4); v is its f32 vector Elem<S>::V.
template <typename S, typename Sink>
__device__ __forceinline__ void warp_gather_pool(
    const void* __restrict__ table, const int32_t* rows, int num_tables,
    int bag, int nvec, float fill, bool avg, float div, int lane,
    Sink sink) {
  using E = Elem<S>;
  using V = typename E::V;
  constexpr int K = Chunk<V>::K;
  const int nout = num_tables * nvec;
  if (bag == 0) {
    for (int o = lane; o < nout; o += 32) {
      const V zero = splat<V>(0.f);
      sink(o, avg ? E::div(zero, div) : zero);
    }
    return;
  }
  const int nitems = (nout > lane ? (nout - lane + 31) / 32 : 0) * bag;
  const S* tab = static_cast<const S*>(table);
  // issue cursor: the table and vector of its output, its bag slot
  int it = lane / nvec, ic = lane - (lane / nvec) * nvec, ij = 0;
  // consume cursor: the output and its bag slot
  int co = lane, cj = 0;
  V acc = splat<V>(0.f);
  for (int base = 0; base < nitems; base += K) {
    typename E::Raw r[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      r[k] = E::raw_splat(fill);
      if (base + k < nitems) {
        const int g = rows[it * bag + ij];
        if (g >= 0)
          r[k] = E::load(tab + static_cast<long long>(g) * nvec + ic);
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
        const V x = E::widen(r[k]);
        acc = cj == 0 ? x : E::add(acc, x);
        if (++cj == bag) {
          cj = 0;
          sink(co, avg ? E::div(acc, div) : acc);
          co += 32;
        }
      }
    }
  }
}

}  // namespace ffk
