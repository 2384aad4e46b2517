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
// Bound: memory.  Each live slot reads its d elements and writes them
// once, plus the n ids.  At the run_random.sh epilogue (n = 131,072 rows
// of d = 64 f32 into the 8M-row table) that is 2 * n * 256 B + 4 n =
// 67.6 MB, 20.2 us at 3.35 TB/s; a ladder block writeback (n = 16,384
// into the 131,072-row epoch cache) moves 8.45 MB, 2.52 us.  bf16 rows
// halve both: 33.8 MB (10.1 us) and 4.26 MB (1.27 us).
//
// The rows are f32 or bf16, in the table's dtype (JAX casts them to it,
// pallas_scatter.py:538, and so does the wrapper): a pure data move of
// 4- or 2-byte elements, bit-exact, so the kernel copies a row as words
// and never looks at an element.
//
// Design: what bounds a copy at this size is the bytes in flight per SM
// (Little's law: 3.35 TB/s at ~0.7 us of loaded latency wants ~18 KB an
// SM), so every lane moves bytes and a tile of 32 rows waits on one id
// load, not one a row.
// - A warp owns tiles of 32 slots.  Their source rows are one contiguous
//   block of 32 * words words, and lane j moves words j, j + 32, j + 64,
//   ... of it: every lane works at any width (a pass of the warp covers
//   32 / words rows, 4 at d = 64 in bf16, 2 in f32; a row over 512 B
//   takes several passes), and the loads are fully coalesced.
// - The warp loads the tile's 32 ids in one coalesced load, one a lane,
//   and each word takes its row's id from the owning lane by
//   `__shfl_sync`.  The next tile's ids are loaded before this tile's
//   rows, so their round trip hides behind the row copy.
// - A thread issues all its loads of a tile (up to kRing words; 8 at
//   bf16 d = 64, 16 at f32) before its first store.  A dropped slot's
//   words are predicated off.  Source rows are read once: streaming
//   loads that skip L1 (`ld.global.nc.L1::no_allocate`).
// - The grid is sized to the card by the wrapper
//   (ops/row_set_kernel.py::row_set_plan): a grid-stride loop over tiles
//   with at most kMinBlocksPerSM blocks of 4 warps on each SM.
// The word is the widest of 16, 4 and 2 bytes that divides the row's
// bytes and both pointers.  The TPU kernel's 16-slot blocks of per-row
// async DMAs and their semaphores are TPU artefacts and are not carried
// over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;  // ops/row_set_kernel.py: WARPS_PER_BLOCK
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kMinBlocksPerSM = 4;  // ops/row_set_kernel.py: BLOCKS_PER_SM
constexpr int kRing = 16;  // words a thread holds in flight
constexpr unsigned kFull = 0xffffffffu;

// A word read once (a source row's, or an id): a streaming load that
// skips L1.  `volatile` and the memory clobber keep every load of a tile
// (and the next tile's ids) ahead of its first store: left free, the
// compiler sank each load to its store (30 registers, one word in
// flight a thread).
template <typename W>
__device__ __forceinline__ W load_once(const W* p);

template <>
__device__ __forceinline__ uint4 load_once(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

template <>
__device__ __forceinline__ uint32_t load_once(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

template <>
__device__ __forceinline__ uint16_t load_once(const uint16_t* p) {
  uint16_t v;
  asm volatile("ld.global.nc.L1::no_allocate.u16 %0, [%1];"
               : "=h"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ int32_t tile_id(const int32_t* __restrict__ ids,
                                           long long tile, int lane, int n) {
  const long long k = tile * 32 + lane;
  // a slot past n is dropped
  return k < n ? static_cast<int32_t>(
                     load_once(reinterpret_cast<const uint32_t*>(ids + k)))
               : -1;
}

// the word 32 further on in a tile of rows of `words` words: row r,
// column c advance by (32 / words, 32 % words) with a carry
__device__ __forceinline__ void advance(int& r, int& c, int dr, int dc,
                                        int words) {
  r += dr;
  c += dc;
  if (c >= words) {
    c -= words;
    ++r;
  }
}

// W: the copy word (uint4, uint32_t or uint16_t); a row is `words` of them
template <typename W>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM) row_set_kernel(
    W* __restrict__ table, const int32_t* __restrict__ ids,
    const W* __restrict__ rows, int n, int words, long long num_rows) {
  const int lane = threadIdx.x & 31;
  const long long tiles = (static_cast<long long>(n) + 31) / 32;
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  const int dr = 32 / words, dc = 32 % words;
  long long tile =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  int32_t next = tile_id(ids, tile, lane, n);
  for (; tile < tiles; tile += stride) {
    const int32_t id = next;
    next = tile_id(ids, tile + stride, lane, n);
    const W* src = rows + tile * 32 * words;
    int r = lane / words, c = lane % words;
    for (int base = 0; base < words; base += kRing) {
      W buf[kRing];
      int32_t dst[kRing];
      const int r0 = r, c0 = c;
#pragma unroll
      for (int i = 0; i < kRing; ++i) {
        dst[i] = -1;
        if (base + i < words) {  // the same on every lane, so is the shuffle
          const int32_t rid = __shfl_sync(kFull, id, r);  // r < 32 here
          if (rid >= 0 && rid < num_rows) {
            dst[i] = rid;
            buf[i] = load_once(src + (base + i) * 32LL + lane);
          }
          advance(r, c, dr, dc, words);
        }
      }
      r = r0;
      c = c0;
#pragma unroll
      for (int i = 0; i < kRing; ++i) {
        if (dst[i] >= 0)
          table[static_cast<long long>(dst[i]) * words + c] = buf[i];
        advance(r, c, dr, dc, words);
      }
    }
  }
}

template <typename W>
int launch(void* table, const void* ids, const void* rows, int n,
           int row_bytes, long long num_rows, int blocks,
           cudaStream_t stream) {
  row_set_kernel<W><<<blocks, kThreads, 0, stream>>>(
      static_cast<W*>(table), static_cast<const int32_t*>(ids),
      static_cast<const W*>(rows), n,
      row_bytes / static_cast<int>(sizeof(W)), num_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` with `blocks` blocks of 128 threads and
// returns cudaGetLastError() (0 when the launch was accepted).  The caller
// checks devices, dtypes and shapes: table (num_rows, d) contiguous; ids
// (n,) int32; rows (n, d) contiguous in the table's dtype; a row is
// `row_bytes` bytes.  `word` (16, 4 or 2) must divide row_bytes and both
// pointers' addresses.  ops/row_set_kernel.py::row_set_plan picks the word
// and the blocks.
int ff_row_set(void* table, const void* ids, const void* rows, int n,
               int row_bytes, long long num_rows, int word, int blocks,
               void* stream) {
  if (n <= 0 || row_bytes <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (word) {
    case 16:
      return launch<uint4>(table, ids, rows, n, row_bytes, num_rows, blocks,
                           s);
    case 4:
      return launch<uint32_t>(table, ids, rows, n, row_bytes, num_rows,
                              blocks, s);
    case 2:
      return launch<uint16_t>(table, ids, rows, n, row_bytes, num_rows,
                              blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
