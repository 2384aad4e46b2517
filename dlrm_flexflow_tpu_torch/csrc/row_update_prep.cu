// Prepare-and-sort for the sorted row update, for Hopper (sm_90a):
//
//   key[k]  = id + R if -R <= id < 0;  id if 0 <= id < R;  R otherwise
//   keys    = key stably sorted (int32);  order = the slots in that order
//
// Replaces everything the JAX package does around the TPU row-update
// kernels before `_row_update_pallas` (dlrm_flexflow_tpu/ops/pallas_scatter.py,
// `sparse_row_update`): the flattening and int32 cast of the ids and the
// stable `jnp.argsort` that gives the kernel its ascending ids, together
// with the `.at[].add` id contract that the port's wrapper applies.  A
// dropped id (outside [-R, R), int32 min and every int64 beyond included)
// gets the key R, so the dropped slots sort after every live one and the
// update kernel stops at the first key >= R.  One launch does it all; the
// wrapper (ops/row_update_kernel.py) only allocates the outputs.
//
// Bound: memory, and far below the launch: the n ids are read once (4 or
// 8 B) and the keys and the order written once (8 B), 32 KB at the
// training step's n = 2048 int64 ids, about 0.01 us at 3.35 TB/s.  What
// the kernel pays is latency and issue inside one block: per pass, a rank
// step, a scan and two scatters, each behind a block barrier.
//
// Design: a stable LSD radix sort in one block, 8 bits a pass, one pass
// per byte of R's bit length (R = 8,000,000 needs 23 bits, three passes;
// R = 2^23 needs 24, also three; R = 255 one, R = 256 two).  A pass ranks
// each element among the earlier elements of its digit without atomics:
//   - the elements sit in a blocked layout, warp w holding positions
//     [w * 32 * ipt, (w + 1) * 32 * ipt), item i of lane l at
//     w * 32 * ipt + i * 32 + l, so position order is (warp, item, lane);
//   - per item, eight ballots (one per digit bit) give each lane the mask
//     of lanes holding its digit; a lane's rank is its warp's running
//     count of that digit plus the lanes of the mask below it, and the
//     mask's lowest lane adds the mask's size to the count (one writer per
//     address, ordered by __syncwarp);
//   - one block-wide exclusive scan over the counts in (digit, warp) order
//     gives each (digit, warp) its first destination;
//   - destination = that + rank: equal digits keep their position order,
//     so each pass is stable and so is the sort.
// Up to kOneTile = 4096 slots (the training step's 2048) one block of 16
// warps keeps the keys in registers and shared memory between passes and
// writes the sorted tile out coalesced.  Above, one block of 32 warps walks
// tiles of kTile = 8192 slots over two global buffers (the outputs and a
// scratch pair the wrapper allocates), ping-ponging so that the last pass
// lands in the outputs: per pass one histogram sweep, then one ranked
// scatter per tile with a running base per digit carried from tile to tile
// in order, which keeps the order stable across tiles.  At those sizes the
// buffers live in the 50 MB L2.
// Measured on an H100 (chip_smoke.py phase 9, n = 2048): a pass costs about
// 2.3 us over a fixed 2 us; __match_any_sync in place of the ballots was
// slower (it slows with the number of distinct digits in a warp), and so
// were 8 and 32 warps at n = 2048.  Not carried over: nothing of the TPU's
// argsort (XLA's); CUB's sorts are deliberately not used.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                   // items per thread, at most
constexpr int kTile = kThreads * kItems;    // slots one tile ranks
constexpr int kSmallWarps = 16;             // the one-tile block
constexpr int kOneTile = kSmallWarps * 32 * kItems;  // slots it sorts
constexpr int kBits = 8;
constexpr int kBins = 1 << kBits;
constexpr int kBinsPerLane = kBins / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t key_of(long long id, long long rows) {
  if (id < 0) id += rows;
  return (id >= 0 && id < rows) ? static_cast<int32_t>(id)
                                : static_cast<int32_t>(rows);
}

// Ranks this thread's items by digit within its warp (see the header),
// the warp's count of digit b at cnt_w[b * dstride]; with `rank` null it
// only counts.  Invalid items take no part.
__device__ __forceinline__ void rank_items(const int32_t* key,
                                           const bool* valid, int ipt,
                                           int shift, int* cnt_w,
                                           int dstride, int* rank) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (i >= ipt) break;
    // the valid lanes holding this lane's digit, one ballot per bit
    const int dig = (key[i] >> shift) & (kBins - 1);
    unsigned peers = __ballot_sync(kFull, valid[i]);
#pragma unroll
    for (int b = 0; b < kBits; ++b) {
      const bool bit = (dig >> b) & 1;
      const unsigned ones = __ballot_sync(kFull, bit);
      peers &= bit ? ones : ~ones;
    }
    int prev = 0;
    if (valid[i]) prev = cnt_w[dig * dstride];
    __syncwarp();
    if (valid[i]) {
      if (rank) rank[i] = prev + __popc(peers & below);
      if (lane == __ffs(peers) - 1)
        cnt_w[dig * dstride] = prev + __popc(peers);
    }
    __syncwarp();
  }
}

__device__ __forceinline__ void zero_row(int* cnt_w, int dstride) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kBinsPerLane; ++j)
    cnt_w[(lane + 32 * j) * dstride] = 0;
  __syncwarp();
}

// The counts sit digit-major, cnt[dig * (W + 1) + warp] (padded so that a
// warp's lanes fall in distinct banks), and one block-wide
// exclusive scan over them in (digit, warp) order gives every (digit,
// warp) its first destination: the digit's base plus the earlier warps'
// count.  Each thread scans 8 consecutive counts, warps by shuffles, the
// W warp totals by warp 0.
constexpr int kPerThread = 8;

constexpr int one_tile_bytes(int n) {
  return (kBins * (kSmallWarps + 1) + kSmallWarps) * 4 + 8 * n;
}

template <int W>
__device__ __forceinline__ void scan_counts(int* cnt, int* wtot) {
  static_assert(W % kPerThread == 0, "whole threads per digit");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kPerDigit = W / kPerThread;  // threads per digit
  int* c = cnt + (threadIdx.x / kPerDigit) * (W + 1) +
           (threadIdx.x % kPerDigit) * kPerThread;
  int v[kPerThread];
  int sum = 0;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    v[q] = c[q];
    sum += v[q];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < W ? wtot[lane] : 0;
    int w_incl = t;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(kFull, w_incl, off);
      if (lane >= off) w_incl += up;
    }
    if (lane < W) wtot[lane] = w_incl - t;
  }
  __syncthreads();
  int run = wtot[warp] + incl - sum;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    c[q] = run;
    run += v[q];
  }
}

// n <= kOneTile: one tile of kSmallWarps warps, the keys in registers and
// shared memory.
template <typename Id>
__global__ void __launch_bounds__(kSmallWarps * 32) prep_one_tile(
    const Id* __restrict__ ids, int n, long long rows, int passes,
    int32_t* __restrict__ keys_out, int32_t* __restrict__ order_out) {
  constexpr int W = kSmallWarps;
  constexpr int kPad = W + 1;
  extern __shared__ int smem[];
  int* cnt = smem;                    // kBins * kPad
  int* wtot = cnt + kBins * kPad;     // W
  int32_t* skey = wtot + W;
  int32_t* sval = skey + n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* cnt_w = cnt + warp;
  const int ipt = (n + W * 32 - 1) / (W * 32);
  int32_t key[kItems], val[kItems];
  int rank[kItems];
  bool valid[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    val[i] = warp * 32 * ipt + i * 32 + lane;
    valid[i] = i < ipt && val[i] < n;
    key[i] = valid[i] ? key_of(static_cast<long long>(ids[val[i]]), rows) : 0;
  }
  for (int p = 0; p < passes; ++p) {
    const int shift = p * kBits;
    zero_row(cnt_w, kPad);
    rank_items(key, valid, ipt, shift, cnt_w, kPad, rank);
    __syncthreads();
    scan_counts<W>(cnt, wtot);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (!valid[i]) continue;
      const int dig = (key[i] >> shift) & (kBins - 1);
      const int dst = cnt_w[dig * kPad] + rank[i];
      skey[dst] = key[i];
      sval[dst] = val[i];
    }
    __syncthreads();
    if (p == passes - 1) break;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (!valid[i]) continue;
      const int pos = warp * 32 * ipt + i * 32 + lane;
      key[i] = skey[pos];
      val[i] = sval[pos];
    }
    __syncthreads();
  }
  // the sorted tile, written out coalesced
  for (int i = threadIdx.x; i < n; i += W * 32) {
    keys_out[i] = skey[i];
    order_out[i] = sval[i];
  }
}

constexpr int kMaxDevices = 64;

// The one-tile block needs more than the default 48 KB of dynamic shared
// memory: the attribute is set once per device and instantiation.
template <typename Id>
int launch_one_tile(const Id* ids, int n, long long rows, int passes,
                    int32_t* keys, int32_t* order, cudaStream_t stream) {
  static bool attribute_set[kMaxDevices];  // a repeated set is harmless
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attribute_set[device]) {
    err = cudaFuncSetAttribute(prep_one_tile<Id>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               one_tile_bytes(kOneTile));
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set[device] = true;
  }
  prep_one_tile<Id><<<1, kSmallWarps * 32, one_tile_bytes(n), stream>>>(
      ids, n, rows, passes, keys, order);
  return static_cast<int>(cudaGetLastError());
}

// Loads tile `t` of pass `p`: from the raw ids on the first pass, else
// from the previous pass's buffers (written by this block: plain loads).
template <typename Id>
__device__ __forceinline__ void load_tile(
    const Id* ids, const int32_t* src_key, const int32_t* src_val, int p,
    int t, int n, long long rows, int32_t* key, int32_t* val, bool* valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pos = t * kTile + warp * 32 * kItems + i * 32 + lane;
    valid[i] = pos < n;
    if (!valid[i]) {
      key[i] = 0;
      val[i] = 0;
    } else if (p == 0) {
      key[i] = key_of(static_cast<long long>(ids[pos]), rows);
      val[i] = pos;
    } else {
      key[i] = src_key[pos];
      val[i] = src_val[pos];
    }
  }
}

// n > kOneTile: tiles over global buffers (see the header).
template <typename Id>
__global__ void __launch_bounds__(kThreads) prep_tiled(
    const Id* __restrict__ ids, int n, long long rows, int passes,
    int32_t* keys_out, int32_t* order_out, int32_t* keys_tmp,
    int32_t* order_tmp) {
  constexpr int kPad = kWarps + 1;
  extern __shared__ int smem[];
  int* cnt = smem;                      // kBins * kPad
  int* wtot = cnt + kBins * kPad;       // kWarps
  int* base = wtot + kWarps;            // kBins: each digit's next slot
  const int warp = threadIdx.x >> 5;
  int* cnt_w = cnt + warp;
  const int tiles = (n + kTile - 1) / kTile;
  int32_t key[kItems], val[kItems];
  int rank[kItems];
  bool valid[kItems];
  const int32_t* src_key = nullptr;
  const int32_t* src_val = nullptr;
  for (int p = 0; p < passes; ++p) {
    const int shift = p * kBits;
    const bool to_out = ((passes - 1 - p) & 1) == 0;
    int32_t* dst_key = to_out ? keys_out : keys_tmp;
    int32_t* dst_val = to_out ? order_out : order_tmp;
    // the pass's digit counted over every tile, scanned: each digit's
    // first slot
    zero_row(cnt_w, kPad);
    for (int t = 0; t < tiles; ++t) {
      load_tile(ids, src_key, src_val, p, t, n, rows, key, val, valid);
      rank_items(key, valid, kItems, shift, cnt_w, kPad, nullptr);
    }
    __syncthreads();
    scan_counts<kWarps>(cnt, wtot);
    __syncthreads();
    if (threadIdx.x < kBins) base[threadIdx.x] = cnt[threadIdx.x * kPad];
    __syncthreads();
    // ranked scatter, tile by tile in order: the tile's scan gives each
    // (digit, warp) its offset within the digit's share of the tile
    for (int t = 0; t < tiles; ++t) {
      zero_row(cnt_w, kPad);
      load_tile(ids, src_key, src_val, p, t, n, rows, key, val, valid);
      rank_items(key, valid, kItems, shift, cnt_w, kPad, rank);
      __syncthreads();
      scan_counts<kWarps>(cnt, wtot);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (!valid[i]) continue;
        const int dig = (key[i] >> shift) & (kBins - 1);
        const int dst =
            base[dig] + cnt_w[dig * kPad] - cnt[dig * kPad] + rank[i];
        dst_key[dst] = key[i];
        dst_val[dst] = val[i];
      }
      __syncthreads();
      if (threadIdx.x < kBins) {  // move each digit past this tile's share
        const int d = threadIdx.x;
        const int end = d + 1 < kBins ? cnt[(d + 1) * kPad]
                                      : min(kTile, n - t * kTile);
        base[d] += end - cnt[d * kPad];
      }
      __syncthreads();
    }
    src_key = dst_key;
    src_val = dst_val;
  }
}

template <typename Id>
int launch(const void* ids, int n, long long rows, void* keys, void* order,
           void* keys_tmp, void* order_tmp, cudaStream_t stream) {
  int bits = 0;
  while (bits < 63 && (rows >> bits) != 0) ++bits;  // bit length of R
  const int passes = bits > kBits ? (bits + kBits - 1) / kBits : 1;
  if (n <= kOneTile) {
    return launch_one_tile<Id>(
        static_cast<const Id*>(ids), n, rows, passes,
        static_cast<int32_t*>(keys), static_cast<int32_t*>(order), stream);
  }
  prep_tiled<Id><<<1, kThreads, (kBins * (kWarps + 1) + kWarps + kBins) * 4,
                   stream>>>(
      static_cast<const Id*>(ids), n, rows, passes,
      static_cast<int32_t*>(keys), static_cast<int32_t*>(order),
      static_cast<int32_t*>(keys_tmp), static_cast<int32_t*>(order_tmp));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Slots the one-tile block sorts: above it the wrapper passes scratch
// buffers.
int ff_row_update_prep_tile() { return kOneTile; }

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).  The caller checks devices and dtypes: ids (n,)
// contiguous, int64 when `ids64` else int32; keys and order (n,) int32;
// keys_tmp and order_tmp (n,) int32 when n > ff_row_update_prep_tile(),
// else unused; 0 < n < 2^31; 0 <= rows < 2^31.
int ff_row_update_prep(const void* ids, int ids64, int n, long long rows,
                       void* keys, void* order, void* keys_tmp,
                       void* order_tmp, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ids64 ? launch<int64_t>(ids, n, rows, keys, order, keys_tmp,
                                 order_tmp, s)
               : launch<int32_t>(ids, n, rows, keys, order, keys_tmp,
                                 order_tmp, s);
}

const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
