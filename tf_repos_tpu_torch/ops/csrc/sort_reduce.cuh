// Sort-and-reduce row scatter: the tile routine shared by K2
// accumulate_rows (sparse_rows.cu) and K4 coo_accumulate_rows
// (coo_pool.cu).
//
//   out[key[i], :] += row(i)   over the slots i of one tile
//
// A scatter-add with one atomicAdd per (slot, column) is bound on this
// card by the longest chain of atomics on one address, not by its bytes:
// same-address atomics serialise in L2 at about 4-5 ns a link, and under
// Zipf ids (or padding that piles onto row 0) the hottest row holds tens
// to hundreds of thousands of slots. This routine removes the chain
// inside a tile:
//   1. one block per tile of slots (2,048 for K2, 2,560 for K4) stages
//      the tile's keys, with dead slots (past the end, or refused by the
//      source) set to the sentinel s, which sorts last;
//   2. sorts the tile's (key, slot) pairs in shared memory with CUB's
//      block-level radix sort over only the bit length of s;
//   3. sums each run of equal key with a block-wide segmented scan, four
//      columns at a time, every slot's row read once (in sorted order);
//   4. adds each run's four sums into the zeroed output with Hopper's
//      vector reductions (row_ops.cuh's emit, sm_90): one float4 where
//      the row is 16-byte aligned (K % 4 == 0), else the float2 pairs
//      and single floats its alignment allows (K = 17);
//   5. skips an atomic whose sums are all exactly 0, which is exact for
//      finite inputs; a NaN or Inf sum still reaches the output.
// The longest chain on one address is then the number of tiles that hold
// its key, at most ceil(N / TILE). Nothing in shared memory grows with
// K, so one tile size serves every K < 4096; a wide row costs
// ceil(K / 4) scans a tile. A block's time is mostly the latency of its
// phases (sort passes, scans, barriers), so the time of a launch follows
// its waves of resident blocks (two a SM at these sizes): the tile sizes
// were settled on an H100 at the main paths' shapes.
//
// The sum order differs from a sequential sum, and the order in which
// the tiles' atomics land changes from run to run: results agree with
// the plain version to a float tolerance.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "row_ops.cuh"

namespace sort_reduce {

constexpr int THREADS = 256;
constexpr int RADIX_BITS = 6;             // key bits a sort pass ranks
constexpr int MIN_BLOCKS = 2;             // blocks an SM must hold at once

// The sentinel key: above every valid key (int32 ids are below 2^31).
inline unsigned sentinel(long long s) {
  return static_cast<unsigned>(s < 0x80000000LL ? s : 0x80000000LL);
}

// The bit length of the sentinel: every key of a tile fits in it.
inline int key_bits(unsigned sent) {
  int b = 0;
  while (b < 32 && (1ull << b) <= sent) ++b;
  return b;
}

// A partial segmented sum of four columns over a span of sorted slots:
// head is set when a run starts inside the span, and the sums run from
// the last such start (or from the span's start).
struct Seg {
  float x, y, z, w;
  int head;
};

struct SegSum {
  __device__ __forceinline__ Seg operator()(const Seg& a, const Seg& b) const {
    if (b.head) return b;
    return Seg{a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w, a.head};
  }
};

// One tile (blockIdx.x) of TILE = THREADS * ITEMS slots of the scatter,
// ITEMS slots a thread. Src supplies the slots' rows:
//   bool src.stage(j)      slot j of the tile is live; called once per
//                          slot before the sort
//   Src::Row src.at(j)     what a live slot j's row is read from; called
//                          once per slot after the sort
//   float4 src.row(r, c)   columns c..c+3 of that row, 0 past k
// keys: n slots, each in [0, s); sent = sentinel(s), bits = key_bits(sent);
// out: f32 [s, k], zeroed by the caller.
template <int ITEMS, class Src>
__device__ __forceinline__ void scatter_tile(const Src& src, const int* __restrict__ keys,
                                             long long n, unsigned sent, int bits, int k,
                                             float* __restrict__ out) {
  constexpr int TILE = THREADS * ITEMS;
  using Sort = cub::BlockRadixSort<unsigned, THREADS, ITEMS, int, RADIX_BITS>;
  using Scan = cub::BlockScan<Seg, THREADS, cub::BLOCK_SCAN_WARP_SCANS>;
  union TempStorage {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
  };
  __shared__ TempStorage tmp;
  __shared__ unsigned skey[TILE + 1];

  const long long t0 = static_cast<long long>(blockIdx.x) * TILE;
  const int rows = static_cast<int>(min(static_cast<long long>(TILE), n - t0));
  unsigned key[ITEMS];
  int slot[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {  // striped: coalesced key reads
    const int j = i * THREADS + threadIdx.x;
    slot[i] = j;
    key[i] = sent;
    if (j < rows) {
      const unsigned kj = static_cast<unsigned>(keys[t0 + j]);
      if (src.stage(j)) key[i] = kj;
    }
  }
  Sort(tmp.sort).Sort(key, slot, 0, bits);  // blocked: this thread holds p0..p0+ITEMS-1

  const int p0 = threadIdx.x * ITEMS;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) skey[p0 + i] = key[i];
  if (threadIdx.x == 0) skey[TILE] = sent;
  __syncthreads();
  unsigned heads = 0, tails = 0;  // bit i: sorted position p0 + i starts / ends a live run
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const unsigned prev = i > 0 ? key[i - 1] : (p0 > 0 ? skey[p0 - 1] : ~key[0]);
    const unsigned next = i + 1 < ITEMS ? key[i + 1] : skey[p0 + ITEMS];
    if (key[i] != prev) heads |= 1u << i;
    if (key[i] != next && key[i] < sent) tails |= 1u << i;
  }

  typename Src::Row at[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (key[i] < sent) at[i] = src.at(slot[i]);
  }

  for (int c = 0; c < k; c += 4) {
    float4 x[ITEMS];
    float4 acc;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      x[i] = key[i] < sent ? src.row(at[i], c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      acc = i == 0 || (heads >> i & 1u) ? x[i] : row_ops::add4(acc, x[i]);
    }
    // carry: the sums of the run still open where the previous thread
    // ends (undefined for thread 0, whose first slot starts a run)
    Seg carry;
    Scan(tmp.scan).ExclusiveScan(Seg{acc.x, acc.y, acc.z, acc.w, heads != 0u}, carry, SegSum());
    float4 run = make_float4(carry.x, carry.y, carry.z, carry.w);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      run = (heads >> i & 1u) ? x[i] : row_ops::add4(run, x[i]);
      if (tails >> i & 1u) {
        row_ops::emit(out + static_cast<long long>(key[i]) * k + c, k - c, run);
      }
    }
    __syncthreads();  // tmp.scan is reused by the next four columns
  }
}

}  // namespace sort_reduce
