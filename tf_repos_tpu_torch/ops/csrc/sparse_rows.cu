// Row expand and row accumulate for the lazy sparse embedding path.
//
// K1 expand_rows:      out[i, :] = table[idx[i], :]
//   Replaces the TPU kernel expand_rows (_expand_kernel) of the JAX
//   package's ops/pallas_sparse.py. On the TPU the compact [S, K] table was pinned in
//   VMEM and each row moved by a scalar-addressed vector load/store. On
//   Hopper the table (S*K*4 bytes, a few MB on the main path) stays in
//   the 50 MB L2 on its own, so the kernel is bound by the bytes it must
//   write to device memory: the [N, K] output plus the [N] index. Design:
//   one block per tile of ROWS_PER_TILE output rows; the block stages the
//   tile's indices in shared memory, then its threads walk the tile's
//   ROWS_PER_TILE*K output elements in order, so consecutive threads
//   store consecutive addresses (coalesced even though K = 17 is odd and
//   rows are not 16-byte aligned). Reads hit L2. The copy moves raw 2- or
//   4-byte words, so f32 and bf16 tables share one kernel and the result
//   is bit-exact.
//
// K2 accumulate_rows:  out[s, :] = sum over {i : idx[i] == s} of g[i, :]
//   Replaces accumulate_rows (_accumulate_kernel) of the JAX package's
//   ops/pallas_sparse.py and, by function, accumulate_rows_packed (the
//   TPU lane-packed layout of the same sum, which JAX runs above its
//   49,152-row VMEM cap). The TPU kept the [S, K] f32 accumulator in VMEM
//   and did ordered read-modify-writes. Here the accumulator is the
//   zeroed [S, K] output in device memory. Bound by bytes: the [N, K]
//   cotangent and the [N] index read once, the [S, K] output written
//   once. What held the first design back was the chain of atomics on
//   one address: one atomicAdd per (slot, column) serialises the hottest
//   row's slots in L2 (Zipf(1.2) ids put ~19% of the DeepFM lookup's
//   425,984 slots on one row; DIN's padding puts ~141K on row 0), so the
//   time followed that chain, as index_add_'s does. The kernel is now
//   sort_reduce.cuh's tile routine: one block per 2,048-slot tile sorts
//   its (idx, slot) pairs in shared memory, sums each run of equal idx
//   in registers, and issues one atomic per (run, four columns), none
//   for a sum of exactly 0 (the padded slots whose cotangent the model
//   zeroes). The chain on one address falls to the tiles that hold the
//   row.
//
// Plain C interface for ctypes. Every entry point launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sort_reduce.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_TILE = 256;

// j / k for 0 <= j < ROWS_PER_TILE * k (k < 4096): the float quotient of
// (j + 0.5) / k sits at least 0.5 / k away from an integer, far beyond
// the float rounding error at these magnitudes, so truncation is exact.
__device__ __forceinline__ int tile_row(int j, float inv_k) {
  return static_cast<int>((static_cast<float>(j) + 0.5f) * inv_k);
}

template <typename W>
__global__ void expand_rows_kernel(const W* __restrict__ table, long long ld,
                                   const int* __restrict__ idx, long long n,
                                   int k, float inv_k, W* __restrict__ out) {
  __shared__ long long row_off[ROWS_PER_TILE];
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS_PER_TILE;
  const int rows = static_cast<int>(min(static_cast<long long>(ROWS_PER_TILE), n - row0));
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    row_off[r] = static_cast<long long>(idx[row0 + r]) * ld;
  }
  __syncthreads();
  W* dst = out + row0 * k;
  const int elems = rows * k;
  for (int j = threadIdx.x; j < elems; j += blockDim.x) {
    const int r = tile_row(j, inv_k);
    const int c = j - r * k;
    dst[j] = table[row_off[r] + c];
  }
}

// K2: one tile of the sort-and-reduce scatter; a slot's row is g[slot].
template <typename G>
struct CotangentRows {
  const G* tile;  // the tile's first row of g
  int k;
  bool vec;  // k % 4 == 0 and g aligned for 4-column loads
  using Row = int;  // the row's offset in the tile
  __device__ __forceinline__ bool stage(int) const { return true; }
  __device__ __forceinline__ Row at(int j) const { return j * k; }
  __device__ __forceinline__ float4 row(Row r, int c) const {
    return row_ops::load4(tile + r + c, k - c, vec);
  }
};

constexpr int ACC_ITEMS = 8;  // K2: slots a thread sorts
constexpr int ACC_TILE = sort_reduce::THREADS * ACC_ITEMS;

template <typename G>
__global__ void __launch_bounds__(sort_reduce::THREADS, sort_reduce::MIN_BLOCKS)
accumulate_rows_kernel(const G* __restrict__ g, const int* __restrict__ idx, long long n, int k,
                       unsigned sent, int bits, bool vec_in, float* __restrict__ out) {
  const G* tile = g + static_cast<long long>(blockIdx.x) * ACC_TILE * k;
  sort_reduce::scatter_tile<ACC_ITEMS>(CotangentRows<G>{tile, k, vec_in}, idx, n, sent, bits, k,
                                       out);
}

inline unsigned int tiles(long long n) {
  return static_cast<unsigned int>((n + ROWS_PER_TILE - 1) / ROWS_PER_TILE);
}

}  // namespace

extern "C" {

// word_bytes: 4 (f32) or 2 (bf16) -- the copy is dtype-agnostic.
int tr_expand_rows(const void* table, long long ld, const int* idx, long long n,
                   int k, int word_bytes, void* out, void* stream) {
  if (n > 0) {
    const float inv_k = 1.0f / static_cast<float>(k);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (word_bytes == 4) {
      expand_rows_kernel<uint32_t><<<tiles(n), THREADS, 0, s>>>(
          static_cast<const uint32_t*>(table), ld, idx, n, k, inv_k,
          static_cast<uint32_t*>(out));
    } else if (word_bytes == 2) {
      expand_rows_kernel<uint16_t><<<tiles(n), THREADS, 0, s>>>(
          static_cast<const uint16_t*>(table), ld, idx, n, k, inv_k,
          static_cast<uint16_t*>(out));
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// g_is_bf16: 0 for an f32 cotangent, 1 for bf16; idx in [0, s). out is
// f32 [s, k] and must be zeroed by the caller.
int tr_accumulate_rows(const void* g, const int* idx, long long n, int k, long long s,
                       int g_is_bf16, float* out, void* stream) {
  if (n > 0 && s > 0) {
    const unsigned blocks = static_cast<unsigned>((n + ACC_TILE - 1) / ACC_TILE);
    const unsigned sent = sort_reduce::sentinel(s);
    const int bits = sort_reduce::key_bits(sent);
    const uintptr_t a = reinterpret_cast<uintptr_t>(g);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (g_is_bf16) {
      accumulate_rows_kernel<__nv_bfloat16><<<blocks, sort_reduce::THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(g), idx, n, k, sent, bits, k % 4 == 0 && a % 8 == 0,
          out);
    } else {
      accumulate_rows_kernel<float><<<blocks, sort_reduce::THREADS, 0, st>>>(
          static_cast<const float*>(g), idx, n, k, sent, bits, k % 4 == 0 && a % 16 == 0, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Slots a block of K2 takes.
int tr_accumulate_rows_tile() { return ACC_TILE; }

}  // extern "C"
