// Row expand and row accumulate for the lazy sparse embedding path.
//
// K1 expand_rows:      out[i, :] = table[idx[i], :]
//   Replaces the TPU kernel expand_rows (_expand_kernel) of the JAX
//   package's ops/pallas_sparse.py. On the TPU the compact [S, K] table
//   was pinned in VMEM and each row moved by a scalar-addressed vector
//   load/store. On Hopper the gather is a copy: its bound is the bytes of
//   the ids, the distinct rows read and the [N, K] output, moved once.
//   What sets its time depends on N:
//   - at the serving sizes (N = 13,312 ids of 68-byte rows, 0.9 MB out)
//     launch latency and two dependent memory round trips (the id, then
//     its row) set it, far above the 0.33 us bytes bound; the first
//     design gave such a launch 52 blocks of 256 rows for 132 SMs and
//     each thread a chain of 17 loads;
//   - from ~5 MB out (the ESMM point, the [4.5M, 16] serving table, the
//     DIN COO lookup, DeepFM training) the bytes set it, and the number
//     of memory instructions a byte costs.
//   Design:
//   - the grid fills the card: rows per block from N and the SM count
//     (queried once per device and cached), so a launch has at least
//     BLOCKS_PER_SM blocks an SM even at N = 13,312 (262 blocks where
//     the first design had 52), and at large N a block copies
//     THREAD_BYTES of rows a thread;
//   - each block stages its rows' offsets (id * row stride, 64-bit) in
//     shared memory, then walks its output row-major: thread t takes
//     items t, t + THREADS, ..., with unroll<W>() loads in flight before
//     their stores; the (row, column) of the next item is carried by
//     adding (THREADS / k, THREADS % k), so no item divides;
//   - a 16-byte path: when K and the row stride are whole 16-byte
//     chunks and both base pointers are 16-byte aligned (K = 16 in f32,
//     a [S, 3K] store's w columns at stride 48 or 128, the [4.5M, 16]
//     table), an item is one uint4 chunk of a row (4 f32 or 8 bf16
//     words): neighbouring lanes copy neighbouring chunks, a quarter of
//     the memory instructions of 4-byte words. Every other table (K = 17,
//     a view such as su[:, 1:17], an odd stride) takes the same walk over
//     2- or 4-byte words. Both copy raw words, so f32 and bf16 share the
//     kernels and the result is bit-exact;
//   - streaming stores (st.global.cs): the output is written once, so its
//     lines, not the table's, leave L2 first (beside plain stores in one
//     call: DeepFM training 0.0151 -> 0.0132 ms, the DIN COO lookup
//     0.0380 -> 0.0367);
//   - the serving entry, tr_expand_rows_clamped, reads int32 or int64
//     ids in place (rows of ids_cols ids, ids_ld apart: DeepFM's dynamic
//     fields are the view ids[:, 13:]) and applies JAX's gather rule to
//     each (add V once to a negative id, then clamp to [0, V-1], in
//     64-bit), so a serving gather is this one launch. The training entry
//     takes a contiguous int32 idx in [0, S) and clamps nothing, so a
//     mapper fault is not hidden.
//   Times, ms (NVIDIA H100 80GB HBM3, 700 W; the first design -> this
//   one in one call of scripts/torch_kernel_ab.py --source=sparse_rows):
//   DeepFM serving, N = 13,312 of K = 17: 0.0055 -> 0.0032 (an empty
//   launch is 0.0017); ESMM/DIN serving, N = 164,736 of K = 16 over
//   [4.5M, 16]: 0.0072 -> 0.0055; the DIN COO lookup, N = 1.31M at
//   stride 48: 0.0426 -> 0.0366; the ESMM point, N = 57,344: 0.0053 ->
//   0.0036; DeepFM training, N = 425,984 of K = 17 at stride 51: 0.0148
//   -> 0.0130. The whole serving gather (normalize_ids's four launches,
//   and for DeepFM a copy of the ids view, before K1 -> the one launch):
//   0.0162 -> 0.0035 (DeepFM), 0.0164 -> 0.0057 (ESMM/DIN).
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

#include <algorithm>

#include "sort_reduce.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 2;  // K1: the fewest blocks an SM gets, when N allows
constexpr int THREAD_BYTES = 64;  // K1: row bytes a thread copies at large N
constexpr int MAX_ROWS = 1024;    // K1: rows a block stages
constexpr int MAX_DEVICES = 64;

// K1: items a thread has in flight, 64 bytes of 16-byte chunks or 32 of
// words
template <typename W>
__host__ __device__ constexpr int unroll() { return sizeof(W) >= 16 ? 4 : 8; }

// The SM count of the current device, queried once per device.
cudaError_t sm_count(int* out) {
  static int counts[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < MAX_DEVICES && counts[dev] > 0) {
    *out = counts[dev];
    return cudaSuccess;
  }
  int c = 0;
  e = cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < MAX_DEVICES) counts[dev] = c;
  *out = c;
  return cudaSuccess;
}

// K1's ids: output row i reads the id at (i / cols) * ld + i % cols (one
// contiguous run: cols = ld = n). CLAMP applies JAX's gather rule for a
// [v, ...] table: add v once to a negative id, then clamp to [0, v-1].
template <typename Id, bool CLAMP>
struct Ids {
  const Id* p;
  long long cols, ld, v;
  __device__ __forceinline__ long long row(long long i) const {
    const long long at = cols == ld ? i : (i / cols) * ld + i % cols;
    long long x = static_cast<long long>(p[at]);
    if (CLAMP) {
      if (x < 0) x += v;
      x = x < 0 ? 0 : (x >= v ? v - 1 : x);
    }
    return x;
  }
};

// One block copies rows_per_block output rows of k words W (a 2- or
// 4-byte word, or a 16-byte uint4 chunk); ld is the table's row stride
// in W.
template <typename W, typename I>
__global__ void __launch_bounds__(THREADS)
expand_rows_kernel(const W* __restrict__ table, long long ld, I ids, long long n, int k,
                   int rows_per_block, W* __restrict__ out) {
  __shared__ long long row_off[MAX_ROWS];
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(min(static_cast<long long>(rows_per_block), n - row0));
  for (int r = threadIdx.x; r < rows; r += THREADS) row_off[r] = ids.row(row0 + r) * ld;
  __syncthreads();
  W* dst = out + row0 * k;
  const int items = rows * k;  // <= max(THREADS * THREAD_BYTES / sizeof(W), k)
  // item j is (row j / k, column j % k); the next item a thread takes
  // is THREADS further: carried, not divided
  const int dr = THREADS / k, dc = THREADS % k;
  int j = threadIdx.x;
  int r = j / k, c = j - r * k;
  constexpr int UNROLL = unroll<W>();
  while (j < items) {
    W val[UNROLL];
    int at[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      at[u] = j;
      if (j < items) val[u] = __ldg(table + row_off[r] + c);
      j += THREADS;
      r += dr;
      c += dc;
      if (c >= k) {
        c -= k;
        ++r;
      }
    }
    // streaming stores: the output is written once and not read here, so
    // its lines go first when L2 is full, not the table's
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (at[u] < items) __stcs(dst + at[u], val[u]);
    }
  }
}

template <typename W, typename I>
int launch_expand(const void* table, long long ld, I ids, long long n, int k, void* out,
                  cudaStream_t s) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  // THREAD_BYTES of rows a thread, or fewer rows, so that the launch has
  // BLOCKS_PER_SM blocks an SM
  const long long fill = (n + static_cast<long long>(BLOCKS_PER_SM) * sms - 1) /
                         (static_cast<long long>(BLOCKS_PER_SM) * sms);
  const int row_bytes = k * static_cast<int>(sizeof(W));
  const int most = std::min(MAX_ROWS, std::max(1, THREADS * THREAD_BYTES / row_bytes));
  const int rows = static_cast<int>(std::max(1LL, std::min(fill, static_cast<long long>(most))));
  const long long blocks = (n + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  expand_rows_kernel<W, I><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<const W*>(table), ld, ids, n, k, rows, static_cast<W*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The path from the arguments: 16-byte chunks when the row, the row
// stride and both base pointers are 16-byte aligned, else words.
template <typename I>
int expand(const void* table, long long ld, I ids, long long n, int k, int word_bytes,
           void* out, cudaStream_t s) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (word_bytes != 2 && word_bytes != 4) return static_cast<int>(cudaErrorInvalidValue);
  const long long row_bytes = static_cast<long long>(k) * word_bytes;
  if (row_bytes % 16 == 0 && (ld * word_bytes) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(table) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    return launch_expand<uint4>(table, ld * word_bytes / 16, ids, n,
                                static_cast<int>(row_bytes / 16), out, s);
  }
  if (word_bytes == 4) return launch_expand<uint32_t>(table, ld, ids, n, k, out, s);
  return launch_expand<uint16_t>(table, ld, ids, n, k, out, s);
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

}  // namespace

extern "C" {

// word_bytes: 4 (f32) or 2 (bf16) -- the copy is dtype-agnostic. idx:
// n contiguous int32 ids in [0, S), not checked.
int tr_expand_rows(const void* table, long long ld, const int* idx, long long n, int k,
                   int word_bytes, void* out, void* stream) {
  return expand(table, ld, Ids<int, false>{idx, n, n, 0}, n, k, word_bytes, out,
                static_cast<cudaStream_t>(stream));
}

// The serving gather over a whole [v, ...] table: ids int32 (id_bytes 4)
// or int64 (8), any value, in rows of ids_cols ids ids_ld apart; each is
// read as JAX's gather reads it (add v once if negative, clamp to
// [0, v-1]). v > 0.
int tr_expand_rows_clamped(const void* table, long long ld, const void* ids, int id_bytes,
                           long long ids_cols, long long ids_ld, long long n, int k,
                           long long v, int word_bytes, void* out, void* stream) {
  if (n > 0 && (v <= 0 || ids_cols <= 0 || ids_ld < ids_cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id_bytes == 4) {
    return expand(table, ld, Ids<int, true>{static_cast<const int*>(ids), ids_cols, ids_ld, v},
                  n, k, word_bytes, out, s);
  }
  if (id_bytes == 8) {
    return expand(table, ld,
                  Ids<long long, true>{static_cast<const long long*>(ids), ids_cols, ids_ld, v},
                  n, k, word_bytes, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
