// Row scatter for the fused w|m|v write-back under --dma_scatter.
//
// K7 dma_row_scatter:  store[u[r], :] = rows[r, :]   for u[r] in [0, n_valid)
//   Replaces the TPU kernel dma_row_scatter (_dma_scatter_kernel) of the
//   JAX package's ops/pallas_sparse.py. The TPU issued one async DMA per
//   row in waves of 16 in flight, with the indices streamed through SMEM
//   blocks, to get around XLA's conservative scatter lowering. The waves
//   and semaphores are a TPU artefact: the uids are unique by the dedup
//   contract, so the write-back is S independent row copies with no
//   read-modify-write and no collisions, i.e. a plain tiled copy. Bound:
//   the bytes it must move, [S, L] rows read once and written once plus
//   the [S] index (117.9 MB at S = 114,688, L = 128 f32: 0.035 ms at
//   3.35 TB/s). Design: one block per tile of ROWS_PER_TILE rows; the
//   block stages the tile's destination row offsets in shared memory
//   (-1 for a dropped row: the sentinel V, anything >= n_valid or < 0),
//   then its threads walk the tile's ROWS_PER_TILE * width copy units in
//   order, so consecutive threads read consecutive addresses of `rows`
//   and write consecutive addresses within each destination row. The
//   copy unit is the widest of 16, 8, 4 or 2 bytes that divides the row
//   width, both row strides and both base addresses (16 bytes for the
//   [V+1, 128] f32 store), and the copy moves raw words, so f32 and bf16
//   share one kernel and the result is bit-exact.
//
// Plain C interface for ctypes. The entry point launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_TILE = 256;

// j / k for 0 <= j < ROWS_PER_TILE * k (k < 4096): the float quotient of
// (j + 0.5) / k sits at least 0.5 / k away from an integer, far beyond
// the float rounding error at these magnitudes, so truncation is exact.
__device__ __forceinline__ int tile_row(int j, float inv_k) {
  return static_cast<int>((static_cast<float>(j) + 0.5f) * inv_k);
}

// ld_store, ld_rows and width in copy units of type U.
template <typename U>
__global__ void row_scatter_kernel(U* __restrict__ store, long long ld_store,
                                   const U* __restrict__ rows, long long ld_rows,
                                   const int* __restrict__ u, long long s,
                                   int n_valid, int width, float inv_w) {
  __shared__ long long dst[ROWS_PER_TILE];
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS_PER_TILE;
  const int nrows = static_cast<int>(min(static_cast<long long>(ROWS_PER_TILE), s - row0));
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const int d = u[row0 + r];
    dst[r] = (d >= 0 && d < n_valid) ? static_cast<long long>(d) * ld_store : -1;
  }
  __syncthreads();
  const U* src = rows + row0 * ld_rows;
  const int elems = nrows * width;
  for (int j = threadIdx.x; j < elems; j += blockDim.x) {
    const int r = tile_row(j, inv_w);
    const int c = j - r * width;
    const long long o = dst[r];
    if (o >= 0) store[o + c] = src[static_cast<long long>(r) * ld_rows + c];
  }
}

template <typename U>
void launch(void* store, long long ld_store, const void* rows, long long ld_rows,
            const int* u, long long s, int n_valid, int width, cudaStream_t stream) {
  const unsigned int tiles =
      static_cast<unsigned int>((s + ROWS_PER_TILE - 1) / ROWS_PER_TILE);
  row_scatter_kernel<U><<<tiles, THREADS, 0, stream>>>(
      static_cast<U*>(store), ld_store, static_cast<const U*>(rows), ld_rows, u, s,
      n_valid, width, 1.0f / static_cast<float>(width));
}

}  // namespace

extern "C" {

// store [*, ld_store] and rows [s, ld_rows], row width `width` elements of
// `word_bytes` (4: f32, 2: bf16) bytes; u int32 [s]. Rows with u outside
// [0, n_valid) are dropped.
int tr_row_scatter(void* store, long long ld_store, const void* rows, long long ld_rows,
                   const int* u, long long s, int width, int word_bytes, int n_valid,
                   void* stream) {
  if (word_bytes != 4 && word_bytes != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (s > 0 && width > 0) {
    const long long row_b = static_cast<long long>(width) * word_bytes;
    const long long lds_b = ld_store * word_bytes, ldr_b = ld_rows * word_bytes;
    const uintptr_t addr = reinterpret_cast<uintptr_t>(store) | reinterpret_cast<uintptr_t>(rows);
    int unit = word_bytes;
    for (int ub = 16; ub > word_bytes; ub /= 2) {
      if (row_b % ub == 0 && lds_b % ub == 0 && ldr_b % ub == 0 && addr % ub == 0) {
        unit = ub;
        break;
      }
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int w = static_cast<int>(row_b / unit);
    const long long ls = lds_b / unit, lr = ldr_b / unit;
    switch (unit) {
      case 16: launch<uint4>(store, ls, rows, lr, u, s, n_valid, w, st); break;
      case 8: launch<uint2>(store, ls, rows, lr, u, s, n_valid, w, st); break;
      case 4: launch<uint32_t>(store, ls, rows, lr, u, s, n_valid, w, st); break;
      default: launch<uint16_t>(store, ls, rows, lr, u, s, n_valid, w, st); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
