// COO segment pool and its transpose for the multi-hot (--mh_coo) path.
//
// K3 coo_pool_rows:        out[dest[i], :] += w[i] * table[idx[i], :]
//   Replaces the TPU kernel coo_pool_rows (_coo_pool_kernel) of the JAX
//   package's ops/pallas_sparse.py. The TPU pinned the compact table and
//   the pooled output in VMEM and walked the slots with ordered scalar
//   read-modify-writes. Here the table (S x K f32, ~7 MB of a [S, 3K]
//   w|m|v store on the ESMM main path, read through its row stride) and
//   the [n_out, K] output (1.3 MB) stay in the 50 MB L2, so the kernel is
//   bound by the bytes of the three M-long slot arrays (12 B per slot)
//   plus one pass over the table and the output. Design: one block per
//   tile of ROWS_PER_TILE slots; the block stages the tile's idx, dest
//   and w in shared memory, then its threads walk the tile's
//   ROWS_PER_TILE * K products as one flat run, so consecutive threads
//   read consecutive table words. The output is shared by many slots
//   (the packer emits each (group, row) bag as a contiguous run, ~135
//   slots for the largest field after combine), so per-element atomics
//   would pile onto the same K words: each thread instead sums its
//   products while the target (dest, column) stays the same and issues
//   one atomicAdd when it changes. That is a saving, not a contract:
//   any order of slots gives the same sum up to float rounding.
//
// K4 coo_accumulate_rows:  d[idx[i], :] += w[i] * dp[dest[i], :]
//   Replaces coo_accumulate_rows (_coo_pool_bwd_kernel) and, by function,
//   coo_accumulate_rows_packed (the TPU lane-packed layout of the same
//   sum). Same bytes and the same tiled walk: dp ([n_out, K], 1.3 MB)
//   is gathered from L2 and the [S, K] f32 result takes atomics, with
//   the same run merging on the (idx, column) target. Under Zipf ids the
//   hot rows still serialise their atomics, as in K2.
//
// Slots with w == 0 are skipped: they add w * x = +-0, which leaves the
// sum unchanged for every finite x. The packer pads M up to 25% with
// idx = dest = 0, w = 0, and the skip keeps those from reading rows or
// issuing atomics. (For a non-finite x the plain version would add NaN;
// the kernel does not.)
//
// Plain C interface for ctypes. Every entry point launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
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

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One tile of both kernels: out[tgt[i] * k + c] += w[i] * src[src_row[i]
// * ld + c], K3 with (src, src_row, tgt) = (table, idx, dest), K4 with
// (dp, dest, idx). ld is the source row stride in elements.
template <typename T>
__device__ __forceinline__ void coo_scatter_tile(const T* __restrict__ src, long long ld,
                                                 const int* __restrict__ src_row,
                                                 const int* __restrict__ tgt,
                                                 const float* __restrict__ w, long long m,
                                                 int k, float inv_k, float* __restrict__ out) {
  __shared__ long long src_off[ROWS_PER_TILE];
  __shared__ long long tgt_off[ROWS_PER_TILE];
  __shared__ float wt[ROWS_PER_TILE];
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS_PER_TILE;
  const int rows = static_cast<int>(min(static_cast<long long>(ROWS_PER_TILE), m - row0));
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    src_off[r] = static_cast<long long>(src_row[row0 + r]) * ld;
    tgt_off[r] = static_cast<long long>(tgt[row0 + r]) * k;
    wt[r] = w[row0 + r];
  }
  __syncthreads();
  const int elems = rows * k;
  long long cur = -1;  // output element of the running sum
  float acc = 0.0f;
  for (int j = threadIdx.x; j < elems; j += blockDim.x) {
    const int r = tile_row(j, inv_k);
    const float wr = wt[r];
    if (wr == 0.0f) continue;
    const int c = j - r * k;
    const long long o = tgt_off[r] + c;
    if (o != cur) {
      if (cur >= 0) atomicAdd(out + cur, acc);
      cur = o;
      acc = 0.0f;
    }
    acc += wr * to_f32(src[src_off[r] + c]);
  }
  if (cur >= 0) atomicAdd(out + cur, acc);
}

template <typename T>
__global__ void coo_pool_kernel(const T* __restrict__ table, long long ld,
                                const int* __restrict__ idx, const int* __restrict__ dest,
                                const float* __restrict__ w, long long m, int k,
                                float inv_k, float* __restrict__ out) {
  coo_scatter_tile<T>(table, ld, idx, dest, w, m, k, inv_k, out);
}

__global__ void coo_accumulate_kernel(const float* __restrict__ dp,
                                      const int* __restrict__ idx,
                                      const int* __restrict__ dest,
                                      const float* __restrict__ w, long long m, int k,
                                      float inv_k, float* __restrict__ out) {
  coo_scatter_tile<float>(dp, k, dest, idx, w, m, k, inv_k, out);
}

inline unsigned int tiles(long long m) {
  return static_cast<unsigned int>((m + ROWS_PER_TILE - 1) / ROWS_PER_TILE);
}

}  // namespace

extern "C" {

// K3. table [S, k] with row stride ld, f32 (table_is_bf16 = 0) or bf16
// (1); idx, dest, w [m]; out f32 [n_out, k], zeroed by the caller.
int tr_coo_pool_rows(const void* table, long long ld, const int* idx,
                     const int* dest, const float* w, long long m, int k,
                     int table_is_bf16, float* out, void* stream) {
  if (m > 0) {
    const float inv_k = 1.0f / static_cast<float>(k);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (table_is_bf16) {
      coo_pool_kernel<__nv_bfloat16><<<tiles(m), THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(table), ld, idx, dest, w, m, k,
          inv_k, out);
    } else {
      coo_pool_kernel<float><<<tiles(m), THREADS, 0, s>>>(
          static_cast<const float*>(table), ld, idx, dest, w, m, k, inv_k, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K4. dp f32 [n_out, k] contiguous; idx, dest, w [m]; out f32 [S, k],
// zeroed by the caller.
int tr_coo_accumulate_rows(const float* dp, const int* idx, const int* dest,
                           const float* w, long long m, int k, float* out,
                           void* stream) {
  if (m > 0) {
    const float inv_k = 1.0f / static_cast<float>(k);
    coo_accumulate_kernel<<<tiles(m), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        dp, idx, dest, w, m, k, inv_k, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
