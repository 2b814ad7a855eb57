// Segment sum and segment select over a sorted slot stream, for DIN's
// attention over the live multi-hot slots (--mh_coo).
//
// The stream: cdest[i] is the compact segment of slot i (the running
// count of non-empty (group, row) bags, data/sparse_batch.MhCooPacker),
// nondecreasing with steps of at most 1 over the live prefix. Bucket
// padding slots after the live prefix carry cdest = 0 and zero values,
// so the stream is sorted only up to the live count; both kernels take
// any cdest in [0, n_out) and rely on the sort for speed only.
//
// K5 sorted_segsum:  out[cdest[i], :] += vals[i, :]      (f32 out, zeroed)
//   Replaces the TPU kernel sorted_segsum (_sorted_segsum_kernel) of the
//   JAX package's ops/pallas_sparse.py and, by function,
//   sorted_segsum_packed (_sorted_segsum_packed_kernel, the same sum with
//   a lane-packed accumulator for large n_out). The TPU turned each
//   512-slot chunk into a one-hot matmul over a window of the output
//   pinned in VMEM. Here the [n_out, K] output (1 MB at n_out = 16,384,
//   6.4 MB at n_out = Su ~ 100k) stays in the 50 MB L2, so the kernel is
//   bound by the bytes of the [M, K] values and the [M] cdest read once.
//   Design: each thread owns one column of a strip of STRIP consecutive
//   slots; it keeps a running sum while cdest stays the same and adds it
//   with one atomicAdd when cdest changes and at the strip's end. The
//   sort makes runs long (~80 slots per segment at n_out = G), so the
//   atomics drop from M*K to about (M / STRIP + segments) * K and no
//   hot-row pile-up remains. Neighbouring threads take neighbouring
//   columns of one strip, so a warp reads whole rows. Padding slots add
//   their zeros into row 0. No TF32 and no tensor cores: the sum is a
//   plain f32 accumulation of f32 or bf16 values.
//
// K6 sorted_expand:  out[i, :] = src[cdest[i], :]
//   Replaces sorted_expand (_sorted_expand_kernel). src is small (1 MB at
//   n_src = 16,384, K = 16) and stays in L2, so the kernel is bound by
//   the [M, K] output written once plus the [M] cdest read. Design (K1's
//   tiled walk of sparse_rows.cu, on a contiguous source): one
//   block per tile of ROWS_PER_TILE output rows; the block stages the
//   tile's source row offsets in shared memory, then its threads walk the
//   tile's ROWS_PER_TILE * K output elements in order, so consecutive
//   threads store consecutive addresses. The copy moves raw 2- or 4-byte
//   words: bit-exact in f32 and bf16. Padding slots copy src row 0; the
//   model multiplies them by a zero weight.
//
// Plain C interface for ctypes. Every entry point launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int STRIP = 32;  // consecutive slots one K5 thread sums
constexpr int UNROLL = 8;  // slots loaded ahead of the running sum
constexpr int ROWS_PER_TILE = 256;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void sorted_segsum_kernel(const T* __restrict__ vals,
                                     const int* __restrict__ cdest, long long m,
                                     int k, long long items, float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= items) return;
  const long long strip = t / k;
  const int c = static_cast<int>(t - strip * k);
  const long long i0 = strip * STRIP;
  const int n = static_cast<int>(min(static_cast<long long>(STRIP), m - i0));
  int cur = cdest[i0];
  float acc = 0.0f;
  for (int base = 0; base < n; base += UNROLL) {
    // load UNROLL slots ahead of the dependent sum
    int d[UNROLL];
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = i0 + min(base + u, n - 1);
      d[u] = cdest[i];
      v[u] = to_f32(vals[i * k + c]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u >= n) break;
      if (d[u] != cur) {
        atomicAdd(out + static_cast<long long>(cur) * k + c, acc);
        cur = d[u];
        acc = 0.0f;
      }
      acc += v[u];
    }
  }
  atomicAdd(out + static_cast<long long>(cur) * k + c, acc);
}

// j / k for 0 <= j < ROWS_PER_TILE * k (k < 4096): the float quotient of
// (j + 0.5) / k sits at least 0.5 / k away from an integer, far beyond
// the float rounding error at these magnitudes, so truncation is exact.
__device__ __forceinline__ int tile_row(int j, float inv_k) {
  return static_cast<int>((static_cast<float>(j) + 0.5f) * inv_k);
}

template <typename W>
__global__ void sorted_expand_kernel(const W* __restrict__ src,
                                     const int* __restrict__ cdest, long long m,
                                     int k, float inv_k, W* __restrict__ out) {
  __shared__ long long row_off[ROWS_PER_TILE];
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS_PER_TILE;
  const int rows = static_cast<int>(min(static_cast<long long>(ROWS_PER_TILE), m - row0));
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    row_off[r] = static_cast<long long>(cdest[row0 + r]) * k;
  }
  __syncthreads();
  W* dst = out + row0 * k;
  const int elems = rows * k;
  for (int j = threadIdx.x; j < elems; j += blockDim.x) {
    const int r = tile_row(j, inv_k);
    dst[j] = src[row_off[r] + (j - r * k)];
  }
}

inline unsigned int blocks(long long n, long long per_block) {
  return static_cast<unsigned int>((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// K5. vals [m, k] contiguous, f32 (vals_is_bf16 = 0) or bf16 (1); cdest
// [m]; out f32 [n_out, k], zeroed by the caller.
int tr_sorted_segsum(const void* vals, const int* cdest, long long m, int k,
                     int vals_is_bf16, float* out, void* stream) {
  if (m > 0) {
    const long long items = (m + STRIP - 1) / STRIP * k;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vals_is_bf16) {
      sorted_segsum_kernel<__nv_bfloat16><<<blocks(items, THREADS), THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(vals), cdest, m, k, items, out);
    } else {
      sorted_segsum_kernel<float><<<blocks(items, THREADS), THREADS, 0, s>>>(
          static_cast<const float*>(vals), cdest, m, k, items, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K6. src [n_src, k] contiguous; word_bytes: 4 (f32) or 2 (bf16), the
// copy is dtype-agnostic; cdest [m]; out [m, k] in src's dtype.
int tr_sorted_expand(const void* src, const int* cdest, long long m, int k,
                     int word_bytes, void* out, void* stream) {
  if (m > 0) {
    const float inv_k = 1.0f / static_cast<float>(k);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (word_bytes == 4) {
      sorted_expand_kernel<uint32_t><<<blocks(m, ROWS_PER_TILE), THREADS, 0, s>>>(
          static_cast<const uint32_t*>(src), cdest, m, k, inv_k,
          static_cast<uint32_t*>(out));
    } else if (word_bytes == 2) {
      sorted_expand_kernel<uint16_t><<<blocks(m, ROWS_PER_TILE), THREADS, 0, s>>>(
          static_cast<const uint16_t*>(src), cdest, m, k, inv_k,
          static_cast<uint16_t*>(out));
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
