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
//   pinned in VMEM. Here the [n_out, K] output (1 MB at n_out = G =
//   16,384, 7.3 MB at n_out = Su = 114,688) stays in the 50 MB L2, so the
//   least time is the [M, K] values and the [M] cdest read once (90-97 MB
//   at DIN's published point, 0.027-0.029 ms at 3.35 TB/s).
//   What bounds such a sum here, besides its bytes, is its chains of
//   atomics on one address. The bucket tail (~130-142K padding slots at
//   cdest 0, values exactly 0) would send one zero-valued atomic per strip
//   and column into the same words of row 0, ~4,400 links; at n_out = Su
//   the hottest id (Zipf 1.2: ~18% of the live slots) is one run of ~210K
//   slots, ~6,600 strips, all adding into one row; and the ~11-slot runs
//   there would make ~2.2M scalar atomics.
//   Design: a block of 256 threads sums 64 consecutive strips of STRIP
//   slots at K = 16; one thread owns four columns of a strip. It loads
//   them with one 16-byte load
//   (f32) or one 8-byte load (bf16) a slot, UNROLL slots ahead of its
//   running float4 sum, and ends a run at a change of cdest and at the
//   strip's end. A run of the block's first or last segment (the only
//   ones that can go on past the block in a sorted stream) adds into a
//   shared-memory row, and the block adds that row into device memory
//   once; any other run goes straight there with row_ops.cuh's emit: one
//   float4 reduction on a 16-byte aligned row (K % 4 == 0), else the
//   float2 and float ones its alignment allows (K = 5, 17), and none for a
//   sum of exactly 0. So the padding tail adds nothing, and a segment that
//   spans many blocks takes one reduction a block and column group: the
//   chain on the hot row falls from its strips to its blocks (~100).
//   Neighbouring threads take the column groups of one strip, so a quad of
//   lanes reads a whole 64-byte row (K = 16). An unsorted stream only
//   makes more runs. No TF32 and no tensor cores: the sum is a plain f32
//   accumulation of f32 or bf16 values. On an H100 the launch then follows
//   its loads: chip_smoke.py times it beside the same launch on all-zero
//   values, where no reduction is sent (PERF.md).
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

#include <algorithm>

#include "row_ops.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int STRIP = 32;  // consecutive slots one K5 thread sums
constexpr int UNROLL = 8;  // slots loaded ahead of the running sum (K5)
static_assert(STRIP % UNROLL == 0, "a K5 strip is whole unrolled steps");
constexpr int ROWS_PER_TILE = 256;

// Add the four columns of v (cols of them left in the row) into a row of
// shared memory; all-zero sums add nothing.
__device__ __forceinline__ void smem_add4(float* a, int cols, float4 v) {
  if (v.x == 0.0f && v.y == 0.0f && v.z == 0.0f && v.w == 0.0f) return;
  atomicAdd(a, v.x);
  if (cols > 1) atomicAdd(a + 1, v.y);
  if (cols > 2) atomicAdd(a + 2, v.z);
  if (cols > 3) atomicAdd(a + 3, v.w);
}

// A block sums spb consecutive strips: lanes threads a strip, thread
// (strip, lane) the column groups lane, lane + lanes, ... (groups of four
// columns, cut at k). edge: 2k floats of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(THREADS)
sorted_segsum_kernel(const T* __restrict__ vals, const int* __restrict__ cdest, long long m,
                     int k, int groups, int lanes, int spb, bool vec,
                     float* __restrict__ out) {
  extern __shared__ float edge[];  // sums of the block's first and last segment
  const long long i_first = static_cast<long long>(blockIdx.x) * spb * STRIP;
  const long long i_end = min(m, i_first + static_cast<long long>(spb) * STRIP);
  const int d_first = __ldg(cdest + i_first);
  const int d_last = __ldg(cdest + i_end - 1);
  for (int j = threadIdx.x; j < 2 * k; j += blockDim.x) edge[j] = 0.0f;
  __syncthreads();
  const long long i0 = i_first + static_cast<long long>(threadIdx.x / lanes) * STRIP;
  if (threadIdx.x < spb * lanes && i0 < i_end) {
    const int n = static_cast<int>(min(static_cast<long long>(STRIP), i_end - i0));
    for (int grp = threadIdx.x % lanes; grp < groups; grp += lanes) {
      const int c = grp * 4;
      const int cols = k - c;
      // a run of the block's first or last segment may go on in the
      // neighbouring strips and blocks: it adds into shared memory, once a
      // block into device memory; any other run goes straight there
      auto put = [&](int d, float4 v) {
        if (d == d_first) {
          smem_add4(edge + c, cols, v);
        } else if (d == d_last) {
          smem_add4(edge + k + c, cols, v);
        } else {
          row_ops::emit(out + static_cast<long long>(d) * k + c, cols, v);
        }
      };
      const T* src = vals + i0 * k + c;
      int cur = __ldg(cdest + i0);
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int base = 0; base < n; base += UNROLL) {
        int d[UNROLL];
        float4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {  // loads ahead of the dependent sum
          const int j = min(base + u, n - 1);
          d[u] = __ldg(cdest + i0 + j);
          v[u] = row_ops::load4(src + static_cast<long long>(j) * k, cols, vec);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (base + u >= n) break;
          if (d[u] != cur) {
            put(cur, acc);
            cur = d[u];
            acc = v[u];
          } else {
            acc = row_ops::add4(acc, v[u]);
          }
        }
      }
      put(cur, acc);
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < 2 * groups; q += blockDim.x) {
    const int last = q >= groups;
    const int c = (q - last * groups) * 4;
    const int cols = k - c;
    const float* a = edge + last * k + c;
    const float4 v = make_float4(a[0], cols > 1 ? a[1] : 0.0f, cols > 2 ? a[2] : 0.0f,
                                 cols > 3 ? a[3] : 0.0f);
    row_ops::emit(out + static_cast<long long>(last ? d_last : d_first) * k + c, cols, v);
  }
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
    const int groups = (k + 3) / 4;
    const int lanes = std::min(groups, THREADS);
    const int spb = std::max(1, THREADS / groups);
    const long long strips = (m + STRIP - 1) / STRIP;
    const unsigned int grid = blocks(strips, spb);
    const size_t smem = 2 * static_cast<size_t>(k) * sizeof(float);
    const uintptr_t a = reinterpret_cast<uintptr_t>(vals);
    const bool vec = k % 4 == 0 && a % (vals_is_bf16 ? 8 : 16) == 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vals_is_bf16) {
      sorted_segsum_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
          static_cast<const __nv_bfloat16*>(vals), cdest, m, k, groups, lanes, spb, vec, out);
    } else {
      sorted_segsum_kernel<float><<<grid, THREADS, smem, s>>>(
          static_cast<const float*>(vals), cdest, m, k, groups, lanes, spb, vec, out);
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
