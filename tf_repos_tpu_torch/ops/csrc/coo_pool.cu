// COO segment pool and its transpose for the multi-hot (--mh_coo) path.
//
// K3 coo_pool_rows:        out[dest[i], :] += w[i] * table[idx[i], :]
//   Replaces the TPU kernel coo_pool_rows (_coo_pool_kernel) of the JAX
//   package's ops/pallas_sparse.py. The TPU pinned the compact table and
//   the pooled output in VMEM and walked the slots with ordered scalar
//   read-modify-writes. Here the table (S x K f32, ~7 MB of a [S, 3K]
//   w|m|v store on the ESMM main path, read through its row stride) and
//   the [n_out, K] output (1.3 MB) stay in the 50 MB L2, so the least
//   time is the three M-long slot arrays (12 B per slot) plus one pass
//   over the table and the output (16.5 MB at the ESMM point, 0.0049 ms
//   at 3.35 TB/s). What held the first design back was its atomics: it
//   walked each 256-slot tile's products as one flat run over the
//   block's threads, so every (group, row) bag, which the packer emits as
//   one contiguous run of slots (~32 on average, ~250 at most after
//   combine), was spread over all K column owners and many threads, and
//   each change of target sent one scalar atomicAdd: ~3.8M of them onto
//   an output of 330K floats at the ESMM point.
//   Design (K5's strip walk of sorted_seg.cu, with the gather and the
//   weight): a block of 256 threads sums 64 consecutive strips of STRIP
//   slots at K = 16; one thread owns four columns of a strip, so a quad
//   of lanes reads a whole 64-byte table row. A thread takes its strip
//   UNROLL slots at a time: their idx, dest and w with one 16-byte load
//   each (one load a slot where the arrays are not 16-byte aligned, and
//   at the ragged end), then their UNROLL table rows together, each with
//   one 16-byte load (f32) or one 8-byte load (bf16) where K, the row
//   stride and the base allow (K % 4 == 0, ld % 4 == 0, base aligned;
//   else one load a column: K = 5, 17, a view at column 1, an odd
//   stride). It keeps a float4 running sum of w * row while dest is
//   unchanged and adds it into the output at a change of dest and at the
//   strip's end with row_ops.cuh's emit: one float4 reduction on a
//   16-byte aligned row, else the float2 and float ones its alignment
//   allows, and none for a sum of exactly 0. A bag then costs one
//   reduction a strip it touches and column group (~240K float4
//   reductions at the ESMM point, against ~3.8M scalar atomics); the
//   longest bag (~250 slots) spans at most 17 strips, so no run needs a
//   shared-memory sum across blocks as K5's hot segment does. A shuffled
//   slot order only makes more runs, and so more reductions: the sum is
//   the same. No tensor cores: a plain f32 accumulation of f32 or bf16
//   rows. STRIP = 16 fills an H100 in one wave at the ESMM point (640
//   blocks, five an SM at 48 registers a thread); there the launch
//   follows its row gathers (64 bytes a live slot, from L2), not its
//   reductions: it takes as long on an all-zero table, where it sends
//   none (PERF.md).
//
// K4 coo_accumulate_rows:  d[idx[i], :] += w[i] * dp[dest[i], :]
//   Replaces coo_accumulate_rows (_coo_pool_bwd_kernel) and, by function,
//   coo_accumulate_rows_packed (the TPU lane-packed layout of the same
//   sum, which JAX runs above its 49,152-row VMEM cap). Bound by bytes:
//   the three M-long slot arrays read once, dp ([n_out, K], 1.3 MB on the
//   ESMM main path, gathered from L2) and the [S, K] f32 result written
//   once. What held the first design (K3's walk with run merging) back
//   was the chain of atomics on one address: it merged runs of equal
//   target, but K4's target is idx and the packer emits the slots in
//   dest order, so almost nothing merged, and the hottest id's slots
//   (up to one per (example, group) bag under combine, ~20K on ESMM)
//   serialised one atomicAdd per column in L2. K4 is now sort_reduce.cuh's
//   tile routine, shared with K2: one block per 2,560-slot tile sorts its
//   (idx, slot) pairs, sums w * dp[dest] over each run of equal idx in
//   registers and issues one atomic per (run, four columns). The chain
//   on one address falls to the tiles that hold the id.
//
// Slots with w == 0 are skipped in both kernels: they add w * x = +-0,
// which leaves the sum unchanged for every finite x. The packer pads M up
// to 25% with idx = dest = 0, w = 0, and the skip keeps those from reading
// rows or issuing atomics (K4 sorts them past the tile's live slots, and
// like K2 issues no atomic for a run whose sum is exactly 0). (For a
// non-finite x the plain version would add NaN; the kernels do not.)
//
// Plain C interface for ctypes. Every entry point launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sort_reduce.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int STRIP = 16;  // consecutive slots one K3 thread sums
constexpr int UNROLL = 4;  // slots whose table rows one K3 thread has in flight
static_assert(STRIP % UNROLL == 0 && UNROLL % 4 == 0, "a K3 strip is whole 16-byte steps");

// The idx, dest and w of UNROLL consecutive slots of a strip of n, from
// its slot base on: 16-byte loads where the step lies inside the strip
// and the arrays are 16-byte aligned (vec), else one load a slot, w = 0
// past the strip's end.
struct Slots {
  int idx[UNROLL], dest[UNROLL];
  float w[UNROLL];
  __device__ __forceinline__ void fetch(const int* __restrict__ idx0, const int* __restrict__ dest0,
                                        const float* __restrict__ w0, int base, int n, bool vec) {
    if (vec && base + UNROLL <= n) {
#pragma unroll
      for (int u = 0; u < UNROLL; u += 4) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(idx0 + base + u));
        const int4 d = __ldg(reinterpret_cast<const int4*>(dest0 + base + u));
        const float4 v = __ldg(reinterpret_cast<const float4*>(w0 + base + u));
        idx[u] = a.x, idx[u + 1] = a.y, idx[u + 2] = a.z, idx[u + 3] = a.w;
        dest[u] = d.x, dest[u + 1] = d.y, dest[u + 2] = d.z, dest[u + 3] = d.w;
        w[u] = v.x, w[u + 1] = v.y, w[u + 2] = v.z, w[u + 3] = v.w;
      }
      return;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = min(base + u, n - 1);
      idx[u] = __ldg(idx0 + j);
      dest[u] = __ldg(dest0 + j);
      w[u] = base + u < n ? __ldg(w0 + j) : 0.0f;
    }
  }
};

// K3. A block sums spb consecutive strips: lanes threads a strip, thread
// (strip, lane) the column groups lane, lane + lanes, ... (groups of four
// columns, cut at k). A slot with w == 0 adds nothing and ends no run.
template <typename T>
__global__ void __launch_bounds__(THREADS)
coo_pool_kernel(const T* __restrict__ table, long long ld, const int* __restrict__ idx,
                const int* __restrict__ dest, const float* __restrict__ w, long long m, int k,
                int groups, int lanes, int spb, bool vec_slots, bool vec_rows,
                float* __restrict__ out) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * spb + threadIdx.x / lanes) * STRIP;
  if (threadIdx.x >= spb * lanes || i0 >= m) return;
  const int n = static_cast<int>(min(static_cast<long long>(STRIP), m - i0));
  for (int grp = threadIdx.x % lanes; grp < groups; grp += lanes) {
    const int c = grp * 4;
    const int cols = k - c;
    int cur = -1;  // dest of the running sum
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int base = 0; base < n; base += UNROLL) {
      Slots now;
      now.fetch(idx + i0, dest + i0, w + i0, base, n, vec_slots);
      float4 x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {  // the table rows, in flight together
        const T* row = table + static_cast<long long>(now.idx[u]) * ld + c;
        x[u] = now.w[u] != 0.0f ? row_ops::load4(row, cols, vec_rows)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float wu = now.w[u];
        if (wu == 0.0f) continue;
        if (now.dest[u] != cur) {
          if (cur >= 0) row_ops::emit(out + static_cast<long long>(cur) * k + c, cols, acc);
          cur = now.dest[u];
          acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        acc = make_float4(fmaf(wu, x[u].x, acc.x), fmaf(wu, x[u].y, acc.y),
                          fmaf(wu, x[u].z, acc.z), fmaf(wu, x[u].w, acc.w));
      }
    }
    if (cur >= 0) row_ops::emit(out + static_cast<long long>(cur) * k + c, cols, acc);
  }
}

// K4: one tile of the sort-and-reduce scatter; a slot's row is
// w[slot] * dp[dest[slot]], and slots with w == 0 are dead. The tile's
// dest and w are read again after the sort, from L1.
struct WeightedRows {
  struct Row {
    long long off;  // dest * k
    float w;
  };
  const float* dp;
  const int* dest;  // the tile's first slot
  const float* w;
  int k;
  bool vec;  // k % 4 == 0 and dp 16-byte aligned
  __device__ __forceinline__ bool stage(int j) const { return w[j] != 0.0f; }
  __device__ __forceinline__ Row at(int j) const {
    return Row{static_cast<long long>(__ldg(dest + j)) * k, __ldg(w + j)};
  }
  __device__ __forceinline__ float4 row(const Row& r, int c) const {
    const float4 x = row_ops::load4(dp + r.off + c, k - c, vec);
    return make_float4(r.w * x.x, r.w * x.y, r.w * x.z, r.w * x.w);
  }
};

// K4's tile: 2,560 slots. At the ESMM point (M = 655,360) its 256 tiles
// then fit in one wave of two blocks on each SM of an H100.
constexpr int COO_ACC_ITEMS = 10;
constexpr int COO_ACC_TILE = sort_reduce::THREADS * COO_ACC_ITEMS;

__global__ void __launch_bounds__(sort_reduce::THREADS, sort_reduce::MIN_BLOCKS)
coo_accumulate_kernel(const float* __restrict__ dp, const int* __restrict__ idx,
                      const int* __restrict__ dest, const float* __restrict__ w, long long m,
                      int k, unsigned sent, int bits, bool vec_in, float* __restrict__ out) {
  const long long t0 = static_cast<long long>(blockIdx.x) * COO_ACC_TILE;
  sort_reduce::scatter_tile<COO_ACC_ITEMS>(WeightedRows{dp, dest + t0, w + t0, k, vec_in}, idx, m,
                                           sent, bits, k, out);
}

}  // namespace

extern "C" {

// K3. table [S, k] with row stride ld, f32 (table_is_bf16 = 0) or bf16
// (1); idx, dest, w [m]; out f32 [n_out, k], zeroed by the caller.
int tr_coo_pool_rows(const void* table, long long ld, const int* idx,
                     const int* dest, const float* w, long long m, int k,
                     int table_is_bf16, float* out, void* stream) {
  if (m > 0) {
    const int groups = (k + 3) / 4;
    const int lanes = groups < THREADS ? groups : THREADS;
    const int spb = THREADS / groups > 1 ? THREADS / groups : 1;
    const long long strips = (m + STRIP - 1) / STRIP;
    const unsigned grid = static_cast<unsigned>((strips + spb - 1) / spb);
    const uintptr_t a = reinterpret_cast<uintptr_t>(table);
    const bool vec_rows = k % 4 == 0 && ld % 4 == 0 && a % (table_is_bf16 ? 8 : 16) == 0;
    const bool vec_slots = (reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(dest) |
                            reinterpret_cast<uintptr_t>(w)) % 16 == 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (table_is_bf16) {
      coo_pool_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(table), ld, idx, dest, w, m, k, groups, lanes, spb,
          vec_slots, vec_rows, out);
    } else {
      coo_pool_kernel<float><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(table), ld, idx, dest, w, m, k, groups, lanes, spb, vec_slots,
          vec_rows, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K4. dp f32 [n_out, k] contiguous; idx in [0, s), dest, w [m]; out f32
// [s, k], zeroed by the caller.
int tr_coo_accumulate_rows(const float* dp, const int* idx, const int* dest,
                           const float* w, long long m, int k, long long s, float* out,
                           void* stream) {
  if (m > 0 && s > 0) {
    const unsigned blocks = static_cast<unsigned>((m + COO_ACC_TILE - 1) / COO_ACC_TILE);
    const unsigned sent = sort_reduce::sentinel(s);
    const bool vec_in = k % 4 == 0 && reinterpret_cast<uintptr_t>(dp) % 16 == 0;
    coo_accumulate_kernel<<<blocks, sort_reduce::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        dp, idx, dest, w, m, k, sent, sort_reduce::key_bits(sent), vec_in, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Slots a block of K4 takes.
int tr_coo_accumulate_rows_tile() { return COO_ACC_TILE; }

}  // extern "C"
