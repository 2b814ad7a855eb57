// Field-block table-gradient scatter for the dense step under --field_blocks.
//
// K8 field_block_scatter:
//   out[ids[b,f], :] += round(g[b,f,:])   for every (b, f) with
//                                        offs[f] <= ids[b,f] < offs[f] + sizes[f]
//                                        and ids[b,f] < vocab
//   round() is the bf16 rounding (nearest even) under use_bf16, else the
//   identity; the sums are f32. Ids outside their field's block (and the
//   -1 padding) add nothing: this is not a plain scatter-add. Blocks that
//   overlap add up.
//   Replaces the TPU kernel field_block_scatter (_scatter_kernel) of the
//   JAX package's ops/pallas_embedding.py. The TPU built a one-hot tile
//   per (field, vocab chunk, batch tile) on the VPU and contracted it with
//   g on the MXU, keeping each [tile_v, W] output piece resident in VMEM
//   across the batch tiles. On Hopper the scatter's least time is the
//   bytes it must move: ids and g read once, the [vocab, W] f32 output
//   written once (54.0 MB at B = 16384, F = 39, W = 17, vocab = 117,581:
//   0.016 ms at 3.35 TB/s; zeroing the output first, as the atomics need,
//   is this design's own extra 8.0 MB). The one-hot product would multiply
//   by zeros tile_v times over; the GPU adds each row where it belongs.
//   What bounds a scatter of this kind here, besides its bytes: the
//   reductions into device memory (one scalar atomicAdd an element would
//   be 7.24M at the DeepFM point), the latency of each thread's walk when
//   a block's phases are serial, and the hot rows of small fields.
//   Design: each block sums PAIRS consecutive (b, f) pairs of the
//   row-major [B, F] ids; its warps work alone, with no block-wide barrier
//   until the end. A warp takes tiles of 32 consecutive pairs (fewer for
//   W > 32): a tile's g elements are one contiguous run, which the warp
//   loads with 16-byte loads into its own 4 KB of shared memory (rounding
//   to bf16 on the way), while its registers already hold the next tile's
//   loads and ids. Then each lane takes one pair: it drops it outside its
//   field's block and adds its row with row_ops.cuh's emit_span, single
//   floats and a pair up to the row's first 16-byte boundary in out,
//   float4 reductions, then the tail (5 or 6 operations for a 17-float
//   row instead of 17: 2.34M at the DeepFM point). Hot rows are the known
//   hazard: a field whose block is small (Criteo's 13 continuous fields
//   are one-row blocks, hit by every batch row) would pile B reductions
//   onto W words. Such fields (field_plan in ops/field_block.py: a
//   block's pairs hit each row at least 4 times) sum into the block's
//   shared-memory accumulator instead, the counterpart of the TPU's
//   VMEM-resident output piece, and each block adds its accumulator rows
//   into device memory once at its end: a chain of one reduction per
//   block on each of those words. The order of the additions changes from
//   run to run, so results agree with a sequential sum only to a float
//   tolerance. On an H100 the stream of g through the warps' shared memory
//   takes most of the time: chip_smoke.py times the launch beside the same
//   launch with every id -1, where nothing is added (PERF.md). An even W
//   puts the lanes' rows on the same shared-memory banks (16-way at
//   W = 16).
//
// Plain C interface for ctypes. The entry point launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "row_ops.cuh"

namespace {

constexpr int PAIRS = 2048;  // (b, f) pairs one block sums before it flushes (ops/field_block.py)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_FLOATS = 1024;  // g floats a warp stages a tile (4 KB: 32 pairs at W = 17)
constexpr int STAGE = WARP_FLOATS / 4 / 32;  // float4 loads a lane a tile

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The float4 loads of one warp tile: cnt floats from src (16-byte aligned
// when vec), float4 q = lane + 32 i in r[i]; the partial last one by
// scalar loads.
__device__ __forceinline__ void stage_load(float4 (&r)[STAGE], const float* src, int cnt,
                                           bool vec, int lane) {
#pragma unroll
  for (int i = 0; i < STAGE; ++i) {
    const int q = lane + i * 32;
    if (4 * q < cnt) r[i] = row_ops::load4(src + 4 * q, cnt - 4 * q, vec && cnt - 4 * q >= 4);
  }
}

// dynamic shared memory: each warp's staged tile [WARPS][WARP_FLOATS],
// the accumulator [n_acc], the field table [3 nf] (offsets, sizes,
// accumulator base of each field, -1: the field adds straight into
// device memory). tile: pairs a warp tile, a multiple of 4 where it
// can be, so that every tile starts on a 16-byte boundary of g.
__global__ void __launch_bounds__(THREADS)
field_block_scatter_kernel(const int* __restrict__ ids, const float* __restrict__ g,
                           long long n_pairs, int nf, int w, const int* __restrict__ fields,
                           int n_acc, int vocab, bool use_bf16, int tile,
                           bool vec, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* gs = reinterpret_cast<float*>(smem) + warp * WARP_FLOATS;
  float* acc = reinterpret_cast<float*>(smem) + WARPS * WARP_FLOATS;
  int* fld = reinterpret_cast<int*>(acc + n_acc);
  for (int s = threadIdx.x; s < 3 * nf; s += THREADS) fld[s] = fields[s];
  for (int s = threadIdx.x; s < n_acc; s += THREADS) acc[s] = 0.0f;
  __syncthreads();

  const long long b0 = static_cast<long long>(blockIdx.x) * PAIRS;
  const long long b1 = min(n_pairs, b0 + PAIRS);
  long long q0 = b0 + static_cast<long long>(warp) * tile;
  const long long step = static_cast<long long>(WARPS) * tile;
  float4 r[STAGE];
  int id = -1;
  if (q0 < b1) {
    const int n = static_cast<int>(min(static_cast<long long>(tile), b1 - q0));
    stage_load(r, g + q0 * w, n * w, vec, lane);
    if (lane < n) id = __ldg(ids + q0 + lane);
  }
  for (; q0 < b1; q0 += step) {
    const int n = static_cast<int>(min(static_cast<long long>(tile), b1 - q0));
    __syncwarp();  // the last tile's rows are read
#pragma unroll
    for (int i = 0; i < STAGE; ++i) {
      const int q = lane + i * 32;
      if (4 * q < n * w) {
        float4 v = r[i];
        if (use_bf16) {
          v = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
        }
        reinterpret_cast<float4*>(gs)[q] = v;
      }
    }
    __syncwarp();
    const int my_id = id;
    const long long q1 = q0 + step;
    if (q1 < b1) {  // the next tile's loads, in flight during this tile's adds
      const int n1 = static_cast<int>(min(static_cast<long long>(tile), b1 - q1));
      stage_load(r, g + q1 * w, n1 * w, vec, lane);
      id = lane < n1 ? __ldg(ids + q1 + lane) : -1;
    }
    if (lane >= n) continue;
    // lane: pair q0 + lane
    const int f = static_cast<int>((q0 + lane) % nf);
    const int rel = my_id - fld[f];
    if (rel < 0 || rel >= fld[nf + f] || my_id >= vocab) continue;
    const float* src = gs + lane * w;
    const int base = fld[2 * nf + f];
    if (base >= 0) {
      float* a = acc + base + rel * w;
      for (int j = 0; j < w; ++j) atomicAdd(a + j, src[j]);
    } else {
      row_ops::emit_span(out + static_cast<long long>(my_id) * w, src, w);
    }
  }
  if (n_acc == 0) return;
  __syncthreads();
  // each accumulated field's rows into device memory, once a block
  for (int f = 0; f < nf; ++f) {
    const int base = fld[2 * nf + f];
    if (base < 0) continue;
    const int n = fld[nf + f] * w;
    for (int j = threadIdx.x * 32; j < n; j += THREADS * 32) {
      row_ops::emit_span(out + static_cast<long long>(fld[f]) * w + j, acc + base + j,
                         min(32, n - j));
    }
  }
}

}  // namespace

extern "C" {

// ids int32 [n_pairs] (row-major [B, nf]), g f32 [n_pairs, w], out f32
// [vocab, w] zeroed by the caller; fields int32 [3 * nf] on the device;
// n_acc floats of shared-memory accumulator.
int tr_field_block_scatter(const int* ids, const float* g, long long n_pairs, int nf, int w,
                           const int* fields, int n_acc, int vocab, int use_bf16, float* out,
                           void* stream) {
  if (w <= 0 || w > WARP_FLOATS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pairs > 0) {
    // pairs a warp tile: as many as WARP_FLOATS hold, at most 32 (a lane
    // each), a multiple of 4 where that leaves any
    int tile = std::min(32, WARP_FLOATS / w);
    if (tile >= 4) tile = tile / 4 * 4;
    const unsigned int blocks =
        static_cast<unsigned int>((n_pairs + PAIRS - 1) / PAIRS);
    const size_t smem = (static_cast<size_t>(WARPS) * WARP_FLOATS + n_acc + 3 * nf) * 4;
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(field_block_scatter_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    }
    const bool vec = reinterpret_cast<uintptr_t>(g) % 16 == 0 && (tile * w) % 4 == 0;
    field_block_scatter_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        ids, g, n_pairs, nf, w, fields, n_acc, vocab, use_bf16 != 0, tile, vec, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
