// Field-block table-gradient scatter for the dense step under --field_blocks.
//
// K8 field_block_scatter:
//   out[ids[b,f], :] += round(g[b,f,:])   for every (b, f) with
//                                        offs[f] <= ids[b,f] < offs[f] + sizes[f]
//                                        and ids[b,f] < vocab
//   round() is the bf16 rounding (nearest even) under use_bf16, else the
//   identity; the sums are f32. Ids outside their field's block (and the
//   -1 padding) add nothing: this is not a plain scatter-add.
//   Replaces the TPU kernel field_block_scatter (_scatter_kernel) of the
//   JAX package's ops/pallas_embedding.py. The TPU built a one-hot tile
//   per (field, vocab chunk, batch tile) on the VPU and contracted it with
//   g on the MXU, keeping each [tile_v, W] output piece resident in VMEM
//   across the batch tiles. On Hopper the scatter is bound by the bytes it
//   must move: ids and g read once, the [vocab, W] f32 output written
//   once (54.0 MB at B = 16384, F = 39, W = 17, vocab = 117,581: 0.016 ms
//   at 3.35 TB/s; zeroing the output first, as the atomics need, is this
//   design's own extra 8.0 MB). The one-hot product would multiply by zeros
//   tile_v times over; the GPU adds each element where it belongs instead.
//   Design: one block per tile of PAIRS consecutive (b, f) pairs of the
//   row-major [B, F] ids, so the tile's g elements are one contiguous run.
//   The block first resolves each pair's target (dropped, a global row,
//   or a slot of its shared-memory accumulator) into shared memory, then
//   its threads walk the tile's PAIRS * W elements in order (coalesced
//   reads of g) and add each with one atomic. Hot rows are the known
//   hazard: a field whose block is small (Criteo's 13 continuous fields
//   are one-row blocks, hit by every batch row) would pile B atomics onto
//   W words. Such fields (expected >= 4 hits per row within a tile) sum
//   into the block's shared-memory accumulator instead -- the counterpart
//   of the TPU's VMEM-resident output piece -- and the block then adds
//   each non-zero accumulator word into device memory with one atomic.
//   The other fields (hits spread over thousands of rows) add straight
//   into device memory. The order of the additions changes from run to
//   run, so results agree with a sequential sum only to a float tolerance.
//
// Plain C interface for ctypes. The entry point launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PAIRS = 2048;  // (b, f) pairs per tile

// j / k for 0 <= j < PAIRS * k (k <= 1024): the quotient (j + 0.5) / k
// sits at least 0.5 / k away from an integer; the float one is below
// PAIRS = 2^11 with a relative error below 2^-22 (two roundings), so its
// error is below 2^-11 <= 0.5 / k, and truncation is exact.
__device__ __forceinline__ int tile_row(int j, float inv_k) {
  return static_cast<int>((static_cast<float>(j) + 0.5f) * inv_k);
}

// fields: int32 [3F] = offsets, sizes, shared-memory base of each field's
// accumulator (-1: the field adds straight into device memory).
__global__ void field_block_scatter_kernel(const int* __restrict__ ids,
                                           const float* __restrict__ g,
                                           long long n_pairs, int nf, int w,
                                           float inv_w, const int* __restrict__ fields,
                                           int n_acc, int vocab, int use_bf16,
                                           float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* tgt = reinterpret_cast<long long*>(smem);  // [PAIRS]
  float* acc = reinterpret_cast<float*>(tgt + PAIRS);   // [n_acc]
  const long long p0 = static_cast<long long>(blockIdx.x) * PAIRS;
  const int np = static_cast<int>(min(static_cast<long long>(PAIRS), n_pairs - p0));
  for (int s = threadIdx.x; s < n_acc; s += blockDim.x) acc[s] = 0.0f;
  // target of each pair: -1 dropped; >= 0 the element offset of its row
  // in out; <= -2 the slot -2 - t of its row in acc
  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    const long long gp = p0 + p;
    const int f = static_cast<int>(gp % nf);
    const int id = ids[gp];
    const int rel = id - fields[f];
    long long t = -1;
    if (rel >= 0 && rel < fields[nf + f] && id < vocab) {
      const int base = fields[2 * nf + f];
      t = base >= 0 ? -2 - (static_cast<long long>(base) + static_cast<long long>(rel) * w)
                    : static_cast<long long>(id) * w;
    }
    tgt[p] = t;
  }
  __syncthreads();
  const float* src = g + p0 * w;
  const int elems = np * w;
  for (int j = threadIdx.x; j < elems; j += blockDim.x) {
    const int p = tile_row(j, inv_w);
    const long long t = tgt[p];
    if (t == -1) continue;
    const int c = j - p * w;
    float v = src[j];
    if (use_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
    if (t >= 0) {
      atomicAdd(out + t + c, v);
    } else {
      atomicAdd(acc + (-2 - t) + c, v);
    }
  }
  if (n_acc == 0) return;
  __syncthreads();
  for (int f = 0; f < nf; ++f) {
    const int base = fields[2 * nf + f];
    if (base < 0) continue;
    const long long row0 = static_cast<long long>(fields[f]) * w;
    const int n = fields[nf + f] * w;
    for (int s = threadIdx.x; s < n; s += blockDim.x) {
      const float v = acc[base + s];
      if (v != 0.0f) atomicAdd(out + row0 + s, v);
    }
  }
}

}  // namespace

extern "C" {

// ids int32 [n_pairs] (row-major [B, nf]), g f32 [n_pairs, w], out f32
// [vocab, w] zeroed by the caller; fields int32 [3 * nf] on the device;
// n_acc floats of shared-memory accumulator (PAIRS * 8 + n_acc * 4 bytes
// of dynamic shared memory, at most 48 KB).
int tr_field_block_scatter(const int* ids, const float* g, long long n_pairs, int nf, int w,
                           const int* fields, int n_acc, int vocab, int use_bf16, float* out,
                           void* stream) {
  if (n_pairs > 0 && w > 0) {
    const unsigned int tiles = static_cast<unsigned int>((n_pairs + PAIRS - 1) / PAIRS);
    const size_t smem = PAIRS * sizeof(long long) + static_cast<size_t>(n_acc) * sizeof(float);
    field_block_scatter_kernel<<<tiles, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        ids, g, n_pairs, nf, w, 1.0f / static_cast<float>(w), fields, n_acc, vocab, use_bf16,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
