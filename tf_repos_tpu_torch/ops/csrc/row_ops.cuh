// Row loads and vector reductions shared by the scatter kernels: K2 and
// K4 (through sort_reduce.cuh), K5 (sorted_seg.cu) and K8
// (field_block.cu).
//
// Hopper adds a float4 or float2 into device memory with one reduction
// (atomicAdd on a float4* or float2*, sm_90: RED.E.ADD.F32x4 in SASS), so
// a row of K floats costs about K / 4 operations instead of K, if each
// operation starts on its own 16- or 8-byte boundary. A row at an odd
// float offset (K = 17: row r starts at 17 r floats, so its alignment
// cycles through all four) takes single floats and a pair up to the next
// 16-byte boundary, float4s from there, and a pair and a single float for
// its tail. Every emitter skips an operation whose values are all exactly
// 0: the output is zeroed first, so adding +-0 changes nothing (exact for
// finite inputs), and a NaN or Inf still reaches the output, as with
// index_add_.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace row_ops {

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four columns from p; vec: one 16-byte (f32) or 8-byte (bf16) load,
// else one load per column below cols.
__device__ __forceinline__ float4 load4(const float* p, int cols, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(p[0], cols > 1 ? p[1] : 0.0f, cols > 2 ? p[2] : 0.0f,
                     cols > 3 ? p[3] : 0.0f);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int cols, bool vec) {
  if (vec) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return make_float4(to_f32(p[0]), cols > 1 ? to_f32(p[1]) : 0.0f,
                     cols > 2 ? to_f32(p[2]) : 0.0f, cols > 3 ? to_f32(p[3]) : 0.0f);
}

// One reduction of 1, 2 or 4 floats at p (p aligned to its width),
// skipped when its values are all exactly 0.
__device__ __forceinline__ void add_one(float* p, float a) {
  if (a != 0.0f) atomicAdd(p, a);
}
__device__ __forceinline__ void add_pair(float* p, float a, float b) {
  if (a != 0.0f || b != 0.0f) atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}
__device__ __forceinline__ void add_quad(float* p, float4 v) {
  if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f) {
    atomicAdd(reinterpret_cast<float4*>(p), v);
  }
}

// Add four columns of one row (cols of them left in the row) into dst
// with the widest reductions its alignment allows: one float4 on a
// 16-byte boundary, else float2 pairs from an 8-byte boundary and single
// floats around them.
__device__ __forceinline__ void emit(float* dst, int cols, float4 v) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dst);
  if (cols >= 4 && (addr & 15) == 0) {
    add_quad(dst, v);
  } else if ((addr & 7) == 0) {  // pair, pair
    if (cols >= 2) add_pair(dst, v.x, v.y); else add_one(dst, v.x);
    if (cols >= 4) add_pair(dst + 2, v.z, v.w); else if (cols == 3) add_one(dst + 2, v.z);
  } else {  // one, pair, one
    add_one(dst, v.x);
    if (cols >= 3) add_pair(dst + 1, v.y, v.z); else if (cols == 2) add_one(dst + 1, v.y);
    if (cols >= 4) add_one(dst + 3, v.w);
  }
}

// Add the n floats src[0..n) (any memory, read as scalars) into dst[0..n)
// with the fewest reductions dst's alignment allows: a single float to an
// 8-byte boundary, a pair to a 16-byte boundary, float4s, then a pair and
// a single float for the tail. A 17-float row takes 5 or 6 operations.
__device__ __forceinline__ void emit_span(float* dst, const float* src, int n) {
  int j = 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dst);
  if ((addr & 4) && n > 0) {
    add_one(dst, src[0]);
    j = 1;
  }
  if (((addr + 4 * j) & 8) && n - j >= 2) {
    add_pair(dst + j, src[j], src[j + 1]);
    j += 2;
  }
  for (; j + 4 <= n; j += 4) {
    add_quad(dst + j, make_float4(src[j], src[j + 1], src[j + 2], src[j + 3]));
  }
  if (j + 2 <= n) {
    add_pair(dst + j, src[j], src[j + 1]);
    j += 2;
  }
  if (j < n) add_one(dst + j, src[j]);
}

}  // namespace row_ops
