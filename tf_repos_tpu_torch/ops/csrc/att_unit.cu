// DIN's attention unit, fused: one kernel forward, one backward (and a
// small reduce of the backward's per-block weight gradients).
//
//   x   = bf16([u, u - a, a])                      [N, 3K]  (K input width)
//   pre = bf16(x @ bf16(W1)) + b1                  [N, W]   (W hidden width)
//   h   = relu(pre)
//   s   = sigmoid(h @ w2 + b2)                     [N]      the slot's weight
//
// Replaces no TPU kernel: the JAX package leaves this MLP to XLA (its
// models/din.py), and the port ran it as ATen's chain (ops/towers.py
// apply_mlp and dense): a bf16 GEMM writing [N, W], its f32 copy, the
// bias, the ReLU, an f32 SIMT GEMM for the output layer, and in the
// backward one [N, W] f32 kernel for each of the output layer's product,
// the ReLU's gate, the bias sum and the cast, then the two bf16 GEMMs.
// At DIN's benchmark point (N = 1,572,864 slots, K = 32, W = 256) that
// moved ~25 GB a step through device memory.
//
// What bounds it here. The model's work is 2 * 3K * W + 2 * W FLOPs a
// slot forward (49.7k at K = 32) and twice that backward: ~0.07 + 0.14 ms
// a step at 989 TFLOP/s bf16. Its least traffic is u and a read once
// and the weight written (260 B a slot forward), and u, a, the weight's
// gradient and s read, du and da written (520 B backward): ~0.12 + 0.24
// ms at 3.35 TB/s. So the unit is bound by its bytes, and only if no
// [N, W] or [N, 3K] tensor reaches device memory.
//
// Design. Persistent blocks of 8 warps walk tiles of 64 slots. W1 stays
// in shared memory as bf16 for the whole launch (96 x 256 x 2 = 48 KB at
// K = 32, rows padded by 8 elements so ldmatrix is free of bank
// conflicts). A ring of raw f32 tiles of u and a (and, backward,
// of g and s) is filled by cp.async, so the loads of the next tiles are
// in flight while the block computes and cost no registers; each thread
// then forms [u, u - a, a] in f32 for the chunks it copied and rounds it
// to bf16 into one of two x buffers, so one barrier a tile orders it. The
// products run on the tensor cores (mma.sync m16n8k16, bf16 operands,
// f32 sums; fragments through ldmatrix). Warp w owns hidden columns
// [w W/8, (w+1) W/8) for all 64 slots, so its epilogue needs only its
// own columns of b1 and w2.
//   Forward (two blocks a SM): the warp's W1 fragments stay in registers
//   for the launch; its product, two m16 tiles at a time, is rounded to
//   bf16 (torch's bf16 GEMM returns bf16), + b1, ReLU, and dotted with w2
//   in f32: a sum over the quad's lanes by shuffles, then over the 8
//   warps in fixed order in shared memory, + b2, the sigmoid.
//   Backward (one block a SM: its dW1 partial lives in registers): the
//   first layer is recomputed, two m16 tiles at a time. With g_s = g (1 -
//   s) s, the epilogue forms g_pre = [pre > 0] g_s w2 in f32 (adding up
//   db1 = sum g_pre and dw2 = sum g_s h in registers) and writes it as
//   bf16 into shared memory. Then dW1 += x^T g_pre over the warp's
//   columns, in registers across all the block's tiles; and dx = g_pre
//   W1^T, a warp taking the same 8 features of each third of x (u, u - a,
//   a) for its m16 tiles, so that each thread holds dx_0, dx_1 and dx_2 of
//   its elements: rounded to bf16 (as torch's bf16 GEMM returns it), du =
//   dx_0 + dx_1 and da = dx_2 - dx_1 in f32 go straight to device memory.
//   A block writes its dW1, db1, dw2 and db2 partial once; the reduce
//   launch sums the partials in block order and rounds dW1 to bf16.
// Every rounding point is the ATen chain's: bf16 operands with f32 sums,
// the first layer's product and the GEMMs' gradients rounded to bf16,
// the bias, ReLU, output layer and sigmoid in f32. Slots past N are
// zero rows with a zero gradient; nothing is written for them.
//
// Plain C interface for ctypes. Every entry point launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;        // slots a block takes at a time
constexpr int MT = TILE / 16;   // m16 tiles of a slot tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// c += a b on a 16 x 8 x 16 tile: a's four registers, b's two, c f32
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two floats as bf16, lo in the low half (the lower column of a fragment)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// Shared by both kernels: the layout constants of one <KIN, W> instance.
template <int KIN, int W>
struct Shape {
  static constexpr int K = KIN / 3;        // u and a width
  static constexpr int KS = KIN / 16;      // k16 steps over the input features
  static constexpr int CW = W / WARPS;     // hidden columns a warp owns
  static constexpr int NT = CW / 8;        // its n8 tiles
  static constexpr int WS = W + 8;         // padded row strides (bf16 elements)
  static constexpr int XS = KIN + 8;
  static constexpr int CPR = K / 4;        // float4 chunks of a u or a row
  static constexpr int LOADS = TILE * CPR / THREADS;
  static_assert(KIN % 48 == 0 && W % 64 == 0 && W <= 256, "3K in {48, 96}, W in 64..256");
  static_assert(TILE * CPR % THREADS == 0, "a tile's loads are whole rounds of the block");
};

// W1 [KIN, W] f32 -> bf16 rows of stride WS in shared memory
template <int KIN, int W>
__device__ __forceinline__ void stage_w1(const float* __restrict__ w1, __nv_bfloat16* sW) {
  using S = Shape<KIN, W>;
  for (int i = threadIdx.x; i < KIN * W / 4; i += THREADS) {
    const int r = i / (W / 4), c = (i % (W / 4)) * 4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(w1) + i);
    *reinterpret_cast<uint2*>(sW + r * S::WS + c) = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
  }
}

// Raw f32 tiles of u and a (and, backward, of g and s) in a ring of
// Ring::STAGES slots, filled by cp.async: thread i copies the 16-byte
// chunks i, i + THREADS, ... of a tile (and, if i < TILE, row i's g and
// s), then converts those same chunks, so its own wait_group orders the
// two. The forward's ring is two slots (two blocks share a SM), the
// backward's three.
template <int KIN, bool GRAD>
struct Ring {
  static constexpr int K = KIN / 3;
  static constexpr int STAGES = GRAD ? 3 : 2;
  static constexpr int SLOT = 2 * TILE * K + (GRAD ? 2 * TILE : 0);  // floats
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most STAGES - 2 groups are pending: the oldest tile is in
template <int STAGES>
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2));
}

// Starts the copies of tile `tile` (zeros past n; nothing for a tile past
// the end) into ring slot `slot`, and commits them as one group.
template <int KIN, int W, bool GRAD>
__device__ __forceinline__ void issue_tile(float* ring, int slot, const float* __restrict__ u,
                                           const float* __restrict__ a,
                                           const float* __restrict__ gw,
                                           const float* __restrict__ s, long long n,
                                           long long tile, long long ntiles) {
  using S = Shape<KIN, W>;
  constexpr int K = S::K;
  if (tile < ntiles) {
    float* su = ring + slot * Ring<KIN, GRAD>::SLOT;
    float* sa = su + TILE * K;
#pragma unroll
    for (int l = 0; l < S::LOADS; ++l) {
      const int idx = threadIdx.x + l * THREADS;
      const long long row = tile * TILE + idx / S::CPR;
      const bool ok = row < n;
      const long long off = ok ? row * K + (idx % S::CPR) * 4 : 0;
      cp_async16(su + idx * 4, u + off, ok);
      cp_async16(sa + idx * 4, a + off, ok);
    }
    if (GRAD && threadIdx.x < TILE) {  // GRAD is constant: no branch forward
      const long long row = tile * TILE + threadIdx.x;
      const bool ok = row < n;
      float* sg = sa + TILE * K;
      cp_async4(sg + threadIdx.x, gw + (ok ? row : 0), ok);
      cp_async4(sg + TILE + threadIdx.x, s + (ok ? row : 0), ok);
    }
  }
  cp_async_commit();
}

// [u, u - a, a] in bf16 into the x buffer, from this thread's chunks of
// ring slot `slot`; backward, g_s = g (1 - s) s into gs[row] (the order
// ATen's sigmoid backward takes) for this thread's row, returned (0 for
// threads past the tile).
template <int KIN, int W, bool GRAD>
__device__ __forceinline__ float convert_tile(const float* ring, int slot, __nv_bfloat16* sX,
                                              float* gs) {
  using S = Shape<KIN, W>;
  constexpr int K = S::K;
  const float* su = ring + slot * Ring<KIN, GRAD>::SLOT;
  const float* sa = su + TILE * K;
#pragma unroll
  for (int l = 0; l < S::LOADS; ++l) {
    const int idx = threadIdx.x + l * THREADS;
    const float4 x = *reinterpret_cast<const float4*>(su + idx * 4);
    const float4 y = *reinterpret_cast<const float4*>(sa + idx * 4);
    __nv_bfloat16* row = sX + (idx / S::CPR) * S::XS + (idx % S::CPR) * 4;
    *reinterpret_cast<uint2*>(row) = make_uint2(pack2(x.x, x.y), pack2(x.z, x.w));
    *reinterpret_cast<uint2*>(row + K) =
        make_uint2(pack2(x.x - y.x, x.y - y.y), pack2(x.z - y.z, x.w - y.w));
    *reinterpret_cast<uint2*>(row + 2 * K) = make_uint2(pack2(y.x, y.y), pack2(y.z, y.w));
  }
  float g = 0.0f;
  if (GRAD && threadIdx.x < TILE) {
    const float* sg = sa + TILE * K;
    const float sv = sg[TILE + threadIdx.x];
    g = sg[threadIdx.x] * (1.0f - sv) * sv;
    gs[threadIdx.x] = g;
  }
  return g;
}

constexpr int FWD_BLOCKS = 2;  // forward blocks a SM

template <int KIN, int W>
__global__ void __launch_bounds__(THREADS, FWD_BLOCKS)
att_unit_fwd_kernel(const float* __restrict__ u, const float* __restrict__ a, long long n,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    float* __restrict__ out) {
  using S = Shape<KIN, W>;
  constexpr int NT = S::NT, KS = S::KS, WS = S::WS, XS = S::XS;
  using R = Ring<KIN, false>;
  constexpr int STAGES = R::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);                       // [STAGES][SLOT]
  float* sRow = ring + STAGES * R::SLOT;                              // [WARPS][TILE]
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(sRow + WARPS * TILE);
  __nv_bfloat16* sX = sW + KIN * WS;                                  // [2][TILE][XS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int c0 = warp * S::CW;
  const long long ntiles = (n + TILE - 1) / TILE;
  auto tile_of = [&](long long i) { return blockIdx.x + i * gridDim.x; };

  for (int i = 0; i < STAGES - 1; ++i)
    issue_tile<KIN, W, false>(ring, i, u, a, nullptr, nullptr, n, tile_of(i), ntiles);
  stage_w1<KIN, W>(w1, sW);
  float bc[NT][2], wc[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bc[j][e] = __ldg(b1 + c0 + 8 * j + 2 * t + e);
      wc[j][e] = __ldg(w2 + c0 + 8 * j + 2 * t + e);
    }
  const float bias2 = __ldg(b2);
  cp_async_wait_oldest<STAGES>();
  convert_tile<KIN, W, false>(ring, 0, sX, nullptr);
  issue_tile<KIN, W, false>(ring, STAGES - 1, u, a, nullptr, nullptr, n, tile_of(STAGES - 1),
                            ntiles);
  __syncthreads();
  // the warp's W1 fragments, for the whole launch: B = W1 [k][n] -> .trans
  uint32_t bw[KS][NT][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      ldsm_x2_t(bw[ks][j], sW + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * WS + c0 + 8 * j);

  for (long long i = 0; tile_of(i) < ntiles; ++i) {
    const __nv_bfloat16* x = sX + (i & 1) * TILE * XS;
    __syncthreads();  // x of tile i is whole; sRow's last readers are done
#pragma unroll
    for (int mh = 0; mh < MT; mh += 2) {
      float acc[2][NT][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t af[4];
          ldsm_x4(af, x + ((mh + m) * 16 + (lane & 15)) * XS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma(acc[m][j], af, bw[ks][j][0], bw[ks][j][1]);
        }
      // each row's dot with w2 over the warp's columns
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p0 += fmaxf(bf16_round(acc[m][j][e]) + bc[j][e], 0.0f) * wc[j][e];
            p1 += fmaxf(bf16_round(acc[m][j][2 + e]) + bc[j][e], 0.0f) * wc[j][e];
          }
        p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
        p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
        p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
        p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
        if (t == 0) {
          sRow[warp * TILE + (mh + m) * 16 + g] = p0;
          sRow[warp * TILE + (mh + m) * 16 + g + 8] = p1;
        }
      }
    }
    __syncthreads();  // the row dots are whole; x of tile i is read
    if (threadIdx.x < TILE) {
      const long long row = tile_of(i) * TILE + threadIdx.x;
      float z = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) z += sRow[w * TILE + threadIdx.x];
      if (row < n) out[row] = sigmoid(z + bias2);
    }
    if (tile_of(i + 1) < ntiles) {
      cp_async_wait_oldest<STAGES>();
      convert_tile<KIN, W, false>(ring, (i + 1) % STAGES, sX + ((i + 1) & 1) * TILE * XS,
                                  nullptr);
    }
    issue_tile<KIN, W, false>(ring, (i + STAGES) % STAGES, u, a, nullptr, nullptr, n,
                              tile_of(i + STAGES), ntiles);
  }
}

template <int KIN, int W>
__global__ void __launch_bounds__(THREADS, 1)
att_unit_bwd_kernel(const float* __restrict__ u, const float* __restrict__ a,
                    const float* __restrict__ gw, const float* __restrict__ s, long long n,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, float* __restrict__ du,
                    float* __restrict__ da, float* __restrict__ part, long long stride) {
  using S = Shape<KIN, W>;
  constexpr int NT = S::NT, KS = S::KS, WS = S::WS, XS = S::XS, K = S::K;
  using R = Ring<KIN, true>;
  constexpr int STAGES = R::STAGES;
  constexpr int MW = KIN / 16;          // m16 tiles of dW1's rows (input features)
  constexpr int DJ = K / 8;             // dx: warps across the 8-feature groups of a third
  constexpr int DM = MT * DJ / WARPS;   // dx: m16 tiles a warp takes
  static_assert(MT * DJ % WARPS == 0, "the dx tiles split evenly over the warps");
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);                       // [STAGES][SLOT]
  float* sB1 = ring + STAGES * R::SLOT;
  float* sW2 = sB1 + W;
  float* sGs = sW2 + W;                                               // [2][TILE] g_s
  float* sRed = sGs + 2 * TILE;                                       // [WARPS]
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(sRed + WARPS);
  __nv_bfloat16* sX = sW + KIN * WS;                                  // [2][TILE][XS]
  __nv_bfloat16* sG = sX + 2 * TILE * XS;                             // g_pre, [TILE][WS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int c0 = warp * S::CW;
  const long long ntiles = (n + TILE - 1) / TILE;
  auto tile_of = [&](long long i) { return blockIdx.x + i * gridDim.x; };

  for (int i = 0; i < STAGES - 1; ++i)
    issue_tile<KIN, W, true>(ring, i, u, a, gw, s, n, tile_of(i), ntiles);
  stage_w1<KIN, W>(w1, sW);
  for (int i = threadIdx.x; i < W; i += THREADS) {
    sB1[i] = __ldg(b1 + i);
    sW2[i] = __ldg(w2 + i);
  }
  float dw[MW][NT][4];
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dw[m][j][e] = 0.0f;
  float db1[NT][2], dw2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) db1[j][0] = db1[j][1] = dw2[j][0] = dw2[j][1] = 0.0f;
  cp_async_wait_oldest<STAGES>();
  float db2 = convert_tile<KIN, W, true>(ring, 0, sX, sGs);
  issue_tile<KIN, W, true>(ring, STAGES - 1, u, a, gw, s, n, tile_of(STAGES - 1), ntiles);

  for (long long i = 0; tile_of(i) < ntiles; ++i) {
    const __nv_bfloat16* x = sX + (i & 1) * TILE * XS;
    const float* gsv = sGs + (i & 1) * TILE;
    __syncthreads();  // x and g_s of tile i are whole; tile i - 1's readers of sG are done
    // the first layer again, two m16 tiles at a time, and g_pre into sG
#pragma unroll
    for (int mh = 0; mh < MT; mh += 2) {
      float acc[2][NT][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          ldsm_x4(af[m], x + ((mh + m) * 16 + (lane & 15)) * XS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bf[2];
          ldsm_x2_t(bf, sW + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * WS + c0 + 8 * j);
#pragma unroll
          for (int m = 0; m < 2; ++m) mma(acc[m][j], af[m], bf[0], bf[1]);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r0 = (mh + m) * 16 + g;
        const float gs0 = gsv[r0], gs1 = gsv[r0 + 8];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = c0 + 8 * j + 2 * t;
          float gp[2][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float bias = sB1[c + e], wo = sW2[c + e];
            const float pre0 = bf16_round(acc[m][j][e]) + bias;
            const float pre1 = bf16_round(acc[m][j][2 + e]) + bias;
            dw2[j][e] += gs0 * fmaxf(pre0, 0.0f) + gs1 * fmaxf(pre1, 0.0f);
            gp[0][e] = pre0 > 0.0f ? gs0 * wo : 0.0f;
            gp[1][e] = pre1 > 0.0f ? gs1 * wo : 0.0f;
            db1[j][e] += gp[0][e] + gp[1][e];
          }
          *reinterpret_cast<uint32_t*>(sG + r0 * WS + c) = pack2(gp[0][0], gp[0][1]);
          *reinterpret_cast<uint32_t*>(sG + (r0 + 8) * WS + c) = pack2(gp[1][0], gp[1][1]);
        }
      }
    }
    __syncthreads();  // g_pre of tile i is whole
    // dW1 += x^T g_pre over the warp's columns: A = x^T (.trans), B = g_pre (.trans)
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 16) {
      uint32_t bg[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        ldsm_x2_t(bg[j], sG + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * WS + c0 + 8 * j);
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        uint32_t af[4];
        ldsm_x4_t(af, x + (kk + (lane & 7) + (lane >> 4) * 8) * XS + m * 16 +
                          ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(dw[m][j], af, bg[j][0], bg[j][1]);
      }
    }
    // dx = g_pre W1^T for the warp's DM m16 tiles and, in each third of x,
    // the features [8 jd, 8 jd + 8); B = W1^T [k = hidden][n = feature] is
    // W1's rows: no .trans
    {
      const int jd = warp % DJ, m0 = (warp / DJ) * DM;
      float dacc[DM][3][4];
#pragma unroll
      for (int m = 0; m < DM; ++m)
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) dacc[m][q][e] = 0.0f;
#pragma unroll 4
      for (int kc = 0; kc < W; kc += 16) {
        uint32_t af[DM][4];
#pragma unroll
        for (int m = 0; m < DM; ++m)
          ldsm_x4(af[m], sG + ((m0 + m) * 16 + (lane & 15)) * WS + kc + (lane >> 4) * 8);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          uint32_t bf[2];
          ldsm_x2(bf, sW + (q * K + 8 * jd + (lane & 7)) * WS + kc + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int m = 0; m < DM; ++m) mma(dacc[m][q], af[m], bf[0], bf[1]);
        }
      }
      // du = dx_0 + dx_1, da = dx_2 - dx_1: f32 of the bf16 dx
      const int f = 8 * jd + 2 * t;
#pragma unroll
      for (int m = 0; m < DM; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = tile_of(i) * TILE + (m0 + m) * 16 + g + 8 * h;
          if (row < n) {
            const float x0 = bf16_round(dacc[m][0][2 * h]), y0 = bf16_round(dacc[m][1][2 * h]);
            const float z0 = bf16_round(dacc[m][2][2 * h]);
            const float x1 = bf16_round(dacc[m][0][2 * h + 1]);
            const float y1 = bf16_round(dacc[m][1][2 * h + 1]);
            const float z1 = bf16_round(dacc[m][2][2 * h + 1]);
            *reinterpret_cast<float2*>(du + row * K + f) = make_float2(x0 + y0, x1 + y1);
            *reinterpret_cast<float2*>(da + row * K + f) = make_float2(z0 - y0, z1 - y1);
          }
        }
    }
    if (tile_of(i + 1) < ntiles) {
      cp_async_wait_oldest<STAGES>();
      db2 += convert_tile<KIN, W, true>(ring, (i + 1) % STAGES, sX + ((i + 1) & 1) * TILE * XS,
                                        sGs + ((i + 1) & 1) * TILE);
    }
    issue_tile<KIN, W, true>(ring, (i + STAGES) % STAGES, u, a, gw, s, n, tile_of(i + STAGES),
                             ntiles);
  }

  // the block's partial: dW1 [KIN][W], db1 [W], dw2 [W], db2
  float* p = part + blockIdx.x * stride;
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int f = m * 16 + g, c = c0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(p + f * W + c) = make_float2(dw[m][j][0], dw[m][j][1]);
      *reinterpret_cast<float2*>(p + (f + 8) * W + c) = make_float2(dw[m][j][2], dw[m][j][3]);
    }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = db1[j][e], y = dw2[j][e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        x += __shfl_xor_sync(0xffffffffu, x, o);
        y += __shfl_xor_sync(0xffffffffu, y, o);
      }
      if (g == 0) {
        p[KIN * W + c0 + 8 * j + 2 * t + e] = x;
        p[KIN * W + W + c0 + 8 * j + 2 * t + e] = y;
      }
    }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) db2 += __shfl_xor_sync(0xffffffffu, db2, o);
  if (lane == 0) sRed[warp] = db2;
  __syncthreads();
  if (threadIdx.x == 0) {
    float z = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) z += sRed[w];
    p[KIN * W + 2 * W] = z;
  }
}

// Sums the blocks' partials in block order: dW1 rounded to bf16 (torch's
// bf16 GEMM returns it so), db1, dw2, db2 in f32.
__global__ void att_unit_reduce_kernel(const float* __restrict__ part, int blocks,
                                       long long stride, int kin_w, int w,
                                       float* __restrict__ dw1, float* __restrict__ db1,
                                       float* __restrict__ dw2, float* __restrict__ db2) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j > kin_w + 2 * w) return;
  float z = 0.0f;
  for (int b = 0; b < blocks; ++b) z += part[b * stride + j];
  if (j < kin_w) {
    dw1[j] = bf16_round(z);
  } else if (j < kin_w + w) {
    db1[j - kin_w] = z;
  } else if (j < kin_w + 2 * w) {
    dw2[j - kin_w - w] = z;
  } else {
    db2[0] = z;
  }
}

template <int KIN, int W>
size_t fwd_smem() {
  using S = Shape<KIN, W>;
  using R = Ring<KIN, false>;
  return (R::STAGES * R::SLOT + WARPS * TILE) * sizeof(float) +
         (KIN * S::WS + 2 * TILE * S::XS) * sizeof(__nv_bfloat16);
}

template <int KIN, int W>
size_t bwd_smem() {
  using S = Shape<KIN, W>;
  using R = Ring<KIN, true>;
  return (R::STAGES * R::SLOT + 2 * W + 2 * TILE + WARPS) * sizeof(float) +
         (KIN * S::WS + 2 * TILE * S::XS + TILE * S::WS) * sizeof(__nv_bfloat16);
}

// Raises a kernel's dynamic shared memory limit to `smem` on the current
// device, once a device (a bit of *set_on each; the attribute call costs
// host time on every launch otherwise). False if the call failed.
template <typename Kernel>
bool raise_smem(unsigned long long* set_on, Kernel kernel, size_t smem) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (*set_on & bit)) return true;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return false;
  *set_on |= bit;
  return true;
}

template <int KIN, int W>
int launch_fwd(const float* u, const float* a, long long n, const float* w1, const float* b1,
               const float* w2, const float* b2, float* out, int grid, cudaStream_t stream) {
  const size_t smem = fwd_smem<KIN, W>();
  static unsigned long long set_on = 0;  // devices whose limit this instance has raised
  if (!raise_smem(&set_on, att_unit_fwd_kernel<KIN, W>, smem))
    return static_cast<int>(cudaGetLastError());
  att_unit_fwd_kernel<KIN, W><<<grid, THREADS, smem, stream>>>(u, a, n, w1, b1, w2, b2, out);
  return static_cast<int>(cudaGetLastError());
}

template <int KIN, int W>
int launch_bwd(const float* u, const float* a, const float* gw, const float* s, long long n,
               const float* w1, const float* b1, const float* w2, float* du, float* da,
               float* part, long long stride, int grid, cudaStream_t stream) {
  const size_t smem = bwd_smem<KIN, W>();
  static unsigned long long set_on = 0;
  if (!raise_smem(&set_on, att_unit_bwd_kernel<KIN, W>, smem))
    return static_cast<int>(cudaGetLastError());
  att_unit_bwd_kernel<KIN, W><<<grid, THREADS, smem, stream>>>(u, a, gw, s, n, w1, b1, w2, du, da,
                                                               part, stride);
  return static_cast<int>(cudaGetLastError());
}

#define AU_BY_WIDTH(KIN_, FN, ...)                   \
  switch (w) {                                       \
    case 64: return FN<KIN_, 64>(__VA_ARGS__);       \
    case 128: return FN<KIN_, 128>(__VA_ARGS__);     \
    case 192: return FN<KIN_, 192>(__VA_ARGS__);     \
    case 256: return FN<KIN_, 256>(__VA_ARGS__);     \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

extern "C" {

// The tile of slots a block takes, and the forward's blocks a SM (the
// backward takes one, and its partial one row of the workspace a block).
int tr_att_unit_tile() { return TILE; }
int tr_att_unit_fwd_blocks() { return FWD_BLOCKS; }

// Forward. u, a [n, k] f32 contiguous, 16-byte aligned; w1 [3k, w] f32;
// b1, w2 [w]; b2 [1]; out [n]. k in {16, 32}, w in {64, 128, 192, 256};
// grid at most ceil(n / tile) blocks (the caller's: tr_att_unit_fwd_blocks()
// a SM).
int tr_att_unit_forward(const float* u, const float* a, long long n, int k, int w,
                        const float* w1, const float* b1, const float* w2, const float* b2,
                        float* out, int grid, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 16) { AU_BY_WIDTH(48, launch_fwd, u, a, n, w1, b1, w2, b2, out, grid, st) }
  if (k == 32) { AU_BY_WIDTH(96, launch_fwd, u, a, n, w1, b1, w2, b2, out, grid, st) }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward. gw, s [n] f32 (the weight's gradient and the forward's
// weight); du, da [n, k]; part [grid, stride] f32 scratch, stride >=
// 3k w + 2w + 1 and even. Writes du, da and the partials.
int tr_att_unit_backward(const float* u, const float* a, const float* gw, const float* s,
                         long long n, int k, int w, const float* w1, const float* b1,
                         const float* w2, float* du, float* da, float* part, long long stride,
                         int grid, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 16) {
    AU_BY_WIDTH(48, launch_bwd, u, a, gw, s, n, w1, b1, w2, du, da, part, stride, grid, st)
  }
  if (k == 32) {
    AU_BY_WIDTH(96, launch_bwd, u, a, gw, s, n, w1, b1, w2, du, da, part, stride, grid, st)
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The partials' sum: dw1 [3k, w] (bf16-rounded), db1 [w], dw2 [w], db2 [1].
int tr_att_unit_reduce(const float* part, int blocks, long long stride, int kin, int w,
                       float* dw1, float* db1, float* dw2, float* db2, void* stream) {
  const int total = kin * w + 2 * w + 1;
  att_unit_reduce_kernel<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      part, blocks, stride, kin * w, w, dw1, db1, dw2, db2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
