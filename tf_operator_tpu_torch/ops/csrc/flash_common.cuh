// Pieces shared by the flash-attention backward kernels (flash_bwd.cu),
// which K8 borrows; the TMA + wgmma kernels (flash_fwd.cu,
// grouped_matmul.cu) take only the constants, the bf16 packing, the f32
// split and the launch from here.
//
// One kernel per function, templated on the element type T and the head
// dimension D (16..128, so the register arrays have fixed sizes). Every
// product is a tensor-core mma.sync.m16n8k16 on bf16 operands with f32
// accumulation. Every warp owns 16 rows of the block's 64-row tile and
// keeps its score tile, softmax state and output accumulators in
// registers; operands come from shared memory through ldmatrix.
//
//   - T = bf16 (the training path): one bf16 plane per shared tile, and
//     the next K/V (or Q/dO) tile streams in with cp.async while the
//     current one is used.
//   - T = f32: each value is split on load into two bf16 planes,
//     x = hi + lo with hi = bf16(x) and lo = bf16(x - hi) (the residual
//     left after hi is below 2^-16 |x|), and each product is the three
//     mma's hi.hi + hi.lo + lo.hi, summed apart and added to the f32
//     accumulator on the CUDA cores (see mma below); P and dS, which come
//     from registers, are split the same way. So the f32 kernel is the
//     bf16 kernel's own code (tiles, loop bounds, causal and ragged-edge
//     masks, online softmax, group sums) run at close to f32 precision,
//     and holding it to the plain version at f32 tolerance checks that
//     code. Its loads are plain (not cp.async), since each value must be
//     split on the way into shared memory.
//
// Layouts: q, o, do, dq are [b, t, h, d] and k, v, dk, dv are [b, t, h_kv, d],
// contiguous (the model's own layout; no transpose copy). lse and delta are
// [b, h, t] f32. Query head hi reads kv head hi / (h / h_kv).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;  // as flash_attention.py NEG_INF
constexpr int kMaxSmem = 232448;   // the H100's per-block opt-in limit (227 KB)

// ---------------------------------------------------------------------------
// mma.m16n8k16 fragments, ldmatrix, cp.async
// ---------------------------------------------------------------------------
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, q = lane % 4):
//   A 16x16: a0 (row g, cols 2q..2q+1), a1 (row g+8, same cols),
//            a2 (row g, cols 2q+8..), a3 (row g+8, cols 2q+8..)
//   B 16x8:  b0 (rows 2q..2q+1, col g), b1 (rows 2q+8.., col g)
//   C 16x8:  c0, c1 (row g, cols 2q, 2q+1), c2, c3 (row g+8, same cols)
// so the C tiles of two neighbouring 8-column blocks, packed to bf16, are
// the A fragment of the next product over those 16 columns.

constexpr int kMmaTile = 64;  // rows of a block's tile; 4 warps x 16 rows
// Scores are kept in log2 units (scale * log2(e) folded into one
// multiply) so each exponential is a single exp2.
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int mma_ld(int d) { return d + 8; }  // bf16 tile row, elements

// Bf16 planes per operand: 1 for bf16, 2 (hi, lo) for f32.
template <typename T> struct Planes;
template <> struct Planes<__nv_bfloat16> { static constexpr int value = 1; };
template <> struct Planes<float> { static constexpr int value = 2; };

// Elements of one shared tile (all its planes), and its bytes.
template <typename T, int D>
__host__ __device__ constexpr int tile_elems() { return Planes<T>::value * kMmaTile * mma_ld(D); }
template <typename T, int D>
__host__ __device__ constexpr size_t tile_bytes() {
  return (size_t)tile_elems<T, D>() * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills when !valid (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0, x1 -> the packed bf16 pair of their hi parts, and of their lo parts.
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// Rows [r0, r0 + 64) of one head of a [b, t, heads, D] tensor into a shared
// tile [planes][64][mma_ld(D)]; rows at or past t are zeros. bf16:
// asynchronous (cp.async; the caller commits and waits). f32: read, split
// and stored before returning.
template <typename T, int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const T* __restrict__ src, int bi,
                                          int hi, int r0, int t, int heads) {
  constexpr int kChunks = D / 8;  // 8 elements a chunk: 16 bytes of bf16
  for (int e = threadIdx.x; e < kMmaTile * kChunks; e += blockDim.x) {
    const int r = e / kChunks;
    const int c = (e - r * kChunks) * 8;
    const int row = r0 + r;
    const bool valid = row < t;
    const T* g = valid ? src + (((size_t)bi * t + row) * heads + hi) * (size_t)D + c : src;
    __nv_bfloat16* s = dst + r * mma_ld(D) + c;
    if constexpr (Planes<T>::value == 1) {
      cp_async16(s, g, valid);
    } else {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (valid) {
        a = reinterpret_cast<const float4*>(g)[0];
        b = reinterpret_cast<const float4*>(g)[1];
      }
      uint4 h, l;
      split_pack(a.x, a.y, h.x, l.x);
      split_pack(a.z, a.w, h.y, l.y);
      split_pack(b.x, b.y, h.z, l.z);
      split_pack(b.z, b.w, h.w, l.w);
      *reinterpret_cast<uint4*>(s) = h;
      *reinterpret_cast<uint4*>(s + kMmaTile * mma_ld(D)) = l;
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Each loader below fills one fragment per plane, P = Planes<T>::value:
// frag[p] comes from plane p of the tile, kMmaTile * ld elements apart.

// A fragment of rows [r0, r0 + 16) x cols [c0, c0 + 16) of a row-major tile.
template <int P>
__device__ __forceinline__ void load_a(uint32_t (*a)[4], const __nv_bfloat16* tile, int ld,
                                       int r0, int c0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < P; ++p)
    ldsm_x4(a[p], tile + p * kMmaTile * ld + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two 8-column blocks n0 and n0 + 8, depth [k0, k0 + 16),
// where B[k][n] = tile[n][k] (the tile's rows are B's columns: K for q.k^T):
// b[p][0], b[p][1] for n0; b[p][2], b[p][3] for n0 + 8.
template <int P>
__device__ __forceinline__ void load_b_rows_are_n(uint32_t (*b)[4], const __nv_bfloat16* tile,
                                                  int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < P; ++p)
    ldsm_x4(b[p], tile + p * kMmaTile * ld + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                      ((lane >> 3) & 1) * 8);
}

// The same where B[k][n] = tile[k][n] (the tile's rows are B's depth: V for p.v).
template <int P>
__device__ __forceinline__ void load_b_rows_are_k(uint32_t (*b)[4], const __nv_bfloat16* tile,
                                                  int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < P; ++p)
    ldsm_x4_trans(b[p], tile + p * kMmaTile * ld + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                            n0 + (lane >> 4) * 8);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A.B over 16 x 8, B the 8-column block `nb` (0 or 1) of fragments b.
// bf16: one mma into c. Split f32: hi.hi + hi.lo + lo.hi (lo.lo, below
// 2^-16 of the product, is left out), summed into a fresh accumulator and
// then added to c on the CUDA cores. The tensor cores' f32 accumulation
// drops the low bits of each sum toward zero, and straight into c that
// bias grows with the number of steps: on an H100, dv of O(1) at t = 2048
// (causal, g = 4: 1536 mma's into one accumulator) came out 3.4e-4 off
// the plain version. A fresh 16-deep partial keeps the bias to an ulp of
// the partial, and the adds round to nearest.
template <int P>
__device__ __forceinline__ void mma(float* c, uint32_t (*a)[4], uint32_t (*b)[4], int nb) {
  if constexpr (P == 1) {
    mma16816(c, a[0], b[0][2 * nb], b[0][2 * nb + 1]);
  } else {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma16816(part, a[1], b[0][2 * nb], b[0][2 * nb + 1]);
    mma16816(part, a[0], b[1][2 * nb], b[1][2 * nb + 1]);
    mma16816(part, a[0], b[0][2 * nb], b[0][2 * nb + 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += part[i];
  }
}

// The A fragment (per plane) over columns [16 kk, 16 kk + 16) of a warp's
// 16 x 64 f32 C tiles c[8][4] (score-shaped): rounded to bf16, or split.
template <int P>
__device__ __forceinline__ void c_to_a(uint32_t (*a)[4], float (*c)[4], int kk) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float* src = c[2 * kk + (j >> 1)] + 2 * (j & 1);  // a0..a3 as in the layout above
    if constexpr (P == 1) {
      a[0][j] = pack_bf16(src[0], src[1]);
    } else {
      split_pack(src[0], src[1], a[0][j], a[1][j]);
    }
  }
}

// Store a warp's 16 x D f32 accumulator acc[D/8][4] (rows row0 and row0 + 8)
// times `s0` / `s1` (per row) to one head of a [b, t, heads, D] tensor of T.
template <typename T, int D>
__device__ __forceinline__ void store_acc(T* __restrict__ dst, float (*acc)[4], float s0, float s1,
                                          int bi, int hi, int row0, int t, int heads) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= t) continue;
    const float sc = half ? s1 : s0;
    T* out = dst + (((size_t)bi * t + row) * heads + hi) * (size_t)D + 2 * q;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = acc[n][2 * half] * sc, x1 = acc[n][2 * half + 1] * sc;
      if constexpr (Planes<T>::value == 1) {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) = __floats2bfloat162_rn(x0, x1);
      } else {
        *reinterpret_cast<float2*>(out + 8 * n) = make_float2(x0, x1);
      }
    }
  }
}

// Run the statements with a compile-time D equal to the head dim d (the
// statements end in a return); other head dims return an error.
#define FLASH_DISPATCH_D(d, ...)                       \
  switch (d) {                                         \
    case 16: { constexpr int D = 16; __VA_ARGS__; }    \
    case 32: { constexpr int D = 32; __VA_ARGS__; }    \
    case 48: { constexpr int D = 48; __VA_ARGS__; }    \
    case 64: { constexpr int D = 64; __VA_ARGS__; }    \
    case 80: { constexpr int D = 80; __VA_ARGS__; }    \
    case 96: { constexpr int D = 96; __VA_ARGS__; }    \
    case 112: { constexpr int D = 112; __VA_ARGS__; }  \
    case 128: { constexpr int D = 128; __VA_ARGS__; }  \
    default: return (int)cudaErrorInvalidValue;        \
  }

// Set a block-size-dependent dynamic shared memory limit above 48 KB and
// launch; returns cudaGetLastError() so a refused launch reaches Python.
template <typename Kernel, typename... Args>
inline int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                  cudaStream_t stream, Args... args) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace flash
