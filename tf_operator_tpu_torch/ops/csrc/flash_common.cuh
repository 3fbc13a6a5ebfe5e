// Pieces shared by the port's CUDA kernels: the element type's planes and
// the f32 split (every kernel), the bf16 packing, the mma.sync.m16n8k16
// fragments with ldmatrix and cp.async (K8, fused_linear_stats.cu), and the
// launch. The TMA + wgmma helpers are in hopper.cuh, which includes this
// file.
//
// bf16 and f32 run the same kernels. An f32 value is split into two bf16
// planes, x = hi + lo with hi = bf16(x) and lo = bf16(x - hi) (the residual
// left after hi is below 2^-16 |x|), and each product is the three products
// hi.hi + hi.lo + lo.hi (lo.lo, below 2^-16 of the product, is left out);
// values that come from registers (P, dS) are split the same way. So the
// f32 kernel is the bf16 kernel's own code (tiles, walks, masks,
// descriptors) run at close to f32 precision, and holding it to the plain
// version at f32 tolerance checks that code.
//
// The tensor cores' f32 accumulation drops the low bits of each sum toward
// zero, a bias that grows with the number of products summed into one
// accumulator: on an H100, dv of O(1) at t = 2048 (causal, g = 4: 1536
// products into one accumulator) came out 3.4e-4 off the plain version. So
// the f32 kernels sum a tile's products into a fresh accumulator and add it
// to the running sum on the CUDA cores, which round to nearest.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;  // as flash_attention.py NEG_INF
constexpr int kMaxSmem = 232448;   // the H100's per-block opt-in limit (227 KB)
// Scores are kept in log2 units (scale * log2(e) folded into one
// multiply) so each exponential is a single exp2.
constexpr float kLog2e = 1.4426950408889634f;

// Bf16 planes per operand: 1 for bf16, 2 (hi, lo) for f32.
template <typename T> struct Planes;
template <> struct Planes<__nv_bfloat16> { static constexpr int value = 1; };
template <> struct Planes<float> { static constexpr int value = 2; };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// the A fragment of the next product over those 16 columns. wgmma's sums
// and its A operand from registers take the same layouts, a warp's 16 rows
// each.

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

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
