// Fused matmul + batch-norm statistics for Hopper (sm_90a): K8.
//
// Replaces tf_operator_tpu/ops/fused_linear_stats.py::_kernel (:69), launched
// by _fwd_impl (:126): y [M, N] = xin [M, K] @ w [K, N], where xin is x or,
// with the prologue, relu(x * a + b) (a, b [K] f32: the previous layer's
// folded BN affine), and per column n the sum and the sum of squares of the
// f32 product. ResNet's bottleneck runs its 1x1 convolutions (conv1, conv3,
// the projection) through it as [b*h*w, cin] @ [cin, cout].
//
// Bound: at ResNet-50, b 128, 224^2 the path's 36 launches a step span M
// 6,272 to 401,408 and K, N 64 to 2,048. Stages 0 and 1 are bytes-bound
// (conv3 at M 401,408, K 64, N 256: 0.077 ms of bytes at 3.35 TB/s against
// 0.013 ms of operations at 989 TFLOP/s), stage 3 operations-bound. So the
// product runs on the tensor cores and the statistics cost no extra pass
// over y:
//   - one block per (128-row, BN-column) tile of y, BN 128, or 64 where N is
//     at most 64 (8 of the 36 launches: 128-wide tiles would waste half of
//     each block there). Each of the 2 x BN/32 warps owns a 64 x 32 piece of
//     the tile in registers, bf16 mma.sync.m16n8k16 with f32 accumulation
//     from ldmatrix fragments; the next 32-deep slice of both operands
//     streams in with cp.async while the current one is multiplied (two
//     stages). Each 16-deep product goes into a fresh accumulator that is
//     then added to the sum on the CUDA cores: the tensor cores drop the low
//     bits of their f32 sums toward zero, which straight into a K-deep sum
//     would bias the sum of squares by ~K/16 ulps;
//   - the statistics come from the unrounded f32 accumulator, never from the
//     rounded y. The TPU kernel added each M block's sums into one resident
//     stats block, which only its sequential grid order makes sound. Here
//     blocks run in no order, so each block reduces its tile by column (warp
//     shuffles over the rows a warp holds, then shared memory across the
//     two row warps) and writes one partial row to an f32 [2][ceil(M/128)][N]
//     buffer; the wrapper sums the partial rows, as the JAX wrapper sums its
//     8 stat rows outside the kernel. No atomics, so the result does not
//     change from run to run;
//   - the prologue applies relu(x * a + b) in f32 (one fused multiply-add)
//     on the way into shared memory, then rounds to bf16 for the tensor
//     cores (the TPU kept it in f32; a declared difference, see ROADMAP
//     Queue 3). Rows past M and columns past K stay zero, not relu(b);
//   - any M, N and K are masked; K and N must be multiples of 8 (16-byte
//     rows), and M at most 65,535 row tiles.
// T = f32 runs this same code on operands split into bf16 hi + lo, three
// products each (see flash_common.cuh), so the f32 check vouches for the bf16
// code's tiling, masks and reductions. The split keeps each operand to
// ~2^-17 of itself; a weight's dropped bits are the same for every row, so
// where the rows are all >= 0 (ReLU'd activations) they add up in a
// column's sum instead of cancelling: up to ~100 f32 ulps of sum|y| on an
// H100, against ~5 for bf16 operands (chip_smoke.FLS_STATS_C). Loads that apply the prologue or split
// go through registers instead of cp.async. Not done yet: wgmma, TMA, more
// stages, persistent blocks.

#include "flash_common.cuh"

namespace fls {
namespace {

using bf16 = __nv_bfloat16;
using flash::Planes;

constexpr int kBM = 128;      // output tile rows
constexpr int kBK = 32;       // depth of one pipeline stage
constexpr int kPad = 8;       // bf16 elements added to each shared row (no bank conflicts)
constexpr int kMaxTiles = 65535;  // row tiles on gridDim.y

// Tile geometry for a BN-column output tile: 2 warps along M (64 rows each)
// by BN / 32 along N (32 columns each); A is [kBM][kBK], B is [kBK][BN].
template <int BN>
struct Tile {
  static constexpr int kWarpsN = BN / 32;
  static constexpr int kThreads = 64 * kWarpsN;
  static constexpr int ldA = kBK + kPad;
  static constexpr int planeA = kBM * ldA;
  static constexpr int ldB = BN + kPad;
  static constexpr int planeB = kBK * ldB;
};

template <typename T, int BN>
__host__ __device__ constexpr int stage_elems() {
  return Planes<T>::value * (Tile<BN>::planeA + Tile<BN>::planeB);
}
template <typename T, int BN>
constexpr size_t smem_bytes() {
  const size_t pipe = 2 * (size_t)stage_elems<T, BN>() * sizeof(bf16);
  const size_t red = 4 * (size_t)BN * sizeof(float);  // the statistics' reduction
  return pipe > red ? pipe : red;
}

// Rows [r0, r0 + ROWS) x cols [c0, c0 + COLS) of the row-major matrix src
// (leading dimension ld, valid rows < rmax, valid cols < cmax, cmax % 8 == 0)
// into a shared tile [planes][ROWS][COLS + kPad]; chunks out of range are
// zeros. PRO applies relu(v * a[col] + b[col]) in f32 to valid elements
// first. bf16 without PRO: cp.async (the caller commits and waits);
// otherwise read, transformed, rounded or split, and stored before returning.
template <typename T, int ROWS, int COLS, bool PRO, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const T* __restrict__ src, int ld, int r0,
                                          int c0, int rmax, int cmax, const float* __restrict__ a,
                                          const float* __restrict__ b) {
  constexpr int LDS = COLS + kPad, CH = COLS / 8, PLANE = ROWS * LDS;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH;
    const int c = (i - r * CH) * 8;
    const int row = r0 + r, col = c0 + c;
    const bool valid = row < rmax && col < cmax;
    const T* g = valid ? src + (size_t)row * ld + col : src;
    bf16* s = dst + r * LDS + c;
    if constexpr (Planes<T>::value == 1 && !PRO) {
      flash::cp_async16(s, g, valid);
    } else {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
      if (valid) {
        if constexpr (Planes<T>::value == 1) {
          const uint4 raw = *reinterpret_cast<const uint4*>(g);
          const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w4[j]));
            v[2 * j] = f.x;
            v[2 * j + 1] = f.y;
          }
        } else {
          const float4 lo = reinterpret_cast<const float4*>(g)[0];
          const float4 hi = reinterpret_cast<const float4*>(g)[1];
          v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
          v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
        }
        if constexpr (PRO) {
          const float4 a0 = reinterpret_cast<const float4*>(a + col)[0];
          const float4 a1 = reinterpret_cast<const float4*>(a + col)[1];
          const float4 b0 = reinterpret_cast<const float4*>(b + col)[0];
          const float4 b1 = reinterpret_cast<const float4*>(b + col)[1];
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = fmaxf(__fmaf_rn(v[j], av[j], bv[j]), 0.f);
        }
      }
      if constexpr (Planes<T>::value == 1) {
        uint4 h;
        h.x = flash::pack_bf16(v[0], v[1]);
        h.y = flash::pack_bf16(v[2], v[3]);
        h.z = flash::pack_bf16(v[4], v[5]);
        h.w = flash::pack_bf16(v[6], v[7]);
        *reinterpret_cast<uint4*>(s) = h;
      } else {
        uint4 h, l;
        flash::split_pack(v[0], v[1], h.x, l.x);
        flash::split_pack(v[2], v[3], h.y, l.y);
        flash::split_pack(v[4], v[5], h.z, l.z);
        flash::split_pack(v[6], v[7], h.w, l.w);
        *reinterpret_cast<uint4*>(s) = h;
        *reinterpret_cast<uint4*>(s + PLANE) = l;
      }
    }
  }
}

// A 16 x 16 (m x k) fragment from a tile stored [m][k]; frag[p] from plane p.
template <int P>
__device__ __forceinline__ void frag_a(uint32_t (*a)[4], const bf16* tile, int plane, int ld,
                                       int m0, int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < P; ++p)
    flash::ldsm_x4(a[p], tile + p * plane + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B of two 8-column blocks n0, n0 + 8 at depth [k0, k0 + 16) from a tile
// stored [k][n]: ldmatrix.trans.
template <int P>
__device__ __forceinline__ void frag_b(uint32_t (*b)[4], const bf16* tile, int plane, int ld,
                                       int n0, int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < P; ++p)
    flash::ldsm_x4_trans(b[p], tile + p * plane + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                                   n0 + (lane >> 4) * 8);
}

// c += A.B over 16 x 8 (B the 8-column block nb of fragments b), through a
// fresh accumulator added on the CUDA cores (see the header); split f32:
// hi.hi + hi.lo + lo.hi (flash_common.cuh).
template <int P>
__device__ __forceinline__ void mma_fresh(float* c, uint32_t (*a)[4], uint32_t (*b)[4], int nb) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (P == 2) {
    flash::mma16816(part, a[1], b[0][2 * nb], b[0][2 * nb + 1]);
    flash::mma16816(part, a[0], b[1][2 * nb], b[1][2 * nb + 1]);
  }
  flash::mma16816(part, a[0], b[0][2 * nb], b[0][2 * nb + 1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += part[i];
}

// acc[mi][ni] += A.B over one kBK-deep stage: the warp's 64 x 32 piece at
// (wm0, wn0) of the tile, 4 x 4 mma tiles of 16 x 8.
template <int P, int BN>
__device__ __forceinline__ void mma_stage(float (*acc)[4][4], const bf16* as, const bf16* bs,
                                          int wm0, int wn0) {
  using TL = Tile<BN>;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t a[4][P][4];
    uint32_t b[2][P][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) frag_a<P>(a[mi], as, TL::planeA, TL::ldA, wm0 + 16 * mi, 16 * kk);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) frag_b<P>(b[nj], bs, TL::planeB, TL::ldB, wn0 + 16 * nj, 16 * kk);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_fresh<P>(acc[mi][ni], a[mi], b[ni >> 1], ni & 1);
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}
__device__ __forceinline__ void store_pair(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}

// y = xin @ w in T; part[0][tile][n] and part[1][tile][n] the sum and the sum
// of squares over the tile's rows of the f32 product's column n.
template <typename T, int BN, bool PRO>
__global__ void __launch_bounds__(Tile<BN>::kThreads)
fls_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ a,
           const float* __restrict__ b, T* __restrict__ y, float* __restrict__ part, int M, int K,
           int N) {
  using TL = Tile<BN>;
  constexpr int P = Planes<T>::value;
  constexpr int SE = stage_elems<T, BN>();
  constexpr int AE = P * TL::planeA;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / TL::kWarpsN;
  const int wm0 = wm * 64, wn0 = (warp % TL::kWarpsN) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  auto load = [&](int step, bf16* as, bf16* bs) {
    const int k0 = step * kBK;
    load_tile<T, kBM, kBK, PRO, TL::kThreads>(as, x, K, m0, k0, M, K, a, b);
    load_tile<T, kBK, BN, false, TL::kThreads>(bs, w, N, k0, n0, K, N, nullptr, nullptr);
  };
  // two stages alternate, the next loading while the current is multiplied
  const int steps = (K + kBK - 1) / kBK;
  load(0, smem, smem + AE);
  flash::cp_async_commit();
  for (int i = 0; i < steps; ++i) {
    bf16* cur = smem + (i & 1) * SE;
    if (i + 1 < steps) {
      bf16* nxt = smem + ((i + 1) & 1) * SE;
      load(i + 1, nxt, nxt + AE);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    mma_stage<P, BN>(acc, cur, cur + AE, wm0, wn0);
    __syncthreads();  // the stage is free for the load two steps on
  }

  // y, rounded to T
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm0 + 16 * mi + (lane >> 2) + 8 * half;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn0 + 8 * ni + 2 * (lane & 3);
        if (row < M && col < N)
          store_pair(y + (size_t)row * N + col, acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
  }

  // statistics of the f32 accumulator: this thread's 8 rows, then the 8
  // lanes that hold the same columns (lane bits 2-4), then the two row warps
  float s[4][2], q[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) s[ni][0] = s[ni][1] = q[ni][0] = q[ni][1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm0 + 16 * mi + (lane >> 2) + 8 * half;
      const float keep = row < M ? 1.f : 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float v = acc[mi][ni][2 * half + j] * keep;
          s[ni][j] += v;
          q[ni][j] += v * v;
        }
      }
    }
  }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[ni][j] += __shfl_xor_sync(0xffffffffu, s[ni][j], off);
        q[ni][j] += __shfl_xor_sync(0xffffffffu, q[ni][j], off);
      }
    }
  }
  float* red = reinterpret_cast<float*>(smem_raw);  // [2 stats][2 row warps][BN]
  if (lane < 4) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn0 + 8 * ni + 2 * lane + j;
        red[wm * BN + c] = s[ni][j];
        red[(2 + wm) * BN + c] = q[ni][j];
      }
    }
  }
  __syncthreads();
  const size_t tiles = gridDim.y;
  for (int c = threadIdx.x; c < BN; c += TL::kThreads) {
    const int col = n0 + c;
    if (col < N) {
      part[(size_t)blockIdx.y * N + col] = red[c] + red[BN + c];
      part[(tiles + blockIdx.y) * N + col] = red[2 * BN + c] + red[3 * BN + c];
    }
  }
}

template <typename T, int BN, bool PRO>
int run(const void* x, const void* w, const float* a, const float* b, void* y, float* part, int M,
        int K, int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + kBM - 1) / kBM);
  return flash::launch(fls_kernel<T, BN, PRO>, grid, Tile<BN>::kThreads, smem_bytes<T, BN>(),
                       stream, static_cast<const T*>(x), static_cast<const T*>(w), a, b,
                       static_cast<T*>(y), part, M, K, N);
}

template <typename T>
int dispatch(const void* x, const void* w, const float* a, const float* b, void* y, float* part,
             int M, int K, int N, bool relu, cudaStream_t st) {
  if (N <= 64)
    return relu ? run<T, 64, true>(x, w, a, b, y, part, M, K, N, st)
                : run<T, 64, false>(x, w, a, b, y, part, M, K, N, st);
  return relu ? run<T, 128, true>(x, w, a, b, y, part, M, K, N, st)
              : run<T, 128, false>(x, w, a, b, y, part, M, K, N, st);
}

}  // namespace
}  // namespace fls

// C entry (ctypes). x [M, K], w [K, N], y [M, N] are contiguous, 16-byte
// aligned, bf16 (bf16 = 1) or f32; with relu = 1, a and b are contiguous,
// 16-byte aligned f32 [K]; part is f32 [2][ceil(M / 128)][N]. Returns
// cudaGetLastError() after the launch (0 when it was taken), or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int fused_linear_stats(const void* x, const void* w, const float* a, const float* b,
                                  void* y, float* part, int M, int K, int N, int relu, int bf16,
                                  void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || (M + fls::kBM - 1) / fls::kBM > fls::kMaxTiles ||
      (relu && (a == nullptr || b == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? fls::dispatch<__nv_bfloat16>(x, w, a, b, y, part, M, K, N, relu != 0, st)
              : fls::dispatch<float>(x, w, a, b, y, part, M, K, N, relu != 0, st);
}
