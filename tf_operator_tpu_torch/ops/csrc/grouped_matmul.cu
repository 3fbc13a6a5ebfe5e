// Grouped (block-diagonal) matmul for Hopper (sm_90a): the MoE experts.
//
// Replaces the four Pallas TPU kernels of tf_operator_tpu/ops/grouped_matmul.py:
//   gmm_fwd        <- _gmm_fwd_kernel (K5): y[r] = x[r] @ w[be[r / B]], with
//                     be[i] = -1 (a sentinel block) writing zeros; with
//                     trans = 1 the product is x[r] @ w[e]^T (the dx of K5)
//   gmm_fwd_scaled <- _gmm_fwd_scaled_kernel (K6): the same times an f32
//                     row_scale[r], applied to the f32 sum before rounding
//   gmm_dw         <- _dw_kernel (K7a): dw[e] = sum over the blocks of e of
//                     x_b^T dy_b, f32
//   gmm_dw_scaled  <- _dw_scaled_kernel (K7b): dw[e] = sum (s * x_b)^T dy_b
// B is the routing block (block_rows rows, a multiple of kBM); rows arrive
// grouped so that every block belongs to one expert.
//
// Bound: operations. At moe-small's training shape (10240 routed rows,
// 768 <-> 3072, 8 experts) each launch does 2 * 10240 * 768 * 3072 =
// 48.3 GFLOP, 0.049 ms at the H100's 989 TFLOP/s bf16 dense peak, against
// ~116 MB of operands (0.035 ms at 3.35 TB/s). So every product runs on
// the tensor cores (bf16 mma.sync.m16n8k16 with f32 accumulation, operands
// through ldmatrix from shared memory), in 128 x 128 output tiles:
//   - forward (K5, K6): one block per (128-row tile inside a routing block,
//     128-column tile). The block reads its block's expert from `be`
//     itself; a sentinel block writes its zeros and does no product. The
//     TPU steered the weight BlockSpec by a scalar-prefetched map; here the
//     block offsets its own weight pointer. dx reads w[e] in place through
//     the B tile's other layout (its rows are the output's columns, loaded
//     without .trans), so no w^T is materialised, where the JAX rule
//     swaps the axes of w first (grouped_matmul.py:345);
//   - dw (K7a, K7b): one block per (expert, 128-row tile of dw, 128-column
//     tile) walks the expert's block list in a loop, 32 rows a step, and
//     writes its f32 tile once. The TPU carried the accumulator across its
//     sequential grid axis; on Hopper the blocks run in no order, so the
//     walk is the loop inside the block and nothing carries between
//     blocks (no atomics). The sum starts at zero, so an expert with no
//     blocks gets an exact-zero dw. x^T is read through ldmatrix.trans from
//     the [rows][k] tile. The block lists come from the caller
//     (_expert_block_lists, computed on the device): the grid is static;
//   - each of the 8 warps owns a 64 x 32 piece of the tile in registers;
//     the next 32-deep slice of both operands streams in with cp.async
//     (bf16) while the current one is multiplied (two stages);
//   - K7b's scale multiplies the x rows in f32 on their way into shared
//     memory, then rounds to bf16 (the TPU kept s * x in f32; a declared
//     difference, see ROADMAP Queue 3).
// T = f32 runs this same code on operands split into bf16 hi + lo, three
// products each (see flash_common.cuh), so the f32 check vouches for the
// bf16 code's tiling, walks and masks. Loads that scale or split go
// through registers instead of cp.async. Not done yet: wgmma, TMA, more
// stages, persistent blocks.

#include "flash_common.cuh"

namespace gmm {
namespace {

using bf16 = __nv_bfloat16;
using flash::Planes;

constexpr int kBM = 128;  // output tile rows
constexpr int kBN = 128;  // output tile columns
constexpr int kBK = 32;   // depth of one pipeline stage
constexpr int kThreads = 256;  // 8 warps: 2 (rows) x 4 (columns), 64 x 32 each
constexpr int kPad = 8;   // bf16 elements added to each shared row (no bank conflicts)

// Rows [r0, r0 + ROWS) x cols [c0, c0 + COLS) of the row-major matrix src
// (leading dimension ld, valid rows < rmax, valid cols < cmax, cmax % 8 == 0)
// into a shared tile [planes][ROWS][COLS + kPad]; chunks out of range are
// zeros. SCALE multiplies source row `row` by scale[row] in f32 first.
// bf16 unscaled: cp.async (the caller commits and waits); otherwise read,
// scaled, rounded or split, and stored before returning.
template <typename T, int ROWS, int COLS, bool SCALE>
__device__ __forceinline__ void load_tile(bf16* dst, const T* __restrict__ src, int ld, int r0,
                                          int c0, int rmax, int cmax,
                                          const float* __restrict__ scale) {
  constexpr int LDS = COLS + kPad, CH = COLS / 8, PLANE = ROWS * LDS;
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
    const int r = i / CH;
    const int c = (i - r * CH) * 8;
    const int row = r0 + r, col = c0 + c;
    const bool valid = row < rmax && col < cmax;
    const T* g = valid ? src + (size_t)row * ld + col : src;
    bf16* s = dst + r * LDS + c;
    if constexpr (Planes<T>::value == 1 && !SCALE) {
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
          const float4 a = reinterpret_cast<const float4*>(g)[0];
          const float4 b = reinterpret_cast<const float4*>(g)[1];
          v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
          v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
        }
        if constexpr (SCALE) {
          const float sc = scale[row];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] *= sc;
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

// Fragment loaders (layouts in flash_common.cuh); frag[p] from plane p,
// `plane` elements apart.

// A 16 x 16 (m x k) from a tile stored [m][k].
template <int P>
__device__ __forceinline__ void frag_a_mk(uint32_t (*a)[4], const bf16* tile, int plane, int ld,
                                          int m0, int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < P; ++p)
    flash::ldsm_x4(a[p], tile + p * plane + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// A 16 x 16 (m x k) from a tile stored [k][m] (x^T for dw): ldmatrix.trans;
// matrix j = lane / 8 is rows k0 + 8 (j / 2), cols m0 + 8 (j % 2).
template <int P>
__device__ __forceinline__ void frag_a_km(uint32_t (*a)[4], const bf16* tile, int plane, int ld,
                                          int m0, int k0) {
  const int lane = threadIdx.x & 31;
  const int j = lane >> 3;
#pragma unroll
  for (int p = 0; p < P; ++p)
    flash::ldsm_x4_trans(a[p], tile + p * plane + (k0 + (lane & 7) + ((j >> 1) << 3)) * ld + m0 +
                                   ((j & 1) << 3));
}

// B of two 8-column blocks n0, n0 + 8 at depth [k0, k0 + 16) from a tile
// stored [k][n] (w for y = x.w; dy for dw): ldmatrix.trans.
template <int P>
__device__ __forceinline__ void frag_b_kn(uint32_t (*b)[4], const bf16* tile, int plane, int ld,
                                          int n0, int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < P; ++p)
    flash::ldsm_x4_trans(b[p], tile + p * plane + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                                   n0 + (lane >> 4) * 8);
}

// The same from a tile stored [n][k] (w[e] read as w[e]^T for dx).
template <int P>
__device__ __forceinline__ void frag_b_nk(uint32_t (*b)[4], const bf16* tile, int plane, int ld,
                                          int n0, int k0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < P; ++p)
    flash::ldsm_x4(b[p], tile + p * plane + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                             ((lane >> 3) & 1) * 8);
}

// Shared tile geometry: A is [kBM][kBK] (A_KM: [kBK][kBM]), B is [kBK][kBN]
// (B_NK: [kBN][kBK]), each row padded by kPad.
template <bool A_KM>
struct TileA {
  static constexpr int ld = (A_KM ? kBM : kBK) + kPad;
  static constexpr int plane = (A_KM ? kBK : kBM) * ld;
};
template <bool B_NK>
struct TileB {
  static constexpr int ld = (B_NK ? kBK : kBN) + kPad;
  static constexpr int plane = (B_NK ? kBN : kBK) * ld;
};

template <typename T, bool A_KM, bool B_NK>
__host__ __device__ constexpr int stage_elems() {
  return Planes<T>::value * (TileA<A_KM>::plane + TileB<B_NK>::plane);
}
template <typename T, bool A_KM, bool B_NK>
constexpr size_t smem_bytes() {
  return 2 * (size_t)stage_elems<T, A_KM, B_NK>() * sizeof(bf16);
}

// acc[mi][ni] += A.B over one kBK-deep stage: the warp's 64 x 32 piece at
// (wm0, wn0) of the tile, 4 x 4 mma tiles of 16 x 8.
template <int P, bool A_KM, bool B_NK>
__device__ __forceinline__ void mma_stage(float (*acc)[4][4], const bf16* as, const bf16* bs,
                                          int wm0, int wn0) {
  using TA = TileA<A_KM>;
  using TB = TileB<B_NK>;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t a[4][P][4];
    uint32_t b[2][P][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      if constexpr (A_KM) {
        frag_a_km<P>(a[mi], as, TA::plane, TA::ld, wm0 + 16 * mi, 16 * kk);
      } else {
        frag_a_mk<P>(a[mi], as, TA::plane, TA::ld, wm0 + 16 * mi, 16 * kk);
      }
    }
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      if constexpr (B_NK) {
        frag_b_nk<P>(b[nj], bs, TB::plane, TB::ld, wn0 + 16 * nj, 16 * kk);
      } else {
        frag_b_kn<P>(b[nj], bs, TB::plane, TB::ld, wn0 + 16 * nj, 16 * kk);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) flash::mma<P>(acc[mi][ni], a[mi], b[ni >> 1], ni & 1);
  }
}

// The pipelined loop over `steps` stages: load(step, a_tile, b_tile) fills
// one stage; two stages alternate, the next loading while the current is
// multiplied.
template <typename T, bool A_KM, bool B_NK, class Load>
__device__ __forceinline__ void mainloop(float (*acc)[4][4], bf16* smem, int steps, Load load,
                                         int wm0, int wn0) {
  constexpr int P = Planes<T>::value;
  constexpr int SE = stage_elems<T, A_KM, B_NK>();
  constexpr int AE = P * TileA<A_KM>::plane;
  if (steps <= 0) return;
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
    mma_stage<P, A_KM, B_NK>(acc, cur, cur + AE, wm0, wn0);
    __syncthreads();  // the stage is free for the load two steps on
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}
__device__ __forceinline__ void store_pair(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}

// Forward (K5, K6): y [R, N] = x [R, K] @ w[e] ([K, N]; TRANS: w[e] is
// [N, K] and is read as w[e]^T), times s[r] when SCALED.
template <typename T, bool TRANS, bool SCALED>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ be,
           const float* __restrict__ s, T* __restrict__ y, int R, int K, int N, int block_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int e = be[m0 / block_rows];
  if (e < 0) {
    // sentinel block: its rows still exist (static shapes), so write zeros,
    // and spend no product on them
    constexpr int CH = kBN / 8;
    for (int i = threadIdx.x; i < kBM * CH; i += kThreads) {
      const int r = i / CH;
      const int c = n0 + (i - r * CH) * 8;
      if (c >= N) continue;
      T* out = y + (size_t)(m0 + r) * N + c;
#pragma unroll
      for (int j = 0; j < 8; j += 2) store_pair(out + j, 0.f, 0.f);
    }
    return;
  }
  const T* we = w + (size_t)e * K * N;
  const int warp = threadIdx.x >> 5;
  const int wm0 = (warp >> 2) * 64, wn0 = (warp & 3) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  auto load = [&](int step, bf16* as, bf16* bs) {
    const int k0 = step * kBK;
    load_tile<T, kBM, kBK, false>(as, x, K, m0, k0, R, K, nullptr);
    if constexpr (TRANS) {
      load_tile<T, kBN, kBK, false>(bs, we, K, n0, k0, N, K, nullptr);
    } else {
      load_tile<T, kBK, kBN, false>(bs, we, N, k0, n0, K, N, nullptr);
    }
  };
  mainloop<T, false, TRANS>(acc, smem, (K + kBK - 1) / kBK, load, wm0, wn0);

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm0 + 16 * mi + (lane >> 2) + 8 * half;
      float sc = 1.f;
      if constexpr (SCALED) sc = s[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn0 + 8 * ni + 2 * (lane & 3);
        if (row < R && col < N)
          store_pair(y + (size_t)row * N + col, acc[mi][ni][2 * half] * sc,
                     acc[mi][ni][2 * half + 1] * sc);
      }
    }
  }
}

// dw (K7a, K7b): dw[e] [K, N] f32 = sum over the blocks of expert e (the
// first nblocks[e] entries of blist[e * nb ...]) of x_b^T dy_b, with x's
// rows times s[r] when SCALED.
template <typename T, bool SCALED>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ s,
          const int* __restrict__ nblocks, const int* __restrict__ blist, float* __restrict__ dw,
          int R, int K, int N, int nb, int block_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int e = blockIdx.z;
  const int spb = block_rows / kBK;  // stages per routing block
  const int steps = nblocks[e] * spb;
  const int* bl = blist + (size_t)e * nb;
  const int warp = threadIdx.x >> 5;
  const int wm0 = (warp >> 2) * 64, wn0 = (warp & 3) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  auto load = [&](int step, bf16* as, bf16* bs) {
    const int blk = step / spb;
    const int r0 = bl[blk] * block_rows + (step - blk * spb) * kBK;
    load_tile<T, kBK, kBM, SCALED>(as, x, K, r0, m0, R, K, s);
    load_tile<T, kBK, kBN, false>(bs, dy, N, r0, n0, R, N, nullptr);
  };
  mainloop<T, true, false>(acc, smem, steps, load, wm0, wn0);

  const int lane = threadIdx.x & 31;
  float* out = dw + (size_t)e * K * N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm0 + 16 * mi + (lane >> 2) + 8 * half;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn0 + 8 * ni + 2 * (lane & 3);
        if (row < K && col < N)
          store_pair(out + (size_t)row * N + col, acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
  }
}

bool shapes_ok(int R, int K, int N, int block_rows) {
  return R > 0 && K > 0 && N > 0 && block_rows > 0 && block_rows % kBM == 0 &&
         R % block_rows == 0 && K % 8 == 0 && N % 8 == 0;
}

template <typename T, bool TRANS, bool SCALED>
int fwd(const void* x, const void* w, const int* be, const float* s, void* y, int R, int K, int N,
        int block_rows, cudaStream_t stream) {
  if (!shapes_ok(R, K, N, block_rows)) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, R / kBM);
  return flash::launch(fwd_kernel<T, TRANS, SCALED>, grid, kThreads,
                       smem_bytes<T, false, TRANS>(), stream, static_cast<const T*>(x),
                       static_cast<const T*>(w), be, s, static_cast<T*>(y), R, K, N, block_rows);
}

template <typename T, bool SCALED>
int dw(const void* x, const void* dy, const float* s, const int* nblocks, const int* blist,
       float* out, int R, int K, int N, int E, int nb, int block_rows, cudaStream_t stream) {
  if (!shapes_ok(R, K, N, block_rows) || E <= 0 || nb != R / block_rows)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (K + kBM - 1) / kBM, E);
  return flash::launch(dw_kernel<T, SCALED>, grid, kThreads, smem_bytes<T, true, false>(), stream,
                       static_cast<const T*>(x), static_cast<const T*>(dy), s, nblocks, blist,
                       out, R, K, N, nb, block_rows);
}

}  // namespace
}  // namespace gmm

// C entries (ctypes). x, w, y (and dy) are contiguous, 16-byte aligned,
// bf16 (bf16 = 1) or f32; be, nblocks, blist int32; s, dw f32. Each
// returns cudaGetLastError() after the launch (0 when it was taken).

extern "C" int gmm_fwd(const void* x, const void* w, const int* be, void* y, int R, int K, int N,
                       int block_rows, int trans, int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return trans ? gmm::fwd<__nv_bfloat16, true, false>(x, w, be, nullptr, y, R, K, N, block_rows, st)
                 : gmm::fwd<__nv_bfloat16, false, false>(x, w, be, nullptr, y, R, K, N, block_rows, st);
  return trans ? gmm::fwd<float, true, false>(x, w, be, nullptr, y, R, K, N, block_rows, st)
               : gmm::fwd<float, false, false>(x, w, be, nullptr, y, R, K, N, block_rows, st);
}

extern "C" int gmm_fwd_scaled(const void* x, const void* w, const int* be, const float* s, void* y,
                              int R, int K, int N, int block_rows, int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? gmm::fwd<__nv_bfloat16, false, true>(x, w, be, s, y, R, K, N, block_rows, st)
              : gmm::fwd<float, false, true>(x, w, be, s, y, R, K, N, block_rows, st);
}

extern "C" int gmm_dw(const void* x, const void* dy, const int* nblocks, const int* blist,
                      float* dw, int R, int K, int N, int E, int nb, int block_rows, int bf16,
                      void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? gmm::dw<__nv_bfloat16, false>(x, dy, nullptr, nblocks, blist, dw, R, K, N, E, nb,
                                               block_rows, st)
              : gmm::dw<float, false>(x, dy, nullptr, nblocks, blist, dw, R, K, N, E, nb,
                                       block_rows, st);
}

extern "C" int gmm_dw_scaled(const void* x, const void* dy, const float* s, const int* nblocks,
                             const int* blist, float* dw, int R, int K, int N, int E, int nb,
                             int block_rows, int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? gmm::dw<__nv_bfloat16, true>(x, dy, s, nblocks, blist, dw, R, K, N, E, nb,
                                              block_rows, st)
              : gmm::dw<float, true>(x, dy, s, nblocks, blist, dw, R, K, N, E, nb, block_rows,
                                      st);
}
