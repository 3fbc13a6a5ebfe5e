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
// ~116 MB of operands (0.035 ms at 3.35 TB/s; dw's f32 output alone is 75
// MB). So every product runs on the tensor cores.
//
// Forward (K5, K6): bf16 mma.sync.m16n8k16 with f32 accumulation, operands
// through ldmatrix from shared memory, 128 x 128 output tiles, one block
// per (128-row tile inside a routing block, 128-column tile). The block
// reads its block's expert from `be` itself; a sentinel block writes its
// zeros and does no product. The TPU steered the weight BlockSpec by a
// scalar-prefetched map; here the block offsets its own weight pointer. dx
// reads w[e] in place through the B tile's other layout (its rows are the
// output's columns, loaded without .trans), so no w^T is materialised,
// where the JAX rule swaps the axes of w first (grouped_matmul.py:345).
// Each of the 8 warps owns a 64 x 32 piece of the tile in registers; the
// next 32-deep slice of both operands streams in with cp.async (bf16)
// while the current one is multiplied (two stages). T = f32 runs this same
// code on operands split into bf16 hi + lo, three products each (see
// flash_common.cuh), loaded through registers.
//
// dw (K7a, K7b), dw_kernel below: Hopper's TMA and wgmma.
//   - The TPU carried the accumulator across its sequential grid axis; on
//     Hopper the blocks run in no order, so each (expert, 128-row tile of
//     dw, 256-column tile) item walks the expert's block list in a loop
//     and writes its f32 tile once: no atomics, the same bits every run,
//     and an expert with no blocks gets exact zeros. The block lists come
//     from the caller (_expert_block_lists, on the device).
//   - One persistent block per SM (288 threads) takes its items from a
//     plan every block deals alike at its start (plan_items: longest
//     walks first, each round's items to the blocks with the least work),
//     since routing leaves some experts with far more rows than others.
//     Warp 8 is the producer: one thread walks the items' block
//     lists and fills a ring of 4 stages of 64 rows (block_rows is a
//     multiple of 128, so a stage never straddles a routing block) with
//     cp.async.bulk.tensor: x's [64 rows][128 cols] and dy's [64][256] as
//     64 x 64 boxes, 48 KB a stage, behind full and empty mbarriers. It
//     runs ahead into the next item while the consumers write this one's
//     tile, so the epilogue overlaps the next item's loads.
//   - Warpgroups 0 and 1 are the consumers: each owns 64 rows x 256
//     columns of the tile in 128 f32 registers a thread and issues four
//     wgmma.mma_async.m64n256k16 a stage. A = x^T and B = dy are both
//     read MN-major (trans 1) from the 128-byte-swizzled boxes TMA lays
//     down; a k-step of 16 is 16 box rows (2 KB) on. They wait only on
//     mbarriers (no __syncthreads in the loop) and give a slot back once
//     wgmma.wait_group 1 says its products are done.
//   - Operand bytes streamed into the SMs: rows x (128 + 256) x 2 a tile,
//     where 128 x 128 tiles read rows x 512 for half the outputs.
//   - K7b: the producer also bulk-copies the stage's 64 scales; each
//     consumer warpgroup multiplies its landed x box by them in f32 and
//     rounds to bf16 in place (the TPU kept s * x in f32; a declared
//     difference, ROADMAP Queue 3), then fence.proxy.async before wgmma
//     reads it. The other warpgroup's products run meanwhile. (Scaling the
//     next stage's box behind the current products measured slower:
//     tf_operator_tpu_torch/tools/gmm_dw_variants.py, PERF.md.)
//   - T = f32 runs the same walk, ring and products: TMA lands f32 boxes
//     (one stage), the consumers split them into bf16 hi and lo planes in
//     the swizzled layout (scaling x first for K7b) and issue the three
//     products hi.hi + hi.lo + lo.hi into the same sums, so the f32 check
//     vouches for the bf16 kernel's walk, tiles and descriptors.
//   - The tensor maps are encoded in the C entries from the raw pointers
//     and shapes (cuTensorMapEncodeTiled through the runtime's driver
//     entry point) and passed as __grid_constant__ parameters.
// Not done yet: the forward's wgmma and TMA (K5, K6 and the dx use still
// run the mma.sync code above, whose load_tile SCALE and mainloop A_KM
// forms no kernel instantiates now); items smaller than a whole walk, so
// that the last round does not leave blocks idle.

#include <climits>

#include "flash_common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// dw (K7a, K7b): a TMA ring feeding wgmma
// ---------------------------------------------------------------------------

constexpr int kDepth = 64;   // rows of x and dy a stage (block_rows is a multiple of 128)
constexpr int kTM = 128;     // dw tile rows (x's columns): 64 a consumer warpgroup
constexpr int kTN = 256;     // dw tile columns (dy's columns)
constexpr int kBox = 64;     // columns of a TMA box: 64 bf16 fill one 128-byte swizzle row
constexpr int kXBoxes = kTM / kBox;             // a stage holds x's boxes, then dy's
constexpr int kBoxes = (kTM + kTN) / kBox;
constexpr int kRowBytes = kBox * 2;             // a bf16 box row
constexpr int kPlaneBox = kDepth * kRowBytes;   // a bf16 box, 8192 bytes
constexpr int kDwThreads = 288;  // warps 0-7: two consumer warpgroups; warp 8: the producer
constexpr int kAcc = kTN / 2;    // f32 sums a consumer thread holds (64 x 256 / 128)
constexpr int kMaxExperts = 1024;  // bounds of the item plan's shared arrays
constexpr int kMaxBlocks = 1024;
constexpr int kMaxRounds = 2048;

// Shared memory of dw_kernel<T> (byte offsets): the ring of `stages`
// stages, each kBoxes TMA boxes of [kDepth rows][kBox] T; for f32 the
// stage split into bf16 hi and lo planes (each laid out as a bf16 stage);
// kDepth scales a stage (K7b); the full and empty mbarriers.
template <typename T>
struct DwLayout {
  static constexpr int stages = Planes<T>::value == 1 ? 4 : 1;
  static constexpr int box = kDepth * kBox * (int)sizeof(T);
  static constexpr int stage = kBoxes * box;
  static constexpr int planes = stages * stage;
  static constexpr int plane = kBoxes * kPlaneBox;
  static constexpr int scales = planes + (Planes<T>::value == 1 ? 0 : 2 * plane);
  static constexpr int bars = scales + stages * kDepth * 4;
  static constexpr int plan = bars + 2 * stages * 8;  // plan_items' arrays
  static constexpr int bytes = plan + 4 * (2 * kMaxExperts + 2 * kMaxBlocks + kMaxRounds) + 1024;
};

using hopper::bar_sync;
using hopper::fence_async_smem;
using hopper::mbar_arrive;
using hopper::mbar_expect;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::tma_box;
using hopper::bulk_copy;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

// wgmma descriptor of a 64-row (reduction) x 64k-wide tile of bf16 boxes
// at shared address addr, MN-major with the 128-byte swizzle: each row of
// a box is 128 bytes of one reduction index; the next 8 rows start 1024
// bytes on (SBO); the next 64 columns, in the next box, 8192 bytes on (LBO).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return hopper::sw128_desc(addr, kPlaneBox, 1024);
}

// d (the 64 x kTN f32 sums of a warpgroup) += A . B, A 64 x 16 and B 16 x
// kTN read by descriptor, both MN-major (trans-a = trans-b = 1).
__device__ __forceinline__ void wgmma_256(float* d, uint64_t a, uint64_t b) {
  hopper::Wgmma<kTN>::ss<1, 1>(d, a, b, 1);
}

// acc += (x box)^T . (dy boxes) over one stage: a is the warpgroup's x box,
// b dy's first box (shared addresses in a bf16 stage or plane). The tiles
// are MN-major, so the 16 reduction rows of step k start 16 rows further
// on, not 16 columns.
__device__ __forceinline__ void stage_products(float* acc, uint32_t a, uint32_t b) {
#pragma unroll
  for (int k = 0; k < kDepth / 16; ++k)
    wgmma_256(acc, sw128_desc(a + k * 16 * kRowBytes), sw128_desc(b + k * 16 * kRowBytes));
}

// Expert e's walk: `steps` stages of kDepth rows over its block list.
struct Walk {
  const int* bl;
  int spb, block_rows, steps;
  __device__ __forceinline__ int row(int step) const {  // the first x / dy row of a stage
    const int blk = step / spb;
    return bl[blk] * block_rows + (step - blk * spb) * kDepth;
  }
};
__device__ __forceinline__ Walk expert_walk(const int* nblocks, const int* blist, int e, int nb,
                                            int block_rows) {
  const int spb = block_rows / kDepth;  // stages per routing block
  const int steps = nblocks[e] * spb;
  return {blist + (size_t)e * nb, spb, block_rows, steps};
}

// This block's items, in the order it takes them: LPT by rounds. The items
// sorted longest walk first (an expert's items are equal; ties by expert)
// are dealt in rounds of gridDim.x: the i-th of a round goes to the block
// with the i-th least work so far (ties by block index). Every block deals
// the whole plan and keeps its own items in `mine`; returns their count.
// Dealt in index order instead, one expert with many blocks can leave a
// few blocks with far more stages than the average. Run by all threads.
__device__ __forceinline__ int plan_items(int* plan, const int* nblocks, int E, int tiles,
                                          int spb) {
  int *perm = plan, *cost = perm + kMaxExperts, *key = cost + kMaxExperts;
  int *rank = key + kMaxBlocks, *mine = rank + kMaxBlocks;
  const int G = gridDim.x, G4 = (G + 3) / 4, items = E * tiles;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int n = nblocks[e];
    int r = 0;
    for (int f = 0; f < E; ++f) r += nblocks[f] > n || (nblocks[f] == n && f < e);
    perm[r] = e;
    cost[r] = max(n * spb, 1);  // an empty walk still writes its tile
  }
  // key[b] = work so far * kMaxBlocks + b: ordering by key orders by (work, index)
  for (int b = threadIdx.x; b < 4 * G4; b += blockDim.x) key[b] = b < G ? b : INT_MAX;
  __syncthreads();
  // equal walks: every round finds the blocks' work equal, so block b takes
  // the b-th item of each round and the ranks need no computing
  const bool equal = cost[0] == cost[E - 1];
  int count = 0;
  for (int k0 = 0; k0 < items; k0 += G) {
    if (!equal) {
      for (int b = threadIdx.x; b < G; b += blockDim.x) {
        int r = b;  // the first round: no block has work yet
        if (k0 > 0) {
          const int kb = key[b];
          const int4* k4 = reinterpret_cast<const int4*>(key);
          r = 0;
#pragma unroll 4
          for (int c = 0; c < G4; ++c) {
            const int4 v = k4[c];
            r += (v.x < kb) + (v.y < kb) + (v.z < kb) + (v.w < kb);
          }
        }
        rank[b] = r;
      }
      __syncthreads();
      for (int b = threadIdx.x; b < G; b += blockDim.x) {
        const int k = k0 + rank[b];
        if (k < items) key[b] += cost[k / tiles] * kMaxBlocks;
      }
    }
    const int k = k0 + (equal ? (int)blockIdx.x : rank[blockIdx.x]);
    if (k < items) {
      if (threadIdx.x == 0) mine[count] = perm[k / tiles] * tiles + k % tiles;
      ++count;
    }
    __syncthreads();
  }
  return count;
}

// The scale of row r of a stage (K7b), from the stage's copy of s.
template <bool SCALED>
__device__ __forceinline__ float scale_of(const float* ss, int r) {
  return SCALED ? ss[r] : 1.f;
}

// K7b in bf16: a warpgroup's landed x box times the stage's scales in f32,
// rounded to bf16 in place. Each 128-byte row of the box is one x row (the
// swizzle only permutes its 16-byte chunks), so chunk q is row q / 8.
__device__ __forceinline__ void scale_box(unsigned char* box, const float* ss, int t) {
  for (int q = t; q < kDepth * 8; q += 128) {
    uint4* p = reinterpret_cast<uint4*>(box + q * 16);
    const uint4 v = *p;
    const uint32_t in[4] = {v.x, v.y, v.z, v.w};
    uint32_t out[4];
    const float sc = scale_of<true>(ss, q / 8);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in[j]));
      out[j] = flash::pack_bf16(f.x * sc, f.y * sc);
    }
    *p = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// f32: the landed stage (boxes [kDepth][kBox] f32) split into bf16 hi and
// lo planes, swizzled as TMA lays out a bf16 stage; x's rows are scaled
// first (K7b). Run by both consumer warpgroups (t < 256).
template <bool SCALED>
__device__ __forceinline__ void split_stage(const unsigned char* stage, unsigned char* hi,
                                            unsigned char* lo, const float* ss, int t) {
  hopper::split_boxes(stage, hi, lo, kBoxes, kDepth, t, 256, [&](int b, int r) {
    return b < kXBoxes ? scale_of<SCALED>(ss, r) : 1.f;
  });
}

// dw[e] [K, N] f32 = sum over the blocks of expert e (the first nblocks[e]
// entries of blist[e * nb ...]) of (s * x_b)^T dy_b (s = 1 unless SCALED).
// x and dy arrive as tensor maps of [R, K] and [R, N]. A persistent block
// takes the items (expert, 128-row tile, 256-column tile) plan_items gives
// it; the producer warp runs ahead through them, so one item's epilogue
// overlaps the next item's loads.
template <typename T, bool SCALED>
__global__ void __launch_bounds__(kDwThreads, 1)
dw_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dymap,
          const float* __restrict__ s, const int* __restrict__ nblocks,
          const int* __restrict__ blist, float* __restrict__ dw, int K, int N, int E, int nb,
          int block_rows) {
  using L = DwLayout<T>;
  constexpr bool kSplit = Planes<T>::value == 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (flash::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = flash::smem_addr(smem);
  const uint32_t full = base + L::bars, empty = full + 8 * L::stages;
  const int tiles_n = (N + kTN - 1) / kTN, tiles = tiles_n * ((K + kTM - 1) / kTM);
  const int* mine =
      reinterpret_cast<const int*>(smem + L::plan) + 2 * kMaxExperts + 2 * kMaxBlocks;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::stages; ++i) {
      mbar_init(full + 8 * i, 1);   // the producer's arrive, with the stage's bytes
      mbar_init(empty + 8 * i, 2);  // one arrive from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int count = plan_items(reinterpret_cast<int*>(smem + L::plan), nblocks, E, tiles,
                               block_rows / kDepth);  // synchronises the block

  if (warp == 8) {  // the producer: one thread issues every copy
    if ((threadIdx.x & 31) == 0) {
      int it = 0;  // stages issued, over all items
      for (int j = 0; j < count; ++j) {
        const int item = mine[j], e = item / tiles, rest = item - e * tiles;
        const int m0 = rest / tiles_n * kTM, n0 = rest % tiles_n * kTN;
        const Walk w = expert_walk(nblocks, blist, e, nb, block_rows);
        for (int step = 0; step < w.steps; ++step, ++it) {
          const int st = it % L::stages;
          mbar_wait(empty + 8 * st, ((it / L::stages) & 1) ^ 1);
          const int r0 = w.row(step);
          const uint32_t bar = full + 8 * st, dst = base + st * L::stage;
          mbar_expect(bar, L::stage + (SCALED ? kDepth * 4 : 0));
          for (int b = 0; b < kXBoxes; ++b) tma_box(dst + b * L::box, xmap, bar, m0 + b * kBox, r0);
          for (int b = kXBoxes; b < kBoxes; ++b)
            tma_box(dst + b * L::box, dymap, bar, n0 + (b - kXBoxes) * kBox, r0);
          if constexpr (SCALED)
            bulk_copy(base + L::scales + st * kDepth * 4, s + r0, kDepth * 4, bar);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp >> 2, t = threadIdx.x & 127;
  const float* scales = reinterpret_cast<const float*>(smem + L::scales);
  float acc[kAcc];
  int it = 0;  // stages consumed, over all items
  for (int j = 0; j < count; ++j) {
    const int item = mine[j], e = item / tiles, rest = item - e * tiles;
    const int m0 = rest / tiles_n * kTM, n0 = rest % tiles_n * kTN;
    const Walk w = expert_walk(nblocks, blist, e, nb, block_rows);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int step = 0; step < w.steps; ++step, ++it) {
      const int st = it % L::stages;
      mbar_wait(full + 8 * st, (it / L::stages) & 1);
      unsigned char* stage = smem + st * L::stage;
      const float* ss = scales + st * kDepth;
      if constexpr (kSplit) {
        // one plane pair serves the stage: both warpgroups' products of the
        // last stage must be done before it is overwritten
        wgmma_wait<0>();
        bar_sync(1, 256);
        split_stage<SCALED>(stage, smem + L::planes, smem + L::planes + L::plane, ss,
                            threadIdx.x);
        fence_async_smem();
        bar_sync(1, 256);
        if (t == 0) mbar_arrive(empty + 8 * st);
        const uint32_t hi = base + L::planes, lo = hi + L::plane;
        const uint32_t xo = wg * kPlaneBox, dyo = kXBoxes * kPlaneBox;
        wgmma_fence();
        stage_products(acc, hi + xo, hi + dyo);
        stage_products(acc, hi + xo, lo + dyo);
        stage_products(acc, lo + xo, hi + dyo);
        wgmma_commit();
      } else {
        if constexpr (SCALED) {
          scale_box(stage + wg * kPlaneBox, ss, t);
          fence_async_smem();  // the generic stores, before wgmma's reads
          bar_sync(2 + wg, 128);
        }
        const uint32_t a = base + st * L::stage;
        wgmma_fence();
        stage_products(acc, a + wg * kPlaneBox, a + kXBoxes * kPlaneBox);
        wgmma_commit();
        // the previous stage's products are done: its slot goes back
        wgmma_wait<1>();
        if (step > 0 && t == 0) mbar_arrive(empty + 8 * ((it - 1) % L::stages));
      }
    }
    wgmma_wait<0>();
    hopper::fence_regs<kAcc>(acc);
    if (!kSplit && w.steps > 0 && t == 0) mbar_arrive(empty + 8 * ((it - 1) % L::stages));

    // acc[4j .. 4j + 3]: rows g, g + 8 (g = 16 warp + lane / 4) of the
    // warpgroup's 64, columns 8j + 2 (lane % 4) and the next
    const int lane = t & 31;
    const int row = m0 + wg * 64 + (t >> 5) * 16 + (lane >> 2);
    float* out = dw + (size_t)e * K * N;
#pragma unroll
    for (int j = 0; j < kTN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col < N) {
        if (row < K) store_pair(out + (size_t)row * N + col, acc[4 * j], acc[4 * j + 1]);
        if (row + 8 < K)
          store_pair(out + (size_t)(row + 8) * N + col, acc[4 * j + 2], acc[4 * j + 3]);
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

// The row-major [rows, cols] matrix at p as boxes of kDepth rows x kBox
// columns: bf16 with the 128-byte swizzle wgmma reads, f32 as it is;
// columns past cols read as zeros. 0, or minus the driver's CUresult.
template <typename T>
int encode_rows(CUtensorMap* map, const void* p, int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {kBox, kDepth};
  return hopper::encode(map, Planes<T>::value == 1, 2, p, dims, strides, box);
}

template <typename T, bool SCALED>
int dw(const void* x, const void* dy, const float* s, const int* nblocks, const int* blist,
       float* out, int R, int K, int N, int E, int nb, int block_rows, cudaStream_t stream) {
  if (!shapes_ok(R, K, N, block_rows) || E <= 0 || E > kMaxExperts || nb != R / block_rows ||
      (SCALED && reinterpret_cast<uintptr_t>(s) % 16))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, dymap;
  int err = encode_rows<T>(&xmap, x, R, K);
  if (!err) err = encode_rows<T>(&dymap, dy, R, N);
  if (err) return err;
  int dev = 0, sms = 0;
  if ((err = (int)cudaGetDevice(&dev)) ||
      (err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  const int items = E * ((K + kTM - 1) / kTM) * ((N + kTN - 1) / kTN);
  const int grid = items < sms ? items : sms;
  if (grid > kMaxBlocks || (items + grid - 1) / grid > kMaxRounds)
    return (int)cudaErrorInvalidValue;
  return flash::launch(dw_kernel<T, SCALED>, dim3(grid), kDwThreads,
                       (size_t)DwLayout<T>::bytes, stream, xmap, dymap, s, nblocks, blist, out, K,
                       N, E, nb, block_rows);
}

}  // namespace
}  // namespace gmm

// C entries (ctypes). x, w, y (and dy) are contiguous, 16-byte aligned,
// bf16 (bf16 = 1) or f32; be, nblocks, blist int32; s (16-byte aligned for
// dw), dw f32. Each returns cudaGetLastError() after the launch (0 when it
// was taken); the dw entries return minus the driver's CUresult when a
// tensor map cannot be encoded.

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
