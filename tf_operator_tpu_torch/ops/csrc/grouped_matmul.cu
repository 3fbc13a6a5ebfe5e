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
// MB). So every product runs on wgmma, fed by TMA, in both kernels:
//
// Forward (K5, K6, K5's dx form), fwd_kernel below.
//   - An item is one 128-row tile inside a routing block x one 256-column
//     tile of y. Items are numbered row tile by row tile (fwd_item), and
//     rows arrive grouped by expert, so the items a round runs side by side
//     share one or a few experts' weights in the 50 MB L2 (all experts'
//     weights are 37.7 MB at moe-small's shape).
//   - One persistent block per SM (288 threads) takes items blockIdx.x,
//     + gridDim.x, ...; every item but a sentinel is K deep, so the deal
//     is even. The TPU steered the weight BlockSpec by a scalar-prefetched
//     map; here both roles read the item's expert from `be` themselves,
//     and a sentinel item issues no loads and writes zeros.
//   - Warp 8 is the producer: one thread fills a ring of kFwdStages stages
//     of 64 reduction indices with cp.async.bulk.tensor, behind full and
//     empty mbarriers: x's [128 rows][64] (a 2-D map over [R, K]) and
//     w[e]'s [64][256] ([256][64] for dx), as 64 x 64 boxes with the
//     128-byte swizzle, 48 KB a stage. w is a 3-D map over [E, K, N]
//     ([E, N, K] for dx), so a box past K or N reads zeros, never the next
//     expert's rows. It runs ahead into the next item while the consumers
//     finish this one, so one item's epilogue overlaps the next one's loads.
//   - Warpgroups 0 and 1 are the consumers: each owns 64 rows x 256 columns
//     of the tile in 128 f32 registers a thread and issues four
//     wgmma.mma_async.m64n256k16 a stage. A = x is K-major (a depth step of
//     16 is 32 bytes along the swizzled row); B = w[e] is MN-major (a step is
//     16 box rows on), or for dx K-major: w[e] [N, K] read in place as
//     w[e]^T, where the JAX rule swaps the axes first (grouped_matmul.py:345).
//     A slot goes back once wgmma.wait_group 1 says its products are done;
//     no __syncthreads in the loop.
//   - Epilogue: K6 multiplies each f32 sum by s[row] before rounding. bf16
//     tiles are rounded into a swizzled shared buffer, kEpiCols columns at a
//     time, and written by TMA stores (cp.async.bulk.tensor shared ->
//     global, clipped at N), which drain while the next item's products
//     run: y is 62.9 MB of the ~116 MB a d -> f launch moves at
//     moe-small's shape.
//   - T = f32 runs the same walk, ring and products: TMA lands f32 boxes
//     (one stage), the consumers split them into bf16 hi and lo planes in
//     the swizzled layout and issue hi.hi + hi.lo + lo.hi into the same
//     sums, so the f32 check vouches for the bf16 kernel's walk, boxes and
//     descriptors; its tiles are stored from registers.
//
// dw (K7a, K7b), dw_kernel below: the same machinery.
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
//   - T = f32 as in the forward (x scaled first for K7b).
// The tensor maps of both are encoded in the C entries from the raw
// pointers and shapes (cuTensorMapEncodeTiled through the runtime's driver
// entry point) and passed as __grid_constant__ parameters.
// Measured against variants of the forward (tools/gmm_fwd_variants.py,
// PERF.md): 3 stages with the tile stored in one round, 128 x 128 tiles
// with 4-6 stages, one block an item, and items numbered column tile by
// column tile were all slower at moe-small's four forward shapes; bf16
// tiles stored from registers took 1.55x as long where y is the larger
// side (d -> f).
// Not done yet: dw items smaller than a whole walk, so that the last round
// does not leave blocks idle.

#include <climits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace gmm {
namespace {

using bf16 = __nv_bfloat16;
using flash::Planes;

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

using hopper::kBox;       // columns of a TMA box: 64 bf16 fill one 128-byte swizzle row
using hopper::kRowBytes;  // a bf16 box row
constexpr int kThreads = 288;  // warps 0-7: two consumer warpgroups; warp 8: the producer

// Two neighbouring outputs from their f32 sums: rounded to bf16, or as they
// are.
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float x0, float x1) {
  if constexpr (Planes<T>::value == 1) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  }
}

// ---------------------------------------------------------------------------
// Forward (K5, K6, K5's dx form): a TMA ring feeding wgmma
// ---------------------------------------------------------------------------

constexpr int kBM = 128;        // forward tile rows: 64 a consumer warpgroup
constexpr int kFN = 256;        // forward tile columns
constexpr int kFwdStages = 4;   // ring stages (bf16; f32 lands one stage)
constexpr int kEpiCols = 128;   // columns of y a warpgroup rounds into shared memory at a time
constexpr int kFBox = kBox * kRowBytes;        // a bf16 box of 64 x 64, 8192 bytes
constexpr int kXFBoxes = kBM / kBox;           // a stage holds x's boxes, then w[e]'s
constexpr int kFwdBoxes = (kBM + kFN) / kBox;
constexpr int kFwdAcc = kFN / 2;               // f32 sums a consumer thread holds

// Shared memory of fwd_kernel<T> (byte offsets from a 1024-byte boundary):
// the ring of `stages` stages, each kFwdBoxes TMA boxes of [64][kBox] T; for
// f32 the stage split into bf16 hi and lo planes (each laid out as a bf16
// stage); for bf16 each consumer warpgroup's epilogue buffer (kEpiCols /
// kBox boxes of 64 rows of y); the full and empty mbarriers.
template <typename T>
struct FwdLayout {
  static constexpr bool split = Planes<T>::value == 2;
  static constexpr bool tma_store = !split;  // f32 tiles go out from registers
  static constexpr int stages = split ? 1 : kFwdStages;
  static constexpr int box = kBox * kBox * (int)sizeof(T);
  static constexpr int stage = kFwdBoxes * box;
  static constexpr int planes = stages * stage;
  static constexpr int plane = kFwdBoxes * kFBox;
  static constexpr int epi = planes + (split ? 2 * plane : 0);
  static constexpr int epi_wg = tma_store ? kEpiCols / kBox * kFBox : 0;
  static constexpr int bars = epi + 2 * epi_wg;
  static constexpr int bytes = bars + 2 * stages * 8 + 1024;
};

// Item i of the forward: row tile i / tiles_n and column tile i % tiles_n
// (the column tiles of one row tile next to each other, then the next row
// tile), and the expert of its routing block (-1: a sentinel).
struct FwdItem {
  int m0, n0, e;
};
__device__ __forceinline__ FwdItem fwd_item(int i, int tiles_m, int tiles_n, const int* be,
                                            int block_rows) {
  FwdItem w;
  w.m0 = i / tiles_n * kBM;
  w.n0 = i % tiles_n * kFN;
  w.e = be[w.m0 / block_rows];
  return w;
}

// acc += x . w[e] (or x . w[e]^T) over one stage of 64 reduction indices: a
// is the warpgroup's x box, K-major (a depth step of 16 is 32 bytes along
// the swizzled 128-byte row); b is w[e]'s first box. K5, K6: [64 k][64 n]
// boxes, MN-major, a step 16 box rows on and the next 64 columns one box
// on (LBO). dx: [64 n][64 k] boxes, K-major like a, whose 256 rows run on
// across the boxes 1024 bytes every 8 (SBO).
template <bool TRANS>
__device__ __forceinline__ void fwd_products(float* acc, uint32_t a, uint32_t b) {
#pragma unroll
  for (int k = 0; k < kBox / 16; ++k) {
    const uint64_t ad = hopper::kmajor_desc(a + k * 32);
    const uint64_t bd = TRANS ? hopper::kmajor_desc(b + k * 32)
                              : hopper::sw128_desc(b + k * 16 * kRowBytes, kFBox, 1024);
    hopper::Wgmma<kFN>::ss<0, TRANS ? 0 : 1>(acc, ad, bd, 1);
  }
}

// y [R, N] = x [R, K] @ w[e] (w [E, K, N]; TRANS: w [E, N, K] read as
// w[e]^T), times s[r] when SCALED, e the expert of row r's routing block.
// x, w and y arrive as tensor maps (y's for the TMA stores); y's pointer
// for f32's stores from registers.
template <typename T, bool TRANS, bool SCALED>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
           const __grid_constant__ CUtensorMap ymap, const int* __restrict__ be,
           const float* __restrict__ s, T* __restrict__ y, int K, int N, int tiles_m,
           int tiles_n, int block_rows) {
  using L = FwdLayout<T>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (flash::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = flash::smem_addr(smem);
  const uint32_t full = base + L::bars, empty = full + 8 * L::stages;
  const int items = tiles_m * tiles_n, steps = (K + kBox - 1) / kBox;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::stages; ++i) {
      mbar_init(full + 8 * i, 1);   // the producer's arrive, with the stage's bytes
      mbar_init(empty + 8 * i, 2);  // one arrive from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // the producer: one thread issues every copy
    if ((threadIdx.x & 31) == 0) {
      int it = 0;  // stages issued, over all items
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const FwdItem w = fwd_item(i, tiles_m, tiles_n, be, block_rows);
        if (w.e < 0) continue;  // a sentinel: no loads
        for (int k0 = 0; k0 < K; k0 += kBox, ++it) {
          const int st = it % L::stages;
          mbar_wait(empty + 8 * st, ((it / L::stages) & 1) ^ 1);
          const uint32_t bar = full + 8 * st, dst = base + st * L::stage;
          mbar_expect(bar, L::stage);
          for (int b = 0; b < kXFBoxes; ++b)
            tma_box(dst + b * L::box, xmap, bar, k0, w.m0 + b * kBox);
          for (int b = 0; b < kFN / kBox; ++b) {
            const int c = w.n0 + b * kBox;  // y's columns: w[e]'s (dx: its rows)
            const int c0 = TRANS ? k0 : c, c1 = TRANS ? c : k0;
            hopper::tma_box_3d(dst + (kXFBoxes + b) * L::box, wmap, bar, c0, c1, w.e);
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile;
  // acc[4j .. 4j + 3] are this thread's rows r, r + 8 of them at columns
  // 8j + q and the next
  const int wg = warp >> 2, t = threadIdx.x & 127, lane = t & 31;
  const int r = (t >> 5) * 16 + (lane >> 2), q = 2 * (lane & 3);
  float acc[kFwdAcc];
  int it = 0;  // stages consumed, over all items
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const FwdItem w = fwd_item(i, tiles_m, tiles_n, be, block_rows);
    const int n = w.e < 0 ? 0 : steps;  // a sentinel's sums stay zero
#pragma unroll
    for (int x = 0; x < kFwdAcc; ++x) acc[x] = 0.f;
    for (int step = 0; step < n; ++step, ++it) {
      const int st = it % L::stages;
      mbar_wait(full + 8 * st, (it / L::stages) & 1);
      if constexpr (L::split) {
        // one plane pair serves the stage: both warpgroups' products of the
        // last stage must be done before it is overwritten
        wgmma_wait<0>();
        bar_sync(1, 256);
        hopper::split_boxes(smem + st * L::stage, smem + L::planes, smem + L::planes + L::plane,
                            kFwdBoxes, kBox, threadIdx.x, 256, [](int, int) { return 1.f; });
        fence_async_smem();
        bar_sync(1, 256);
        if (t == 0) mbar_arrive(empty + 8 * st);
        const uint32_t hi = base + L::planes, lo = hi + L::plane;
        const uint32_t xo = wg * kFBox, wo = kXFBoxes * kFBox;
        wgmma_fence();
        fwd_products<TRANS>(acc, hi + xo, hi + wo);
        fwd_products<TRANS>(acc, hi + xo, lo + wo);
        fwd_products<TRANS>(acc, lo + xo, hi + wo);
        wgmma_commit();
      } else {
        const uint32_t a = base + st * L::stage;
        wgmma_fence();
        fwd_products<TRANS>(acc, a + wg * kFBox, a + kXFBoxes * kFBox);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: its slot goes back
        if (step > 0 && t == 0) mbar_arrive(empty + 8 * ((it - 1) % L::stages));
      }
    }
    wgmma_wait<0>();
    hopper::fence_regs<kFwdAcc>(acc);
    if (!L::split && n > 0 && t == 0) mbar_arrive(empty + 8 * ((it - 1) % L::stages));

    const int row = w.m0 + wg * 64 + r;
    const bool scaled = SCALED && w.e >= 0;  // a sentinel's zeros stay zeros
    const float s0 = scaled ? s[row] : 1.f, s1 = scaled ? s[row + 8] : 1.f;
    if constexpr (L::tma_store) {
      // rounded into the warpgroup's buffer, laid out as TMA lays bf16
      // boxes (16-byte chunk c of row r at c ^ (r % 8)), then stored a box
      // at a time by one thread; the buffer is rewritten only once the
      // last stores have read it
      unsigned char* buf = smem + L::epi + wg * L::epi_wg;
      const uint32_t bufa = base + L::epi + wg * L::epi_wg;
#pragma unroll
      for (int c0 = 0; c0 < kFN; c0 += kEpiCols) {
        if (t == 0) hopper::bulk_wait_read<0>();
        bar_sync(2 + wg, 128);
#pragma unroll
        for (int j = c0 / 8; j < (c0 + kEpiCols) / 8; ++j) {
          const int off = (j - c0 / 8) / 8 * kFBox + (((j & 7) ^ (r & 7)) << 4) + 2 * q;
          *reinterpret_cast<uint32_t*>(buf + off + r * kRowBytes) =
              flash::pack_bf16(acc[4 * j] * s0, acc[4 * j + 1] * s0);
          *reinterpret_cast<uint32_t*>(buf + off + (r + 8) * kRowBytes) =
              flash::pack_bf16(acc[4 * j + 2] * s1, acc[4 * j + 3] * s1);
        }
        fence_async_smem();  // the generic stores, before the TMA store reads them
        bar_sync(2 + wg, 128);
        if (t == 0) {
          for (int b = 0; b < kEpiCols / kBox; ++b) {
            const int col = w.n0 + c0 + b * kBox;
            if (col < N) hopper::tma_store(ymap, bufa + b * kFBox, col, w.m0 + wg * 64);
          }
          hopper::bulk_commit();
        }
      }
    } else {
      T* out = y + (size_t)row * N;
#pragma unroll
      for (int j = 0; j < kFN / 8; ++j) {
        const int col = w.n0 + 8 * j + q;
        if (col < N) {
          store_pair(out + col, acc[4 * j] * s0, acc[4 * j + 1] * s0);
          store_pair(out + 8 * (size_t)N + col, acc[4 * j + 2] * s1, acc[4 * j + 3] * s1);
        }
      }
    }
  }
  if (L::tma_store && t == 0) hopper::bulk_wait<0>();  // the buffers outlive their stores
}

// ---------------------------------------------------------------------------
// dw (K7a, K7b): a TMA ring feeding wgmma
// ---------------------------------------------------------------------------

constexpr int kDepth = 64;   // rows of x and dy a stage (block_rows is a multiple of 128)
constexpr int kTM = 128;     // dw tile rows (x's columns): 64 a consumer warpgroup
constexpr int kTN = 256;     // dw tile columns (dy's columns)
constexpr int kXBoxes = kTM / kBox;             // a stage holds x's boxes, then dy's
constexpr int kBoxes = (kTM + kTN) / kBox;
constexpr int kPlaneBox = kDepth * kRowBytes;   // a bf16 box, 8192 bytes
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
__global__ void __launch_bounds__(kThreads, 1)
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

// The row-major [rows, cols] matrix at p as boxes of box_rows rows x kBox
// columns: bf16 with the 128-byte swizzle wgmma reads, f32 as it is;
// elements past the edges read as zeros (and TMA stores clip there). 0, or
// minus the driver's CUresult.
template <typename T>
int encode_rows(CUtensorMap* map, const void* p, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {kBox, (cuuint32_t)box_rows};
  return hopper::encode(map, Planes<T>::value == 1, 2, p, dims, strides, box);
}

// The experts' weights [E, rows, cols] at p as a 3-D map of [kBox][kBox]
// boxes of one expert, so a box past rows or cols reads zeros, not the next
// expert's first rows (with a 2-D map over [E * rows, cols] only x's zero
// columns would hide those, and a non-finite weight there would still turn
// the sums into NaN). The C entries are not told E: the kernel reads only
// the experts `be` names, which lie in [0, E), so the outer extent is the
// most an int32 entry of be can name.
template <typename T>
int encode_experts(CUtensorMap* map, const void* p, int rows, int cols) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)INT_MAX};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * sizeof(T), (cuuint64_t)rows * cols * sizeof(T)};
  const cuuint32_t box[3] = {kBox, kBox, 1};
  return hopper::encode(map, Planes<T>::value == 1, 3, p, dims, strides, box);
}

template <typename T, bool TRANS, bool SCALED>
int fwd(const void* x, const void* w, const int* be, const float* s, void* y, int R, int K, int N,
        int block_rows, cudaStream_t stream) {
  if (!shapes_ok(R, K, N, block_rows)) return (int)cudaErrorInvalidValue;
  int sms = 0, err = hopper::bind_device(&sms);
  if (err) return err;
  CUtensorMap xmap, wmap, ymap;
  err = encode_rows<T>(&xmap, x, R, K, kBox);
  if (!err) err = TRANS ? encode_experts<T>(&wmap, w, N, K) : encode_experts<T>(&wmap, w, K, N);
  if (!err) err = encode_rows<T>(&ymap, y, R, N, kBox);
  if (err) return err;
  const int tiles_m = R / kBM, tiles_n = (N + kFN - 1) / kFN;
  if ((long long)tiles_m * tiles_n > INT_MAX) return (int)cudaErrorInvalidValue;
  const int items = tiles_m * tiles_n;
  const int blocks = items < sms ? items : sms;  // persistent: one block an SM
  return flash::launch(fwd_kernel<T, TRANS, SCALED>, dim3(blocks), kThreads,
                       (size_t)FwdLayout<T>::bytes, stream, xmap, wmap, ymap, be, s,
                       static_cast<T*>(y), K, N, tiles_m, tiles_n, block_rows);
}

template <typename T, bool SCALED>
int dw(const void* x, const void* dy, const float* s, const int* nblocks, const int* blist,
       float* out, int R, int K, int N, int E, int nb, int block_rows, cudaStream_t stream) {
  if (!shapes_ok(R, K, N, block_rows) || E <= 0 || E > kMaxExperts || nb != R / block_rows ||
      (SCALED && reinterpret_cast<uintptr_t>(s) % 16))
    return (int)cudaErrorInvalidValue;
  int sms = 0, err = hopper::bind_device(&sms);
  if (err) return err;
  CUtensorMap xmap, dymap;
  err = encode_rows<T>(&xmap, x, R, K, kDepth);
  if (!err) err = encode_rows<T>(&dymap, dy, R, N, kDepth);
  if (err) return err;
  const int items = E * ((K + kTM - 1) / kTM) * ((N + kTN - 1) / kTN);
  const int grid = items < sms ? items : sms;
  if (grid > kMaxBlocks || (items + grid - 1) / grid > kMaxRounds)
    return (int)cudaErrorInvalidValue;
  return flash::launch(dw_kernel<T, SCALED>, dim3(grid), kThreads,
                       (size_t)DwLayout<T>::bytes, stream, xmap, dymap, s, nblocks, blist, out, K,
                       N, E, nb, block_rows);
}

}  // namespace
}  // namespace gmm

// C entries (ctypes). x, w, y (and dy) are contiguous, 16-byte aligned,
// bf16 (bf16 = 1) or f32; be, nblocks, blist int32; s (16-byte aligned for
// dw), dw f32. Each returns cudaGetLastError() after the launch (0 when it
// was taken), or minus the driver's CUresult when a tensor map cannot be
// encoded.

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
