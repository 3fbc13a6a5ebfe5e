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
// 6,272 to 401,408 and K, N 64 to 2,048. Most of the step's bound is bytes
// (stage 1 at M 401,408: conv3, K 64 -> N 256, moves 0.077 ms of x and y at
// 3.35 TB/s against 0.013 ms of operations at 989 TFLOP/s); the last stage's
// products are operations-bound. So the product runs on wgmma, fed by TMA,
// the statistics cost no pass over y, and y's stores drain while the next
// tile loads. The machinery is grouped_matmul.cu's forward (hopper.cuh):
//   - An item is a 128-row x BN-column tile of y, BN 128, or 64 where N is at
//     most 64 (8 of the 36 launches). Items are numbered row tile by row
//     tile; persistent blocks, as many as the SMs take in multiples of the
//     column tiles, take items blockIdx.x, + gridDim.x, ..., so each block
//     stays on one column tile.
//   - Warpgroup 2 is the producer (setmaxnreg down to 40): one thread fills
//     a ring of Layout::stages stages of 64 reduction indices with
//     cp.async.bulk.tensor behind full and empty mbarriers: x's [128
//     rows][64] as two 64 x 64 boxes and w's [64][BN] as BN / 64 boxes,
//     128-byte swizzle. Boxes past M, K or N read zeros. It runs ahead into
//     the next items while the consumers finish this one, so one item's
//     epilogue overlaps the next ones' loads (a K = 64 item is one stage).
//     With it a thread gets 168 registers, too few for 128 x 256 tiles (three
//     accumulator sets, see below); 128 x 256 tiles with thread 0 issuing
//     the loads instead measured slower (PERF.md).
//   - Warpgroups 0 and 1 are the consumers: each owns 64 rows x BN columns
//     of the tile and issues 4 BN / 64 wgmma.mma_async.m64n64k16 a stage,
//     A = x K-major, B = w MN-major, as fwd_kernel reads w[e].
//   - The prologue applies relu(x * a + b) in f32 (one fused multiply-add)
//     to the warpgroup's own landed x box in place and rounds it to bf16
//     (the TPU kept it in f32; a declared difference, ROADMAP Queue 3),
//     then fence.proxy.async and a warpgroup barrier before wgmma reads it.
//     Chunks at k >= K keep TMA's zeros. Rows >= M become relu(b), which
//     the statistics leave out and the stores clip.
//   - Statistics come from the unrounded f32 sums, never from the rounded
//     y. The tensor cores drop the low bits of their f32 sums toward zero,
//     which through a K-deep accumulation would bias the sum of squares by
//     ~K/64 ulps (on an H100 all 2048 into one accumulator came out at 1.07
//     times chip_smoke.FLS_STATS_C's limit of 32 ulps for bf16), and even
//     64-deep runs bias every y toward zero enough that ResNet-50's loss
//     drifts from the plain version's (resnet_parity's first bf16 step
//     2.3e-3 off, against 2.0e-4 for 32-deep runs; PERF.md). So each
//     32-deep product (kFresh 16-deep steps) goes into a fresh accumulator,
//     one 64-column half at a time (m64n64k16) into two 32-float
//     accumulators in turn, and is added to the sums on the CUDA cores,
//     which round to nearest, while the next one's product runs.
//   - The TPU kernel added each M block's sums into one resident stats
//     block, which only its sequential grid order makes sound. Here each
//     warpgroup reduces its 64 rows of an item by column: a thread's two
//     rows, then the 8 lanes holding the same columns (shuffles that halve
//     the values each step), then its 4 warps in order through shared
//     memory (two buffers, so one warpgroup barrier an item), into a running
//     sum of the block's items. Each warpgroup writes one partial row, and
//     stats_kernel, launched right after, sums the rows in order, as the
//     JAX wrapper sums its 8 stat rows outside the kernel. No atomics, so
//     the result does not change from run to run. No barrier ties the two
//     warpgroups at an item's end (starting warpgroup 1 a stage behind, so
//     that the epilogues interleave, measured slower: PERF.md).
//   - y: bf16 tiles are rounded into a swizzled shared buffer per
//     warpgroup and written by TMA stores, clipped at M and N, which drain
//     while the next item's products run.
//   - T = f32 runs the same walk, ring, products and epilogue: TMA lands
//     f32 boxes (one stage), the consumers split them into bf16 hi and lo
//     planes (x through the prologue first) and issue hi.hi + hi.lo + lo.hi
//     into the same sums, so the f32 check vouches for the bf16 kernel's
//     walk, boxes, descriptors, masks and reductions; its tiles are stored
//     from registers. The split keeps each operand to ~2^-17 of itself; a
//     weight's dropped bits are the same for every row, so where the rows
//     are all >= 0 (ReLU'd activations) they add up in a column's sum (up
//     to ~100 f32 ulps of sum|y|, FLS_STATS_C's 256 for f32).
// Any M, N and K are masked; K and N must be multiples of 8 (16-byte rows).

#include <climits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace fls {
namespace {

using flash::Planes;
using hopper::bar_sync;
using hopper::fence_async_smem;
using hopper::kBox;       // columns of a TMA box: 64 bf16 fill one 128-byte swizzle row
using hopper::kRowBytes;  // a bf16 box row
using hopper::mbar_arrive;
using hopper::mbar_expect;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::tma_box;

constexpr int kBM = 128;                  // tile rows: 64 a consumer warpgroup
constexpr int kXBoxes = kBM / kBox;       // a stage holds x's boxes, then w's
constexpr int kThreads = 384;             // warpgroups 0, 1: the consumers; 2: the producer
constexpr int kFBox = kBox * kRowBytes;   // a bf16 box of 64 x 64, 8192 bytes
// At most 4 stages: of 3, 4 and 5 at 128 x 128 and 4 and 8 at 128 x 64, 4
// took the least time a ResNet-50 step (tools/fls_decode_variants.py,
// PERF.md).
constexpr int kMaxStages = 4;
// 16-deep products summed in one fresh accumulator before it is added to
// the sums on the CUDA cores (see the header).
constexpr int kFresh = 2;

// Shared memory of fls_kernel<T, BN> (byte offsets from a 1024-byte
// boundary): the ring of `stages` stages, each `boxes` TMA boxes of
// [64][kBox] T (x's two, then w's BN / 64), as many as fit; for f32 the
// stage split into bf16 hi and lo planes (each laid out as a bf16 stage);
// for bf16 each consumer warpgroup's epilogue buffer (64 rows of y); each
// consumer warpgroup's two statistics buffers of [4 warps][sum, sum of
// squares][BN] f32; the full and empty mbarriers.
template <typename T, int BN>
struct Layout {
  static constexpr bool split = Planes<T>::value == 2;
  static constexpr int boxes = kXBoxes + BN / kBox;
  static constexpr int box = kBox * kBox * (int)sizeof(T);
  static constexpr int stage = boxes * box;
  static constexpr int plane = boxes * kFBox;
  static constexpr int epi_wg = split ? 0 : BN / kBox * kFBox;
  static constexpr int red_buf = 8 * 2 * BN * 4;
  static constexpr int fixed = (split ? 2 * plane : 0) + 2 * epi_wg + 2 * red_buf;
  static constexpr int fit = (flash::kMaxSmem - 1024 - fixed - 16 * kMaxStages) / stage;
  static constexpr int stages = split ? 1 : (fit < kMaxStages ? fit : kMaxStages);
  static constexpr int planes = stages * stage;
  static constexpr int epi = planes + (split ? 2 * plane : 0);
  static constexpr int red = epi + 2 * epi_wg;
  static constexpr int bars = red + 2 * red_buf;
  static constexpr int bytes = bars + 16 * stages + 1024;
};

// first ? a : b as a bitwise select: a select between two elements of a
// register array can compile to a select of their addresses, which moves
// the array to local memory.
__device__ __forceinline__ float pick(bool first, float a, float b) {
  const uint32_t m = 0u - (uint32_t)first;
  return __uint_as_float((__float_as_uint(a) & m) | (__float_as_uint(b) & ~m));
}

// One step of the statistics' reduction over lanes l and l ^ OFF, which
// hold the same columns: each keeps HALF of its 2 HALF values (the upper
// half where bit OFF of its lane is set) and adds its partner's copy.
template <int OFF, int HALF>
__device__ __forceinline__ void halve(float* v, int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int x = 0; x < HALF; ++x) {
    const float send = pick(upper, v[x], v[x + HALF]);
    const float keep = pick(upper, v[x + HALF], v[x]);
    v[x] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

__device__ __forceinline__ float prologue(float v, float a, float b) {
  return fmaxf(__fmaf_rn(v, a, b), 0.f);
}

// bf16 with the prologue: a consumer warpgroup's landed x box (64 rows x
// 64 k, 128-byte swizzle: the 16-byte chunk of k0 + 8c in row r sits at
// chunk c ^ (r % 8)) through relu(x * a + b) in f32, rounded back in place.
// Chunks at k >= K (TMA's zeros; K % 8 == 0) stay zero.
__device__ __forceinline__ void prologue_box(unsigned char* box, const float* __restrict__ a,
                                             const float* __restrict__ b, int k0, int K, int t) {
  for (int q = t; q < kBox * 8; q += 128) {
    const int r = q >> 3, k = k0 + 8 * ((q & 7) ^ (r & 7));
    if (k >= K) continue;
    uint4* p = reinterpret_cast<uint4*>(box + q * 16);
    const uint4 raw = *p;
    const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
    const float4 a0 = reinterpret_cast<const float4*>(a + k)[0];
    const float4 a1 = reinterpret_cast<const float4*>(a + k)[1];
    const float4 b0 = reinterpret_cast<const float4*>(b + k)[0];
    const float4 b1 = reinterpret_cast<const float4*>(b + k)[1];
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint32_t out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in[j]));
      out[j] = flash::pack_bf16(prologue(f.x, av[2 * j], bv[2 * j]),
                                prologue(f.y, av[2 * j + 1], bv[2 * j + 1]));
    }
    *p = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// f32: the landed stage (boxes [64 rows][kBox] f32, unswizzled) split into
// bf16 hi and lo planes laid out as TMA lays out a bf16 stage (128-byte
// swizzle); x's boxes go through the prologue first. Run by both consumer
// warpgroups (t < 256).
template <bool PRO>
__device__ __forceinline__ void split_stage(const unsigned char* src, unsigned char* hi,
                                            unsigned char* lo, int boxes,
                                            const float* __restrict__ a,
                                            const float* __restrict__ b, int k0, int K, int t) {
  for (int q = t; q < boxes * kBox * 8; q += 256) {
    const int bx = q / (kBox * 8), r = (q >> 3) % kBox, c = q & 7;
    const float4* s = reinterpret_cast<const float4*>(src + ((bx * kBox + r) * kBox + c * 8) * 4);
    const float4 u = s[0], w = s[1];
    float v[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
    if constexpr (PRO) {
      const int k = k0 + 8 * c;
      if (bx < kXBoxes && k < K) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = prologue(v[j], a[k + j], b[k + j]);
      }
    }
    uint4 h, l;
    flash::split_pack(v[0], v[1], h.x, l.x);
    flash::split_pack(v[2], v[3], h.y, l.y);
    flash::split_pack(v[4], v[5], h.z, l.z);
    flash::split_pack(v[6], v[7], h.w, l.w);
    const int off = (bx * kBox + r) * kRowBytes + ((c ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// d (= A . B, or += when accumulate; 64 rows x 64 columns, 32 f32 a
// thread) over the 16 reduction indices k16 of a stage and w's 64-column
// box h (hi.hi + hi.lo + lo.hi for f32): the warpgroup's x box, K-major (a
// depth step of 16 is 32 bytes along the swizzled row), times w's box of
// [64 k][64 n], MN-major (a step is 16 box rows on).
template <bool SPLIT>
__device__ __forceinline__ void k16_products(float* d, uint32_t hi, uint32_t lo, int wg, int k,
                                             int h, bool accumulate) {
  const uint32_t a = hi + wg * kFBox, b = hi + (kXBoxes + h) * kFBox;
  const uint64_t ad = hopper::kmajor_desc(a + k * 32);
  const uint64_t bd = hopper::sw128_desc(b + k * 16 * kRowBytes, kFBox, 1024);
  hopper::Wgmma<kBox>::ss<0, 1>(d, ad, bd, accumulate ? 1 : 0);
  if constexpr (SPLIT) {
    const uint32_t al = lo + wg * kFBox, bl = lo + (kXBoxes + h) * kFBox;
    hopper::Wgmma<kBox>::ss<0, 1>(d, ad, hopper::sw128_desc(bl + k * 16 * kRowBytes, kFBox, 1024),
                                  1);
    hopper::Wgmma<kBox>::ss<0, 1>(d, hopper::kmajor_desc(al + k * 32), bd, 1);
  }
}

// One stage of a consumer warpgroup: wait for it, apply the prologue (or
// split f32), then its products in parts of kFresh 16-deep products x 64
// columns, each part into a fresh accumulator (f0 and f1 in turn; FIRST,
// the item's first stage: its first kFresh straight into the sums), added
// to the sums on the CUDA cores once the next part is issued and it is
// done, so the adds overlap the products. Then the stage goes back.
template <typename T, int BN, bool PRO, bool FIRST>
__device__ __forceinline__ void stage(float* acc, float* f0, float* f1, unsigned char* smem,
                                      uint32_t base, uint32_t full, uint32_t empty, int it, int k0,
                                      int K, const float* __restrict__ a,
                                      const float* __restrict__ b, int wg, int t) {
  using L = Layout<T, BN>;
  constexpr int kHalves = BN / kBox, kParts = kBox / 16 / kFresh * kHalves;
  const int st = it % L::stages;
  mbar_wait(full + 8 * st, (it / L::stages) & 1);
  uint32_t hi = base + st * L::stage, lo = 0;
  if constexpr (L::split) {
    // one plane pair serves both warpgroups, each of which waited for its
    // last products before this barrier
    bar_sync(1, 256);
    split_stage<PRO>(smem + st * L::stage, smem + L::planes, smem + L::planes + L::plane,
                     L::boxes, a, b, k0, K, threadIdx.x);
    fence_async_smem();
    bar_sync(1, 256);
    if (t == 0) mbar_arrive(empty + 8 * st);
    hi = base + L::planes;
    lo = hi + L::plane;
  } else if constexpr (PRO) {
    prologue_box(smem + st * L::stage + wg * L::box, a, b, k0, K, t);
    fence_async_smem();  // the generic stores, before wgmma's reads
    bar_sync(2 + wg, 128);
  }
  // part p: depth steps kFresh (p / kHalves) on, columns 64 (p % kHalves)
  // on; acc holds column 8j + ... at acc[4j ...], so the part's 32 sums
  // are acc + 32 h
#pragma unroll
  for (int p = 0; p <= kParts; ++p) {
    if (p < kParts) {
      const int k1 = p / kHalves * kFresh, h = p % kHalves;
      hopper::wgmma_fence();
#pragma unroll
      for (int k = k1; k < k1 + kFresh; ++k) {
        if (FIRST && k1 == 0)
          k16_products<L::split>(acc + 32 * h, hi, lo, wg, k, h, k > k1);
        else if (p % 2 == 0)
          k16_products<L::split>(f0, hi, lo, wg, k, h, k > k1);
        else
          k16_products<L::split>(f1, hi, lo, wg, k, h, k > k1);
      }
      hopper::wgmma_commit();
    }
    if (p > 0) {  // part p - 1 is done: add it
      if (p < kParts)
        hopper::wgmma_wait<1>();
      else
        hopper::wgmma_wait<0>();
      const int k1 = (p - 1) / kHalves * kFresh, h = (p - 1) % kHalves;
      if (FIRST && k1 == 0) {
        hopper::fence_regs<32>(acc + 32 * h);
      } else if ((p - 1) % 2 == 0) {
        hopper::fence_regs<32>(f0);
#pragma unroll
        for (int x = 0; x < 32; ++x) acc[32 * h + x] += f0[x];
      } else {
        hopper::fence_regs<32>(f1);
#pragma unroll
        for (int x = 0; x < 32; ++x) acc[32 * h + x] += f1[x];
      }
    }
  }
  if (!L::split && t == 0) mbar_arrive(empty + 8 * st);
}

// y = xin @ w in T (xin = relu(x * a + b) when PRO); part[0][row][n] and
// part[1][row][n] the sum and the sum of squares over this block's items'
// rows of the f32 product's column n (row = blockIdx.x / tiles_n). x, w and
// y arrive as tensor maps (y's for bf16's TMA stores); y's pointer for
// f32's stores from registers. Warpgroup 2 is the producer.
template <typename T, int BN, bool PRO>
__global__ void __launch_bounds__(kThreads, 1)
fls_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
           const __grid_constant__ CUtensorMap ymap, const float* __restrict__ a,
           const float* __restrict__ b, T* __restrict__ y, float* __restrict__ part, int M, int K,
           int N, int tiles_m, int tiles_n) {
  using L = Layout<T, BN>;
  constexpr int kAcc = BN / 2;  // f32 sums a consumer thread holds (64 x BN / 128)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (flash::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = flash::smem_addr(smem);
  const uint32_t full = base + L::bars, empty = full + 8 * L::stages;
  const int items = tiles_m * tiles_n, steps = (K + kBox - 1) / kBox;
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::stages; ++i) {
      mbar_init(full + 8 * i, 1);   // the producer's arrive, with the stage's bytes
      mbar_init(empty + 8 * i, 2);  // one arrive from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warpgroup: one thread issues every copy
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;  // stages issued, over all items
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const int m0 = i / tiles_n * kBM, n0 = i % tiles_n * BN;
        for (int k0 = 0; k0 < K; k0 += kBox, ++it) {
          const int st = it % L::stages;
          mbar_wait(empty + 8 * st, ((it / L::stages) & 1) ^ 1);
          const uint32_t bar = full + 8 * st, dst = base + st * L::stage;
          mbar_expect(bar, L::stage);
          for (int bx = 0; bx < kXBoxes; ++bx)
            tma_box(dst + bx * L::box, xmap, bar, k0, m0 + bx * kBox);
          for (int bx = 0; bx < BN / kBox; ++bx)
            tma_box(dst + (kXBoxes + bx) * L::box, wmap, bar, n0 + bx * kBox, k0);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile;
  // acc[4j .. 4j + 3] are this thread's rows r, r + 8 of them at columns 8j
  // + q and the next
  hopper::setmaxnreg_inc<232>();
  const int warp = threadIdx.x >> 5, wg = warp >> 2, t = threadIdx.x & 127, lane = t & 31;
  const int r = (t >> 5) * 16 + (lane >> 2), q = 2 * (lane & 3);
  float acc[kAcc], f0[32], f1[32];
  // thread t: the sum over this warpgroup's rows of statistic c / BN, column
  // c % BN, c = t + 128 u
  float run[BN / 64];
#pragma unroll
  for (int u = 0; u < BN / 64; ++u) run[u] = 0.f;
  int it = 0;  // stages consumed, over all items
  const int n0 = blockIdx.x % tiles_n * BN;  // the block's column tile: gridDim.x % tiles_n == 0
  for (int i = blockIdx.x, j = 0; i < items; i += gridDim.x, ++j) {
    const int m0 = i / tiles_n * kBM;
    stage<T, BN, PRO, true>(acc, f0, f1, smem, base, full, empty, it++, 0, K, a, b, wg, t);
    for (int step = 1; step < steps; ++step)
      stage<T, BN, PRO, false>(acc, f0, f1, smem, base, full, empty, it++, step * kBox, K, a, b,
                               wg, t);

    const int row = m0 + wg * 64 + r;
    if constexpr (!L::split) {
      // rounded into the warpgroup's buffer, laid out as TMA lays bf16 boxes
      // (16-byte chunk c of row r at c ^ (r % 8)), then stored a box at a
      // time by one thread; the buffer is rewritten only once the last
      // item's stores have read it
      unsigned char* buf = smem + L::epi + wg * L::epi_wg;
      const uint32_t bufa = base + L::epi + wg * L::epi_wg;
      if (t == 0) hopper::bulk_wait_read<0>();
      bar_sync(2 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const int off = jj / 8 * kFBox + (((jj & 7) ^ (r & 7)) << 4) + 2 * q;
        *reinterpret_cast<uint32_t*>(buf + off + r * kRowBytes) =
            flash::pack_bf16(acc[4 * jj], acc[4 * jj + 1]);
        *reinterpret_cast<uint32_t*>(buf + off + (r + 8) * kRowBytes) =
            flash::pack_bf16(acc[4 * jj + 2], acc[4 * jj + 3]);
      }
      fence_async_smem();  // the generic stores, before the TMA store reads them
      bar_sync(2 + wg, 128);
      if (t == 0) {
        for (int bx = 0; bx < BN / kBox; ++bx)
          if (n0 + bx * kBox < N)
            hopper::tma_store(ymap, bufa + bx * kFBox, n0 + bx * kBox, m0 + wg * 64);
        hopper::bulk_commit();
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const int col = n0 + 8 * jj + q;
        if (col < N) {
          if (row < M)
            *reinterpret_cast<float2*>(y + (size_t)row * N + col) =
                make_float2(acc[4 * jj], acc[4 * jj + 1]);
          if (row + 8 < M)
            *reinterpret_cast<float2*>(y + (size_t)(row + 8) * N + col) =
                make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
        }
      }
    }

    // statistics of the f32 sums, rows past M left out, 64 columns at a
    // time: v[2j + e] is this thread's two rows' sum at column 64 g + 8j +
    // q + e, v[16 + 2j + e] their sum of squares. Lanes l ^ 16, l ^ 8 and l
    // ^ 4 hold the same columns: after the three halving steps lane l has
    // v[x] = original x + 4 ((l >> 2) & 7), summed over the warp's 16 rows
    // (constant trip counts, so v stays in registers). Then the
    // warpgroup's 4 warps in order through red [warp][sum, ssq][BN], two
    // buffers by item, so a buffer is rewritten only after every thread of
    // the warpgroup passed the next item's barrier.
    const bool live0 = row < M, live1 = row + 8 < M;
    float* red = reinterpret_cast<float*>(smem + L::red) + (wg * 2 + (j & 1)) * (4 * 2 * BN);
    const int lb = (lane >> 2) & 7;
#pragma unroll
    for (int g = 0; g < BN / 64; ++g) {
      float v[32];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * (8 * g + jj) + e;
          const float y0 = live0 ? acc[i] : 0.f, y1 = live1 ? acc[i + 2] : 0.f;
          v[2 * jj + e] = y0 + y1;
          v[16 + 2 * jj + e] = y0 * y0 + y1 * y1;
        }
      }
      halve<16, 16>(v, lane);
      halve<8, 8>(v, lane);
      halve<4, 4>(v, lane);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int c2 = x + 4 * (lb & 3);
        red[((warp & 3) * 2 + (lb >> 2)) * BN + 64 * g + 8 * (c2 >> 1) + q + (c2 & 1)] = v[x];
      }
    }
    bar_sync(2 + wg, 128);
#pragma unroll
    for (int u = 0; u < BN / 64; ++u) {
      const int c = t + 128 * u, stat = c / BN, col = c - stat * BN;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) sum += red[(w * 2 + stat) * BN + col];
      run[u] += sum;
    }
  }
  // the warpgroup's partial row: part [2][2 gridDim.x / tiles_n][N]
  const int rows = 2 * (gridDim.x / tiles_n), prow = 2 * (blockIdx.x / tiles_n) + wg;
#pragma unroll
  for (int u = 0; u < BN / 64; ++u) {
    const int c = t + 128 * u, stat = c / BN, col = c - stat * BN;
    if (n0 + col < N) part[((size_t)stat * rows + prow) * N + n0 + col] = run[u];
  }
  if (!L::split && t == 0) hopper::bulk_wait<0>();  // the buffers outlive their stores
}

// stats [2][N] (= [2N]): the sum of the rows of part [2][rows][N]. A block
// takes 32 of the 2N statistics, one a lane; warp w sums its eighth of the
// rows in order, then lane c of warp 0 the 8 warps' sums in order.
__global__ void __launch_bounds__(256)
stats_kernel(const float* __restrict__ part, float* __restrict__ stats, int rows, int N) {
  __shared__ float sums[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, c = blockIdx.x * 32 + lane;
  const int per = (rows + 7) / 8, r1 = min(rows, (w + 1) * per);
  float sum = 0.f;
  if (c < 2 * N) {
    const int stat = c / N, col = c - stat * N;
    const float* p = part + (size_t)stat * rows * N + col;
    for (int r = w * per; r < r1; ++r) sum += p[(size_t)r * N];
  }
  sums[w][lane] = sum;
  __syncthreads();
  if (w == 0 && c < 2 * N) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) total += sums[i][lane];
    stats[c] = total;
  }
}

// The row-major [rows, cols] matrix at p as 64 x 64 boxes: bf16 with the
// 128-byte swizzle wgmma reads, f32 as it is; elements past the edges read
// as zeros (and TMA stores clip there). 0, or minus the driver's CUresult.
template <typename T>
int encode_rows(CUtensorMap* map, const void* p, int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {kBox, kBox};
  return hopper::encode(map, Planes<T>::value == 1, 2, p, dims, strides, box);
}

template <typename T, int BN, bool PRO>
int run(const void* x, const void* w, const float* a, const float* b, void* y, float* part,
        float* stats, int M, int K, int N, cudaStream_t stream) {
  int sms = 0, err = hopper::bind_device(&sms);
  if (err) return err;
  CUtensorMap xmap, wmap, ymap;
  err = encode_rows<T>(&xmap, x, M, K);
  if (!err) err = encode_rows<T>(&wmap, w, K, N);
  if (!err) err = encode_rows<T>(&ymap, y, M, N);
  if (err) return err;
  const long long tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + BN - 1) / BN;
  if (tiles_m * tiles_n > INT_MAX) return (int)cudaErrorInvalidValue;
  // persistent, one block an SM, each block on one column tile (so it sums
  // its items' statistics in place): `rows` blocks per column tile
  long long rows = sms / tiles_n;
  rows = rows < 1 ? 1 : rows < tiles_m ? rows : tiles_m;
  err = flash::launch(fls_kernel<T, BN, PRO>, dim3((unsigned)(rows * tiles_n)), kThreads,
                      (size_t)Layout<T, BN>::bytes, stream, xmap, wmap, ymap, a, b,
                      static_cast<T*>(y), part, M, K, N, (int)tiles_m, (int)tiles_n);
  if (err) return err;
  stats_kernel<<<(2 * N + 31) / 32, 256, 0, stream>>>(part, stats, 2 * (int)rows, N);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const float* a, const float* b, void* y, float* part,
             float* stats, int M, int K, int N, bool relu, cudaStream_t st) {
  if (N <= 64)
    return relu ? run<T, 64, true>(x, w, a, b, y, part, stats, M, K, N, st)
                : run<T, 64, false>(x, w, a, b, y, part, stats, M, K, N, st);
  return relu ? run<T, 128, true>(x, w, a, b, y, part, stats, M, K, N, st)
              : run<T, 128, false>(x, w, a, b, y, part, stats, M, K, N, st);
}

}  // namespace
}  // namespace fls

// C entry (ctypes): fls_kernel, then stats_kernel, on `stream`. x [M, K],
// w [K, N], y [M, N] are contiguous, 16-byte aligned, bf16 (bf16 = 1) or
// f32; with relu = 1, a and b are contiguous, 16-byte aligned f32 [K];
// part is f32 scratch of 4 ceil(M / 128) N; stats f32 [2][N] gets the
// column sums and sums of squares. Returns cudaGetLastError() after the
// launches (0 when they were taken), cudaErrorInvalidValue for shapes the
// kernel does not take, or minus the driver's CUresult when a tensor map
// cannot be encoded.
extern "C" int fused_linear_stats(const void* x, const void* w, const float* a, const float* b,
                                  void* y, float* part, float* stats, int M, int K, int N,
                                  int relu, int bf16, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || (relu && (a == nullptr || b == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? fls::dispatch<__nv_bfloat16>(x, w, a, b, y, part, stats, M, K, N, relu != 0, st)
              : fls::dispatch<float>(x, w, a, b, y, part, stats, M, K, N, relu != 0, st);
}
