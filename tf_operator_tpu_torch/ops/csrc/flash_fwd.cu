// Flash-attention forward for Hopper (sm_90a): o and the f32 row-LSE.
//
// Replaces tf_operator_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas
// TPU kernel launched by _fwd). Same function: o = softmax(q.k^T / sqrt(d)).v
// per query head, causal or not, GQA-native (query head hi reads kv head
// hi / g, g = h / h_kv, and no repeated K/V exists), plus
// lse = m + log(l), the log-sum-exp of each row's scaled, masked scores.
//
// Bound: operations. At the training shape (b 6, t 2048, h 16, h_kv 4,
// d 128, causal, bf16) one launch does 1.03e11 flops of q.k^T and p.v on
// the live (lower) triangle, 0.104 ms at the H100's 989 TFLOP/s bf16
// dense peak, against ~127 MB of q, k, v, o and lse, 0.038 ms at 3.35 TB/s.
// So both products run on wgmma, the only way to the card's dense rate,
// fed by TMA, and the score matrix never leaves registers:
//   - A work item is 128 query rows of one (batch, kv head, query block).
//     As the TPU kernel folds a GQA group into one program, for an even
//     group size g the rows are two query heads of the group x 64
//     positions, one head a consumer warpgroup, so both share the causal
//     diagonal; for odd g (MHA: g = 1) one head x 128 positions, 64 a
//     warpgroup. Each K/V tile lands in shared memory once for both.
//   - One persistent block an SM (384 threads) takes its items heaviest
//     causal first, dealt in snake order (item_index) so the blocks' work
//     evens out. Warpgroup 2 is the producer (setmaxnreg down to 40
//     registers; the consumers go up to 232): one thread loads each item's
//     Q into one of two buffers and streams K and V tiles of KT = 64 keys
//     through a 5-stage ring with cp.async.bulk.tensor behind full and
//     empty mbarriers, running ahead into the next item while the
//     consumers finish this one. The tensor maps are 4-D over [b, t, heads,
//     d] (no transpose copy), boxes 64 columns wide with the 128-byte
//     swizzle; TMA's zero fill past t replaces zero-filled ragged rows, and
//     its zero fill past d pads the head dim to DP = 64 or 128, so every d
//     of 16..128 (multiples of 16) runs on one of two instantiations.
//   - Warpgroups 0 and 1 are the consumers; each runs the online softmax
//     over the item's key tiles (the TPU's sequential grid axis becomes
//     this loop): S = Q.K^T as wgmma m64n64k16 with both operands K-major
//     from the swizzled boxes; the causal and ragged mask only on tiles that
//     cross the diagonal or t; the running max and sum in log2 units, one
//     ex2 instruction an element; P packed to bf16 A fragments straight from
//     S's registers; O += P.V as wgmma m64nDPk16 with A from registers and V
//     read MN-major, O's f32 sums in registers, rescaled as the max moves.
//     The next tile's S is issued together with this tile's P.V, and its
//     softmax runs while P.V is on the tensor cores (FA3's intra-warpgroup
//     overlap); the last tile is peeled off, since ptxas serialises every
//     wgmma of a kernel where a branch separates a product from its wait. A
//     warpgroup gives a stage back once its products are done; no
//     __syncthreads in the loop.
//   - T = f32 runs the same walk, ring, masks and products: TMA lands f32
//     boxes (one stage), the consumers split them into bf16 hi and lo
//     planes in the swizzled layout (Q once an item, K and V each tile), P
//     is split in registers, and each product is hi.hi + hi.lo + lo.hi;
//     P.V's three go into a fresh sum that is then added to O (see
//     flash_common.cuh for why), so the f32 check vouches for the
//     bf16 kernel's masks, walk and descriptors.
// Measured against variants of this source (tools/flash_fwd_variants.py,
// PERF.md): 128-key tiles, 2 stages, one block an item, a round-robin
// deal, no fold, the mask on every tile, exp2f, O rescaled only when a
// row's max moved, and FA3's ping-pong between the warpgroups were all
// slower at gqa-2048's shape; 4 stages tie there and lose at moe-small's.

#include <climits>
#include <type_traits>

#include "hopper.cuh"

namespace flash {
namespace {

using hopper::kRowBytes;

constexpr int kRows = 64;      // query rows of a consumer warpgroup
constexpr int kThreads = 384;  // warpgroups 0, 1: the consumers; 2: the producer
constexpr int kStages = 5;     // ring stages (bf16; f32 lands one stage)

// Shared memory of fwd_kernel<T, DP> (byte offsets from a 1024-byte
// boundary): Q's two buffers (f32: its hi, then lo plane), each both
// warpgroups' boxes; the ring of `stages` landed stages, each K's then V's
// boxes of [KT rows][64] T; for f32 the stage's K and V split into bf16 hi,
// then lo planes (Q lands there first); the mbarriers: full and empty a
// stage, full and empty a Q buffer.
template <typename T, int DP>
struct FwdLayout {
  static constexpr bool split = Planes<T>::value == 2;
  static constexpr int KT = 64;                             // keys a tile
  static constexpr int stages = split ? 1 : kStages;
  static constexpr int qbufs = split ? 1 : 2;
  static constexpr int boxes = DP / hopper::kBox;           // boxes a row of Q, K or V
  static constexpr int qbox = kRows * kRowBytes;            // a bf16 Q box
  static constexpr int kvbox = KT * kRowBytes;              // a bf16 K or V box
  static constexpr int qplane = 2 * boxes * qbox;           // [warpgroup][box]
  static constexpr int kvplane = 2 * boxes * kvbox;         // K's boxes, then V's
  static constexpr int stage = kvplane * (int)sizeof(T) / 2;
  static constexpr int q = 0;
  static constexpr int ring = q + 2 * qplane;
  static constexpr int planes = ring + stages * stage;
  static constexpr int bars = planes + (split ? 2 * kvplane : 0);
  static constexpr int bytes = bars + 2 * (stages + qbufs) * 8 + 1024;
  static_assert(!split || 2 * kvplane >= 2 * boxes * kRows * kRowBytes * 2,
                "f32 Q must land in the K/V planes");
};

// Byte offset of depth step kk (16 bf16) in K-major boxes of `box` bytes:
// 32 bytes along the row, the next box every 4 steps.
__device__ __forceinline__ uint32_t qk_step(int kk, int box) {
  return (kk >> 2) * box + (kk & 3) * 32;
}
// Byte offset of key step kk (16 keys) in MN-major V boxes: 16 rows on.
__device__ __forceinline__ uint32_t pv_step(int kk) { return kk * 16 * kRowBytes; }

// s = Q.K^T for one warpgroup: q and k the shared addresses of its Q boxes
// and the tile's K boxes (hi planes; the lo planes qlo and klo bytes on).
// f32: the small cross terms first, then hi.hi, all into s.
template <int P, int DP, int KT>
__device__ __forceinline__ void qk_products(float* s, uint32_t q, uint32_t k, int qbox, int kbox,
                                            int qlo, int klo) {
  using W = hopper::Wgmma<KT>;
  if constexpr (P == 2) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      W::template ss<0, 0>(s, hopper::kmajor_desc(q + qlo + qk_step(kk, qbox)),
                           hopper::kmajor_desc(k + qk_step(kk, kbox)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      W::template ss<0, 0>(s, hopper::kmajor_desc(q + qk_step(kk, qbox)),
                           hopper::kmajor_desc(k + klo + qk_step(kk, kbox)), 1);
  }
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    W::template ss<0, 0>(s, hopper::kmajor_desc(q + qk_step(kk, qbox)),
                         hopper::kmajor_desc(k + qk_step(kk, kbox)), P == 2 || kk > 0);
}

// acc (+)= P.V for one warpgroup: pa the A fragments of P (per key step and
// plane), v the tile's V boxes (hi plane; lo vlo bytes on), MN-major, the
// next 64 columns one box (kvbox bytes) on. f32: hi.lo + lo.hi + hi.hi.
template <int P, int DP, int KT>
__device__ __forceinline__ void pv_products(float* acc, uint32_t (*pa)[P][4], uint32_t v,
                                            int kvbox, int vlo, int accumulate) {
  using W = hopper::Wgmma<DP>;
  if constexpr (P == 2) {
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      W::template rs<1>(acc, pa[kk][1], hopper::sw128_desc(v + pv_step(kk), kvbox, 1024),
                        accumulate || kk > 0);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      W::template rs<1>(acc, pa[kk][0], hopper::sw128_desc(v + vlo + pv_step(kk), kvbox, 1024),
                        1);
  }
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    W::template rs<1>(acc, pa[kk][0], hopper::sw128_desc(v + pv_step(kk), kvbox, 1024),
                      P == 2 || accumulate || kk > 0);
}

// The online softmax of one warpgroup over tile k0's scores s (raw, in
// registers, rows row0 and row0 + 8 of this thread): the mask where the
// tile crosses the diagonal or t, the running max m (raw) and the per-thread
// partial sums l in log2 units; s becomes exp2 of the scaled scores minus
// the new max, and a the factor the sums of the older tiles take.
// 2^x as the bare MUFU instruction (ex2.approx.ftz: a result below 2^-126
// flushes to 0); exp2f adds a range fix-up around it, and the softmax's
// exponentials are a large part of the kernel's issue slots.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int KT>
__device__ __forceinline__ void softmax_tile(float* s, int k0, int t, int causal, int pw,
                                             int row0, int cq, float scale2, float (&m)[2],
                                             float (&l)[2], float (&a)[2]) {
  // s[4n + e]: row row0 (e < 2) or row0 + 8, key k0 + 8n + cq + (e & 1)
  const bool edge = k0 + KT > t || (causal && k0 + KT - 1 > pw);
  if (edge) {
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * n + cq + (e & 1);
        const int row = e < 2 ? row0 : row0 + 8;
        if (col >= t || (causal && col > row)) s[4 * n + e] = kNegInf;
      }
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < KT / 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the 4 threads of a quad hold one row's KT scores
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    a[r] = ex2((m[r] - mx[r]) * scale2);
    m[r] = mx[r];
    l[r] *= a[r];
  }
  // Key 0 is live for every row, so from the first tile on the max is
  // finite and ex2 of a masked score is exactly 0. A row with no live key
  // yet (none such reaches here unless the mask is wrong) keeps weight 0:
  // against its own masked max, fmaf's exact product would leave a
  // rounding residual that ex2 can blow up to inf.
  const float ms0 = (mx[0] == kNegInf ? 0.f : mx[0]) * scale2;
  const float ms1 = (mx[1] == kNegInf ? 0.f : mx[1]) * scale2;
#pragma unroll
  for (int n = 0; n < KT / 8; ++n) {
    s[4 * n] = ex2(fmaf(s[4 * n], scale2, -ms0));
    s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], scale2, -ms0));
    s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], scale2, -ms1));
    s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], scale2, -ms1));
    l[0] += s[4 * n] + s[4 * n + 1];
    l[1] += s[4 * n + 2] + s[4 * n + 3];
  }
}

// P (a tile's probabilities, score-shaped in registers) as the A fragments
// of p.v, per key step and plane: the fragment of key step n / 2 takes a0,
// a1 from its first 8 keys and a2, a3 from the next 8 (flash_common.cuh's
// fragment layouts); bf16, or split into hi and lo.
template <int P, int KT>
__device__ __forceinline__ void pack_p(uint32_t (*pa)[P][4], const float* s) {
#pragma unroll
  for (int n = 0; n < KT / 8; ++n) {
    uint32_t* a = pa[n >> 1][0] + 2 * (n & 1);
    if constexpr (P == 1) {
      a[0] = pack_bf16(s[4 * n], s[4 * n + 1]);
      a[1] = pack_bf16(s[4 * n + 2], s[4 * n + 3]);
    } else {
      uint32_t* b = pa[n >> 1][1] + 2 * (n & 1);
      split_pack(s[4 * n], s[4 * n + 1], a[0], b[0]);
      split_pack(s[4 * n + 2], s[4 * n + 3], a[1], b[1]);
    }
  }
}

// The blocks' work items, heaviest causal query blocks first: item i is
// query block nqb - 1 - i / (units * b) of unit (i % (units * b)) % units
// (a head pair, or a head) of batch (i % (units * b)) / units. Block p of G
// takes the p-th item of each round of G in even rounds and the (G-1-p)-th
// in odd ones, so the blocks that took the heavier items of one round take
// the lighter ones of the next.
__device__ __forceinline__ int item_index(int round, int p, int G) {
  return round * G + ((round & 1) ? G - 1 - p : p);
}
struct Item {
  int bi, h0, hk, p0, nk;
};
__device__ __forceinline__ Item item_of(int i, int units, int b, int nqb, int span, int t, int h,
                                        int h_kv, int fold, int causal, int kt) {
  const int per = units * b, r = i % per;
  Item w;
  w.bi = r / units;
  w.h0 = fold ? 2 * (r % units) : r % units;
  w.hk = w.h0 / (h / h_kv);
  w.p0 = (nqb - 1 - i / per) * span;
  const int last = min(w.p0 + span, t) - 1;  // the item's last live position
  w.nk = causal ? last / kt + 1 : (t + kt - 1) / kt;
  return w;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap, T* __restrict__ o, float* __restrict__ lse,
           int b, int t, int h, int h_kv, int d, int causal, int fold, float scale) {
  using L = FwdLayout<T, DP>;
  constexpr int KT = L::KT, P = Planes<T>::value;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + L::bars, empty = full + 8 * L::stages;
  const uint32_t qfull = empty + 8 * L::stages, qempty = qfull + 8 * L::qbufs;

  const int span = fold ? kRows : 2 * kRows;  // positions an item covers
  const int units = fold ? h / 2 : h;
  const int nqb = (t + span - 1) / span, items = units * b * nqb;
  const auto item = [&](int i) {
    return item_of(i, units, b, nqb, span, t, h, h_kv, fold, causal, KT);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::stages; ++i) {
      hopper::mbar_init(full + 8 * i, 1);   // the producer's arrive, with the stage's bytes
      hopper::mbar_init(empty + 8 * i, 2);  // one arrive from each consumer warpgroup
    }
    for (int i = 0; i < L::qbufs; ++i) {
      hopper::mbar_init(qfull + 8 * i, 1);
      hopper::mbar_init(qempty + 8 * i, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warpgroup: one thread issues every copy
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      constexpr int qbytes = kRows * hopper::kBox * (int)sizeof(T);  // a landed Q box
      constexpr int kvbytes = KT * hopper::kBox * (int)sizeof(T);   // a landed K or V box
      int it = 0;  // tiles issued, over all items
      for (int n = 0, i = blockIdx.x; i < items; i = item_index(++n, blockIdx.x, gridDim.x)) {
        const Item w = item(i);
        const int qb = n % L::qbufs;
        hopper::mbar_wait(qempty + 8 * qb, ((n / L::qbufs) & 1) ^ 1);
        const uint32_t qdst = base + (L::split ? L::planes : L::q + qb * L::qplane);
        hopper::mbar_expect(qfull + 8 * qb, 2 * L::boxes * qbytes);
        for (int wg = 0; wg < 2; ++wg)
          for (int bx = 0; bx < L::boxes; ++bx)
            hopper::tma_box_4d(qdst + (wg * L::boxes + bx) * qbytes, qmap, qfull + 8 * qb,
                               bx * hopper::kBox, w.h0 + (fold ? wg : 0),
                               w.p0 + (fold ? 0 : wg * kRows), w.bi);
        for (int j = 0; j < w.nk; ++j, ++it) {
          const int st = it % L::stages;
          hopper::mbar_wait(empty + 8 * st, ((it / L::stages) & 1) ^ 1);
          const uint32_t bar = full + 8 * st, dst = base + L::ring + st * L::stage;
          hopper::mbar_expect(bar, L::stage);
          for (int bx = 0; bx < L::boxes; ++bx) {
            hopper::tma_box_4d(dst + bx * kvbytes, kmap, bar, bx * hopper::kBox, w.hk, j * KT,
                               w.bi);
            hopper::tma_box_4d(dst + (L::boxes + bx) * kvbytes, vmap, bar, bx * hopper::kBox,
                               w.hk, j * KT, w.bi);
          }
        }
      }
    }
  } else {
    // the consumers: warpgroup wg owns 64 rows of one query head of each item
    hopper::setmaxnreg_inc<232>();
    const int warp = threadIdx.x >> 5, wg = warp >> 2, lane = threadIdx.x & 31;
    const bool lead = (threadIdx.x & 127) == 0;
    const int cq = 2 * (lane & 3);        // this thread's first column of each 8
    const float scale2 = scale * kLog2e;  // raw scores -> log2 units
    const auto one = [](int, int) { return 1.f; };
    // f32: the landed stage's K (part 0) or V (part 1) boxes split into the
    // planes, by both warpgroups, once neither reads that part of the planes
    const auto split = [&](int part) {
      constexpr int landed = L::boxes * KT * hopper::kBox * 4;  // f32 K or V boxes
      hopper::bar_sync(1, 256);
      hopper::split_boxes(smem + L::ring + part * landed,
                          smem + L::planes + part * L::boxes * L::kvbox,
                          smem + L::planes + L::kvplane + part * L::boxes * L::kvbox, L::boxes,
                          KT, threadIdx.x, 256, one);
      hopper::fence_async_smem();
      hopper::bar_sync(1, 256);
    };
    // tile it's bf16 K boxes, then V's (f32: the hi plane)
    const auto kv_of = [&](int it) {
      return L::split ? base + L::planes : base + L::ring + (it % L::stages) * L::stage;
    };

    int it = 0;  // tiles consumed, over all items
    for (int n = 0, i = blockIdx.x; i < items; i = item_index(++n, blockIdx.x, gridDim.x)) {
      const Item w = item(i);
      const int head = w.h0 + (fold ? wg : 0);
      const int pw = w.p0 + (fold ? 0 : wg * kRows);         // the warpgroup's first position
      const int row0 = pw + 16 * (warp & 3) + (lane >> 2);  // this thread's rows: row0, row0 + 8
      const int qb = n % L::qbufs;
      hopper::mbar_wait(qfull + 8 * qb, (n / L::qbufs) & 1);
      if constexpr (L::split) {
        hopper::split_boxes(smem + L::planes, smem + L::q, smem + L::q + L::qplane,
                            2 * L::boxes, kRows, threadIdx.x, 256, one);
        hopper::fence_async_smem();  // the first split's bar_sync orders it before any product
      }
      const uint32_t qa = base + L::q + (L::split ? 0 : qb * L::qplane) + wg * L::boxes * L::qbox;

      float acc[DP / 2];
#pragma unroll
      for (int x = 0; x < DP / 2; ++x) acc[x] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, a[2];  // raw max, partial sums

      // tile 0's scores
      float s[KT / 2];
      hopper::mbar_wait(full + 8 * (it % L::stages), (it / L::stages) & 1);
      if constexpr (L::split) {
        split(0);
        split(1);
        if (lead) hopper::mbar_arrive(empty);
      }
      hopper::wgmma_fence();
      qk_products<P, DP, KT>(s, qa, kv_of(it), L::qbox, L::kvbox, L::qplane, L::kvplane);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<KT / 2>(s);
      softmax_tile<KT>(s, 0, t, causal, pw, row0, cq, scale2, m, l, a);

      // O += P_j.V_j, P_j (in s) packed first and O rescaled; with `more`,
      // the scores of tile j + 1 are issued ahead of it, and their softmax
      // runs while P_j.V_j is still on the tensor cores. The last tile is
      // peeled off, so no branch separates a product from its wait.
      uint32_t pa[KT / 16][P][4];
      float part[P == 2 ? DP / 2 : 1];  // f32: P_j.V_j, added to acc once done
      const auto step = [&](int j, auto more) {  // more: std::bool_constant
        pack_p<P, KT>(pa, s);
#pragma unroll
        for (int x = 0; x < DP / 8; ++x) {
          acc[4 * x] *= a[0];
          acc[4 * x + 1] *= a[0];
          acc[4 * x + 2] *= a[1];
          acc[4 * x + 3] *= a[1];
        }
        if constexpr (decltype(more)::value) {
          hopper::mbar_wait(full + 8 * ((it + 1) % L::stages), ((it + 1) / L::stages) & 1);
          if constexpr (L::split) split(0);  // K_j's planes are free: S_j is done
        }
        const uint32_t vb = kv_of(it) + L::boxes * L::kvbox;
        hopper::wgmma_fence();
        if constexpr (decltype(more)::value) {
          qk_products<P, DP, KT>(s, qa, kv_of(it + 1), L::qbox, L::kvbox, L::qplane,
                                 L::kvplane);
          hopper::wgmma_commit();
        }
        if constexpr (P == 2) {
          pv_products<P, DP, KT>(part, pa, vb, L::kvbox, L::kvplane, 0);
        } else {
          pv_products<P, DP, KT>(acc, pa, vb, L::kvbox, L::kvplane, 1);
        }
        hopper::wgmma_commit();
        if constexpr (decltype(more)::value) {
          hopper::wgmma_wait<1>();
          hopper::fence_regs<KT / 2>(s);
          softmax_tile<KT>(s, (j + 1) * KT, t, causal, pw, row0, cq, scale2, m, l, a);
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs<KT / 16 * P * 4>(&pa[0][0][0]);
        if constexpr (L::split) {
          hopper::fence_regs<DP / 2>(part);
#pragma unroll
          for (int x = 0; x < DP / 2; ++x) acc[x] += part[x];
          if constexpr (decltype(more)::value) {
            split(1);  // V_j's planes are free: both warpgroups' P_j.V_j are done
            if (lead) hopper::mbar_arrive(empty);
          }
        } else {
          hopper::fence_regs<DP / 2>(acc);
          if (lead) hopper::mbar_arrive(empty + 8 * (it % L::stages));
        }
        ++it;
      };
      for (int j = 0; j < w.nk - 1; ++j) step(j, std::true_type{});
      step(w.nk - 1, std::false_type{});
      // the item's Q is read (f32: and the planes, where the next one lands)
      if (lead) hopper::mbar_arrive(qempty + 8 * qb);

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row >= t) continue;
        const float inv = 1.f / l[half];
        T* out = o + (((size_t)w.bi * t + row) * h + head) * (size_t)d;
#pragma unroll
        for (int x = 0; x < DP / 8; ++x) {
          const int col = 8 * x + cq;
          if (col >= d) continue;
          const float x0 = acc[4 * x + 2 * half] * inv, x1 = acc[4 * x + 2 * half + 1] * inv;
          if constexpr (P == 1) {
            *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(x0, x1);
          } else {
            *reinterpret_cast<float2*>(out + col) = make_float2(x0, x1);
          }
        }
        if ((lane & 3) == 0)
          lse[((size_t)w.bi * h + head) * t + row] = m[half] * scale + logf(l[half]);
      }
    }
  }
}

// [b, t, heads, d] at p as a 4-D tensor map (innermost first: d, heads, t,
// b) read in boxes of 64 columns x `rows` positions of one head.
template <typename T>
int encode_heads(CUtensorMap* map, const void* p, int b, int t, int heads, int d, int rows) {
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)t, (cuuint64_t)b};
  const cuuint64_t strides[3] = {d * e, (cuuint64_t)heads * d * e, (cuuint64_t)t * heads * d * e};
  const cuuint32_t box[4] = {hopper::kBox, 1, (cuuint32_t)rows, 1};
  return hopper::encode(map, Planes<T>::value == 1, 4, p, dims, strides, box);
}

template <typename T, int DP>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int b, int t, int h,
        int h_kv, int d, int causal, float scale, cudaStream_t stream) {
  using L = FwdLayout<T, DP>;
  int sms = 0, err = hopper::bind_device(&sms);
  if (err) return err;
  CUtensorMap qmap, kmap, vmap;
  err = encode_heads<T>(&qmap, q, b, t, h, d, kRows);
  if (!err) err = encode_heads<T>(&kmap, k, b, t, h_kv, d, L::KT);
  if (!err) err = encode_heads<T>(&vmap, v, b, t, h_kv, d, L::KT);
  if (err) return err;
  // fold two query heads of a group into an item where the group splits
  // into pairs
  const int fold = (h / h_kv) % 2 == 0;
  const int span = fold ? kRows : 2 * kRows;
  const long long items = (long long)(fold ? h / 2 : h) * b * ((t + span - 1) / span);
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  const int grid = items < sms ? (int)items : sms;  // persistent: one block an SM
  return launch(fwd_kernel<T, DP>, dim3(grid), kThreads, (size_t)L::bytes, stream, qmap, kmap,
                vmap, static_cast<T*>(o), lse, b, t, h, h_kv, d, causal, fold, scale);
}

}  // namespace
}  // namespace flash

// Plain C entry point, bound with ctypes. q [b, t, h, d], k/v
// [b, t, h_kv, d], o like q (bf16 when `bf16`, else f32), lse [b, h, t] f32,
// all contiguous and 16-byte aligned; d a multiple of 16 up to 128. Launches
// on `stream` (PyTorch's current stream), allocates nothing, does not
// synchronise, and returns cudaGetLastError() (minus the driver's CUresult
// when a tensor map cannot be encoded).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int b, int t, int h, int h_kv, int d,
                         int causal, float scale, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 16 || d > 128 || h_kv <= 0 || h % h_kv) return (int)cudaErrorInvalidValue;
  if (d <= 64)
    return bf16 ? flash::fwd<__nv_bfloat16, 64>(q, k, v, o, lse, b, t, h, h_kv, d, causal, scale, s)
                : flash::fwd<float, 64>(q, k, v, o, lse, b, t, h, h_kv, d, causal, scale, s);
  return bf16 ? flash::fwd<__nv_bfloat16, 128>(q, k, v, o, lse, b, t, h, h_kv, d, causal, scale, s)
              : flash::fwd<float, 128>(q, k, v, o, lse, b, t, h, h_kv, d, causal, scale, s);
}
