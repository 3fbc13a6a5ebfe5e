// Flash-attention backward for Hopper (sm_90a): dq (K2), and dk with dv (K3).
//
// Replaces tf_operator_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (the Pallas TPU kernels launched by _bwd). Same
// functions: P is rebuilt from the forward's lse, p = exp(s - lse), never
// stored; dp = dO.v^T; ds = p (dp - delta) with delta = rowsum(dO * O) -
// dlse computed by the caller (the lse cotangent folds into delta as in
// _bwd); dq = scale ds.k, dk = scale ds^T.q, dv = p^T.dO, GQA-native (query
// head hi reads kv head hi / g, g = h / h_kv; dk and dv sum the group).
//
// Bound: operations. At the training shape (b 6, t 2048, h 16, h_kv 4,
// d 128, causal, bf16) dq does 1.55e11 flops (s, dp, dq) and dk/dv
// 2.06e11 (s, dp, dv, dk) on the live (lower) triangle: 0.156 ms and 0.208
// ms at the H100's 989 TFLOP/s bf16 dense peak, against ~0.05 ms of bytes
// each at 3.35 TB/s. So every product runs on wgmma, fed by TMA, and P and
// dS never leave registers. Both kernels follow flash_fwd.cu: persistent
// blocks take their work items heaviest causal first in snake order
// (item_index); the last warpgroup is the producer, whose first thread
// streams tiles with cp.async.bulk.tensor through a ring behind full and
// empty mbarriers, running ahead into the next item; the others are the
// consumers, 64 rows each. Tensor maps are 4-D over [b, t, heads, d] (no
// transpose copy), boxes 64 columns wide with the 128-byte swizzle; TMA's
// zero fill past t and past d pads ragged rows and the head dim (DP = 64 or
// 128), and the mask, not the zero fill, makes p exactly 0 at and past t
// and above the diagonal. lse and delta ([b, h, t] f32: a row is 4t bytes,
// which TMA cannot take for t % 4 != 0) come in by guarded loads.
//   - dq: 384 threads, one block an SM. An item is 128 query rows of one
//     (batch, kv head, query block): for an even group size two query
//     heads of the group x 64 positions, one head a consumer warpgroup,
//     sharing the causal diagonal; for odd g (MHA) one head x 128
//     positions. Q and dO land once an item (one buffer at d > 64, two
//     below); 64-key K and V tiles stream through a 4-stage ring (5 at
//     d <= 64). Per tile each consumer runs S = Q.K^T and dP = dO.V^T
//     (wgmma m64n64k16, both operands K-major), p = exp2(s scale log2(e) -
//     lse log2(e)), masked only on tiles that cross the diagonal or t, dS =
//     P (dP - delta) packed to bf16 A fragments in registers, and dQ += dS.K
//     (m64nDPk16, A from registers, K read MN-major). The next tile's S and
//     dP are issued with this tile's dS.K, and its dS is computed while dS.K
//     is on the tensor cores; the last tile is peeled off, so no branch
//     separates a product from its wait. dq = scale dQ is stored from
//     registers.
//   - dk/dv: an item is 128 keys of one (batch, kv head) at d > 64, 64 a
//     consumer warpgroup (384 threads, one block an SM, the consumers at 240
//     registers and the producer at 24); at d <= 64, 64 keys, one consumer
//     warpgroup and two blocks an SM. The item's K and V land once and
//     stay. The producer streams (query tile, head) pairs of Q and dO
//     through a 2-stage ring (3 at d <= 64): every head of the group at
//     every live query tile, from the diagonal down. Summing the group
//     inside the block makes each dk/dv row the work of one block: no
//     atomics, one write. Each consumer warp stages a pair's lse and delta
//     in shared memory, fetched a pair ahead. Per pair each consumer runs
//     S^T = K.Q^T and dP^T = V.dO^T (K-major), P^T while dP^T runs, then dV
//     += P^T.dO while dS^T = P^T (dP^T - delta) is computed, then dK +=
//     dS^T.Q (dO and Q read MN-major). dk = scale dK and dv = dV are stored
//     from registers. The next pair's S^T and dP^T are not issued ahead: a
//     thread holds dK's and dV's sums (64 + 64 f32 at d 128) beside S^T, dP^T
//     and two A fragments, and ptxas has no registers left to keep them in
//     flight.
//   - T = f32 runs the same walks, masks and descriptors on bf16 hi/lo
//     planes, each product hi.hi + hi.lo + lo.hi. Its planes take twice the
//     bytes, so it lands one stage and one Q buffer, and the consumers split
//     each landed f32 box in place into its hi and lo planes (the lo plane
//     8 KB after the hi one). Its products run one at a time, dQ's, dK's
//     and dV's into a fresh sum one 64-column box at a time, added to the
//     f32 sums on the CUDA cores (flash_common.cuh), and dk/dv reads P^T back
//     from its fragments. Its dk/dv items are 64 keys, one consumer
//     warpgroup a block, which keeps the registers it is launched with. So
//     the f32 check vouches for the bf16 kernels' walks, masks and
//     descriptors.
// Measured against variants of this source (tools/flash_bwd_variants.py,
// PERF.md): for dq 2 stages, two Q/dO buffers with 3 stages at d 128, no
// fold, a round-robin deal and each product waited for before the next
// was issued; for dk/dv 128-key items at d 64 and 64-key items at d 128,
// 4 stages, two K/V buffers, the next pair's scores issued behind dK, each
// product waited for before the next, and a round-robin deal.

#include <climits>
#include <type_traits>

#include "hopper.cuh"

namespace flash {
namespace {

using hopper::kRowBytes;

constexpr int kRows = 64;      // rows of a consumer warpgroup: queries (dq), keys (dk/dv)
constexpr int KT = 64;         // keys a tile (dq), queries a tile (dk/dv)
constexpr int kThreads = 384;  // dq: warpgroups 0, 1 the consumers; 2 the producer
constexpr bool kOverlap = true;  // the next products issued with this tile's last (bf16)

// At DP = 128 and at DP = 64 (bf16; f32 lands one buffer and one stage,
// and runs one dk/dv consumer warpgroup): dq's Q/dO buffers and ring
// stages; dk/dv's consumer warpgroups, 64 keys each (one: two blocks an
// SM), and ring stages.
constexpr int dq_qbufs(int dp) { return dp > 64 ? 1 : 2; }
constexpr int dq_stages(int dp) { return dp > 64 ? 4 : 5; }
constexpr int dkv_groups(int dp) { return dp > 64 ? 2 : 1; }
constexpr int dkv_stages(int dp) { return dp > 64 ? 2 : 3; }

// The bytes of one landed box of 64 rows x 64 columns of T: a bf16 box, or
// an f32 box, which the consumers split in place into a bf16 hi plane and,
// `lo` bytes on, its lo plane.
template <typename T>
struct Slot {
  static constexpr int bytes = kRows * hopper::kBox * (int)sizeof(T);
  static constexpr int lo = Planes<T>::value == 2 ? kRows * kRowBytes : 0;
};

// Shared memory of dq_kernel<T, DP> (byte offsets from a 1024-byte
// boundary): `qbufs` buffers of the item's Q, then dO, boxes
// ([warpgroup][box] each); the ring of stages, each a 64-key tile's K,
// then V, boxes; the mbarriers: full and empty a stage, full and empty a
// Q buffer.
template <typename T, int DP>
struct DqLayout {
  static constexpr bool split = Planes<T>::value == 2;
  static constexpr bool serial = split || !kOverlap;
  static constexpr int stages = split ? 1 : dq_stages(DP);
  static constexpr int qbufs = split ? 1 : dq_qbufs(DP);
  static constexpr int boxes = DP / hopper::kBox;  // boxes a row of Q, dO, K or V
  static constexpr int slot = Slot<T>::bytes, lo = Slot<T>::lo;
  static constexpr int qplane = 2 * boxes * slot;  // Q of both warpgroups
  static constexpr int qbuf = 2 * qplane;          // Q, then dO
  static constexpr int stage = 2 * boxes * slot;   // K, then V
  static constexpr int ring = qbufs * qbuf;
  static constexpr int bars = ring + stages * stage;
  static constexpr int bytes = bars + 2 * (stages + qbufs) * 8 + 1024;
};

// Shared memory of dkv_kernel<T, DP>: the item's K, then V, boxes
// ([warpgroup][box] each); the ring of stages, each a 64-query tile's Q,
// then dO, boxes; each consumer warp's two buffers of a pair's 64 lse (log2
// units), then 64 delta; the mbarriers: full and empty a stage, full and
// empty K/V. f32's sums and planes do not fit two consumer warpgroups'
// registers: its items are 64 keys, one consumer warpgroup a block, which
// keeps the registers it is launched with (up to 255).
template <typename T, int DP>
struct DkvLayout {
  static constexpr bool split = Planes<T>::value == 2;
  static constexpr bool serial = split || !kOverlap;
  static constexpr int groups = split ? 1 : dkv_groups(DP);
  static constexpr int threads = 128 * (groups + 1);
  static constexpr int per_sm = split ? 1 : 2 / groups;  // blocks an SM
  static constexpr bool rebalance = threads * per_sm > 256;  // setmaxnreg
  static constexpr int keys = groups * kRows;             // keys an item
  static constexpr int stages = split ? 1 : dkv_stages(DP);
  static constexpr int boxes = DP / hopper::kBox;
  static constexpr int slot = Slot<T>::bytes, lo = Slot<T>::lo;
  static constexpr int kvplane = groups * boxes * slot;  // K of the item's keys
  static constexpr int ring = 2 * kvplane;               // K, then V
  static constexpr int stage = 2 * boxes * slot;         // Q, then dO
  static constexpr int rows = ring + stages * stage;
  static constexpr int bars = rows + 4 * groups * 2 * (2 * KT * 4);
  static constexpr int bytes = bars + 2 * (stages + 1) * 8 + 1024;
};

// 2^x as the bare MUFU instruction (ex2.approx.ftz: a result below 2^-126
// flushes to 0), as in flash_fwd.cu.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of depth step kk (16 bf16) in K-major boxes `box` bytes
// apart: 32 bytes along the row, the next box every 4 steps.
__device__ __forceinline__ uint32_t k_step(int kk, int box) {
  return (kk >> 2) * box + (kk & 3) * 32;
}
// Byte offset of reduction step kk (16 rows) in MN-major boxes: 16 rows on.
__device__ __forceinline__ uint32_t mn_step(int kk) { return kk * 16 * kRowBytes; }
// The descriptor of the operand `bytes` (a multiple of 16) after the one of
// desc: shared addresses stay below 2^18, so the 14-bit address field takes
// the add without a carry. A product's descriptors are then one base and a
// constant each.
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// s = A.B^T for one warpgroup, 64 x 64 (wgmma m64n64k16): a the shared
// address of its 64 rows' A boxes, b the tile's 64 rows of B boxes, both
// K-major, `box` bytes from one box to the next; f32: the lo planes `lo`
// bytes on, the small cross terms first, then hi.hi, all into s.
template <int P, int DP>
__device__ __forceinline__ void score_products(float* s, uint32_t a, uint32_t b, int box, int lo) {
  using W = hopper::Wgmma<KT>;
  const uint64_t da = hopper::kmajor_desc(a), db = hopper::kmajor_desc(b);
  if constexpr (P == 2) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      W::template ss<0, 0>(s, desc_at(da, lo + k_step(kk, box)), desc_at(db, k_step(kk, box)),
                           kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      W::template ss<0, 0>(s, desc_at(da, k_step(kk, box)), desc_at(db, lo + k_step(kk, box)),
                           1);
  }
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    W::template ss<0, 0>(s, desc_at(da, k_step(kk, box)), desc_at(db, k_step(kk, box)),
                         P == 2 || kk > 0);
}

// acc (+)= A.B for one warpgroup, A a 64 x KT score-shaped tile in
// registers (pa: its A fragments per 16-deep step and plane), B KT x N at
// b, MN-major (a box row is one reduction index), the next 64 columns one
// box (`box` bytes) on; f32: hi.lo + lo.hi + hi.hi.
template <int P, int N>
__device__ __forceinline__ void mn_products(float* acc, uint32_t (*pa)[P][4], uint32_t b, int box,
                                            int lo, int accumulate) {
  using W = hopper::Wgmma<N>;
  const uint64_t db = hopper::sw128_desc(b, box, 1024);
  if constexpr (P == 2) {
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      W::template rs<1>(acc, pa[kk][1], desc_at(db, mn_step(kk)), accumulate || kk > 0);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      W::template rs<1>(acc, pa[kk][0], desc_at(db, lo + mn_step(kk)), 1);
  }
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    W::template rs<1>(acc, pa[kk][0], desc_at(db, mn_step(kk)), P == 2 || accumulate || kk > 0);
}

// acc += A.B as mn_products, DP columns, waited for: bf16 straight into
// acc; f32 into a fresh sum one 64-column box of B at a time, added to acc
// on the CUDA cores (the tensor cores' accumulation truncates: 1536 adds
// into one sum at t = 2048 drifted 3.4e-4 on an H100). The f32 boxes' loop
// is not unrolled: unrolled, ptxas holds both boxes' sums and spills.
template <int P, int DP>
__device__ __forceinline__ void add_products(float* acc, uint32_t (*pa)[P][4], uint32_t b,
                                             int box, int lo) {
  if constexpr (P == 2) {
#pragma unroll 1
    for (int bx = 0; bx < DP / hopper::kBox; ++bx) {
      float part[hopper::kBox / 2];
      hopper::wgmma_fence();
      mn_products<P, hopper::kBox>(part, pa, b + bx * box, box, lo, 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<hopper::kBox / 2>(part);
#pragma unroll
      for (int x = 0; x < hopper::kBox / 2; ++x) acc[bx * hopper::kBox / 2 + x] += part[x];
    }
  } else {
    hopper::wgmma_fence();
    mn_products<P, DP>(acc, pa, b, box, lo, 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<DP / 2>(acc);
  }
  hopper::fence_regs<KT / 16 * P * 4>(&pa[0][0][0]);
}

// A score-shaped tile s (s[4n + e]: row g (e < 2) or g + 8, column 8n + 2
// (lane % 4) + (e & 1)) as the A fragments of a product over its columns,
// per 16-deep step and plane: the fragment of step n / 2 takes a0, a1 from
// its first 8 columns and a2, a3 from the next 8 (mma.m16n8k16's A
// layout); bf16, or split into hi and lo.
template <int P>
__device__ __forceinline__ void pack_a(uint32_t (*pa)[P][4], const float* s) {
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

__device__ __forceinline__ float2 bf16x2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// f32 boxes [boxes][64 rows][64] as TMA lands them at p, split in place
// into bf16 hi and lo planes laid out as TMA lays bf16 boxes (128-byte
// swizzle: chunk c of row r at chunk c ^ (r % 8)), box j's hi plane at
// j * 16 KB and its lo plane 8 KB on. Run by the THREADS consumer threads
// (named barrier 1), u the caller's index among them; each reads its
// chunks of a box before any thread writes that box (a loop not unrolled,
// which would hold every box's chunks at once). The caller fences and
// syncs before the planes are read.
template <int THREADS>
__device__ __forceinline__ void split_in_place(unsigned char* p, int boxes, int u) {
  constexpr int per = kRows * 8 / THREADS;  // 16-byte bf16 chunks a thread, a box
#pragma unroll 1
  for (int j = 0; j < boxes; ++j) {
    unsigned char* box = p + j * Slot<float>::bytes;
    float4 x[per][2];
#pragma unroll
    for (int i = 0; i < per; ++i) {
      const int q = u + i * THREADS, r = q >> 3, c = q & 7;
      const float4* s = reinterpret_cast<const float4*>(box + (r * hopper::kBox + c * 8) * 4);
      x[i][0] = s[0];
      x[i][1] = s[1];
    }
    hopper::bar_sync(1, THREADS);
#pragma unroll
    for (int i = 0; i < per; ++i) {
      const int q = u + i * THREADS, r = q >> 3, c = q & 7;
      uint4 h, l;
      split_pack(x[i][0].x, x[i][0].y, h.x, l.x);
      split_pack(x[i][0].z, x[i][0].w, h.y, l.y);
      split_pack(x[i][1].x, x[i][1].y, h.z, l.z);
      split_pack(x[i][1].z, x[i][1].w, h.w, l.w);
      const int off = r * kRowBytes + ((c ^ (r & 7)) << 4);
      *reinterpret_cast<uint4*>(box + off) = h;
      *reinterpret_cast<uint4*>(box + Slot<float>::lo + off) = l;
    }
  }
}

// dS of one dq warpgroup's tile of keys k0.. in s, from its raw scores s
// and dP in dp (s[4n + e]: query row0 (e < 2) or row0 + 8, key k0 + 8n + cq
// + (e & 1)); lse2 the rows' lse in log2 units, dl their delta. p is
// exactly 0 where the key is at or past t or, causal, past the row; only
// tiles that cross t or the diagonal are masked.
__device__ __forceinline__ void dq_ds(float* s, const float* dp, int k0, int t, int causal,
                                      int pw, int row0, int cq, float scale2,
                                      const float (&lse2)[2], const float (&dl)[2]) {
#pragma unroll
  for (int n = 0; n < KT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * n + e] = ex2(fmaf(s[4 * n + e], scale2, -lse2[e >> 1]));
  const bool edge = k0 + KT > t || (causal && k0 + KT - 1 > pw);
  if (edge) {
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * n + cq + (e & 1);
        const int row = e < 2 ? row0 : row0 + 8;
        if (col >= t || (causal && col > row)) s[4 * n + e] = 0.f;
      }
    }
  }
#pragma unroll
  for (int n = 0; n < KT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * n + e] *= dp[4 * n + e] - dl[e >> 1];
}

// P^T of one dk/dv warpgroup's keys against the query tile q0.. in s, from
// its raw scores S^T (s[4n + e]: key row0 (e < 2) or row0 + 8, query q0 +
// 8n + cq + (e & 1)); lse2 the tile's 64 lse in log2 units. Exactly 0 where
// the query or the key is at or past t or, causal, the key is past the
// query; only tiles that cross t or the diagonal are masked.
__device__ __forceinline__ void dkv_p(float* s, int q0, int t, int causal, int kw, int row0,
                                      int cq, float scale2, const float* lse2) {
#pragma unroll
  for (int n = 0; n < KT / 8; ++n) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * n + cq);
    s[4 * n] = ex2(fmaf(s[4 * n], scale2, -l.x));
    s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], scale2, -l.y));
    s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], scale2, -l.x));
    s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], scale2, -l.y));
  }
  const bool edge = q0 + KT > t || kw + kRows > t || (causal && kw + kRows - 1 > q0);
  if (edge) {
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = q0 + 8 * n + cq + (e & 1);
        const int key = e < 2 ? row0 : row0 + 8;
        if (col >= t || key >= t || (causal && key > col)) s[4 * n + e] = 0.f;
      }
    }
  }
}

// dS^T = P^T (dP^T - delta) in dp, P^T in s, delta the tile's 64 delta.
__device__ __forceinline__ void dkv_ds(float* dp, const float* s, const float* delta, int cq) {
#pragma unroll
  for (int n = 0; n < KT / 8; ++n) {
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * n + cq);
    dp[4 * n] = s[4 * n] * (dp[4 * n] - dl.x);
    dp[4 * n + 1] = s[4 * n + 1] * (dp[4 * n + 1] - dl.y);
    dp[4 * n + 2] = s[4 * n + 2] * (dp[4 * n + 2] - dl.x);
    dp[4 * n + 3] = s[4 * n + 3] * (dp[4 * n + 3] - dl.y);
  }
}

// The same with P^T read back from its packed fragments pa (hi + lo for
// f32), which then take dS^T in its place.
template <int P>
__device__ __forceinline__ void dkv_ds_packed(uint32_t (*pa)[P][4], const float* dp,
                                              const float* delta, int cq) {
#pragma unroll
  for (int n = 0; n < KT / 8; ++n) {
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * n + cq);
    uint32_t* a = pa[n >> 1][0] + 2 * (n & 1);
    uint32_t* b = pa[n >> 1][P - 1] + 2 * (n & 1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2 p = bf16x2(a[r]);
      if constexpr (P == 2) {
        const float2 l = bf16x2(b[r]);
        p.x += l.x;
        p.y += l.y;
      }
      const float x0 = p.x * (dp[4 * n + 2 * r] - dl.x), x1 = p.y * (dp[4 * n + 2 * r + 1] - dl.y);
      if constexpr (P == 1) {
        a[r] = pack_bf16(x0, x1);
      } else {
        split_pack(x0, x1, a[r], b[r]);
      }
    }
  }
}

// The blocks' work items: block p of G takes the p-th item of each round
// of G in even rounds and the (G-1-p)-th in odd ones, so the blocks that
// took the heavier items of one round take the lighter ones of the next.
__device__ __forceinline__ int item_index(int round, int p, int G) {
  return round * G + ((round & 1) ? G - 1 - p : p);
}

// dq's item i: query block nqb - 1 - i / (units * b) (the heaviest causal
// blocks first) of unit (i % (units * b)) % units (a head pair, or a head)
// of batch (i % (units * b)) / units; nk key tiles reach it.
struct DqItem {
  int bi, h0, hk, p0, nk;
};
__device__ __forceinline__ DqItem dq_item(int i, int units, int b, int nqb, int span, int t,
                                          int h, int h_kv, int fold, int causal) {
  const int per = units * b, r = i % per;
  DqItem w;
  w.bi = r / units;
  w.h0 = fold ? 2 * (r % units) : r % units;
  w.hk = w.h0 / (h / h_kv);
  w.p0 = (nqb - 1 - i / per) * span;
  const int last = min(w.p0 + span, t) - 1;  // the item's last live position
  w.nk = causal ? last / KT + 1 : (t + KT - 1) / KT;
  return w;
}

// dk/dv's item i: the keys k0.. of key block i / (h_kv b) (the lowest, with
// the most live query tiles, first) of kv head (i % (h_kv b)) % h_kv of
// batch (i % (h_kv b)) / h_kv; its pairs are the query tiles from qfirst
// on, each with every head of the group (pair p: tile qfirst + p / g,
// head hk g + p % g).
struct DkvItem {
  int bi, hk, k0, qfirst, pairs;
};
__device__ __forceinline__ DkvItem dkv_item(int i, int b, int t, int h_kv, int g, int causal,
                                            int keys) {
  const int per = h_kv * b, r = i % per;
  DkvItem w;
  w.bi = r / h_kv;
  w.hk = r % h_kv;
  w.k0 = (i / per) * keys;
  w.qfirst = causal ? w.k0 / KT : 0;
  w.pairs = ((t + KT - 1) / KT - w.qfirst) * g;
  return w;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
          const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
          int b, int t, int h, int h_kv, int d, int causal, int fold, float scale) {
  using L = DqLayout<T, DP>;
  constexpr int P = Planes<T>::value;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + L::bars, empty = full + 8 * L::stages;
  const uint32_t qfull = empty + 8 * L::stages, qempty = qfull + 8 * L::qbufs;

  const int span = fold ? kRows : 2 * kRows;  // positions an item covers
  const int units = fold ? h / 2 : h;
  const int nqb = (t + span - 1) / span, items = units * b * nqb;
  const auto item = [&](int i) {
    return dq_item(i, units, b, nqb, span, t, h, h_kv, fold, causal);
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
      int it = 0;  // tiles issued, over all items
      for (int n = 0, i = blockIdx.x; i < items; i = item_index(++n, blockIdx.x, gridDim.x)) {
        const DqItem w = item(i);
        const int qb = n % L::qbufs;
        hopper::mbar_wait(qempty + 8 * qb, ((n / L::qbufs) & 1) ^ 1);
        const uint32_t qdst = base + qb * L::qbuf, qbar = qfull + 8 * qb;
        hopper::mbar_expect(qbar, 2 * L::qplane);
        for (int wg = 0; wg < 2; ++wg) {
          const int head = w.h0 + (fold ? wg : 0), pos = w.p0 + (fold ? 0 : wg * kRows);
          for (int bx = 0; bx < L::boxes; ++bx) {
            const uint32_t dst = qdst + (wg * L::boxes + bx) * L::slot;
            hopper::tma_box_4d(dst, qmap, qbar, bx * hopper::kBox, head, pos, w.bi);
            hopper::tma_box_4d(dst + L::qplane, omap, qbar, bx * hopper::kBox, head, pos, w.bi);
          }
        }
        for (int j = 0; j < w.nk; ++j, ++it) {
          const int st = it % L::stages;
          hopper::mbar_wait(empty + 8 * st, ((it / L::stages) & 1) ^ 1);
          const uint32_t bar = full + 8 * st, dst = base + L::ring + st * L::stage;
          hopper::mbar_expect(bar, L::stage);
          for (int bx = 0; bx < L::boxes; ++bx) {
            hopper::tma_box_4d(dst + bx * L::slot, kmap, bar, bx * hopper::kBox, w.hk, j * KT,
                               w.bi);
            hopper::tma_box_4d(dst + (L::boxes + bx) * L::slot, vmap, bar, bx * hopper::kBox,
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
    const auto kv_of = [&](int it) { return base + L::ring + (it % L::stages) * L::stage; };
    // f32: boxes landed at smem + off split in place by both warpgroups
    const auto split = [&](int off, int boxes) {
      split_in_place<256>(smem + off, boxes, threadIdx.x);
      hopper::fence_async_smem();
      hopper::bar_sync(1, 256);
    };

    int it = 0;  // tiles consumed, over all items
    for (int n = 0, i = blockIdx.x; i < items; i = item_index(++n, blockIdx.x, gridDim.x)) {
      const DqItem w = item(i);
      const int head = w.h0 + (fold ? wg : 0);
      const int pw = w.p0 + (fold ? 0 : wg * kRows);         // the warpgroup's first position
      const int row0 = pw + 16 * (warp & 3) + (lane >> 2);  // this thread's rows: row0, row0 + 8
      float lse2[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const size_t at = ((size_t)w.bi * h + head) * t + row;
        lse2[r] = row < t ? lse[at] * kLog2e : 0.f;
        dl[r] = row < t ? delta[at] : 0.f;
      }
      const int qb = n % L::qbufs;
      hopper::mbar_wait(qfull + 8 * qb, (n / L::qbufs) & 1);
      if constexpr (L::split) split(0, 4 * L::boxes);
      const uint32_t qa = base + qb * L::qbuf + wg * L::boxes * L::slot, da = qa + L::qplane;
      // S = Q.K^T and dP = dO.V^T of the tile whose K boxes are at kv
      float s[KT / 2], dp[KT / 2];
      const auto scores = [&](uint32_t kv) {
        score_products<P, DP>(s, qa, kv, L::slot, L::lo);
        score_products<P, DP>(dp, da, kv + L::boxes * L::slot, L::slot, L::lo);
      };
      const auto ds = [&](int j) {
        dq_ds(s, dp, j * KT, t, causal, pw, row0, cq, scale2, lse2, dl);
      };

      float acc[DP / 2];
#pragma unroll
      for (int x = 0; x < DP / 2; ++x) acc[x] = 0.f;

      // tile 0's dS
      hopper::mbar_wait(full + 8 * (it % L::stages), (it / L::stages) & 1);
      if constexpr (L::split) split(L::ring, 2 * L::boxes);
      hopper::wgmma_fence();
      scores(kv_of(it));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs<KT / 2>(s);
      hopper::fence_regs<KT / 2>(dp);
      ds(0);

      // dQ += dS_j.K_j; with `more`, tile j + 1's S and dP are issued ahead
      // of it and its dS computed while dS_j.K_j is on the tensor cores (f32,
      // or without kOverlap: after it). The last tile is peeled off, so no
      // branch separates a product from its wait.
      uint32_t pa[KT / 16][P][4];
      const auto step = [&](int j, auto more) {  // more: std::bool_constant
        pack_a<P>(pa, s);
        const uint32_t kb = kv_of(it);
        if constexpr (L::serial) {
          add_products<P, DP>(acc, pa, kb, L::slot, L::lo);
          if (lead) hopper::mbar_arrive(empty + 8 * (it % L::stages));
          if constexpr (decltype(more)::value) {
            hopper::mbar_wait(full + 8 * ((it + 1) % L::stages), ((it + 1) / L::stages) & 1);
            if constexpr (L::split) split(L::ring, 2 * L::boxes);
            hopper::wgmma_fence();
            scores(kv_of(it + 1));
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs<KT / 2>(s);
            hopper::fence_regs<KT / 2>(dp);
            ds(j + 1);
          }
        } else {
          if constexpr (decltype(more)::value)
            hopper::mbar_wait(full + 8 * ((it + 1) % L::stages), ((it + 1) / L::stages) & 1);
          hopper::wgmma_fence();
          if constexpr (decltype(more)::value) {
            scores(kv_of(it + 1));
            hopper::wgmma_commit();
          }
          mn_products<P, DP>(acc, pa, kb, L::slot, L::lo, 1);
          hopper::wgmma_commit();
          if constexpr (decltype(more)::value) {
            hopper::wgmma_wait<1>();
            hopper::fence_regs<KT / 2>(s);
            hopper::fence_regs<KT / 2>(dp);
            ds(j + 1);
          }
          hopper::wgmma_wait<0>();
          hopper::fence_regs<KT / 16 * P * 4>(&pa[0][0][0]);
          hopper::fence_regs<DP / 2>(acc);
          if (lead) hopper::mbar_arrive(empty + 8 * (it % L::stages));
        }
        ++it;
      };
      for (int j = 0; j < w.nk - 1; ++j) step(j, std::true_type{});
      step(w.nk - 1, std::false_type{});
      if (lead) hopper::mbar_arrive(qempty + 8 * qb);  // the item's Q and dO are read

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row >= t) continue;
        T* out = dq + (((size_t)w.bi * t + row) * h + head) * (size_t)d;
#pragma unroll
        for (int x = 0; x < DP / 8; ++x) {
          const int col = 8 * x + cq;
          if (col >= d) continue;
          const float x0 = acc[4 * x + 2 * half] * scale, x1 = acc[4 * x + 2 * half + 1] * scale;
          if constexpr (P == 1) {
            *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(x0, x1);
          } else {
            *reinterpret_cast<float2*>(out + col) = make_float2(x0, x1);
          }
        }
      }
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(DkvLayout<T, DP>::threads, DkvLayout<T, DP>::per_sm)
dkv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
           const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
           T* __restrict__ dv, int b, int t, int h, int h_kv, int d, int causal, float scale) {
  using L = DkvLayout<T, DP>;
  constexpr int P = Planes<T>::value, NC = L::groups, kConsumers = 128 * NC;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + L::bars, empty = full + 8 * L::stages;
  const uint32_t kvfull = empty + 8 * L::stages, kvempty = kvfull + 8;

  const int g = h / h_kv;
  const int items = h_kv * b * ((t + L::keys - 1) / L::keys);
  const auto item = [&](int i) { return dkv_item(i, b, t, h_kv, g, causal, L::keys); };

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::stages; ++i) {
      hopper::mbar_init(full + 8 * i, 1);
      hopper::mbar_init(empty + 8 * i, NC);
    }
    hopper::mbar_init(kvfull, 1);
    hopper::mbar_init(kvempty, NC);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread issues every copy
    if constexpr (L::rebalance) hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers) {
      int it = 0;  // pairs issued, over all items
      for (int n = 0, i = blockIdx.x; i < items; i = item_index(++n, blockIdx.x, gridDim.x)) {
        const DkvItem w = item(i);
        hopper::mbar_wait(kvempty, (n & 1) ^ 1);
        hopper::mbar_expect(kvfull, L::ring);
        for (int kg = 0; kg < NC; ++kg)
          for (int bx = 0; bx < L::boxes; ++bx) {
            const uint32_t dst = base + (kg * L::boxes + bx) * L::slot;
            hopper::tma_box_4d(dst, kmap, kvfull, bx * hopper::kBox, w.hk, w.k0 + kg * kRows,
                               w.bi);
            hopper::tma_box_4d(dst + L::kvplane, vmap, kvfull, bx * hopper::kBox, w.hk,
                               w.k0 + kg * kRows, w.bi);
          }
        for (int p = 0; p < w.pairs; ++p, ++it) {
          const int st = it % L::stages;
          const int q0 = (w.qfirst + p / g) * KT, head = w.hk * g + p % g;
          hopper::mbar_wait(empty + 8 * st, ((it / L::stages) & 1) ^ 1);
          const uint32_t bar = full + 8 * st, dst = base + L::ring + st * L::stage;
          hopper::mbar_expect(bar, L::stage);
          for (int bx = 0; bx < L::boxes; ++bx) {
            hopper::tma_box_4d(dst + bx * L::slot, qmap, bar, bx * hopper::kBox, head, q0, w.bi);
            hopper::tma_box_4d(dst + (L::boxes + bx) * L::slot, omap, bar, bx * hopper::kBox,
                               head, q0, w.bi);
          }
        }
      }
    }
  } else {
    // the consumers: warpgroup wg owns 64 keys of each item
    if constexpr (L::rebalance) hopper::setmaxnreg_inc<NC == 2 ? 240 : 232>();
    const int warp = threadIdx.x >> 5, wg = warp >> 2, lane = threadIdx.x & 31;
    const bool lead = (threadIdx.x & 127) == 0;
    const int cq = 2 * (lane & 3);
    const float scale2 = scale * kLog2e;
    const auto split = [&](int off, int boxes) {
      split_in_place<kConsumers>(smem + off, boxes, threadIdx.x);
      hopper::fence_async_smem();
      hopper::bar_sync(1, kConsumers);
    };
    uint32_t pa[KT / 16][P][4];

    int it = 0;  // pairs consumed, over all items
    for (int n = 0, i = blockIdx.x; i < items; i = item_index(++n, blockIdx.x, gridDim.x)) {
      const DkvItem w = item(i);
      const int kw = w.k0 + wg * kRows;                     // the warpgroup's first key
      const int row0 = kw + 16 * (warp & 3) + (lane >> 2);  // this thread's keys: row0, row0 + 8
      hopper::mbar_wait(kvfull, n & 1);
      if constexpr (L::split) split(0, 2 * NC * L::boxes);
      const uint32_t ka = base + wg * L::boxes * L::slot, va = ka + L::kvplane;

      // pair p's lse (log2 units) and delta of query q0 + lane and + 32,
      // fetched a pair ahead and staged in this warp's buffer p % 2
      float ld[4];
      const auto fetch = [&](int p) {
        const int q0 = (w.qfirst + p / g) * KT, head = w.hk * g + p % g;
        const size_t at = ((size_t)w.bi * h + head) * t + q0;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int c = lane + 32 * r;
          ld[r] = q0 + c < t ? lse[at + c] * kLog2e : 0.f;
          ld[2 + r] = q0 + c < t ? delta[at + c] : 0.f;
        }
      };
      const auto stage_rows = [&](int p) {
        float* rows = reinterpret_cast<float*>(smem + L::rows) + (2 * warp + (p & 1)) * 2 * KT;
        __syncwarp();
#pragma unroll
        for (int r = 0; r < 4; ++r) rows[lane + 32 * r] = ld[r];
        __syncwarp();
        if (p + 1 < w.pairs) fetch(p + 1);
        return rows;
      };
      const auto q0_of = [&](int p) { return (w.qfirst + p / g) * KT; };
      const auto stage_of = [&](int it) { return base + L::ring + (it % L::stages) * L::stage; };
      fetch(0);

      float dka[DP / 2], dva[DP / 2];
#pragma unroll
      for (int x = 0; x < DP / 2; ++x) dka[x] = dva[x] = 0.f;
      float s[KT / 2], dp[KT / 2];
      for (int p = 0; p < w.pairs; ++p, ++it) {
        const float* rows = stage_rows(p);
        hopper::mbar_wait(full + 8 * (it % L::stages), (it / L::stages) & 1);
        if constexpr (L::split) split(L::ring, 2 * L::boxes);
        const uint32_t qa = stage_of(it), oa = qa + L::boxes * L::slot;
        if constexpr (L::serial) {
          // S^T, P^T, dV; then dP^T, dS^T, dK, one product at a time
          hopper::wgmma_fence();
          score_products<P, DP>(s, ka, qa, L::slot, L::lo);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs<KT / 2>(s);
          dkv_p(s, q0_of(p), t, causal, kw, row0, cq, scale2, rows);
          pack_a<P>(pa, s);
          add_products<P, DP>(dva, pa, oa, L::slot, L::lo);
          hopper::wgmma_fence();
          score_products<P, DP>(dp, va, oa, L::slot, L::lo);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs<KT / 2>(dp);
          dkv_ds_packed<P>(pa, dp, rows + KT, cq);
          add_products<P, DP>(dka, pa, qa, L::slot, L::lo);
        } else {
          // S^T and dP^T; P^T while dP^T runs; dV += P^T.dO while dS^T is
          // computed; dK += dS^T.Q. The next pair's S^T and dP^T are not
          // issued behind dK: at d 128 their 64 sums in flight beside dK's
          // and dV's leave ptxas too few registers, and it serialises every
          // wgmma (PERF.md, PR 9).
          uint32_t pb[KT / 16][P][4];
          hopper::wgmma_fence();
          score_products<P, DP>(s, ka, qa, L::slot, L::lo);
          hopper::wgmma_commit();
          score_products<P, DP>(dp, va, oa, L::slot, L::lo);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();
          hopper::fence_regs<KT / 2>(s);
          dkv_p(s, q0_of(p), t, causal, kw, row0, cq, scale2, rows);
          pack_a<P>(pa, s);
          hopper::wgmma_fence();
          mn_products<P, DP>(dva, pa, oa, L::slot, L::lo, 1);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();
          hopper::fence_regs<KT / 2>(dp);
          dkv_ds(dp, s, rows + KT, cq);
          pack_a<P>(pb, dp);
          hopper::wgmma_fence();
          mn_products<P, DP>(dka, pb, qa, L::slot, L::lo, 1);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs<KT / 16 * P * 4>(&pa[0][0][0]);
          hopper::fence_regs<KT / 16 * P * 4>(&pb[0][0][0]);
          hopper::fence_regs<DP / 2>(dka);
          hopper::fence_regs<DP / 2>(dva);
        }
        if (lead) hopper::mbar_arrive(empty + 8 * (it % L::stages));
      }
      if (lead) hopper::mbar_arrive(kvempty);  // the item's K and V are read

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row >= t) continue;
        const size_t at = (((size_t)w.bi * t + row) * h_kv + w.hk) * (size_t)d;
#pragma unroll
        for (int x = 0; x < DP / 8; ++x) {
          const int col = 8 * x + cq;
          if (col >= d) continue;
          const int e = 4 * x + 2 * half;
          if constexpr (P == 1) {
            *reinterpret_cast<__nv_bfloat162*>(dk + at + col) =
                __floats2bfloat162_rn(dka[e] * scale, dka[e + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
                __floats2bfloat162_rn(dva[e], dva[e + 1]);
          } else {
            *reinterpret_cast<float2*>(dk + at + col) =
                make_float2(dka[e] * scale, dka[e + 1] * scale);
            *reinterpret_cast<float2*>(dv + at + col) = make_float2(dva[e], dva[e + 1]);
          }
        }
      }
    }
  }
}

// [b, t, heads, d] at p as a 4-D tensor map (innermost first: d, heads, t,
// b) read in boxes of 64 columns x 64 positions of one head.
template <typename T>
int encode_heads(CUtensorMap* map, const void* p, int b, int t, int heads, int d) {
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)t, (cuuint64_t)b};
  const cuuint64_t strides[3] = {d * e, (cuuint64_t)heads * d * e, (cuuint64_t)t * heads * d * e};
  const cuuint32_t box[4] = {hopper::kBox, 1, (cuuint32_t)kRows, 1};
  return hopper::encode(map, Planes<T>::value == 1, 4, p, dims, strides, box);
}

// The four tensor maps of a backward launch, on the current device (whose
// SM count lands in sms).
template <typename T>
int encode_all(CUtensorMap (&maps)[4], int* sms, const void* q, const void* k, const void* v,
               const void* dout, int b, int t, int h, int h_kv, int d) {
  int err = hopper::bind_device(sms);
  if (!err) err = encode_heads<T>(&maps[0], q, b, t, h, d);
  if (!err) err = encode_heads<T>(&maps[1], k, b, t, h_kv, d);
  if (!err) err = encode_heads<T>(&maps[2], v, b, t, h_kv, d);
  if (!err) err = encode_heads<T>(&maps[3], dout, b, t, h, d);
  return err;
}

template <typename T, int DP>
int dq_launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dqo, int b, int t, int h, int h_kv, int d, int causal,
              float scale, cudaStream_t stream) {
  CUtensorMap maps[4];
  int sms = 0;
  const int err = encode_all<T>(maps, &sms, q, k, v, dout, b, t, h, h_kv, d);
  if (err) return err;
  // fold two query heads of a group into an item where the group splits
  // into pairs
  const int fold = (h / h_kv) % 2 == 0;
  const int span = fold ? kRows : 2 * kRows;
  const long long items = (long long)(fold ? h / 2 : h) * b * ((t + span - 1) / span);
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  const int grid = items < sms ? (int)items : sms;  // persistent: one block an SM
  return launch(dq_kernel<T, DP>, dim3(grid), kThreads, (size_t)DqLayout<T, DP>::bytes, stream,
                maps[0], maps[1], maps[2], maps[3], lse, delta, static_cast<T*>(dqo), b, t, h,
                h_kv, d, causal, fold, scale);
}

template <typename T, int DP>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dko, void* dvo, int b, int t, int h, int h_kv, int d,
               int causal, float scale, cudaStream_t stream) {
  using L = DkvLayout<T, DP>;
  CUtensorMap maps[4];
  int sms = 0;
  const int err = encode_all<T>(maps, &sms, q, k, v, dout, b, t, h, h_kv, d);
  if (err) return err;
  const long long items = (long long)h_kv * b * ((t + L::keys - 1) / L::keys);
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long slots = (long long)sms * L::per_sm;  // persistent
  const int grid = (int)(items < slots ? items : slots);
  return launch(dkv_kernel<T, DP>, dim3(grid), L::threads, (size_t)L::bytes, stream, maps[0],
                maps[1], maps[2], maps[3], lse, delta, static_cast<T*>(dko),
                static_cast<T*>(dvo), b, t, h, h_kv, d, causal, scale);
}

}  // namespace
}  // namespace flash

// Plain C entry points, bound with ctypes. q, dout, dq [b, t, h, d];
// k, v, dk, dv [b, t, h_kv, d] (bf16 when `bf16`, else f32); lse, delta
// [b, h, t] f32; all contiguous and 16-byte aligned; d a multiple of 16 up
// to 128. Each launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (minus the driver's CUresult
// when a tensor map cannot be encoded).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse, const float* delta,
                            void* dq, int b, int t, int h, int h_kv, int d,
                            int causal, float scale, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 16 || d > 128 || h_kv <= 0 || h % h_kv) return (int)cudaErrorInvalidValue;
  if (d <= 64)
    return bf16 ? flash::dq_launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, b, t, h,
                                                      h_kv, d, causal, scale, s)
                : flash::dq_launch<float, 64>(q, k, v, dout, lse, delta, dq, b, t, h, h_kv, d,
                                              causal, scale, s);
  return bf16 ? flash::dq_launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, b, t, h,
                                                     h_kv, d, causal, scale, s)
              : flash::dq_launch<float, 128>(q, k, v, dout, lse, delta, dq, b, t, h, h_kv, d,
                                             causal, scale, s);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse, const float* delta,
                             void* dk, void* dv, int b, int t, int h, int h_kv, int d,
                             int causal, float scale, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 16 || d > 128 || h_kv <= 0 || h % h_kv) return (int)cudaErrorInvalidValue;
  if (d <= 64)
    return bf16 ? flash::dkv_launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, b, t,
                                                       h, h_kv, d, causal, scale, s)
                : flash::dkv_launch<float, 64>(q, k, v, dout, lse, delta, dk, dv, b, t, h, h_kv,
                                               d, causal, scale, s);
  return bf16 ? flash::dkv_launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, b, t, h,
                                                      h_kv, d, causal, scale, s)
              : flash::dkv_launch<float, 128>(q, k, v, dout, lse, delta, dk, dv, b, t, h, h_kv,
                                              d, causal, scale, s);
}
