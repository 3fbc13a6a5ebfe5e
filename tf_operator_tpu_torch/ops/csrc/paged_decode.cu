// Paged decode attention for Hopper (sm_90a), f32: K4.
//
// Replaces tf_operator_tpu/ops/flash_attention.py::_decode_kernel (the
// Pallas TPU kernel launched by _decode_call). Same function: one query
// token per sequence attends over that sequence's K/V, which lives in
// fixed-size pages of a pool [n_pages, page, h_kv, d] named by a page
// table [s, p] (int32, any row stride, 0 included) with seq_lens [s]
// (int32) valid positions. Positions >= seq_len are masked; a row with
// seq_len == 0 comes out exactly zero.
//
// Bound: device-memory bytes. Every live K/V element is read once and
// used for g multiply-adds per side (g = h / h_kv, 4 for gqa-2048), far
// below what the tensor cores need, so the products stay f32 on the CUDA
// cores and the floor is the live K/V bytes over 3.35 TB/s. A decode
// step's few (sequence, kv head) walks cannot fill 132 SMs, and each walk
// is a chain of dependent page loads, so the design splits the walks and
// keeps loads in flight (flash-decoding):
//   - split_kernel: one block per (sequence, kv head, split). The host
//     picks the number of splits from the shapes alone (batch, kv heads,
//     table width: flash_attention.py decode_splits), never from seq_lens,
//     which live on the card. Each block reads its own seq_len and page
//     ids (the TPU kernel's scalar prefetch) and takes split j's
//     contiguous run of the LIVE pages, ceil(n_live / splits) of them;
//     splits that start past the live prefix exit at once.
//   - A block streams its pages through a ring of kStages stages with
//     cp.async (16-byte copies, neighbouring threads on neighbouring d),
//     kStages - 1 pages in flight while one is computed, one
//     __syncthreads a page.
//   - The g query rows of the GQA group, pre-scaled by d^-1/2 log2(e),
//     sit in registers (lane j holds d-elements 4j..4j+3), so each K/V
//     page is read from device memory once for the whole group. Each warp
//     takes every 4th token of a page and keeps its own online softmax
//     (max, sum, output) per row in registers; the four warps' states are
//     merged at the end of the run, and the block writes one partial
//     (max, sum, unnormalised output) per query row.
//   - merge_kernel, launched right after on the same stream, merges a
//     row's partials in split order with the log-sum-exp rescale: no
//     atomics, so the result does not change from run to run.
//
// Padded table entries past the live prefix are real page ids (the engine
// pads with trash_page - 1) and freed pages are reused without clearing:
// correctness rests on never reading past ceil(seq_len / page) pages and
// on the in-page mask, applied before a score reaches the running max.

#include "hopper.cuh"

namespace {

using flash::kLog2e;
using flash::kNegInf;
using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;                  // ring stages (pages) of a block
// Limits the Python wrapper checks before launching (keep in step with
// tf_operator_tpu_torch/ops/flash_attention.py): d % 4 == 0 and d <= 128
// (one float4 of d a lane), page <= 32 (8 tokens a warp), g <= 8.
constexpr int kMaxD = 128;
constexpr int kMaxPage = 32;
constexpr int kMaxTok = kMaxPage / kWarps;  // tokens of a page one warp takes
constexpr int kMaxSplits = 65535;           // gridDim.z

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Live pages of a sequence of len positions: never more than the table holds.
__device__ __forceinline__ int live_pages(int len, int page, int max_pages) {
  const int n = len > 0 ? (len + page - 1) / page : 0;
  return n < max_pages ? n : max_pages;
}

// Split j of a row takes pages [j * run, min((j + 1) * run, n_live)).
__device__ __forceinline__ int split_run(int n_live, int splits) {
  return (n_live + splits - 1) / splits;
}

// One (sequence, kv head, split): the split's (max, sum, unnormalised
// output) of each of the group's G >= g query rows, scores in log2 units.
// part_ml [s, h, splits, 2], part_o [s, h, splits, d].
template <int G>
__global__ void __launch_bounds__(kThreads)
split_kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
             const float* __restrict__ v_pages, const int* __restrict__ page_table,
             long long table_stride, const int* __restrict__ seq_lens,
             float* __restrict__ part_o, float* __restrict__ part_ml, int h, int h_kv, int d,
             int page, int max_pages, float qscale) {
  extern __shared__ __align__(16) float smem[];
  const int si = blockIdx.x, hk = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int len = seq_lens[si];
  const int n_live = live_pages(len, page, max_pages);
  const int run = split_run(n_live, splits);
  const int p0 = split * run;
  if (p0 >= n_live) return;  // past the live prefix (every split of a seq_len == 0 row)
  const int n = min(run, n_live - p0);

  const int g = h / h_kv, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d4 = d >> 2, pd = page * d;
  const bool on = lane < d4;  // lanes past d hold zeros

  // q [s, h, d]: head hk * g + r is row r of this block's group
  const float* q_grp = q + ((size_t)si * h + (size_t)hk * g) * d;
  float4 qv[G];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    qv[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (on && r < g) {
      const float4 x = reinterpret_cast<const float4*>(q_grp + (size_t)r * d)[lane];
      qv[r] = make_float4(x.x * qscale, x.y * qscale, x.z * qscale, x.w * qscale);
    }
  }

  // page i of the run into stage i % kStages: K at the stage's start, V pd on
  const int* row = page_table + (size_t)si * (size_t)table_stride;
  const size_t tok_stride = (size_t)h_kv * d;  // floats between tokens of one head
  auto issue = [&](int i) {
    const size_t pid = (size_t)row[p0 + i];
    // element (pid, t, hk, j) of the pool sits at ((pid*page + t)*h_kv + hk)*d + j
    const size_t base = (pid * page * h_kv + hk) * (size_t)d;
    float* ks = smem + (i % kStages) * 2 * pd;
    for (int e = tid; e < page * d4; e += kThreads) {
      const int t = e / d4, j = (e - t * d4) * 4;
      cp_async16(ks + t * d + j, k_pages + base + t * tok_stride + j);
      cp_async16(ks + pd + t * d + j, v_pages + base + t * tok_stride + j);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) issue(i);
    cp_async_commit();  // empty groups complete at once, so the count stays in step
  }

  // this warp's online softmax per row: running max, sum, output (lane's d)
  float m[G], l[G];
  float4 acc[G];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // page i landed for every thread, and page i - 1's stage is free
    if (i + kStages - 1 < n) issue(i + kStages - 1);
    cp_async_commit();
    const float4* ks = reinterpret_cast<const float4*>(smem + (i % kStages) * 2 * pd);
    const float4* vs = ks + pd / 4;
    const int pos0 = (p0 + i) * page;

    // scores of this warp's tokens t = warp + 4u, masked before the max
    float sc[kMaxTok][G];
    bool live[kMaxTok];
    float mx[G];
#pragma unroll
    for (int r = 0; r < G; ++r) mx[r] = m[r];
#pragma unroll
    for (int u = 0; u < kMaxTok; ++u) {
      const int t = warp + kWarps * u;
      live[u] = false;
      if (t < page) {
        const bool lv = pos0 + t < len;
        live[u] = lv;
        const float4 k4 = on ? ks[t * d4 + lane] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const float s = warp_sum(qv[r].x * k4.x + qv[r].y * k4.y + qv[r].z * k4.z +
                                   qv[r].w * k4.w);
          sc[u][r] = lv ? s : kNegInf;
          mx[r] = fmaxf(mx[r], sc[u][r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const float alpha = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha;
      acc[r].x *= alpha;
      acc[r].y *= alpha;
      acc[r].z *= alpha;
      acc[r].w *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kMaxTok; ++u) {
      const int t = warp + kWarps * u;
      if (t < page) {
        const float4 v4 = on ? vs[t * d4 + lane] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < G; ++r) {
          // a masked position adds exactly nothing, even before any live one
          const float p = live[u] ? exp2f(sc[u][r] - m[r]) : 0.f;
          l[r] += p;
          acc[r].x += p * v4.x;
          acc[r].y += p * v4.y;
          acc[r].z += p * v4.z;
          acc[r].w += p * v4.w;
        }
      }
    }
  }

  // the four warps' states, merged in warp order; the stages are free once
  // every warp is past its last page
  cp_async_wait<0>();
  __syncthreads();
  float* wm = smem;                // [kWarps][G] maxima
  float* wl = wm + kWarps * G;     // [kWarps][G] sums
  float* wa = wl + kWarps * G;     // [kWarps][G][d] outputs
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      wm[warp * G + r] = m[r];
      wl[warp * G + r] = l[r];
    }
  }
  if (on) {
#pragma unroll
    for (int r = 0; r < G; ++r) reinterpret_cast<float4*>(wa + (warp * G + r) * d)[lane] = acc[r];
  }
  __syncthreads();
  // warp 0 took the run's first position, which is live: the max is finite
  // and a warp without a live position weighs exactly 0
  for (int e = tid; e < g * d; e += kThreads) {
    const int r = e / d, j = e - r * d;
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, wm[w * G + r]);
    float o = 0.f, lb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(wm[w * G + r] - mb);
      o += wa[(w * G + r) * d + j] * c;
      lb += wl[w * G + r] * c;
    }
    const size_t pr = ((size_t)si * h + (size_t)hk * g + r) * splits + split;
    part_o[pr * d + j] = o;
    if (j == 0) {
      part_ml[2 * pr] = mb;
      part_ml[2 * pr + 1] = lb;
    }
  }
}

// out [s, h, d] from a row's live partials, merged in split order.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
             const int* __restrict__ seq_lens, float* __restrict__ out, int h, int h_kv, int d,
             int page, int max_pages, int splits) {
  const int si = blockIdx.x, hk = blockIdx.y, g = h / h_kv;
  const int n_live = live_pages(seq_lens[si], page, max_pages);
  const int run = split_run(n_live, splits);
  const int live = n_live > 0 ? (n_live + run - 1) / run : 0;
  for (int e = threadIdx.x; e < g * d; e += kThreads) {
    const int r = e / d, j = e - r * d;
    const size_t pr = (size_t)si * h + (size_t)hk * g + r;
    const float* ml = part_ml + pr * splits * 2;
    const float* po = part_o + pr * splits * d + j;
    float mx = kNegInf;
    for (int sp = 0; sp < live; ++sp) mx = fmaxf(mx, ml[2 * sp]);
    float o = 0.f, lsum = 0.f;
    for (int sp = 0; sp < live; ++sp) {
      const float c = exp2f(ml[2 * sp] - mx);
      o += po[(size_t)sp * d] * c;
      lsum += ml[2 * sp + 1] * c;
    }
    // no live split only for seq_len == 0: exactly zero, as the TPU
    // kernel's _finish gives
    out[pr * d + j] = live > 0 ? o / lsum : 0.f;
  }
}

template <int G>
int launch(const float* q, const float* k_pages, const float* v_pages, const int* page_table,
           long long table_stride, const int* seq_lens, float* out, float* part_o,
           float* part_ml, int s, int h, int h_kv, int d, int page, int max_pages, int splits,
           float scale, cudaStream_t stream) {
  // the ring holds at most as many pages as a split can take (n_live <=
  // max_pages); the end-of-run merge reuses it
  const int run = (max_pages + splits - 1) / splits;
  const int stages = run < kStages ? (run > 0 ? run : 1) : kStages;
  const size_t ring = sizeof(float) * (size_t)stages * 2 * page * d;
  const size_t merge = sizeof(float) * ((size_t)2 * kWarps * G + (size_t)kWarps * G * d);
  const size_t smem = ring > merge ? ring : merge;
  const int err = flash::launch(split_kernel<G>, dim3(s, h_kv, splits), kThreads, smem, stream,
                                q, k_pages, v_pages, page_table, table_stride, seq_lens, part_o,
                                part_ml, h, h_kv, d, page, max_pages, scale * kLog2e);
  if (err) return err;
  merge_kernel<<<dim3(s, h_kv), kThreads, 0, stream>>>(part_o, part_ml, seq_lens, out, h, h_kv,
                                                       d, page, max_pages, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches split_kernel, then
// merge_kernel, on `stream` (PyTorch's current stream); allocates nothing
// (part_o f32 [s, h, splits, d] and part_ml f32 [s, h, splits, 2] are the
// caller's scratch), does not synchronise, and returns cudaGetLastError()
// so a refused launch reaches the caller, or cudaErrorInvalidValue for
// sizes the kernels do not take.
extern "C" int paged_decode_f32(const float* q, const float* k_pages, const float* v_pages,
                                const int* page_table, long long table_stride,
                                const int* seq_lens, float* out, float* part_o, float* part_ml,
                                int s, int h, int h_kv, int d, int page_size, int max_pages,
                                int splits, float scale, void* stream) {
  const int g = h_kv > 0 ? h / h_kv : 0;
  if (s <= 0 || g < 1 || g > 8 || h % h_kv || d % 4 || d <= 0 || d > kMaxD || page_size < 1 ||
      page_size > kMaxPage || max_pages < 0 || splits < 1 || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const int G = g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
  switch (G) {
    case 1:
      return launch<1>(q, k_pages, v_pages, page_table, table_stride, seq_lens, out, part_o,
                       part_ml, s, h, h_kv, d, page_size, max_pages, splits, scale, st);
    case 2:
      return launch<2>(q, k_pages, v_pages, page_table, table_stride, seq_lens, out, part_o,
                       part_ml, s, h, h_kv, d, page_size, max_pages, splits, scale, st);
    case 4:
      return launch<4>(q, k_pages, v_pages, page_table, table_stride, seq_lens, out, part_o,
                       part_ml, s, h, h_kv, d, page_size, max_pages, splits, scale, st);
    default:
      return launch<8>(q, k_pages, v_pages, page_table, table_stride, seq_lens, out, part_o,
                       part_ml, s, h, h_kv, d, page_size, max_pages, splits, scale, st);
  }
}
