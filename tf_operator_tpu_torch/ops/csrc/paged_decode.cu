// Paged decode attention for Hopper (sm_90a), f32.
//
// Replaces tf_operator_tpu/ops/flash_attention.py::_decode_kernel (the
// Pallas TPU kernel launched by _decode_call). Same function: one query
// token per sequence attends over that sequence's K/V, which lives in
// fixed-size pages of a pool [n_pages, page, h_kv, d] named by a page
// table [s, p] (int32) with seq_lens [s] (int32) valid positions.
// Positions >= seq_len are masked to NEG_INF; a row with seq_len == 0
// comes out exactly zero.
//
// Bound: device-memory bytes. Every live K/V element is read once and
// used for g multiply-adds per side (g = h / h_kv, 4 for gqa-2048), far
// below the card's ratio of operations to bytes, so the floor is the
// live K/V bytes over 3.35 TB/s. The design keeps that floor reachable:
//   - one thread block per (sequence, kv head) loads its own seq_len and
//     page ids (the TPU kernel's scalar prefetch) and loops over the
//     LIVE pages only, ceil(seq_len / page) of them; the TPU grid walks
//     every table slot and DMAs dead pages too;
//   - the g query rows of the GQA group, pre-scaled by d^-1/2, sit in
//     shared memory, so each K/V page is read from device memory once
//     for the whole group;
//   - a page is staged in shared memory with 16-byte loads, neighbouring
//     threads on neighbouring d;
//   - scores use warp reductions; an online softmax (m, l) per row and an
//     f32 accumulator [g, d] in registers carry across pages.
// This first version is plain CUDA-core f32: no TMA, no wgmma, no
// double buffering, and no split of long sequences across blocks (so a
// decode batch of s sequences fills only s * h_kv SMs). Making it fast
// is later work.
//
// Padded table entries past the live prefix are real page ids (the
// engine pads with trash_page - 1) and freed pages are reused without
// clearing: correctness rests on never reading past ceil(seq_len/page)
// pages and on the in-page mask. Both bounds below are exact.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Limits the Python wrapper checks before launching (keep in step with
// tf_operator_tpu_torch/ops/flash_attention.py): d % 4 == 0 (16-byte
// loads), page <= 32 (one warp lane per page position), g * d <=
// kThreads * kMaxAcc, and the shared memory below <= 48 KB.
constexpr int kMaxAcc = 8;
constexpr float kNegInf = -1e30f;  // as flash_attention.py NEG_INF

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
paged_decode_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k_pages,
                        const float* __restrict__ v_pages,
                        const int* __restrict__ page_table,
                        long long table_stride,
                        const int* __restrict__ seq_lens,
                        float* __restrict__ out,
                        int h, int h_kv, int d, int page_size, int max_pages,
                        float scale) {
  extern __shared__ float smem[];
  const int g = h / h_kv;
  const int si = blockIdx.x;
  const int hk = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gd = g * d;
  const int pd = page_size * d;

  float* qs = smem;                  // [g, d] query rows, pre-scaled
  float* ks = qs + gd;               // [page, d] K page
  float* vs = ks + pd;               // [page, d] V page
  float* ps = vs + pd;               // [g, page] scores, then probabilities
  float* m_s = ps + g * page_size;   // [g] running max
  float* l_s = m_s + g;              // [g] running sum
  float* a_s = l_s + g;              // [g] this page's rescale factor

  const int len = seq_lens[si];
  int n_live = len > 0 ? (len + page_size - 1) / page_size : 0;
  if (n_live > max_pages) n_live = max_pages;

  // q [s, h, d]: head hk*g + r is row r of this block's group.
  const float* q_grp = q + ((size_t)si * h + (size_t)hk * g) * d;
  for (int e = tid; e < gd; e += kThreads) qs[e] = q_grp[e] * scale;
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  const int* row = page_table + (size_t)si * (size_t)table_stride;
  const size_t tok_stride = (size_t)h_kv * d;  // floats between tokens of one head
  const int d4 = d >> 2;

  for (int pi = 0; pi < n_live; ++pi) {
    const size_t pid = (size_t)row[pi];
    // element (pid, t, hk, j) of the pool sits at ((pid*page + t)*h_kv + hk)*d + j
    const size_t base = (pid * page_size * h_kv + hk) * (size_t)d;
    const float* kb = k_pages + base;
    const float* vb = v_pages + base;
    for (int e = tid; e < page_size * d4; e += kThreads) {
      const int t = e / d4;
      const int j4 = e - t * d4;
      const float4 kv = reinterpret_cast<const float4*>(kb + t * tok_stride)[j4];
      const float4 vv = reinterpret_cast<const float4*>(vb + t * tok_stride)[j4];
      reinterpret_cast<float4*>(ks + t * d)[j4] = kv;
      reinterpret_cast<float4*>(vs + t * d)[j4] = vv;
    }
    __syncthreads();

    // scores [g, page]: one warp per (row, position) dot product
    const int pos0 = pi * page_size;
    for (int pr = warp; pr < g * page_size; pr += kWarps) {
      const int r = pr / page_size;
      const int t = pr - r * page_size;
      float sum = 0.f;
      for (int j = lane; j < d; j += 32) sum += qs[r * d + j] * ks[t * d + j];
      sum = warp_sum(sum);
      if (lane == 0) ps[pr] = (pos0 + t < len) ? sum : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per row, one lane per page position. The
    // page is live, so position pos0 < len is unmasked and m_new is finite.
    for (int r = warp; r < g; r += kWarps) {
      const float sv = lane < page_size ? ps[r * page_size + lane] : -INFINITY;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(sv));
      const float p = lane < page_size ? expf(sv - m_new) : 0.f;
      const float psum = warp_sum(p);
      if (lane < page_size) ps[r * page_size + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r, j] = acc * alpha[r] + sum_t p[r, t] * V[t, j]
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < gd) {
        const int r = e / d;
        const int j = e - r * d;
        const float* pr = ps + r * page_size;
        float a = acc[i] * a_s[r];
        for (int t = 0; t < page_size; ++t) a += pr[t] * vs[t * d + j];
        acc[i] = a;
      }
    }
    __syncthreads();  // the next page overwrites ks, vs and ps
  }

  // l == 0 only when no page was live (seq_len == 0): divide by 1, so the
  // row is exactly zero, as the TPU kernel's _finish does.
  float* o_grp = out + ((size_t)si * h + (size_t)hk * g) * d;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < gd) {
      const float l = l_s[e / d];
      o_grp[e] = acc[i] / (l == 0.f ? 1.f : l);
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` (PyTorch's
// current stream), allocates nothing, does not synchronise, and returns
// cudaGetLastError() so a refused launch reaches the caller.
extern "C" int paged_decode_f32(const float* q, const float* k_pages,
                                const float* v_pages, const int* page_table,
                                long long table_stride, const int* seq_lens,
                                float* out, int s, int h, int h_kv, int d,
                                int page_size, int max_pages, float scale,
                                void* stream) {
  const int g = h / h_kv;
  const size_t smem =
      sizeof(float) * ((size_t)g * d + 2 * (size_t)page_size * d +
                       (size_t)g * page_size + 3 * (size_t)g);
  dim3 grid(s, h_kv);
  paged_decode_f32_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q, k_pages, v_pages, page_table, table_stride, seq_lens, out, h, h_kv,
      d, page_size, max_pages, scale);
  return (int)cudaGetLastError();
}
