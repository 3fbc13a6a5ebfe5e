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
// The design answers that with the tensor cores and no score matrix in
// device memory:
//   - one block per (batch, query head, 64-row query tile) loops over the
//     key tiles with an online softmax (f32 running max m, sum l and
//     output accumulator); the TPU kernel's sequential grid dimension
//     becomes this loop, and its VMEM scratch becomes registers;
//   - each of the 4 warps owns 16 query rows: q.k^T and p.v are bf16
//     mma.sync.m16n8k16 products with f32 accumulation, the scores, the
//     softmax and the 16 x d output accumulator never leave registers,
//     and p is fed to the second product straight from the first one's
//     accumulator registers;
//   - K/V tiles are double-buffered in shared memory (cp.async for bf16),
//     so the next tile loads while the current one is multiplied;
//   - under causal masking the loop stops at the diagonal tile, so tiles
//     wholly above it are never loaded, and the heaviest query tiles get
//     the lowest block indices, so they start first;
//   - q, k and v are read in the model layout [b, t, h, d]; the ragged edge
//     (t not a multiple of 64) is zero-filled on load and masked to
//     NEG_INF in the scores.
// The f32 instantiation is this same code on split operands (see
// flash_common.cuh). What it does not do yet: wgmma, TMA, warp
// specialisation, or splitting a long row's keys across blocks.

#include "flash_common.cuh"

namespace flash {
namespace {

template <typename T, int D>
__global__ void __launch_bounds__(128)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int t, int h, int h_kv, int causal,
           float scale) {
  constexpr int P = Planes<T>::value;
  constexpr int kT = kMmaTile, LD = mma_ld(D), KD = D / 16, ND = D / 8, TE = tile_elems<T, D>();
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + TE;      // [2] tiles
  __nv_bfloat16* vs = ks + 2 * TE;  // [2] tiles

  const int nq = (t + kT - 1) / kT;
  const int qt = nq - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hi / (h / h_kv);
  const int q0 = qt * kT;
  const int lane = threadIdx.x & 31;
  const int w0 = (threadIdx.x >> 5) * 16;
  const int row0 = q0 + w0 + (lane >> 2);  // this thread's rows: row0, row0 + 8
  const int cq = 2 * (lane & 3);           // its first column in each 8-column block
  const int nk = causal ? qt + 1 : nq;     // equal tiles: up to the diagonal
  const float scale2 = scale * kLog2e;      // scores, max and lse in log2 units

  load_tile<T, D>(qs, q, bi, hi, q0, t, h);
  load_tile<T, D>(ks, k, bi, hk, 0, t, h_kv);
  load_tile<T, D>(vs, v, bi, hk, 0, t, h_kv);
  cp_async_commit();

  uint32_t qf[KD][P][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // per-thread partial sums

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      load_tile<T, D>(ks + (buf ^ 1) * TE, k, bi, hk, (kt + 1) * kT, t, h_kv);
      load_tile<T, D>(vs + (buf ^ 1) * TE, v, bi, hk, (kt + 1) * kT, t, h_kv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) load_a<P>(qf[kk], qs, LD, w0, 16 * kk);
    }
    const __nv_bfloat16* kb = ks + buf * TE;
    const __nv_bfloat16* vb = vs + buf * TE;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[P][4];
        load_b_rows_are_n<P>(b, kb, LD, 16 * np, 16 * kk);
        mma<P>(s[2 * np], qf[kk], b, 0);
        mma<P>(s[2 * np + 1], qf[kk], b, 1);
      }
    }

    const int k0 = kt * kT;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * n + cq + (e & 1);
        const int row = e < 2 ? row0 : row0 + 8;
        float x = s[n][e] * scale2;
        if (col >= t || (causal && col > row)) x = kNegInf;
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    // the 4 threads of a quad hold one row's 64 scores
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key 0 is live for every row, so from the first tile on m is finite
    // and exp() of a masked score is exactly 0
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[P][4];
      c_to_a<P>(a, s, kk);
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        uint32_t b[P][4];
        load_b_rows_are_k<P>(b, vb, LD, 16 * dp, 16 * kk);
        mma<P>(acc[2 * dp], a, b, 0);
        mma<P>(acc[2 * dp + 1], a, b, 1);
      }
    }
    __syncthreads();  // the next prefetch overwrites this buffer
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  store_acc<T, D>(o, acc, 1.f / l0, 1.f / l1, bi, hi, row0, t, h);
  if ((lane & 3) == 0) {
    float* lrow = lse + ((size_t)bi * h + hi) * t;
    if (row0 < t) lrow[row0] = m0 * kLn2 + logf(l0);
    if (row0 + 8 < t) lrow[row0 + 8] = m1 * kLn2 + logf(l1);
  }
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int b, int t, int h,
        int h_kv, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((t + kMmaTile - 1) / kMmaTile, h, b);
  return launch(fwd_kernel<T, D>, grid, 128, 5 * tile_bytes<T, D>(), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<T*>(o), lse, t, h, h_kv, causal, scale);
}

}  // namespace
}  // namespace flash

// Plain C entry point, bound with ctypes. q [b, t, h, d], k/v
// [b, t, h_kv, d], o like q (bf16 when `bf16`, else f32), lse [b, h, t] f32,
// all contiguous. Launches on `stream` (PyTorch's current stream),
// allocates nothing, does not synchronise, and returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int b, int t, int h, int h_kv, int d,
                         int causal, float scale, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(d, return bf16 ? flash::fwd<__nv_bfloat16, D>(q, k, v, o, lse, b, t, h, h_kv,
                                                                 causal, scale, s)
                                  : flash::fwd<float, D>(q, k, v, o, lse, b, t, h, h_kv, causal,
                                                         scale, s))
}
