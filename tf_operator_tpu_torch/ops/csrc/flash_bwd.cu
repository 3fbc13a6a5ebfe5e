// Flash-attention backward for Hopper (sm_90a): dq, and dk with dv.
//
// Replaces tf_operator_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (the Pallas TPU kernels launched by _bwd). Same
// functions: P is rebuilt from the forward's lse, p = exp(s - lse), never
// stored; dp = dO.v^T; ds = p * (dp - delta) with
// delta = rowsum(dO * O) - dlse computed by the caller (the lse cotangent
// folds into delta as in _bwd); dq = scale * ds.k, dk = scale * ds^T.q,
// dv = p^T.dO.
//
// Bound: operations. At the training shape (b 6, t 2048, h 16, h_kv 4,
// d 128, causal, bf16) dq does 1.55e11 flops (s, dp, dq) and dk/dv
// 2.06e11 (s, dp, dv, dk) on the live triangle: 0.156 ms and 0.208 ms at
// 989 TFLOP/s bf16, against ~0.05 ms of bytes each at 3.35 TB/s. So the
// design keeps P and dS out of device memory and runs every product on
// the tensor cores (bf16 mma.sync.m16n8k16, f32 accumulation), with the
// per-tile state in registers:
//   - dq: one block per (batch, query head, 64-row query tile) loops over
//     the live key tiles (K/V double-buffered); each warp keeps its 16
//     rows' q fragments, scores, dp and dq accumulator in registers and
//     feeds ds to ds.k from the score registers;
//   - dk/dv: one block per (batch, kv head, 64-row key tile) loops over
//     the g query heads of its group and, for each, over the live query
//     tiles (from the diagonal down when causal; Q/dO double-buffered),
//     accumulating dk and dv in registers. Summing the group inside the
//     block is what makes every dk/dv row the work of one block: no
//     atomics, one write. Each warp computes the transposed tiles s^T and
//     dp^T of its 16 key rows directly (k.q^T, v.dO^T), so no transpose
//     is staged;
//   - rows at or past t are zero-filled on load and masked out of p.
// The f32 instantiation is this same code on split operands (see
// flash_common.cuh). Not done yet: wgmma, TMA, warp specialisation.

#include "flash_common.cuh"

namespace flash {
namespace {

template <typename T, int D>
__global__ void __launch_bounds__(128)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int t, int h, int h_kv,
          int causal, float scale) {
  constexpr int P = Planes<T>::value;
  constexpr int kT = kMmaTile, LD = mma_ld(D), KD = D / 16, ND = D / 8, TE = tile_elems<T, D>();
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + TE;
  __nv_bfloat16* ks = dos + TE;     // [2] tiles
  __nv_bfloat16* vs = ks + 2 * TE;  // [2] tiles

  const int nq = (t + kT - 1) / kT;
  const int qt = nq - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hi / (h / h_kv);
  const int q0 = qt * kT;
  const int lane = threadIdx.x & 31;
  const int w0 = (threadIdx.x >> 5) * 16;
  const int row0 = q0 + w0 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int nk = causal ? qt + 1 : nq;

  load_tile<T, D>(qs, q, bi, hi, q0, t, h);
  load_tile<T, D>(dos, dout, bi, hi, q0, t, h);
  load_tile<T, D>(ks, k, bi, hk, 0, t, h_kv);
  load_tile<T, D>(vs, v, bi, hk, 0, t, h_kv);
  cp_async_commit();
  const float* lrow = lse + ((size_t)bi * h + hi) * t;
  const float* drow = delta + ((size_t)bi * h + hi) * t;
  // p = exp2(s * scale * log2(e) - lse * log2(e)): one exp2 per score
  const float scale2 = scale * kLog2e;
  const float lse0 = row0 < t ? lrow[row0] * kLog2e : 0.f;
  const float lse1 = row0 + 8 < t ? lrow[row0 + 8] * kLog2e : 0.f;
  const float dl0 = row0 < t ? drow[row0] : 0.f, dl1 = row0 + 8 < t ? drow[row0 + 8] : 0.f;

  uint32_t qf[KD][P][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

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

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t da[P][4];
      load_a<P>(da, dos, LD, w0, 16 * kk);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[P][4];
        load_b_rows_are_n<P>(b, kb, LD, 16 * np, 16 * kk);
        mma<P>(s[2 * np], qf[kk], b, 0);
        mma<P>(s[2 * np + 1], qf[kk], b, 1);
        load_b_rows_are_n<P>(b, vb, LD, 16 * np, 16 * kk);
        mma<P>(dp[2 * np], da, b, 0);
        mma<P>(dp[2 * np + 1], da, b, 1);
      }
    }
    const int k0 = kt * kT;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * n + cq + (e & 1);
        const int row = e < 2 ? row0 : row0 + 8;
        const bool live = row < t && col < t && !(causal && col > row);
        const float p = live ? exp2f(s[n][e] * scale2 - (e < 2 ? lse0 : lse1)) : 0.f;
        s[n][e] = p * (dp[n][e] - (e < 2 ? dl0 : dl1));  // ds
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[P][4];
      c_to_a<P>(a, s, kk);
#pragma unroll
      for (int dn = 0; dn < KD; ++dn) {
        uint32_t b[P][4];
        load_b_rows_are_k<P>(b, kb, LD, 16 * dn, 16 * kk);
        mma<P>(acc[2 * dn], a, b, 0);
        mma<P>(acc[2 * dn + 1], a, b, 1);
      }
    }
    __syncthreads();  // the next prefetch overwrites this buffer
  }
  store_acc<T, D>(dq, acc, scale, scale, bi, hi, row0, t, h);
}

template <typename T, int D>
__global__ void __launch_bounds__(128)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int t,
           int h, int h_kv, int causal, float scale) {
  constexpr int P = Planes<T>::value;
  constexpr int kT = kMmaTile, LD = mma_ld(D), KD = D / 16, ND = D / 8, TE = tile_elems<T, D>();
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + TE;
  __nv_bfloat16* qs = vs + TE;       // [2] tiles
  __nv_bfloat16* dos = qs + 2 * TE;  // [2] tiles
  float* lse_s = reinterpret_cast<float*>(dos + 2 * TE);  // [2][kT]
  float* delta_s = lse_s + 2 * kT;                        // [2][kT]

  const int nq = (t + kT - 1) / kT;
  const int kt = blockIdx.x;  // low key tiles have the most live query tiles
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = h / h_kv;
  const int k0 = kt * kT;
  const int lane = threadIdx.x & 31;
  const int w0 = (threadIdx.x >> 5) * 16;
  const int key0 = k0 + w0 + (lane >> 2);  // this thread's key rows: key0, key0 + 8
  const int cq = 2 * (lane & 3);
  // equal tiles: key tile kt is seen by query tiles kt..nq-1 when causal
  const int qfirst = causal ? kt : 0;
  const int per_head = nq - qfirst;
  const int n_it = g * per_head;
  const float scale2 = scale * kLog2e;  // p = exp2(s * scale2 - lse * log2(e))

  // stage query tile `it` (group member it / per_head) into buffer `buf`
  auto stage = [&](int it, int buf) {
    const int hi = hk * g + it / per_head;
    const int q0 = (qfirst + it % per_head) * kT;
    load_tile<T, D>(qs + buf * TE, q, bi, hi, q0, t, h);
    load_tile<T, D>(dos + buf * TE, dout, bi, hi, q0, t, h);
    const size_t off = ((size_t)bi * h + hi) * t;
    for (int r = threadIdx.x; r < kT; r += blockDim.x) {
      const int row = q0 + r;
      lse_s[buf * kT + r] = row < t ? lse[off + row] * kLog2e : 0.f;  // log2 units
      delta_s[buf * kT + r] = row < t ? delta[off + row] : 0.f;
    }
  };

  load_tile<T, D>(ks, k, bi, hk, k0, t, h_kv);
  load_tile<T, D>(vs, v, bi, hk, k0, t, h_kv);
  stage(0, 0);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      stage(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (qfirst + it % per_head) * kT;
    const __nv_bfloat16* qb = qs + buf * TE;
    const __nv_bfloat16* db = dos + buf * TE;
    const float* ls = lse_s + buf * kT;
    const float* dl = delta_s + buf * kT;

    // s^T = k.q^T for this warp's 16 keys x 64 queries, then p^T in place
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[P][4];
      load_a<P>(a, ks, LD, w0, 16 * kk);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[P][4];
        load_b_rows_are_n<P>(b, qb, LD, 16 * np, 16 * kk);
        mma<P>(s[2 * np], a, b, 0);
        mma<P>(s[2 * np + 1], a, b, 1);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + cq + (e & 1);
        const int row = q0 + c;
        const int key = e < 2 ? key0 : key0 + 8;
        const bool live = row < t && key < t && !(causal && key > row);
        s[n][e] = live ? exp2f(s[n][e] * scale2 - ls[c]) : 0.f;
      }
    }
    // dv += p^T.dO
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[P][4];
      c_to_a<P>(a, s, kk);
#pragma unroll
      for (int dn = 0; dn < KD; ++dn) {
        uint32_t b[P][4];
        load_b_rows_are_k<P>(b, db, LD, 16 * dn, 16 * kk);
        mma<P>(dva[2 * dn], a, b, 0);
        mma<P>(dva[2 * dn + 1], a, b, 1);
      }
    }
    // dp^T = v.dO^T two 8-query blocks at a time, turned into ds^T in place
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[P][4], b[P][4];
        load_a<P>(a, vs, LD, w0, 16 * kk);
        load_b_rows_are_n<P>(b, db, LD, 16 * np, 16 * kk);
        mma<P>(dp[0], a, b, 0);
        mma<P>(dp[1], a, b, 1);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * (2 * np + j) + cq + (e & 1);
          s[2 * np + j][e] *= dp[j][e] - dl[c];
        }
      }
    }
    // dk += ds^T.q
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[P][4];
      c_to_a<P>(a, s, kk);
#pragma unroll
      for (int dn = 0; dn < KD; ++dn) {
        uint32_t b[P][4];
        load_b_rows_are_k<P>(b, qb, LD, 16 * dn, 16 * kk);
        mma<P>(dka[2 * dn], a, b, 0);
        mma<P>(dka[2 * dn + 1], a, b, 1);
      }
    }
    __syncthreads();  // the next stage overwrites this buffer
  }
  store_acc<T, D>(dk, dka, scale, scale, bi, hk, key0, t, h_kv);
  store_acc<T, D>(dv, dva, 1.f, 1.f, bi, hk, key0, t, h_kv);
}

template <typename T, int D>
int dq_launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dqo, int b, int t, int h, int h_kv, int causal,
              float scale, cudaStream_t stream) {
  const dim3 grid((t + kMmaTile - 1) / kMmaTile, h, b);
  return launch(dq_kernel<T, D>, grid, 128, 6 * tile_bytes<T, D>(), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), lse, delta, static_cast<T*>(dqo), t, h, h_kv,
                causal, scale);
}

template <typename T, int D>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dko, void* dvo, int b, int t, int h, int h_kv,
               int causal, float scale, cudaStream_t stream) {
  const dim3 grid((t + kMmaTile - 1) / kMmaTile, h_kv, b);
  const size_t smem = 6 * tile_bytes<T, D>() + 4 * kMmaTile * sizeof(float);
  return launch(dkv_kernel<T, D>, grid, 128, smem, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), lse, delta, static_cast<T*>(dko),
                static_cast<T*>(dvo), t, h, h_kv, causal, scale);
}

}  // namespace
}  // namespace flash

// Plain C entry points, bound with ctypes. q, dout, dq [b, t, h, d];
// k, v, dk, dv [b, t, h_kv, d] (bf16 when `bf16`, else f32); lse, delta
// [b, h, t] f32; all contiguous. Each launches on `stream`, allocates
// nothing, does not synchronise, and returns cudaGetLastError().
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse, const float* delta,
                            void* dq, int b, int t, int h, int h_kv, int d,
                            int causal, float scale, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(d, return bf16 ? flash::dq_launch<__nv_bfloat16, D>(
                                        q, k, v, dout, lse, delta, dq, b, t, h, h_kv, causal,
                                        scale, s)
                                  : flash::dq_launch<float, D>(q, k, v, dout, lse, delta, dq, b,
                                                               t, h, h_kv, causal, scale, s))
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse, const float* delta,
                             void* dk, void* dv, int b, int t, int h, int h_kv, int d,
                             int causal, float scale, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_D(d, return bf16 ? flash::dkv_launch<__nv_bfloat16, D>(
                                        q, k, v, dout, lse, delta, dk, dv, b, t, h, h_kv,
                                        causal, scale, s)
                                  : flash::dkv_launch<float, D>(q, k, v, dout, lse, delta, dk,
                                                                dv, b, t, h, h_kv, causal, scale,
                                                                s))
}
