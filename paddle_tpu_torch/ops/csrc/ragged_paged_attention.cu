// Ragged paged attention for Hopper: one kernel for a mixed batch of
// prefill chunks and decode tokens over block-table paged K/V pools.
//
// Replaces paddle_tpu/ops/pallas_ops.py::_rpa_kernel (non-quantized
// pools).  Layout, as at the public function:
//   q            [R, nkv, Tr, d]  Tr = Tc * rep; row t*rep + j is q head
//                                 h*rep + j of token t (GQA)
//   k/v pools    [nkv, P, page, d]
//   block_tables [R, Bmax] int32  pool page of logical kv block j
//   seq_lens     [R] int32        kv length including this chunk
//   q_lens       [R] int32        tokens in this chunk (0 = empty slot)
//
// The TPU kernel walked the pages on a sequential grid axis and carried
// the online-softmax state in VMEM scratch from one grid step to the
// next.  Here one block owns (request r, kv head h, 16 q rows) and walks
// the pages in a loop, with the state in shared memory and registers:
//   for each page j with j*page < kvlen and j*page <= horizon:
//     phys = block_tables[r, j]; stage 16 keys and values in smem (f32)
//     s = q.k * scale, masked (kpos <= qpos, kpos < kvlen, tok < qlen)
//     to -1e30; online softmax with p zeroed explicitly on masked keys
//   rows whose running sum l is 0 (padding) are written as exact zeros;
//   a slot with q_len == 0 writes zeros and reads no page.
// Everything is computed in fp32 and rounded once to the pool dtype.
//
// What bounds it on this card: each page is read once per (r, h) block
// and does ~4*d flops per key per q row, so at decode (one q row per
// kv head) it moves ~2 bytes per flop and is bound by the bytes of the
// pages it reads (3.35 TB/s).  Skipping pages past kvlen and past the
// tile's causal horizon is what keeps those bytes to what the batch
// needs.  Nothing is tuned yet: keys load one element per thread, the
// dot products run on the fp32 cores from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -1e30f;  // finite: -inf would NaN masked rows
constexpr int kRows = 16;          // q rows per block
constexpr int kKeys = 16;          // keys staged per smem tile
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    rpa_kernel(const T* __restrict__ q, const T* __restrict__ kp,
               const T* __restrict__ vp, const int* __restrict__ tbl,
               const int* __restrict__ seq_lens,
               const int* __restrict__ q_lens, T* __restrict__ out, int nkv,
               int Tr, int P, int page, int Bmax, int rep, float scale) {
  constexpr int kCols = D / (kThreads / kRows);  // acc columns per thread
  __shared__ float q_s[kRows][D + 1];
  __shared__ float k_s[kKeys][D + 1];
  __shared__ float v_s[kKeys][D + 1];
  __shared__ float p_s[kRows][kKeys + 1];
  __shared__ bool live_s[kRows][kKeys];
  __shared__ float m_s[kRows], l_s[kRows], corr_s[kRows];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int h = blockIdx.y, r = blockIdx.z;
  const int nrows = min(kRows, Tr - row0);
  const int kvlen = seq_lens[r], qlen = q_lens[r];
  const size_t base = (((size_t)r * nkv + h) * Tr + row0) * D;
  const T* qg = q + base;
  T* og = out + base;

  // acc layout: thread owns row i = tid / 8, columns c = tid % 8 + 8 * u
  const int ai = tid / (kThreads / kRows);
  const int ac = tid % (kThreads / kRows);

  if (qlen == 0 || row0 / rep >= qlen) {
    // empty slot, or a tile of padding rows only: exact zeros, no page
    for (int i = tid; i < nrows * D; i += kThreads) og[i] = from_f32<T>(0.f);
    return;
  }

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int t = i / D, c = i - t * D;
    q_s[t][c] = t < nrows ? to_f32(qg[(size_t)t * D + c]) : 0.f;
  }
  if (tid < kRows) {
    m_s[tid] = kNegBig;
    l_s[tid] = 0.f;
  }
  float acc[kCols];
#pragma unroll
  for (int u = 0; u < kCols; ++u) acc[u] = 0.f;

  // causal horizon of the tile's last real row: pages past it (and past
  // kvlen) hold no key that any row of this tile may see
  const int last_tok = min((row0 + nrows - 1) / rep, qlen - 1);
  const int horizon = kvlen - qlen + last_tok;
  const size_t head_base = (size_t)h * P;

  for (int j = 0; j < Bmax && j * page < kvlen && j * page <= horizon;
       ++j) {
    const size_t pg = (head_base + tbl[(size_t)r * Bmax + j]) * page;
    for (int t0 = 0; t0 < page; t0 += kKeys) {
      const int kbase = j * page + t0;
      if (kbase >= kvlen || kbase > horizon) break;
      __syncthreads();  // the previous tile's k_s / v_s / p_s are spent
      for (int i = tid; i < kKeys * D; i += kThreads) {
        const int t = i / D, c = i - t * D;
        float kv = 0.f, vv = 0.f;
        if (t0 + t < page) {
          const size_t off = (pg + t0 + t) * D + c;
          kv = to_f32(kp[off]);
          vv = to_f32(vp[off]);
        }
        k_s[t][c] = kv;
        v_s[t][c] = vv;
      }
      __syncthreads();
      for (int e = tid; e < kRows * kKeys; e += kThreads) {
        const int i = e / kKeys, t = e - i * kKeys;
        float s = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) s += q_s[i][c] * k_s[t][c];
        s *= scale;
        const int tok = (row0 + i) / rep;
        const int qpos = kvlen - qlen + tok;
        const int kpos = kbase + t;
        const bool live = i < nrows && t0 + t < page && kpos <= qpos &&
                          kpos < kvlen && tok < qlen;
        p_s[i][t] = live ? s : kNegBig;
        live_s[i][t] = live;
      }
      __syncthreads();
      if (tid < kRows) {
        const int i = tid;
        const float m_old = m_s[i];
        float m_new = m_old;
        for (int t = 0; t < kKeys; ++t) m_new = fmaxf(m_new, p_s[i][t]);
        float sum = 0.f;
        for (int t = 0; t < kKeys; ++t) {
          // explicit zero: on a fully masked row exp(s - m) would be 1
          const float p = live_s[i][t] ? expf(p_s[i][t] - m_new) : 0.f;
          p_s[i][t] = p;
          sum += p;
        }
        const float corr = expf(m_old - m_new);
        l_s[i] = l_s[i] * corr + sum;
        m_s[i] = m_new;
        corr_s[i] = corr;
      }
      __syncthreads();
      const float corr = corr_s[ai];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int c = ac + u * (kThreads / kRows);
        float a = acc[u] * corr;
#pragma unroll
        for (int t = 0; t < kKeys; ++t) a += p_s[ai][t] * v_s[t][c];
        acc[u] = a;
      }
    }
  }
  __syncthreads();
  if (ai < nrows) {
    const float l = l_s[ai];
    const float denom = l == 0.f ? 1.f : l;  // padding rows -> exact 0
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int c = ac + u * (kThreads / kRows);
      og[(size_t)ai * D + c] = from_f32<T>(acc[u] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* tbl, const int* lens, const int* qlens,
                   void* out, int R, int nkv, int Tr, int P, int page,
                   int Bmax, int rep, float scale, cudaStream_t s) {
  dim3 grid((Tr + kRows - 1) / kRows, nkv, R);
  rpa_kernel<T, D><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tbl, lens, qlens, static_cast<T*>(out), nkv,
      Tr, P, page, Bmax, rep, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (q, pools and out alike); d in {64,
// 128}.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a head
// width the kernel was not built for (the wrapper checks first).
extern "C" int rpa_launch(const void* q, const void* k_pages,
                          const void* v_pages, const void* block_tables,
                          const void* seq_lens, const void* q_lens, void* out,
                          int dtype, int R, int nkv, int Tr, int d, int P,
                          int page, int Bmax, int rep, float scale,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(seq_lens);
  const int* qlens = static_cast<const int*>(q_lens);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k_pages, v_pages, tbl, lens, qlens,
                                      out, R, nkv, Tr, P, page, Bmax, rep,
                                      scale, s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k_pages, v_pages, tbl, lens, qlens,
                                     out, R, nkv, Tr, P, page, Bmax, rep,
                                     scale, s);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k_pages, v_pages, tbl, lens, qlens, out, R,
                              nkv, Tr, P, page, Bmax, rep, scale, s);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k_pages, v_pages, tbl, lens, qlens, out, R,
                             nkv, Tr, P, page, Bmax, rep, scale, s);
  return cudaErrorInvalidValue;
}
