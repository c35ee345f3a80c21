// Ragged paged attention for Hopper: one kernel for a mixed batch of
// prefill chunks and decode tokens over block-table paged K/V pools,
// built twice from one body: over dense pools (bf16 / f32 pages) and
// over int8 pools with one f32 dequant scale per (kv head, page).
//
// Replaces paddle_tpu/ops/pallas_ops.py::_rpa_kernel (dense pools,
// entry rpa_launch) and ::_rpa_kernel_quant (int8 pools, entry
// rpa_quant_launch).  Layout, as at the public function:
//   q            [R, nkv, Tr, d]  Tr = Tc * rep; row t*rep + j is q head
//                                 h*rep + j of token t (GQA)
//   k/v pools    [nkv, P, page, d]
//   k/v scales   [nkv, P] f32     (int8 pools only) page (h, p) holds
//                                 int8 values v with k = v * scale[h, p]
//   block_tables [R, Bmax] int32  pool page of logical kv block j
//   seq_lens     [R] int32        kv length including this chunk
//   q_lens       [R] int32        tokens in this chunk (0 = empty slot)
//
// The TPU kernel walked the pages on a sequential grid axis and carried
// the online-softmax state in VMEM scratch from one grid step to the
// next; the quantized variant took the scales as prefetched SMEM
// scalars.  Here one block owns (request r, kv head h, 16 q rows) and
// walks the pages in a loop, with the state in shared memory and
// registers, and loads each page's scales itself through the block
// table:
//   for each page j with j*page < kvlen and j*page <= horizon:
//     phys = block_tables[r, j]; stage 16 keys and values in smem as
//     f32 (int8 pages: 16 bytes a thread, times the page's scale --
//     scale first, dot second, the reference's order)
//     s = q.k * scale, masked (kpos <= qpos, kpos < kvlen, tok < qlen)
//     to -1e30; online softmax with p zeroed explicitly on masked keys
//   rows whose running sum l is 0 (padding) are written as exact zeros;
//   a slot with q_len == 0 writes zeros and reads no page.
// Pages past kvlen and past the tile's causal horizon are never loaded
// (the reference's skip predicate), nor are their scales.  Everything
// is computed in fp32 and rounded once to q's dtype.
//
// What bounds it on this card: each page is read once per (r, h) block
// and does ~4*d flops per key per q row, so at decode (one q row per kv
// head) it is bound by the bytes of the pages it reads (3.35 TB/s):
// 2 bytes per K/V element for bf16 pools, 1 for int8 plus 8 bytes of
// scales per (head, page) -- half the bytes.  Skipping pages past kvlen
// and past the horizon keeps those bytes to what the batch needs.
// Nothing is tuned yet: one block walks all of a request's pages in
// turn (a long context is a long serial loop on one SM), dense keys
// load one element per thread, and the dot products run on the fp32
// cores from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegBig = -1e30f;  // finite: -inf would NaN masked rows
constexpr int kRows = 16;          // q rows per block
constexpr int kKeys = 16;          // keys staged per smem tile
constexpr int kThreads = 128;
constexpr int kVec = 16;           // int8 values per 16-byte load

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

// Stage keys [t0, t0 + kKeys) of the page starting at row pg into
// k_s / v_s as f32; rows past the page end are zeros.
template <typename KV, int D>
__device__ __forceinline__ void stage_tile(const KV* __restrict__ kp,
                                           const KV* __restrict__ vp,
                                           size_t pg, int t0, int page,
                                           float ksc, float vsc,
                                           float (*k_s)[D + 1],
                                           float (*v_s)[D + 1], int tid) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    constexpr int kPerRow = D / kVec;
    for (int i = tid; i < kKeys * kPerRow; i += kThreads) {
      const int t = i / kPerRow, c0 = (i - t * kPerRow) * kVec;
      int4 kw = make_int4(0, 0, 0, 0), vw = kw;
      if (t0 + t < page) {
        const size_t off = (pg + t0 + t) * D + c0;  // 16-byte aligned
        kw = *reinterpret_cast<const int4*>(kp + off);
        vw = *reinterpret_cast<const int4*>(vp + off);
      }
      const int8_t* kb = reinterpret_cast<const int8_t*>(&kw);
      const int8_t* vb = reinterpret_cast<const int8_t*>(&vw);
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        k_s[t][c0 + u] = static_cast<float>(kb[u]) * ksc;
        v_s[t][c0 + u] = static_cast<float>(vb[u]) * vsc;
      }
    }
  } else {
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
  }
}

// T: q / out dtype; KV: pool dtype (T, or int8_t with k_sc / v_sc)
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
    rpa_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
               const KV* __restrict__ vp, const float* __restrict__ k_sc,
               const float* __restrict__ v_sc, const int* __restrict__ tbl,
               const int* __restrict__ seq_lens,
               const int* __restrict__ q_lens, T* __restrict__ out, int nkv,
               int Tr, int P, int page, int Bmax, int rep, float scale) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
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
    const int phys = tbl[(size_t)r * Bmax + j];
    const size_t pg = (head_base + phys) * page;
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {
      ksc = k_sc[head_base + phys];
      vsc = v_sc[head_base + phys];
    }
    for (int t0 = 0; t0 < page; t0 += kKeys) {
      const int kbase = j * page + t0;
      if (kbase >= kvlen || kbase > horizon) break;
      __syncthreads();  // the previous tile's k_s / v_s / p_s are spent
      stage_tile<KV, D>(kp, vp, pg, t0, page, ksc, vsc, k_s, v_s, tid);
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

template <typename T, typename KV, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ksc, const float* vsc, const int* tbl,
                   const int* lens, const int* qlens, void* out, int R,
                   int nkv, int Tr, int P, int page, int Bmax, int rep,
                   float scale, cudaStream_t s) {
  dim3 grid((Tr + kRows - 1) / kRows, nkv, R);
  rpa_kernel<T, KV, D><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), ksc, vsc, tbl, lens, qlens,
      static_cast<T*>(out), nkv, Tr, P, page, Bmax, rep, scale);
  return cudaGetLastError();
}

// q / out dtype 0 = float32, 1 = bfloat16; pools KV (the q dtype, or
// int8_t); d in {64, 128}.
template <typename KV, bool kSameAsQ>
int dispatch(int dtype, int d, const void* q, const void* kp,
             const void* vp, const float* ksc, const float* vsc,
             const int* tbl, const int* lens, const int* qlens, void* out,
             int R, int nkv, int Tr, int P, int page, int Bmax, int rep,
             float scale, cudaStream_t s) {
#define RPA_CASE(DT, T, DIM)                                                  \
  if (dtype == DT && d == DIM)                                               \
    return launch<T, typename std::conditional<kSameAsQ, T, KV>::type, DIM>( \
        q, kp, vp, ksc, vsc, tbl, lens, qlens, out, R, nkv, Tr, P, page,     \
        Bmax, rep, scale, s);
  RPA_CASE(1, __nv_bfloat16, 128)
  RPA_CASE(1, __nv_bfloat16, 64)
  RPA_CASE(0, float, 128)
  RPA_CASE(0, float, 64)
#undef RPA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Dense pools of q's dtype.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a dtype / head width the kernel was not
// built for (the wrapper checks first).
extern "C" int rpa_launch(const void* q, const void* k_pages,
                          const void* v_pages, const void* block_tables,
                          const void* seq_lens, const void* q_lens, void* out,
                          int dtype, int R, int nkv, int Tr, int d, int P,
                          int page, int Bmax, int rep, float scale,
                          void* stream) {
  return dispatch<void, true>(
      dtype, d, q, k_pages, v_pages, nullptr, nullptr,
      static_cast<const int*>(block_tables),
      static_cast<const int*>(seq_lens), static_cast<const int*>(q_lens),
      out, R, nkv, Tr, P, page, Bmax, rep, scale,
      static_cast<cudaStream_t>(stream));
}

// int8 pools with f32 scales [nkv, P]; q / out of dtype.  The pools'
// base pointers must be 16-byte aligned (the wrapper checks).
extern "C" int rpa_quant_launch(const void* q, const void* k_pages,
                                const void* v_pages, const void* k_scales,
                                const void* v_scales,
                                const void* block_tables,
                                const void* seq_lens, const void* q_lens,
                                void* out, int dtype, int R, int nkv, int Tr,
                                int d, int P, int page, int Bmax, int rep,
                                float scale, void* stream) {
  return dispatch<int8_t, false>(
      dtype, d, q, k_pages, v_pages, static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(seq_lens), static_cast<const int*>(q_lens),
      out, R, nkv, Tr, P, page, Bmax, rep, scale,
      static_cast<cudaStream_t>(stream));
}
