// Flash causal attention for Hopper: a forward kernel and a backward pair
// (dq, dk/dv), bf16 in and out, f32 accumulation on the tensor cores.
//
// Replaces paddle_tpu/ops/pallas_ops.py's six flash bodies:
//   flash_fwd      <- _flash_fwd_kernel_resident (543) and
//                     _flash_fwd_kernel_streamed (313)
//   flash_bwd_dq   <- _flash_bwd_dq_kernel_resident (609) and
//                     _flash_bwd_dq_kernel_streamed (398)
//   flash_bwd_dkv  <- _flash_bwd_dkv_kernel_resident (645) and
//                     _flash_bwd_dkv_kernel_streamed (439)
// Resident vs streamed was a TPU VMEM-capacity split; here one kernel of
// each kind serves every S >= 1 (tail rows and keys are masked).
//
// Layout: q, k, v, o, do are [B, S, H, D] contiguous, read in place
// through the row stride H*D (no [B*H, S, D] transposes); lse and delta
// are [B, H, S] f32.  D is 64 or 128.
//
//   fwd:  one block per (b*h, 64-row q tile), heaviest tiles first.  Each
//         of 4 warps owns 16 q rows; q stays in registers as mma A
//         fragments.  k/v tiles of 64 keys are staged in shared memory,
//         only up to the causal diagonal.  S = q k^T and O += P v run on
//         mma.sync m16n8k16 (bf16 x bf16 -> f32); the online-softmax
//         state (row max, row sum) lives in registers, in log2 units.
//         Writes o (bf16) and lse = m + log(l) (f32, natural log).
//   dq:   one block per (b*h, 64-row q tile); loops over k tiles up to
//         the diagonal.  delta = rowsum(do * o) is computed here, at the
//         start, for the block's rows, and written out for dkv.
//         p = exp(s*scale - lse), ds = p * (do v^T - delta), dq = ds k *
//         scale.
//   dkv:  one block per (b*h, 64-key tile); loops over 32-row q tiles
//         from the diagonal to the end, in the transposed view (rows are
//         keys): dv += p^T do, dk += ds^T q * scale.
// Every output row is owned by one block: no atomics, deterministic.
//
// What bounds it on this card: attention at S = 2048, D = 128 does ~D/2
// flops per byte of q/k/v read once, and far more per byte actually
// moved through shared memory, so it is bound by the tensor cores
// (989 TFLOP/s bf16 dense).  This first version reaches them through
// mma.sync from fragments loaded with 32-bit shared-memory reads, with
// no cp.async pipelining, no wgmma and no TMA: it is right and simple,
// not fast.  Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 64;    // fwd, dq: q rows per block (16 per warp)
constexpr int kBK = 64;    // fwd, dq: keys per staged tile (== kBQ)
constexpr int kBKV = 64;   // dkv: keys per block (16 per warp)
constexpr int kBQ2 = 32;   // dkv: q rows per staged tile
constexpr int kPad = 8;    // bf16 of padding per smem row: no bank conflicts
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegBig = -1e30f;  // finite: -inf - -inf would be NaN

// rows [row0, row0 + ROWS) of one (b, h) slice of a [B, S, H, D] tensor
// (g -> element (b, 0, h, 0), row stride ld) into smem, rows >= S zeroed
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int row0,
                                          int S, size_t ld, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      v = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(s + r * (D + kPad) + c) = v;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, int H, float scale) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [kBK][LD], first holds q
  bf16* v_s = k_s + kBK * LD;                 // [kBK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int nq = (S + kBQ - 1) / kBQ;
  const int qt = nq - 1 - (int)blockIdx.x;  // longest rows first
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const size_t ld = (size_t)H * D;
  const size_t base = (size_t)b * S * ld + (size_t)h * D;
  const int q0 = qt * kBQ;
  const int row[2] = {q0 + warp * 16 + (lane >> 2),
                      q0 + warp * 16 + (lane >> 2) + 8};

  load_tile<D, kBQ>(k_s, q + base, q0, S, ld, tid);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    load_a(qa[kk], k_s + warp * 16 * LD + kk * 16, LD, lane);
  __syncthreads();

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;

  for (int kt = 0; kt <= qt; ++kt) {  // kBK == kBQ: tile qt holds the diagonal
    const int k0 = kt * kBK;
    load_tile<D, kBK>(k_s, k + base, k0, S, ld, tid);
    load_tile<D, kBK>(v_s, v + base, k0, S, ld, tid);
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        uint32_t bf[2];
        load_b_nk(bf, k_s + n * 8 * LD + kk * 16, LD, lane);
        mma(s[n], qa[kk], bf);
      }
    }
    const bool edge = kt == qt || k0 + kBK > S;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + n * 8 + 2 * t + (i & 1);
        float x = s[n][i] * sl2;
        if (edge && (col > row[i >> 1] || col >= S)) x = kNegBig;
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(s[n][i] - mx[i >> 1]);  // masked -> 0
        s[n][i] = p;
        l[i >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bf[2];
        load_b_kn(bf, v_s + kk * 16 * LD + n * 8, LD, lane);
        mma(acc[n], pa, bf);
      }
    }
    __syncthreads();  // k_s / v_s are spent
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    if (row[r] >= S) continue;
    const float inv = 1.f / lsum;
    bf16* orow = o + base + (size_t)row[r] * ld + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_f32(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t == 0) lse[(size_t)bh * S + row[r]] = m[r] * kLn2 + logf(lsum);
  }
}

// ---------------------------------------------------------------------------
// backward: dq (and delta)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse, bf16* __restrict__ dq,
                        float* __restrict__ delta, int S, int H, float scale) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kBQ][LD]
  bf16* do_s = q_s + kBQ * LD;                // [kBQ][LD]
  bf16* k_s = do_s + kBQ * LD;                // [kBK][LD]
  bf16* v_s = k_s + kBK * LD;                 // [kBK][LD]
  __shared__ float delta_s[kBQ];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int nq = (S + kBQ - 1) / kBQ;
  const int qt = nq - 1 - (int)blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const size_t ld = (size_t)H * D;
  const size_t base = (size_t)b * S * ld + (size_t)h * D;
  const int q0 = qt * kBQ;
  const int row[2] = {q0 + warp * 16 + (lane >> 2),
                      q0 + warp * 16 + (lane >> 2) + 8};

  load_tile<D, kBQ>(q_s, q + base, q0, S, ld, tid);
  load_tile<D, kBQ>(do_s, dout + base, q0, S, ld, tid);
  __syncthreads();
  // delta = rowsum(do * o): each warp its 16 rows, lanes across D
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr, qrow = q0 + r;
    float acc = 0.f;
    if (qrow < S) {
      const bf16* orow = o + base + (size_t)qrow * ld;
      for (int c = lane; c < D; c += 32)
        acc += __bfloat162float(orow[c]) * __bfloat162float(do_s[r * LD + c]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta_s[r] = acc;
      if (qrow < S) delta[(size_t)bh * S + qrow] = acc;
    }
  }
  __syncthreads();
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = row[r] < S ? lse[(size_t)bh * S + row[r]] * kLog2e : 0.f;
    dlt[r] = delta_s[row[r] - q0];
  }

  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  const float sl2 = scale * kLog2e;
  const bf16* qw = q_s + warp * 16 * LD;
  const bf16* dow = do_s + warp * 16 * LD;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kBK;
    load_tile<D, kBK>(k_s, k + base, k0, S, ld, tid);
    load_tile<D, kBK>(v_s, v + base, k0, S, ld, tid);
    __syncthreads();

    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, qw + kk * 16, LD, lane);
      load_a(da, dow + kk * 16, LD, lane);
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        uint32_t bf[2];
        load_b_nk(bf, k_s + n * 8 * LD + kk * 16, LD, lane);
        mma(s[n], qa, bf);
        load_b_nk(bf, v_s + n * 8 * LD + kk * 16, LD, lane);
        mma(dp[n], da, bf);
      }
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + n * 8 + 2 * t + (i & 1);
        const int r = i >> 1;
        const float p = (col <= row[r] && col < S)
                            ? exp2f(s[n][i] * sl2 - lse2[r]) : 0.f;
        s[n][i] = p * (dp[n][i] - dlt[r]);  // ds
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t da[4];
      c_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bf[2];
        load_b_kn(bf, k_s + kk * 16 * LD + n * 8, LD, lane);
        mma(dqa[n], da, bf);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
    bf16* drow = dq + base + (size_t)row[r] * ld + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8) =
          pack_f32(dqa[n][2 * r] * scale, dqa[n][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                         int H, float scale) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [kBKV][LD]
  bf16* v_s = k_s + kBKV * LD;                // [kBKV][LD]
  bf16* q_s = v_s + kBKV * LD;                // [kBQ2][LD]
  bf16* do_s = q_s + kBQ2 * LD;               // [kBQ2][LD]
  __shared__ float lse_s[kBQ2], delta_s[kBQ2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int kt = blockIdx.x;  // low key tiles see the most q rows: first
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const size_t ld = (size_t)H * D;
  const size_t base = (size_t)b * S * ld + (size_t)h * D;
  const int k0 = kt * kBKV;
  const int key[2] = {k0 + warp * 16 + (lane >> 2),
                      k0 + warp * 16 + (lane >> 2) + 8};

  load_tile<D, kBKV>(k_s, k + base, k0, S, ld, tid);
  load_tile<D, kBKV>(v_s, v + base, k0, S, ld, tid);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const float sl2 = scale * kLog2e;
  const bf16* kw = k_s + warp * 16 * LD;
  const bf16* vw = v_s + warp * 16 * LD;
  const int nq2 = (S + kBQ2 - 1) / kBQ2;

  for (int j = k0 / kBQ2; j < nq2; ++j) {  // earlier q rows are masked
    const int qs0 = j * kBQ2;
    load_tile<D, kBQ2>(q_s, q + base, qs0, S, ld, tid);
    load_tile<D, kBQ2>(do_s, dout + base, qs0, S, ld, tid);
    if (tid < kBQ2) {
      const bool in = qs0 + tid < S;
      lse_s[tid] = in ? lse[(size_t)bh * S + qs0 + tid] * kLog2e : 0.f;
      delta_s[tid] = in ? delta[(size_t)bh * S + qs0 + tid] : 0.f;
    }
    __syncthreads();

    // transposed view: rows = this warp's 16 keys, columns = 32 q rows
    float st[kBQ2 / 8][4], dpt[kBQ2 / 8][4];
#pragma unroll
    for (int n = 0; n < kBQ2 / 8; ++n) {
      st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
      dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, kw + kk * 16, LD, lane);
      load_a(va, vw + kk * 16, LD, lane);
#pragma unroll
      for (int n = 0; n < kBQ2 / 8; ++n) {
        uint32_t bf[2];
        load_b_nk(bf, q_s + n * 8 * LD + kk * 16, LD, lane);
        mma(st[n], ka, bf);
        load_b_nk(bf, do_s + n * 8 * LD + kk * 16, LD, lane);
        mma(dpt[n], va, bf);
      }
    }
#pragma unroll
    for (int n = 0; n < kBQ2 / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = n * 8 + 2 * t + (i & 1), qrow = qs0 + c;
        const float p = (qrow >= key[i >> 1] && qrow < S)
                            ? exp2f(st[n][i] * sl2 - lse_s[c]) : 0.f;
        st[n][i] = p;
        dpt[n][i] = p * (dpt[n][i] - delta_s[c]);  // ds^T
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBQ2 / 16; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      c_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bf[2];
        load_b_kn(bf, do_s + kk * 16 * LD + n * 8, LD, lane);
        mma(dva[n], pa, bf);
        load_b_kn(bf, q_s + kk * 16 * LD + n * 8, LD, lane);
        mma(dka[n], da, bf);
      }
    }
    __syncthreads();  // q_s / do_s / lse_s / delta_s are spent
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= S) continue;
    bf16* krow = dk + base + (size_t)key[r] * ld + 2 * t;
    bf16* vrow = dv + base + (size_t)key[r] * ld + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8) =
          pack_f32(dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + n * 8) =
          pack_f32(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// dynamic shared memory of each kernel, in bytes
template <int D> constexpr int fwd_smem() { return 2 * kBK * (D + kPad) * 2; }
template <int D> constexpr int dq_smem() {
  return (2 * kBQ + 2 * kBK) * (D + kPad) * 2;
}
template <int D> constexpr int dkv_smem() {
  return (2 * kBKV + 2 * kBQ2) * (D + kPad) * 2;
}

// Raise each kernel's dynamic shared-memory limit once, before its first
// launch (never inside a CUDA-graph capture: the first call is eager).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int S, int H, float scale, cudaStream_t s) {
  static bool ready = false;
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, fwd_smem<D>(), &ready);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, fwd_smem<D>(), s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), S, H, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* dq, void* delta,
                   int B, int S, int H, float scale, cudaStream_t s) {
  static bool ready = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, dq_smem<D>(), &ready);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_bwd_dq_kernel<D><<<grid, kThreads, dq_smem<D>(), s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<bf16*>(dq), static_cast<float*>(delta), S, H, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int S, int H, float scale,
                    cudaStream_t s) {
  static bool ready = false;
  cudaError_t err =
      allow_smem(flash_bwd_dkv_kernel<D>, dkv_smem<D>(), &ready);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBKV - 1) / kBKV, B * H);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, dkv_smem<D>(), s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, scale);
  return cudaGetLastError();
}

}  // namespace

// All tensors bf16 [B, S, H, D] contiguous except lse and delta (f32
// [B, H, S]); d in {64, 128}.  Each returns cudaGetLastError(), or
// cudaErrorInvalidValue for a head width it was not built for (the
// wrapper checks first).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int S, int H,
                                int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128) return fwd<128>(q, k, v, o, lse, B, S, H, scale, s);
  if (d == 64) return fwd<64>(q, k, v, o, lse, B, S, H, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dq, void* delta, int B, int S, int H,
                                   int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return bwd_dq<128>(q, k, v, o, dout, lse, dq, delta, B, S, H, scale, s);
  if (d == 64)
    return bwd_dq<64>(q, k, v, o, dout, lse, dq, delta, B, S, H, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int S, int H,
                                    int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return bwd_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, s);
  if (d == 64)
    return bwd_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale, s);
  return cudaErrorInvalidValue;
}
