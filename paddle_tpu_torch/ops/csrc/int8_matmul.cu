// int8 weight matmul for Hopper: y = dequant(quant_row(x) @ w_q).
//
// Replaces paddle_tpu/ops/pallas_ops.py::_int8_matmul_kernel (the TPU
// kernel behind int8_matmul).  Same arithmetic, op for op, as the plain
// version in ops/int8_matmul.py, so the two agree bit for bit:
//   xs  = max(absmax_k |x[m,k]|, 1e-8) * float32(1/127)
//   xq  = clamp(rint(x / xs), -127, 127)             (IEEE division)
//   acc = sum_k xq[m,k] * w_q[k,n]                   (exact, int32)
//   y   = T_rn((float(acc) * xs[m]) * w_scale[n])
// Integer sums are exact and order-free, so any tiling or K split keeps
// the bits.
//
// What bounds it on this card: a call does 2*M ops per weight byte.  The
// H100 does ~590 int8 tensor-core ops per byte of HBM, so below M ~ 300
// the weight stream bounds it (decode, M = 8: one llama7b step reads
// ~6.7 GB, ~2 ms at 3.35 TB/s) and above it the tensor cores do (the
// long-context prefill, M = 512).  Both regimes run the same tensor-core
// main loop, int8 mma.sync m16n8k32 over 128-column block tiles fed by a
// cp.async ring in shared memory:
//   - The weights stay [K, N], N-contiguous, as the JAX package lays them
//     out; the int8 MMA wants B K-major and neither ldmatrix nor wgmma
//     transposes 8-bit operands.  A lane reads one 32-bit word (4
//     columns) from each of 4 consecutive k rows of the staged tile and
//     transposes the 4x4 bytes with __byte_perm: the four words are the
//     B fragments of four n8 tiles whose logical column j is physical
//     column 4j + t, so a lane's accumulators come out as 8 contiguous
//     columns.  (A block-wide transpose into a K-major copy read by
//     ldmatrix costs a second barrier a stage and measured slower.)  The
//     ring's 16-byte chunks are XOR-swizzled so these reads, and the
//     ldmatrix reads of A, hit 32 banks.  Each thread's copy addresses
//     are set up once; a stage only adds its offset.
//   - K is split over the S blocks of one thread-block cluster (S <= 8)
//     when the tiles alone do not fill the card.  Each block leaves its
//     int32 tile in shared memory, the cluster synchronises, and each
//     block sums a 1/S share of the tile over the cluster's shared
//     memories (DSMEM) and writes it through the epilogue; with S = 1 the
//     epilogue runs from the registers.  No int32 buffer in device
//     memory, no atomics, no ticket: a CUDA graph replays a call as it is.
//   - Epilogue fused: int32 sums -> * xs[m] -> * w_scale[n] -> one
//     rounding to T, written once.
//   - Quantization without a division per value: rint(x * (1 / xs)),
//     with the IEEE division only where the product lies within 1e-3 of
//     a half integer (quant1 says why that is exact).
// The two regimes differ in where A comes from:
//   - rows (prefill, M > 8): a row-quant pre-pass writes xq and xs
//     once (x is read once, not once per column tile); the GEMM, a
//     programmatic dependent launch, streams its first weight stages
//     while the pre-pass runs, then xq tiles (64 or 128 rows) through the
//     ring beside the weights.
//   - stream (decode, M <= 8; 16-row tiles): one launch.  Each block reads the rows of
//     its own K slice, takes their absmax, and the cluster exchanges
//     the slices' absmaxes over DSMEM (its blocks are exactly the K
//     slices of one column tile, so the max is the whole row's); x then
//     rides in the ring beside the weights and each stage is quantized
//     into shared memory just before its MMAs.
// The TPU kernel kept K uncut in VMEM so one grid step saw the whole
// row; here the cluster sees the whole row.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-8f;
constexpr float kInv127 = 1.0f / 127.0f;  // == float32(1 / 127)
constexpr int kBN = 128;     // output columns a block (4 warps x 32)
constexpr int kWarpsN = 4;   // warps across the block's columns
constexpr int kLdp = kBN + 4;  // int32 row stride of the partial tile
constexpr int kStreamRows = 16;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float absmax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// clamp(rint(v / s), -127, 127) as the plain version computes it (IEEE
// division, round half to even), without a division per value: with r =
// 1 / s, v * r is within 3e-5 of v / s wherever |v / s| <= 128, so the two
// round to the same integer unless the quotient lies within 1e-3 of a
// half integer; those few values take the division.
__device__ __forceinline__ uint32_t quant1(float v, float s, float r) {
  const float a = v * r;
  float q = rintf(a);
  if (fabsf(fabsf(a - q) - 0.5f) < 1e-3f) q = rintf(v / s);
  q = fminf(fmaxf(q, -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

// four values quantized and packed, element 0 in the low byte
__device__ __forceinline__ uint32_t quant4(float4 v, float s, float r) {
  return quant1(v.x, s, r) | (quant1(v.y, s, r) << 8) |
         (quant1(v.z, s, r) << 16) | (quant1(v.w, s, r) << 24);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// global -> shared copy of VEC bytes (16: .cg, 8 and 4: .ca); zero-filled when
// !ok (src is then not read)
template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  const int n = ok ? VEC : 0;
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  else if constexpr (VEC == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t a[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// c += a * b, m16n8k32, s8 x s8 -> s32 (g = lane / 4, q = lane % 4):
//   a[0] = A[g][4q..4q+3]  a[1] = A[g+8][4q..]  a[2] = A[g][16+4q..]
//   a[3] = A[g+8][16+4q..] b[0] = B[4q..4q+3][g] b[1] = B[16+4q..][g]
//   c[0..1] = C[g][2q..2q+1]                    c[2..3] = C[g+8][2q..]
__device__ __forceinline__ void mma_s8(int32_t c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// r0..r3 hold 4 columns of 4 consecutive k rows; returns in c[j] the 4
// k-values of column j, low byte first (a B fragment register).
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1,
                                             uint32_t r2, uint32_t r3,
                                             uint32_t c[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0b0 r1b0 r0b1 r1b1
  const uint32_t t1 = __byte_perm(r2, r3, 0x5140);  // r2b0 r3b0 r2b1 r3b1
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362);  // r0b2 r1b2 r0b3 r1b3
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// Shared-memory layouts (16-byte chunks, XOR-swizzled):
//   weight stage [BK rows][kBN bytes]: chunk c of row r at
//     c ^ (((r >> 2) & 3) << 1);
//   xq stage (rows regime) [BM rows][BK bytes]: c ^ ((r >> 1) & 3) at
//     BK = 64, c ^ (r & 7) at BK = 128;
__device__ __forceinline__ int b_off(int r, int c) {
  return r * kBN + ((c ^ (((r >> 2) & 3) << 1)) << 4);
}
template <int BK>
__device__ __forceinline__ int a_off(int r, int c) {
  if constexpr (BK == 64) return r * BK + ((c ^ ((r >> 1) & 3)) << 4);
  return r * BK + ((c ^ (r & 7)) << 4);
}
// The B fragments of the warp's 32 columns (band wn) for k rows
// [32 kk, 32 kk + 32) of a weight stage: b[t] for the n8 tile whose
// logical column j is the band's physical column 4j + t.
__device__ __forceinline__ void load_b(uint32_t b[4][2],
                                       const unsigned char* sb, int kk,
                                       int wn, int lane) {
  const int g = lane >> 2, q = lane & 3;
  // (r >> 2) & 3 == q for every row this lane reads
  const unsigned char* p = sb + (kk * 32 + 4 * q) * kBN +
                           (((2 * wn + (g >> 2)) ^ (q << 1)) << 4) +
                           ((g & 3) << 2);
  uint32_t r[4], c[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const uint32_t*>(p + (16 * h + i) * kBN);
    transpose4x4(r[0], r[1], r[2], r[3], c);
#pragma unroll
    for (int t = 0; t < 4; ++t) b[t][h] = c[t];
  }
}

struct Params {
  const void* x;       // [M, K] T (stream regime)
  const int8_t* xq;    // [M, K] (rows regime, from the pre-pass)
  const float* xs;     // [M]    (rows regime)
  const int8_t* w;     // [K, N]
  const float* ws;     // [N]
  void* out;           // [M, N] T
  int M, K, N;
  int kslice;          // k bytes of one split (a multiple of BK)
};

// A block's shape: WM x kWarpsN warps, each MT m16 tiles x 32 columns;
// BK-byte stages, STAGES of them in the ring.  A stage holds the weight
// tile and the A operand's rows: xq (rows regime) or x itself, in T
// (stream regime, quantized into sQ stage by stage).
template <int WM_, int MT_, int BK_, int STAGES_, bool STREAM_>
struct Cfg {
  static constexpr int WM = WM_, MT = MT_, BK = BK_;
  static constexpr int STAGES = STAGES_;
  static constexpr bool kStream = STREAM_;
  static constexpr int NT = WM * kWarpsN * 32;
  static constexpr int BM = WM * MT * 16;
  static_assert(!kStream || BM == kStreamRows, "stream tiles are 16 rows");
  template <typename T>
  __host__ __device__ static constexpr int a_stage() {
    return BM * BK * (kStream ? (int)sizeof(T) : 1);
  }
  template <typename T>
  __host__ __device__ static constexpr int stage() {
    return a_stage<T>() + BK * kBN;
  }
  // dynamic shared memory (ops/int8_matmul.py::_smem_bytes mirrors it):
  // the larger of the ring and the int32 tile, then (stream) sQ
  template <typename T>
  __host__ __device__ static constexpr int smem() {
    const int ring = STAGES * stage<T>(), part = BM * kLdp * 4;
    return (ring > part ? ring : part) + (kStream ? BM * BK : 0);
  }
};

// One block: rows [m0, m0 + BM) x columns [n0, n0 + kBN) x the k slice
// of its cluster rank.
template <class C, int VEC, typename T>
__global__ void __launch_bounds__(C::NT, C::kStream ? 3 : 2)
    gemm_kernel(Params p) {
  constexpr int NT = C::NT, BM = C::BM, BK = C::BK, MT = C::MT;
  constexpr int STAGES = C::STAGES;
  constexpr int A_STAGE = C::template a_stage<T>();
  constexpr int STAGE = C::template stage<T>();
  constexpr bool kStream = C::kStream;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float amax_s[kStreamRows], xs_s[kStreamRows], rs_s[kStreamRows];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % kWarpsN, wm = warp / kWarpsN;
  // the row tiles of one column tile are neighbours in launch order, so
  // its weight tile is read from HBM once and from L2 by the rest
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int split = (int)cluster.block_rank();  // cluster (1, 1, S)
  const int S = (int)cluster.num_blocks();
  const int k0 = split * p.kslice;
  const int kend = min(p.K, k0 + p.kslice);
  const int nk = (kend - k0 + BK - 1) / BK;
  unsigned char* ring = smem;
  unsigned char* sQ = smem + C::template smem<T>() - BM * BK;  // stream
  const T* x = static_cast<const T*>(p.x);

  // each thread copies the same chunks of every stage: chunk u is
  // i = tid + NT u of the stage, its pointers and checks set up once
  constexpr int W_PER = BK * (kBN / 16) / NT;
  constexpr int A_PER = kStream ? 1 : BM * (BK / 16) / NT;
  static_assert(W_PER * NT == BK * (kBN / 16), "weight chunks divide");
  static_assert(kStream || A_PER * NT == BM * (BK / 16), "xq chunks divide");
  const int8_t* wsrc[W_PER];
  int wdst[W_PER], wrow[W_PER], wcol[W_PER];
#pragma unroll
  for (int u = 0; u < W_PER; ++u) {
    const int i = tid + NT * u, r = i >> 3, c = i & 7;
    wrow[u] = k0 + r;
    wcol[u] = n0 + 16 * c;
    wdst[u] = b_off(r, c);
    wsrc[u] = p.w + (size_t)(k0 + r) * p.N + n0 + 16 * c;
  }
  const int8_t* asrc[A_PER];
  int adst[A_PER], acol[A_PER];
  bool arow[A_PER];
#pragma unroll
  for (int u = 0; u < (kStream ? 0 : A_PER); ++u) {
    const int i = tid + NT * u, r = i / (BK / 16), c = i % (BK / 16);
    arow[u] = m0 + r < p.M;
    acol[u] = k0 + 16 * c;
    adst[u] = a_off<BK>(r, c);
    asrc[u] = p.xq + (size_t)(m0 + r) * p.K + k0 + 16 * c;
  }

  // a stage is the A rows (xq, or x in the stream regime) and the
  // weight tile; the weights depend on no earlier kernel, so they go
  // out before griddepcontrol.wait and the A rows after it
  auto load_a = [&](int s, int ks) {
    unsigned char* st = ring + s * STAGE;
    if constexpr (kStream) {
      // x rows [0, M) x [kb, kb + BK) as they are, 8 bytes a copy
      const int kb = k0 + ks * BK;
      constexpr int R8 = BK * (int)sizeof(T) / 8;
      for (int i = tid; i < p.M * R8; i += NT) {
        const int m = i / R8, j = i % R8;
        const int k = kb + j * (8 / (int)sizeof(T));
        const bool ok = k < kend;
        cp_async<8>(smem_u32(st + m * BK * (int)sizeof(T) + 8 * j),
                    ok ? x + (size_t)m * p.K + k : x, ok);
      }
    } else {
      const uint32_t base = smem_u32(st);
#pragma unroll
      for (int u = 0; u < A_PER; ++u) {
        const int k = acol[u] + ks * BK;
        const int8_t* src = asrc[u] + ks * BK;
#pragma unroll
        for (int j = 0; j < 16; j += VEC) {
          const bool ok = arow[u] && k + j < kend;
          cp_async<VEC>(base + adst[u] + j, ok ? src + j : p.xq, ok);
        }
      }
    }
  };
  auto load_w = [&](int s, int ks) {
    const uint32_t base = smem_u32(ring + s * STAGE + A_STAGE);
    const size_t step = (size_t)ks * BK * p.N;
#pragma unroll
    for (int u = 0; u < W_PER; ++u) {
      const bool krow = wrow[u] + ks * BK < kend;
#pragma unroll
      for (int j = 0; j < 16; j += VEC) {
        const bool ok = krow && wcol[u] + j < p.N;
        cp_async<VEC>(base + wdst[u] + j, ok ? wsrc[u] + step + j : p.w, ok);
      }
    }
  };

  // groups: w0 .. w[STAGES-2], then a0 .. a[STAGES-2], then one group a
  // stage; waiting for all but the STAGES - 2 newest always covers
  // stage ks
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_w(s, s);
    cp_async_commit();
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_a(s, s);
    cp_async_commit();
  }

  if constexpr (kStream) {
    // while the first stages stream in: the absmax of each row's slice
    // (a warp a row, 16 loads a lane in flight), the max over the
    // cluster's slices (the whole row), xs and 1 / xs
    constexpr int U = 16;
    const int qw = (kend - k0) / 4;  // 4-element groups a row
    for (int m = warp; m < p.M; m += NT / 32) {
      const T* xr = x + (size_t)m * p.K + k0;
      float a = 0.f;
      for (int j0 = lane; j0 < qw; j0 += 32 * U) {
        float4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (j0 + 32 * u < qw) v[u] = load4(xr + 4 * (j0 + 32 * u));
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (j0 + 32 * u < qw) a = fmaxf(a, absmax4(v[u]));
      }
      a = warp_max(a);
      if (lane == 0) amax_s[m] = a;
    }
    cluster.sync();
    if (tid < p.M) {
      float a = 0.f;
      for (int r = 0; r < S; ++r)
        a = fmaxf(a, *cluster.map_shared_rank(amax_s + tid, r));
      xs_s[tid] = fmaxf(a, kEps) * kInv127;
      rs_s[tid] = 1.f / xs_s[tid];
    }
  }

  int32_t acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0;

  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage ks landed; stage ks - 1 and sQ free again
    if (ks + STAGES - 1 < nk) {
      load_a((ks + STAGES - 1) % STAGES, ks + STAGES - 1);
      load_w((ks + STAGES - 1) % STAGES, ks + STAGES - 1);
    }
    cp_async_commit();
    const unsigned char* st = ring + (ks % STAGES) * STAGE;
    const unsigned char* sa = st;
    if constexpr (kStream) {
      // the stage's x quantized into sQ ([16][BK] int8, the xq stage's
      // layout); rows M..15 zero
      const T* sx = reinterpret_cast<const T*>(st);
      for (int i = tid; i < kStreamRows * (BK / 4); i += NT) {
        const int r = i / (BK / 4), j = i % (BK / 4);
        const uint32_t q =
            r < p.M ? quant4(load4(sx + r * BK + 4 * j), xs_s[r], rs_s[r])
                    : 0u;
        *reinterpret_cast<uint32_t*>(sQ + a_off<BK>(r, j >> 2) +
                                     ((j & 3) << 2)) = q;
      }
      __syncthreads();
      sa = sQ;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t b[4][2];
      load_b(b, st + A_STAGE, kk, wn, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = (wm * MT + mt) * 16 + (lane & 15);
        uint32_t a[4];
        ldmatrix_x4(a, smem_u32(sa + a_off<BK>(row, 2 * kk + (lane >> 4))));
#pragma unroll
        for (int t = 0; t < 4; ++t) mma_s8(acc[mt][t], a, b[t][0], b[t][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // a lane holds columns col..col+7 of rows g, g + 8 of each m tile: the
  // value at column col + i of row g + 8 h is c[2 h + i / 4] of tile i % 4
  // (tile t's logical column j is the band's column 4 j + t)
  const int g = lane >> 2, col = wn * 32 + 8 * (lane & 3);
  auto val = [&](int mt, int h, int i) -> int32_t {
    return acc[mt][i & 3][2 * h + (i >> 2)];
  };
  T* out = static_cast<T*>(p.out);
  if (S == 1) {
    // no split: the epilogue straight from the registers
    const int n = n0 + col;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (wm * MT + mt) * 16 + g + 8 * h, m = m0 + row;
        if (m >= p.M) continue;
        const float s = kStream ? xs_s[row] : p.xs[m];
#pragma unroll
        for (int e = 0; e < 8; e += 4) {  // columns +0..3, +4..7
          if (n + e >= p.N) continue;
          const float4 w4 = *reinterpret_cast<const float4*>(p.ws + n + e);
          store4(out + (size_t)m * p.N + n + e,
                 (__int2float_rn(val(mt, h, e)) * s) * w4.x,
                 (__int2float_rn(val(mt, h, e + 1)) * s) * w4.y,
                 (__int2float_rn(val(mt, h, e + 2)) * s) * w4.z,
                 (__int2float_rn(val(mt, h, e + 3)) * s) * w4.w);
        }
      }
    return;
  }

  // split: the block's int32 tile into shared memory, the cluster
  // synchronises, and each rank sums its share over the cluster
  int32_t* P = reinterpret_cast<int32_t*>(ring);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = (wm * MT + mt) * 16 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 8; e += 4)
        *reinterpret_cast<int4*>(P + (row + 8 * h) * kLdp + col + e) =
            make_int4(val(mt, h, e), val(mt, h, e + 1), val(mt, h, e + 2),
                      val(mt, h, e + 3));
  }
  cluster.sync();

  // this rank's share of the tile, 4 columns a thread, then the epilogue
  constexpr int E = BM * (kBN / 4);
  const int e0 = split * E / S, e1 = (split + 1) * E / S;
  for (int i = e0 + tid; i < e1; i += NT) {
    const int row = i / (kBN / 4), c4 = i % (kBN / 4);
    const int m = m0 + row, n = n0 + 4 * c4;
    if (m >= p.M || n >= p.N) continue;  // N % 4 == 0: 4 columns in or out
    const int32_t* src = P + row * kLdp + 4 * c4;
    int4 v = make_int4(0, 0, 0, 0);
    for (int r = 0; r < S; ++r) {
      const int4 u =
          *reinterpret_cast<const int4*>(cluster.map_shared_rank(src, r));
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const float s = kStream ? xs_s[row] : p.xs[m];
    const float4 w4 = *reinterpret_cast<const float4*>(p.ws + n);
    // the TPU epilogue's order: (acc * xs) * ws, then one rounding to T
    store4(out + (size_t)m * p.N + n, (__int2float_rn(v.x) * s) * w4.x,
           (__int2float_rn(v.y) * s) * w4.y, (__int2float_rn(v.z) * s) * w4.z,
           (__int2float_rn(v.w) * s) * w4.w);
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// Rows regime pre-pass: one block a row writes xq[m, :] and xs[m],
// reading the row once (its values stay in registers where K <= 12288).
template <typename T>
__global__ void __launch_bounds__(256)
    row_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int K) {
  constexpr int U = 12;
  __shared__ float red[8];
  // the GEMM may launch now: it streams weights until its
  // griddepcontrol.wait, which returns once this grid has finished
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int m = blockIdx.x;
  const T* xr = x + (size_t)m * K;
  float4 v[U];
  float a = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = 4 * (threadIdx.x + 256 * u);
    if (k < K) {
      v[u] = load4(xr + k);
      a = fmaxf(a, absmax4(v[u]));
    }
  }
  for (int k = 4 * (threadIdx.x + 256 * U); k < K; k += 4 * 256)
    a = fmaxf(a, absmax4(load4(xr + k)));
  a = warp_max(a);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = a;
  __syncthreads();
  a = red[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) a = fmaxf(a, red[i]);
  const float s = fmaxf(a, kEps) * kInv127, rs = 1.f / s;
  if (threadIdx.x == 0) xs[m] = s;
  uint32_t* qr = reinterpret_cast<uint32_t*>(xq + (size_t)m * K);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = 4 * (threadIdx.x + 256 * u);
    if (k < K) qr[k / 4] = quant4(v[u], s, rs);
  }
  for (int k = 4 * (threadIdx.x + 256 * U); k < K; k += 4 * 256)
    qr[k / 4] = quant4(load4(xr + k), s, rs);
}

template <class C, int VEC, typename T>
cudaError_t launch_gemm(const Params& p, int tiles_m, int S, bool after_prepass,
                        cudaStream_t stream) {
  auto kern = gemm_kernel<C, VEC, T>;
  const size_t smem = C::template smem<T>();
  static size_t opted = 0;  // the largest size this kernel was opted into
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_m, (p.N + kBN - 1) / kBN, S);
  cfg.blockDim = dim3(C::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = S;
  // after the pre-pass: a programmatic dependent launch, so the weight
  // stages overlap the pre-pass
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = after_prepass ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kern, p);
}

// the block shapes of the plan's tile rows (16: stream; 64, 128: rows)
using StreamCfg = Cfg<1, 1, 64, 5, true>;
using Rows64Cfg = Cfg<2, 2, 64, 4, false>;
using Rows128Cfg = Cfg<2, 4, 128, 3, false>;

template <int VEC, typename T>
cudaError_t run(const Params& p, int bm, int S, cudaStream_t stream) {
  if (bm == kStreamRows)
    return launch_gemm<StreamCfg, VEC, T>(p, 1, S, false, stream);
  row_quant_kernel<T><<<p.M, 256, 0, stream>>>(
      static_cast<const T*>(p.x), const_cast<int8_t*>(p.xq),
      const_cast<float*>(p.xs), p.K);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles_m = (p.M + bm - 1) / bm;
  if (bm == 64)
    return launch_gemm<Rows64Cfg, VEC, T>(p, tiles_m, S, true, stream);
  return launch_gemm<Rows128Cfg, VEC, T>(p, tiles_m, S, true, stream);
}

template <typename T>
cudaError_t run_vec(const Params& p, int bm, int S, cudaStream_t stream) {
  // 16-byte copies need 16-byte aligned rows of w (and of xq)
  const bool v16 = p.N % 16 == 0 && p.K % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.w) % 16 == 0;
  return v16 ? run<16, T>(p, bm, S, stream) : run<4, T>(p, bm, S, stream);
}

}  // namespace

// x [M, K] (dtype 0 = float32, 1 = bfloat16), w_q [K, N] int8, w_scale
// [N] float32, out [M, N] like x.  The plan (ops/int8_matmul.py::
// _split_plan): bm = 16 runs the stream regime (M <= 16, one launch), 64
// or 128 the rows regime (the pre-pass into the caller's scratch xq [M,
// K] int8 and xs [M] float32, then the GEMM); S k splits of kslice bytes
// (a multiple of the shape's stage, 64 or 128 at bm = 128; S <= 8, every
// split non-empty).  Needs K % 4 == 0, N % 4 == 0, x, w_q
// and w_scale 16-byte aligned; the wrapper checks.  Returns
// cudaGetLastError() (or the launch's error).
extern "C" int int8_matmul_launch(const void* x, int dtype, const void* w_q,
                                  const void* w_scale, void* out, void* xq,
                                  void* xs, int M, int K, int N, int bm,
                                  int S, int kslice, void* stream) {
  Params p;
  p.x = x;
  p.xq = static_cast<const int8_t*>(xq);
  p.xs = static_cast<const float*>(xs);
  p.w = static_cast<const int8_t*>(w_q);
  p.ws = static_cast<const float*>(w_scale);
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.kslice = kslice;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? run_vec<__nv_bfloat16>(p, bm, S, s)
                 : run_vec<float>(p, bm, S, s);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
