// The fused decoder blocks for Hopper: one tiled bf16 GEMM main loop
// (mma.sync m16n8k16, f32 accumulation) with an epilogue per use, and two
// row passes for the RMSNorm.  bf16 in and out; row-major everywhere.
//
// Replaces paddle_tpu/ops/pallas_ops.py's four fused-block bodies:
//   fused_qkv_launch        <- _qkv_fused_kernel (1130): xn = RMSNorm(x)
//        one row pass, then q, k, v = xn . wq / wk / wv in one launch
//        (grid z = 3), rope on q and k in the epilogue.
//   fused_attn_out_launch   <- the epilogue of _attn_epi_kernel (1200):
//        y = x + attn . wo, after the port's flash forward
//        (flash_attention.cu, launched by the same wrapper) has written
//        attn and lse.  The TPU summed the heads in f32 scratch along a
//        sequential grid axis; here the head sum is the GEMM's K loop.
//   fused_mlp_fwd_launch    <- _mlp_fused_kernel (1417): the row pass,
//        then [xn . wg | xn . wu] with a = bf16(silu(g) u) in the
//        epilogue (g, u in f32), then y = x + a . wd.
//   fused_mlp_bwd_dx_launch <- _mlp_bwd_dx_kernel (1444): the row pass;
//        g, u = xn . [wg | wu] (f32 workspace); da = dy . wd^T with
//        dg = da u silu'(g), du = da silu(g) in the epilogue (stored
//        bf16: the mma rounds its left operand to bf16, where the
//        reference multiplied f32 dg, du); dxn = [dg | du] . [wg | wu]^T
//        (K = 2I, f32); then a row pass for the RMSNorm backward and the
//        residual, which needs <dz, x> over the whole row.
// Blocks on the card share nothing, so what the TPU carried in VMEM
// scratch across a sequential grid axis (xn, the f32 sums over heads or
// over I) is either the GEMM's own K loop or a workspace in device memory
// that the wrapper allocates.  Every output element has one writer: no
// atomics, deterministic.
//
// The GEMM: a 128 x 128 output tile per block of 8 warps (2 x 4, each
// 64 x 32), K in steps of 32 through a 3-stage cp.async ring, fragments
// by ldmatrix (.trans for a [K, N] weight).  The f32 tile then goes
// through shared memory, where every epilogue reads whole rows of it:
// rope pairs column j with j + D/2 of its head, and the gate/up epilogues
// pair column j of g with column j of u, which a thread's own fragments
// never hold together.  B is addressed three ways: a [K, N] weight, two
// [K, N] weights side by side in N (64 columns of each per tile: g and u
// of the same columns meet in one tile), or a weight stored [N, K] with
// K split over two pointers (wg, wu for the dx product).
//
// What bounds it on this card: every product here has K >= 2048 and
// M = B S = 8192 rows at the bench shape, about 1,000 operations per byte
// of operand, so the tensor cores bound it (989 TFLOP/s bf16 dense; per
// call at the bench shape: qkv 0.208 ms, attention + wo 0.139 ms, MLP
// 0.573 ms, dx 0.955 ms).  mma.sync cannot reach that rate on Hopper
// (wgmma and TMA can), and the workspaces add device-memory round trips:
// this version is right and simple, not fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
constexpr int kThreads = 256;
constexpr int kLdA = kBK + 8;    // A tile [kBM][kLdA]: 80-byte rows
constexpr int kLdBnk = kBK + 8;  // B tile stored [n][k]
constexpr int kLdBkn = kBN + 8;  // B tile stored [k][n]: 272-byte rows
constexpr int kLdC = kBN + 4;    // f32 epilogue tile
constexpr int kStageA = kBM * kLdA;    // elements per stage
constexpr int kStageB = kBN * kLdBnk;  // >= kBK * kLdBkn
constexpr int kSmemPipe = kStages * (kStageA + kStageB) * 2;
constexpr int kSmemC = kBM * kLdC * 4;
constexpr int kSmem = kSmemPipe > kSmemC ? kSmemPipe : kSmemC;
static_assert(kStageB >= kBK * kLdBkn, "B stage too small");

// epilogues
enum {
  kRope,        // out = rope(bf16(acc)) for z < rope_z, else bf16(acc)
  kResidual,    // out = bf16(x + acc)
  kSwiglu,      // dual B: a = bf16(silu(g) * u)
  kGateUp,      // dual B: g, u -> f32 workspace
  kGateUpGrad,  // acc = da; g, u from the workspace -> dg, du (bf16)
  kStoreF32,    // out = acc (f32)
};
// B addressing
enum { kKN, kKNDual, kNK };

struct Gemm {
  const bf16* a;        // A [M, K], row stride lda
  const bf16* b[3];     // B per grid z (kKN), or its low half
  const bf16* b_hi;     // kKNDual: the u weight; kNK: B for k >= ksplit
  void* out[3];         // output per grid z
  const bf16* x;        // kResidual: residual, row stride ldo
  const float* sin;     // kRope: [S, D] tables
  const float* cos;
  float* gu;            // kGateUp / kGateUpGrad: [M, 2 ldo] f32
  int lda, ldb, ldo, ksplit, M, K, S, D, rope_z;
};

__device__ __forceinline__ float rbf(float f) {  // round to bf16 (RN)
  return __bfloat162float(__float2bfloat16(f));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void unpack8(const uint4& u, float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float v[8]) {
  uint4 u;
  u.x = pack_f32(v[0], v[1]);
  u.y = pack_f32(v[2], v[3]);
  u.z = pack_f32(v[4], v[5]);
  u.w = pack_f32(v[6], v[7]);
  return u;
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a * b, m16n8k16, row-major A, column-major B, f32 accumulators
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float sigmoid(float g) {
  return 1.f / (1.f + expf(-g));
}

// ---------------------------------------------------------------------------
// the GEMM: one 128 x 128 tile of A . B per block, then the epilogue
// ---------------------------------------------------------------------------

template <int EPI, int BMODE>
__global__ void __launch_bounds__(kThreads) gemm_kernel(const Gemm p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = sa + kStages * kStageA;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN, z = blockIdx.z;
  const bf16* b_lo = p.b[z];

  auto load_stage = [&](int stage, int k0) {
    bf16* da = sa + stage * kStageA;
    bf16* db = sb + stage * kStageB;
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i >> 2, c = (i & 3) * 8, gr = m0 + r;
      const bf16* src = p.a + (size_t)(gr < p.M ? gr : p.M - 1) * p.lda + k0 + c;
      cp_async16(da + r * kLdA + c, src, gr < p.M);
    }
    if (BMODE == kNK) {
      const bool hi = k0 >= p.ksplit;
      const bf16* bb = hi ? p.b_hi : b_lo;
      const int kk = hi ? k0 - p.ksplit : k0;
      for (int i = tid; i < kBN * (kBK / 8); i += kThreads) {
        const int r = i >> 2, c = (i & 3) * 8;
        cp_async16(db + r * kLdBnk + c,
                   bb + (size_t)(n0 + r) * p.ldb + kk + c, true);
      }
    } else {
      for (int i = tid; i < kBK * (kBN / 8); i += kThreads) {
        const int r = i >> 4, c = (i & 15) * 8;
        const bf16* src =
            BMODE == kKN
                ? b_lo + (size_t)(k0 + r) * p.ldb + n0 + c
                : (c < kBN / 2 ? b_lo : p.b_hi) + (size_t)(k0 + r) * p.ldb +
                      n0 / 2 + (c & (kBN / 2 - 1));
        cp_async16(db + r * kLdBkn + c, src, true);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int nk = p.K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; tile kt - 1's stage is free
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load_stage(nxt % kStages, nxt * kBK);
    cp_async_commit();
    const bf16* ta = sa + (kt % kStages) * kStageA;
    const bf16* tb = sb + (kt % kStages) * kStageB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], ta + (wm * 64 + mi * 16 + (lane & 15)) * kLdA +
                                kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {  // two n8 blocks per ldmatrix
        uint32_t r[4];
        if (BMODE == kNK)
          ldmatrix_x4(r, tb + (wn * 32 + nj * 16 + (lane & 7) +
                               (lane >> 4) * 8) * kLdBnk +
                             kk + ((lane >> 3) & 1) * 8);
        else
          ldmatrix_x4_trans(r, tb + (kk + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * kLdBkn +
                                   wn * 32 + nj * 16 + (lane >> 4) * 8);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is spent: its memory takes the f32 tile

  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm * 64 + mi * 16 + (lane >> 2);
      const int c = wn * 32 + ni * 8 + 2 * (lane & 3);
      *reinterpret_cast<float2*>(cs + r * kLdC + c) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(cs + (r + 8) * kLdC + c) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  __syncthreads();

  if (EPI == kSwiglu || EPI == kGateUp) {
    // tile columns [0, 64) are g, [64, 128) are u, of output columns
    // n0 / 2 + [0, 64)
    const int I = p.ldo;
    for (int i = tid; i < kBM * (kBN / 16); i += kThreads) {
      const int r = i >> 3, c = (i & 7) * 8, gr = m0 + r;
      if (gr >= p.M) continue;
      const float* crow = cs + r * kLdC;
      const size_t col = (size_t)gr * (EPI == kSwiglu ? I : 2 * I) + n0 / 2 + c;
      if (EPI == kSwiglu) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float g = crow[c + j], u = crow[c + kBN / 2 + j];
          v[j] = g * sigmoid(g) * u;
        }
        *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out[0]) + col) =
            pack8(v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; j += 4) {
          *reinterpret_cast<float4*>(p.gu + col + j) = make_float4(
              crow[c + j], crow[c + j + 1], crow[c + j + 2], crow[c + j + 3]);
          *reinterpret_cast<float4*>(p.gu + col + I + j) =
              make_float4(crow[c + 64 + j], crow[c + 65 + j],
                          crow[c + 66 + j], crow[c + 67 + j]);
        }
      }
    }
    return;
  }

  for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {
    const int r = i >> 4, c = (i & 15) * 8, gr = m0 + r;
    if (gr >= p.M) continue;
    const float* crow = cs + r * kLdC;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = crow[c + j];
    if (EPI == kStoreF32) {
      float* o = static_cast<float*>(p.out[z]) + (size_t)gr * p.ldo + n0 + c;
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
      continue;
    }
    if (EPI == kGateUpGrad) {
      // v = da; the dx kernel's f32 epilogue (pallas_ops.py:1466-1470)
      const int I = p.ldo;
      const float* g = p.gu + (size_t)gr * 2 * I + n0 + c;
      float dg[8], du[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float gj = g[j], uj = g[I + j];
        const float sg = sigmoid(gj);
        const float dsilu = sg + gj * sg * (1.f - sg);
        dg[j] = v[j] * uj * dsilu;
        du[j] = v[j] * (gj * sg);
      }
      bf16* o = static_cast<bf16*>(p.out[0]) + (size_t)gr * 2 * I + n0 + c;
      *reinterpret_cast<uint4*>(o) = pack8(dg);
      *reinterpret_cast<uint4*>(o + I) = pack8(du);
      continue;
    }
    if (EPI == kResidual) {
      float xv[8];
      unpack8(*reinterpret_cast<const uint4*>(p.x + (size_t)gr * p.ldo + n0 + c),
              xv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += xv[j];
    }
    if (EPI == kRope && z < p.rope_z) {
      // the reference's rounding: t = bf16(xn . w), rot = rotate_half(t),
      // out = t * bf16(cos) + rot * bf16(sin), each op rounded to bf16
      const int D = p.D, half = D / 2;
      const int s = gr % p.S;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c + j, hd = (n0 + col) % D;
        const float t = rbf(v[j]);
        const float rot = hd < half ? -rbf(crow[col + half])
                                    : rbf(crow[col - half]);
        const float cs_ = rbf(p.cos[(size_t)s * D + hd]);
        const float sn = rbf(p.sin[(size_t)s * D + hd]);
        v[j] = rbf(t * cs_) + rbf(rot * sn);
      }
    }
    *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out[z]) +
                              (size_t)gr * p.ldo + n0 + c) = pack8(v);
  }
}

// ---------------------------------------------------------------------------
// row passes: RMSNorm forward (xn) and backward (+ residual)
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;

// sum of a and b over the block; every thread gets both
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 part[kRowThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kRowThreads / 32; ++w) {
    t.x += part[w].x;
    t.y += part[w].y;
  }
  return t;
}

// xn = bf16(bf16(x * rsqrt(mean(x^2) + eps)) * ln), one block per row
__global__ void __launch_bounds__(kRowThreads)
    rms_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln,
                    bf16* __restrict__ xn, int H, float eps) {
  const size_t row = (size_t)blockIdx.x * H;
  float ss = 0.f;
  for (int c = threadIdx.x * 8; c < H; c += kRowThreads * 8) {
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(x + row + c), v);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += v[j] * v[j];
  }
  const float r = 1.f / sqrtf(block_sum2(ss, 0.f).x / H + eps);
  for (int c = threadIdx.x * 8; c < H; c += kRowThreads * 8) {
    float v[8], w[8];
    unpack8(*reinterpret_cast<const uint4*>(x + row + c), v);
    unpack8(*reinterpret_cast<const uint4*>(ln + c), w);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = rbf(v[j] * r) * w[j];
    *reinterpret_cast<uint4*>(xn + row + c) = pack8(v);
  }
}

// dx = bf16(dy + dz r - x <dz, x> r^3 / H) with dz = dxn * ln
// (pallas_ops.py:1480-1491), one block per row
__global__ void __launch_bounds__(kRowThreads)
    rms_norm_bwd_kernel(const float* __restrict__ dxn,
                        const bf16* __restrict__ x,
                        const bf16* __restrict__ ln,
                        const bf16* __restrict__ dy, bf16* __restrict__ dx,
                        int H, float eps) {
  const size_t row = (size_t)blockIdx.x * H;
  float ss = 0.f, inner = 0.f;
  for (int c = threadIdx.x * 8; c < H; c += kRowThreads * 8) {
    float v[8], w[8];
    unpack8(*reinterpret_cast<const uint4*>(x + row + c), v);
    unpack8(*reinterpret_cast<const uint4*>(ln + c), w);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ss += v[j] * v[j];
      inner += dxn[row + c + j] * w[j] * v[j];
    }
  }
  const float2 t = block_sum2(ss, inner);
  const float r = 1.f / sqrtf(t.x / H + eps);
  const float coef = t.y * r * r * r / H;
  for (int c = threadIdx.x * 8; c < H; c += kRowThreads * 8) {
    float v[8], w[8], g[8];
    unpack8(*reinterpret_cast<const uint4*>(x + row + c), v);
    unpack8(*reinterpret_cast<const uint4*>(ln + c), w);
    unpack8(*reinterpret_cast<const uint4*>(dy + row + c), g);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = g[j] + (dxn[row + c + j] * w[j] * r - v[j] * coef);
    *reinterpret_cast<uint4*>(dx + row + c) = pack8(v);
  }
}

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------

// Raise the kernel's dynamic shared-memory limit once, before its first
// launch (never inside a CUDA-graph capture: the first call is eager).
template <int EPI, int BMODE>
cudaError_t gemm(const Gemm& p, int N, int Z, cudaStream_t s) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<EPI, BMODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  dim3 grid(N / kBN, (p.M + kBM - 1) / kBM, Z);
  gemm_kernel<EPI, BMODE><<<grid, kThreads, kSmem, s>>>(p);
  return cudaGetLastError();
}

cudaError_t rms_norm(const void* x, const void* ln, void* xn, int M, int H,
                     float eps, cudaStream_t s) {
  rms_norm_kernel<<<M, kRowThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln),
      static_cast<bf16*>(xn), H, eps);
  return cudaGetLastError();
}

Gemm make(const void* a, int lda, int M, int K) {
  Gemm p = {};
  p.a = static_cast<const bf16*>(a);
  p.lda = lda;
  p.M = M;
  p.K = K;
  p.ksplit = K;
  return p;
}

}  // namespace

// All tensors row-major and contiguous; activations [M, H] with M = B S;
// weights [in, out] as the model stores them (wq, wk, wv, wo [H, H]; wg,
// wu [H, I]; wd [I, H]); H and I multiples of 128; ln [H] bf16; sin, cos
// [S, D] f32.  Workspaces (xn [M, H] bf16, a [M, I] bf16, gu [M, 2I] f32,
// dgu [M, 2I] bf16, dxn [M, H] f32) come from the caller.  Each returns
// the first CUDA error of its launches, or 0.

extern "C" int fused_qkv_launch(const void* x, const void* ln,
                                const void* wq, const void* wk,
                                const void* wv, const void* sin,
                                const void* cos, void* xn, void* q, void* k,
                                void* v, int M, int S, int H, int D,
                                float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rms_norm(x, ln, xn, M, H, eps, s);
  if (err != cudaSuccess) return err;
  Gemm p = make(xn, H, M, H);
  p.b[0] = static_cast<const bf16*>(wq);
  p.b[1] = static_cast<const bf16*>(wk);
  p.b[2] = static_cast<const bf16*>(wv);
  p.out[0] = q;
  p.out[1] = k;
  p.out[2] = v;
  p.ldb = p.ldo = H;
  p.sin = static_cast<const float*>(sin);
  p.cos = static_cast<const float*>(cos);
  p.S = S;
  p.D = D;
  p.rope_z = 2;  // q and k
  return gemm<kRope, kKN>(p, H, 3, s);
}

extern "C" int fused_attn_out_launch(const void* attn, const void* wo,
                                     const void* x, void* y, int M, int H,
                                     void* stream) {
  Gemm p = make(attn, H, M, H);
  p.b[0] = static_cast<const bf16*>(wo);
  p.out[0] = y;
  p.x = static_cast<const bf16*>(x);
  p.ldb = p.ldo = H;
  return gemm<kResidual, kKN>(p, H, 1, static_cast<cudaStream_t>(stream));
}

extern "C" int fused_mlp_fwd_launch(const void* x, const void* ln,
                                    const void* wg, const void* wu,
                                    const void* wd, void* xn, void* a,
                                    void* y, int M, int H, int I, float eps,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rms_norm(x, ln, xn, M, H, eps, s);
  if (err != cudaSuccess) return err;
  Gemm p = make(xn, H, M, H);  // a = silu(xn wg) * (xn wu)
  p.b[0] = static_cast<const bf16*>(wg);
  p.b_hi = static_cast<const bf16*>(wu);
  p.out[0] = a;
  p.ldb = p.ldo = I;
  err = gemm<kSwiglu, kKNDual>(p, 2 * I, 1, s);
  if (err != cudaSuccess) return err;
  Gemm q = make(a, I, M, I);  // y = x + a wd
  q.b[0] = static_cast<const bf16*>(wd);
  q.out[0] = y;
  q.x = static_cast<const bf16*>(x);
  q.ldb = q.ldo = H;
  return gemm<kResidual, kKN>(q, H, 1, s);
}

extern "C" int fused_mlp_bwd_dx_launch(const void* x, const void* ln,
                                       const void* wg, const void* wu,
                                       const void* wd, const void* dy,
                                       void* xn, void* gu, void* dgu,
                                       void* dxn, void* dx, int M, int H,
                                       int I, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rms_norm(x, ln, xn, M, H, eps, s);
  if (err != cudaSuccess) return err;
  Gemm p = make(xn, H, M, H);  // g, u = xn wg, xn wu (f32)
  p.b[0] = static_cast<const bf16*>(wg);
  p.b_hi = static_cast<const bf16*>(wu);
  p.gu = static_cast<float*>(gu);
  p.ldb = p.ldo = I;
  err = gemm<kGateUp, kKNDual>(p, 2 * I, 1, s);
  if (err != cudaSuccess) return err;
  Gemm q = make(dy, H, M, H);  // da = dy wd^T -> dg, du
  q.b[0] = static_cast<const bf16*>(wd);  // wd [I, H] is B^T
  q.gu = static_cast<float*>(gu);
  q.out[0] = dgu;
  q.ldb = H;
  q.ldo = I;
  err = gemm<kGateUpGrad, kNK>(q, I, 1, s);
  if (err != cudaSuccess) return err;
  Gemm r = make(dgu, 2 * I, M, 2 * I);  // dxn = [dg | du] [wg | wu]^T
  r.b[0] = static_cast<const bf16*>(wg);
  r.b_hi = static_cast<const bf16*>(wu);
  r.ksplit = I;
  r.out[0] = dxn;
  r.ldb = I;
  r.ldo = H;
  err = gemm<kStoreF32, kNK>(r, H, 1, s);
  if (err != cudaSuccess) return err;
  rms_norm_bwd_kernel<<<M, kRowThreads, 0, s>>>(
      static_cast<const float*>(dxn), static_cast<const bf16*>(x),
      static_cast<const bf16*>(ln), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dx), H, eps);
  return cudaGetLastError();
}
