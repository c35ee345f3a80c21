// The fused decoder blocks for Hopper: tiled bf16 GEMMs (f32
// accumulation) with an epilogue per use, and two row passes for the
// RMSNorm.  bf16 in and out; row-major everywhere.
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
//        one launch for da = dy . wd^T and g, u = xn . [wg | wu], with
//        dg = da u silu'(g), du = da silu(g) from the f32 da, g, u in its
//        epilogue (stored bf16: the tensor cores round their left operand
//        to bf16, where the reference multiplied f32 dg, du); dxn = [dg |
//        du] . [wg | wu]^T (K = 2I, f32); then a row pass for the RMSNorm
//        backward and the residual, which needs <dz, x> over the whole
//        row.
// Blocks on the card share nothing, so what the TPU carried in VMEM
// scratch across a sequential grid axis (xn, the f32 sums over heads or
// over I) is either the GEMM's own K loop or a workspace in device memory
// that the wrapper allocates.  Every output element has one writer: no
// atomics, deterministic.
//
// The GEMM main loops (every product here runs on wgmma fed by TMA):
// - gemm_tma_kernel<EPI, BMODE>: q, k, v with rope (row 7), the wo
//   product (row 8), gate/up and down (row 9), dxn (row 10).  wgmma on
//   128-row tiles: A [M, K] and B come in k steps of 64 through a 4-stage
//   ring filled by TMA: one thread of a loader warp issues the copies
//   (128-byte swizzled by the copy engine; rows >= M and columns past the
//   edge arrive as zeros) on each stage's full mbarrier and waits on its
//   empty one, so the two consumer warpgroups (64 rows each) spend no
//   instructions on loads and meet at no block barrier.  Each runs one
//   m64n256k16 a k16 step from shared memory (A K-major), one k step left
//   running while the next is issued.  B is read three ways (BMODE): a
//   [K, N] weight as stored (MN-major, four 64-column boxes; row 7 picks
//   wq, wk or wv by grid z, one launch for all three); two [K, N]
//   weights, the same 128 columns of each (g in accumulator blocks 0-15,
//   u in 16-31, so g and u of one column sit in one thread's registers
//   and the swiglu epilogue runs there; the output tile is 128 wide); or
//   a weight stored [N, K] (K-major, one box of 256 N rows), K split over
//   two weights at ksplit (wg, wu for dxn).  The residual epilogue meets
//   x in f32 through shared memory (16-byte stores); the others store
//   from registers.  Rope does too: a 256-wide tile holds whole heads (D
//   = 64 or 128 divides it), and column j of a head and its partner j +-
//   D/2 sit in one thread's accumulator blocks n and n ^ (D/16).
// - gate_up_grad_kernel: row 10's da and gate/up products, the same
//   roles and ring (3 stages) over two K loops on one 128 x 128 tile of
//   [M, I]: da (m64n128k16, wd K-major) parked in shared memory, then g, u
//   (m64n256k16, the dual B), then dg, du from registers.  It spares the
//   f32 g, u workspace a separate da launch would read back (369 MB each
//   way at the bench shape).
//
// What bounds them on this card: every product here has K >= 2048 and
// M = B S = 8192 rows at the bench shape, about 1,000 operations per byte
// of operand, so the tensor cores bound it (989 TFLOP/s bf16 dense; per
// call at the bench shape: qkv 0.208 ms, attention + wo 0.139 ms, MLP
// 0.573 ms, dx 0.955 ms).  wgmma fed by TMA is the way to that rate.
// What holds the loops below it: a block runs one tile (no persistent
// schedule, so the epilogue and the ring's fill overlap no other tile's
// products), and no cluster shares a tile's loads (a 128 x 256 tile
// reads 48 KB from L2 a k step, 87 operations a byte).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // bf16, pack_f32
#include "wgmma_bf16.cuh"

namespace {

struct Gemm {
  const bf16* a;        // A [M, K], row stride lda
  void* out[3];         // output per grid z (kRope: q, k, v; else out[0])
  const bf16* x;        // kResidual: residual [M, N], row stride ldo
  const float* sin;     // kRope: rope tables [S, D]
  const float* cos;
  int lda, ldb, ldo, M, N, K, ksplit, S, D;
};

__device__ __forceinline__ float rbf(float f) {  // round to bf16 (RN)
  return __bfloat162float(__float2bfloat16(f));
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

__device__ __forceinline__ float sigmoid(float g) {
  return 1.f / (1.f + expf(-g));
}

// dg, du from da and the f32 g, u (pallas_ops.py:1466-1470)
__device__ __forceinline__ float2 swiglu_grad(float da, float g, float u) {
  const float sg = sigmoid(g);
  return make_float2(da * u * (sg + g * sg * (1.f - sg)), da * (g * sg));
}

// ---------------------------------------------------------------------------
// the wgmma GEMM: one 128-row tile per block of two consumer warpgroups
// (64 rows each) and a loader warp, an epilogue per use
// ---------------------------------------------------------------------------

// epilogues
enum {
  kResidual,  // y = bf16(x + acc)
  kSwiglu,    // dual B: a = bf16(silu(g) u)
  kStoreF32,  // out = acc (f32)
  kRope,      // grid z = 3 over wq, wk, wv: rope on q and k (z < 2), bf16
};
// B: [K, N] as stored; two [K, N] weights, the same columns of each; or
// [N, K] as stored (K-major), K split at ksplit over two weights
enum { kKN, kKNDual, kNK };

struct Tma {
  static constexpr int kBM = 128, kBN = 256;  // kBN: the product's N
  static constexpr int kBK = 64;     // one swizzle panel of a K-major tile
  static constexpr int kStages = 4;  // ring stages
  static constexpr int kStageA = kBM * kBK, kStageB = kBK * kBN;  // bf16
  static constexpr int kStageBytes = (kStageA + kStageB) * 2;
  static constexpr int kLdC = kBN + 4;  // f32 residual tile
  static constexpr int kPipe = kStages * kStageBytes;
  static constexpr int kTile = kBM * kLdC * 4;
  static constexpr int kBars = kPipe > kTile ? kPipe : kTile;
  static constexpr int kSmem = kBars + 2 * kStages * 8;  // + mbarriers
  static constexpr int kThreads = 256 + 32;
};

// A [M, K] (K-major) comes in one 128 x 64 box a k step and B in 32 KB:
// kKN four 64 x 64 boxes of [K, N] (MN-major), kKNDual two of each of
// two maps (g's 128 columns, then u's), kNK one 256-row x 64 box of
// [N, K] (K-major; from map_b2 for k >= ksplit); kKN reads map_b,
// map_b2 or map_b3 by grid z (one map but for kRope).  One thread of the
// loader warp issues a stage's copies on its full mbarrier once both
// warpgroups have released it on its empty one.  Each warpgroup runs
// m64n256k16 wgmma from shared memory into f32 accumulators, one k step
// left running while the next is issued.
template <int EPI, int BMODE>
__global__ void __launch_bounds__(Tma::kThreads, 1)
    gemm_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_b2,
                    const __grid_constant__ CUtensorMap map_b3,
                    const Gemm p) {
  static_assert((BMODE == kKNDual) == (EPI == kSwiglu),
                "the swiglu epilogue takes a dual B");
  static_assert(EPI != kRope || BMODE == kKN, "rope reads B as stored");
  constexpr int kTileN = BMODE == kKNDual ? Tma::kBN / 2 : Tma::kBN;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = sa + Tma::kStages * Tma::kStageA;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tma::kBars);
  uint64_t* empty = full + Tma::kStages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * Tma::kBM, n0 = blockIdx.x * kTileN;
  const int nk = p.K / Tma::kBK;
  if (tid == 0) {
    for (int i = 0; i < Tma::kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 256);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 8) {  // the loader
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % Tma::kStages, k = kt * Tma::kBK;
        if (kt >= Tma::kStages)
          mbar_wait(empty + st, (kt / Tma::kStages - 1) & 1);
        mbar_expect_tx(full + st, Tma::kStageBytes);
        tma_load_2d(sa + st * Tma::kStageA, &map_a, k, m0, full + st);
        bf16* tb = sb + st * Tma::kStageB;
        if (BMODE == kNK) {
          const bool hi = k >= p.ksplit;
          tma_load_2d(tb, hi ? &map_b2 : &map_b, hi ? k - p.ksplit : k, n0,
                      full + st);
        } else {
          const CUtensorMap* mb = blockIdx.z == 0   ? &map_b
                                  : blockIdx.z == 1 ? &map_b2
                                                    : &map_b3;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            tma_load_2d(tb + i * Tma::kBK * 64,
                        BMODE == kKNDual && i >= 2 ? &map_b2 : mb,
                        n0 + 64 * (BMODE == kKNDual ? i & 1 : i), k,
                        full + st);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  float acc[Tma::kBN / 8][4];
#pragma unroll
  for (int n = 0; n < Tma::kBN / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % Tma::kStages;
    mbar_wait(full + st, (kt / Tma::kStages) & 1);  // k step kt has landed
    const bf16* ta = sa + st * Tma::kStageA;
    const bf16* tb = sb + st * Tma::kStageB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Tma::kBK / 16; ++kk) {
      const uint64_t desc_a = wgmma_desc_sw128(
          ta + sw128_off<Tma::kBM>(wg * 64, kk * 16), 0);
      if constexpr (BMODE == kNK)
        wgmma_ss<Tma::kBN, 0, 0>(
            acc, desc_a,
            wgmma_desc_sw128(tb + sw128_off<Tma::kBN>(0, kk * 16), 0));
      else
        wgmma_ss<Tma::kBN, 0, 1>(
            acc, desc_a,
            wgmma_desc_sw128(tb + sw128_off<Tma::kBK>(kk * 16, 0),
                             Tma::kBK * 128));
    }
    wgmma_commit();
    wgmma_wait<1>();  // k step kt - 1 is done: release its stage
    if (kt > 0) mbar_arrive(empty + (kt - 1) % Tma::kStages);
  }
  wgmma_wait<0>();
  wgmma_hold(acc);

  if constexpr (EPI == kResidual) {
    bar_sync(1, 256);  // both warpgroups are done: the ring takes the tile
    const int cols = min(Tma::kBN, p.N - n0);  // N: a multiple of 128
    float* cs = reinterpret_cast<float*>(smem);
    const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < Tma::kBN / 8; ++n) {
      const int c = n * 8 + c0;
      *reinterpret_cast<float2*>(cs + r0 * Tma::kLdC + c) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(cs + (r0 + 8) * Tma::kLdC + c) =
          make_float2(acc[n][2], acc[n][3]);
    }
    bar_sync(1, 256);
    for (int i = tid; i < Tma::kBM * (Tma::kBN / 8); i += 256) {
      const int r = i / (Tma::kBN / 8), c = (i % (Tma::kBN / 8)) * 8;
      const int gr = m0 + r;
      if (gr >= p.M || c >= cols) continue;
      const float4 lo =
          *reinterpret_cast<const float4*>(cs + r * Tma::kLdC + c);
      const float4 hi =
          *reinterpret_cast<const float4*>(cs + r * Tma::kLdC + c + 4);
      const size_t off = (size_t)gr * p.ldo + n0 + c;
      float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}, xv[8];
      unpack8(*reinterpret_cast<const uint4*>(p.x + off), xv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += xv[j];
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out[0]) + off) =
          pack8(v);
    }
    return;
  }

  // the other epilogues from registers: this thread's rows r, r + 8 and,
  // in each 8-column block j, the columns 8 j + c, 8 j + c + 1
  const int r0 = m0 + warp * 16 + (lane >> 2), c0 = n0 + 2 * (lane & 3);
  if constexpr (EPI == kRope) {
    // q and k: the reference's rounding, t = bf16(acc), rot =
    // rotate_half(t), out = bf16(bf16(t bf16(cos)) + bf16(rot bf16(sin)))
    // (pallas_ops.py:1146-1155); v: bf16(acc).  n0 is a multiple of D, so
    // column 8 j + c of the tile is column (8 j + c) % D of its head, and
    // its partner (+- D/2) is in block j ^ (D / 16): blocks j and j ^ 8 at
    // D 128, j and j ^ 4 at D 64, the lower half's rot negated.  Blocks j
    // and j + 16 share their columns' table entries.
    const int z = blockIdx.z;
    bf16* out = static_cast<bf16*>(z == 0 ? p.out[0]
                                   : z == 1 ? p.out[1]
                                            : p.out[2]);
    const bool wide = p.D == 128;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= p.M) continue;
      const size_t row = (size_t)(r % p.S) * p.D;
      bf16* orow = out + (size_t)r * p.ldo;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int hd = (c0 - n0 + 8 * j) & (p.D - 1);
        float2 cs = make_float2(0.f, 0.f), sn = cs;
        if (z < 2) {
          cs = __ldg(reinterpret_cast<const float2*>(p.cos + row + hd));
          sn = __ldg(reinterpret_cast<const float2*>(p.sin + row + hd));
          cs = make_float2(rbf(cs.x), rbf(cs.y));
          sn = make_float2(rbf(sn.x), rbf(sn.y));
        }
#pragma unroll
        for (int jj = j; jj < 32; jj += 16) {
          const int c = c0 + 8 * jj;
          if (c >= p.N) continue;
          float v0 = acc[jj][2 * h], v1 = acc[jj][2 * h + 1];
          if (z < 2) {
            const bool lo = wide ? (jj & 8) == 0 : (jj & 4) == 0;
            const float pr0 = wide ? acc[jj ^ 8][2 * h] : acc[jj ^ 4][2 * h];
            const float pr1 =
                wide ? acc[jj ^ 8][2 * h + 1] : acc[jj ^ 4][2 * h + 1];
            const float rot0 = lo ? -rbf(pr0) : rbf(pr0);
            const float rot1 = lo ? -rbf(pr1) : rbf(pr1);
            v0 = rbf(rbf(v0) * cs.x) + rbf(rot0 * sn.x);
            v1 = rbf(rbf(v1) * cs.y) + rbf(rot1 * sn.y);
          }
          *reinterpret_cast<uint32_t*>(orow + c) = pack_f32(v0, v1);
        }
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
    const int c = c0 + 8 * j;
    if (c >= p.N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= p.M) continue;
      const float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
      if constexpr (EPI == kSwiglu) {  // u of column c: block j + 16
        const float u0 = acc[j + 16][2 * h], u1 = acc[j + 16][2 * h + 1];
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.out[0]) +
                                     (size_t)r * p.ldo + c) =
            pack_f32(v0 * sigmoid(v0) * u0, v1 * sigmoid(v1) * u1);
      } else {  // kStoreF32
        *reinterpret_cast<float2*>(static_cast<float*>(p.out[0]) +
                                   (size_t)r * p.ldo + c) =
            make_float2(v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// row 10's da and gate/up products in one launch: da = dy . wd^T and g, u
// = xn . [wg | wu] for one 128 x 128 tile of [M, I], then dg, du from
// registers; no f32 workspace
// ---------------------------------------------------------------------------

struct Gug {
  static constexpr int kStages = 3;  // ring stages of Tma's size
  static constexpr int kPipe = kStages * Tma::kStageBytes;
  static constexpr int kStash = 128 * 128 * 4;  // da, f32
  static constexpr int kSmem = kPipe + kStash + 2 * kStages * 8;
};

// gemm_tma_kernel's ring (3 stages) and roles: the first K / 64 steps
// carry dy and 128 rows of wd (K-major; m64n128k16), the next K / 64 xn
// and the g, u columns as the dual B (m64n256k16).  Each thread parks its
// da in shared memory between the two loops, so no more than the n256
// accumulators are live at once.
__global__ void __launch_bounds__(Tma::kThreads, 1)
    gate_up_grad_kernel(const __grid_constant__ CUtensorMap map_xn,
                        const __grid_constant__ CUtensorMap map_dy,
                        const __grid_constant__ CUtensorMap map_wg,
                        const __grid_constant__ CUtensorMap map_wu,
                        const __grid_constant__ CUtensorMap map_wd,
                        const Gemm p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = sa + Gug::kStages * Tma::kStageA;
  float4* stash = reinterpret_cast<float4*>(smem + Gug::kPipe);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + Gug::kPipe + Gug::kStash);
  uint64_t* empty = full + Gug::kStages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * Tma::kBM, n0 = blockIdx.x * 128;
  const int nk = p.K / Tma::kBK;
  if (tid == 0) {
    for (int i = 0; i < Gug::kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 256);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 8) {  // the loader
    if (lane == 0) {
      for (int kt = 0; kt < 2 * nk; ++kt) {
        const int st = kt % Gug::kStages;
        const bool grad = kt < nk;
        const int k = (grad ? kt : kt - nk) * Tma::kBK;
        if (kt >= Gug::kStages)
          mbar_wait(empty + st, (kt / Gug::kStages - 1) & 1);
        bf16* ta = sa + st * Tma::kStageA;
        bf16* tb = sb + st * Tma::kStageB;
        if (grad) {
          mbar_expect_tx(full + st, 2 * Tma::kStageA * 2);
          tma_load_2d(ta, &map_dy, k, m0, full + st);
          tma_load_2d(tb, &map_wd, k, n0, full + st);
        } else {
          mbar_expect_tx(full + st, Tma::kStageBytes);
          tma_load_2d(ta, &map_xn, k, m0, full + st);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            tma_load_2d(tb + i * Tma::kBK * 64, i >= 2 ? &map_wu : &map_wg,
                        n0 + 64 * (i & 1), k, full + st);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  {
    float da[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n) da[n][0] = da[n][1] = da[n][2] = da[n][3] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % Gug::kStages;
      mbar_wait(full + st, (kt / Gug::kStages) & 1);
      const bf16* ta = sa + st * Tma::kStageA;
      const bf16* tb = sb + st * Tma::kStageB;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Tma::kBK / 16; ++kk)
        wgmma_ss<128, 0, 0>(
            da,
            wgmma_desc_sw128(ta + sw128_off<Tma::kBM>(wg * 64, kk * 16), 0),
            wgmma_desc_sw128(tb + sw128_off<128>(0, kk * 16), 0));
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0) mbar_arrive(empty + (kt - 1) % Gug::kStages);
    }
    wgmma_wait<0>();
    wgmma_hold(da);
    mbar_arrive(empty + (nk - 1) % Gug::kStages);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      stash[j * 256 + tid] = make_float4(da[j][0], da[j][1], da[j][2], da[j][3]);
  }
  float gu[32][4];
#pragma unroll
  for (int n = 0; n < 32; ++n) gu[n][0] = gu[n][1] = gu[n][2] = gu[n][3] = 0.f;
  for (int kt = nk; kt < 2 * nk; ++kt) {
    const int st = kt % Gug::kStages;
    mbar_wait(full + st, (kt / Gug::kStages) & 1);
    const bf16* ta = sa + st * Tma::kStageA;
    const bf16* tb = sb + st * Tma::kStageB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Tma::kBK / 16; ++kk)
      wgmma_ss<256, 0, 1>(
          gu,
          wgmma_desc_sw128(ta + sw128_off<Tma::kBM>(wg * 64, kk * 16), 0),
          wgmma_desc_sw128(tb + sw128_off<Tma::kBK>(kk * 16, 0),
                           Tma::kBK * 128));
    wgmma_commit();
    wgmma_wait<1>();
    if (kt > nk) mbar_arrive(empty + (kt - 1) % Gug::kStages);
  }
  wgmma_wait<0>();
  wgmma_hold(gu);

  const int I = p.ldo;
  const int r0 = m0 + warp * 16 + (lane >> 2), c0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float4 d = stash[j * 256 + tid];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, c = c0 + 8 * j;
      if (r >= p.M) continue;
      const float2 d0 = swiglu_grad(h ? d.z : d.x, gu[j][2 * h],
                                    gu[j + 16][2 * h]);
      const float2 d1 = swiglu_grad(h ? d.w : d.y, gu[j][2 * h + 1],
                                    gu[j + 16][2 * h + 1]);
      bf16* o = static_cast<bf16*>(p.out[0]) + (size_t)r * 2 * I + c;
      *reinterpret_cast<uint32_t*>(o) = pack_f32(d0.x, d1.x);
      *reinterpret_cast<uint32_t*>(o + I) = pack_f32(d0.y, d1.y);
    }
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

// Raise a kernel's dynamic shared-memory limit once, before its first
// launch (never inside a CUDA-graph capture: the first call is eager).
template <typename K>
cudaError_t smem_limit(K kernel, int bytes, bool& ready) {
  if (ready) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  ready = err == cudaSuccess;
  return err;
}

// B as the BMODE reads it: kKN b [K, N] (kRope: b, b2, b3 [K, N], one
// a grid z); kKNDual b, b2 [K, N] (N = the output columns); kNK b [N,
// ksplit] and, for k >= ksplit, b2 [N, K - ksplit]; each with row stride
// p.ldb
template <int EPI, int BMODE>
cudaError_t gemm_tma(const Gemm& p, const void* b, const void* b2,
                     const void* b3, cudaStream_t s) {
  static bool ready = false;
  cudaError_t err =
      smem_limit(gemm_tma_kernel<EPI, BMODE>, Tma::kSmem, ready);
  if (err != cudaSuccess) return err;
  CUtensorMap ma, mb, mb2, mb3;
  if ((err = tma_map_2d(&ma, p.a, p.M, p.K, p.lda, Tma::kBM)) != cudaSuccess)
    return err;
  if (BMODE == kNK) {
    if ((err = tma_map_2d(&mb, b, p.N, p.ksplit, p.ldb, Tma::kBN)) !=
            cudaSuccess ||
        (err = tma_map_2d(&mb2, b2, p.N, p.K - p.ksplit, p.ldb,
                          Tma::kBN)) != cudaSuccess)
      return err;
  } else {
    if ((err = tma_map_2d(&mb, b, p.K, p.N, p.ldb, Tma::kBK)) != cudaSuccess)
      return err;
    mb2 = mb;  // not read unless given
    if (b2 && (err = tma_map_2d(&mb2, b2, p.K, p.N, p.ldb, Tma::kBK)) !=
                  cudaSuccess)
      return err;
  }
  mb3 = mb;
  if (b3 && (err = tma_map_2d(&mb3, b3, p.K, p.N, p.ldb, Tma::kBK)) !=
                cudaSuccess)
    return err;
  constexpr int tile_n = BMODE == kKNDual ? Tma::kBN / 2 : Tma::kBN;
  dim3 grid((p.N + tile_n - 1) / tile_n, (p.M + Tma::kBM - 1) / Tma::kBM,
            EPI == kRope ? 3 : 1);
  gemm_tma_kernel<EPI, BMODE><<<grid, Tma::kThreads, Tma::kSmem, s>>>(
      ma, mb, mb2, mb3, p);
  return cudaGetLastError();
}

cudaError_t rms_norm(const void* x, const void* ln, void* xn, int M, int H,
                     float eps, cudaStream_t s) {
  rms_norm_kernel<<<M, kRowThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln),
      static_cast<bf16*>(xn), H, eps);
  return cudaGetLastError();
}

Gemm make(const void* a, int lda, int M, int K, int N) {
  Gemm p = {};
  p.a = static_cast<const bf16*>(a);
  p.lda = lda;
  p.M = M;
  p.K = K;
  p.N = N;
  p.ksplit = K;
  return p;
}

}  // namespace

// All tensors row-major and contiguous; activations [M, H] with M = B S;
// weights [in, out] as the model stores them (wq, wk, wv, wo [H, H]; wg,
// wu [H, I]; wd [I, H]); H and I multiples of 128; ln [H] bf16; sin, cos
// [S, D] f32.  Workspaces (xn [M, H] bf16, a [M, I] bf16, dgu [M, 2I]
// bf16, dxn [M, H] f32) come from the caller.  Each returns
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
  Gemm p = make(xn, H, M, H, H);  // q, k, v = xn wq, xn wk, xn wv
  p.out[0] = q;
  p.out[1] = k;
  p.out[2] = v;
  p.ldb = p.ldo = H;
  p.sin = static_cast<const float*>(sin);
  p.cos = static_cast<const float*>(cos);
  p.S = S;
  p.D = D;
  return gemm_tma<kRope, kKN>(p, wq, wk, wv, s);
}

extern "C" int fused_attn_out_launch(const void* attn, const void* wo,
                                     const void* x, void* y, int M, int H,
                                     void* stream) {
  Gemm p = make(attn, H, M, H, H);
  p.out[0] = y;
  p.x = static_cast<const bf16*>(x);
  p.ldb = p.ldo = H;
  return gemm_tma<kResidual, kKN>(p, wo, nullptr, nullptr,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int fused_mlp_fwd_launch(const void* x, const void* ln,
                                    const void* wg, const void* wu,
                                    const void* wd, void* xn, void* a,
                                    void* y, int M, int H, int I, float eps,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rms_norm(x, ln, xn, M, H, eps, s);
  if (err != cudaSuccess) return err;
  Gemm p = make(xn, H, M, H, I);  // a = silu(xn wg) * (xn wu)
  p.out[0] = a;
  p.ldb = p.ldo = I;
  err = gemm_tma<kSwiglu, kKNDual>(p, wg, wu, nullptr, s);
  if (err != cudaSuccess) return err;
  Gemm q = make(a, I, M, I, H);  // y = x + a wd
  q.out[0] = y;
  q.x = static_cast<const bf16*>(x);
  q.ldb = q.ldo = H;
  return gemm_tma<kResidual, kKN>(q, wd, nullptr, nullptr, s);
}

extern "C" int fused_mlp_bwd_dx_launch(const void* x, const void* ln,
                                       const void* wg, const void* wu,
                                       const void* wd, const void* dy,
                                       void* xn, void* dgu, void* dxn,
                                       void* dx, int M, int H, int I,
                                       float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rms_norm(x, ln, xn, M, H, eps, s);
  if (err != cudaSuccess) return err;
  // da = dy wd^T and g, u = xn [wg | wu] -> dg, du
  static bool ready = false;
  err = smem_limit(gate_up_grad_kernel, Gug::kSmem, ready);
  if (err != cudaSuccess) return err;
  CUtensorMap mxn, mdy, mwg, mwu, mwd;
  if ((err = tma_map_2d(&mxn, xn, M, H, H, Tma::kBM)) != cudaSuccess ||
      (err = tma_map_2d(&mdy, dy, M, H, H, Tma::kBM)) != cudaSuccess ||
      (err = tma_map_2d(&mwg, wg, H, I, I, Tma::kBK)) != cudaSuccess ||
      (err = tma_map_2d(&mwu, wu, H, I, I, Tma::kBK)) != cudaSuccess ||
      (err = tma_map_2d(&mwd, wd, I, H, H, 128)) != cudaSuccess)
    return err;
  Gemm p = make(xn, H, M, H, I);
  p.out[0] = dgu;
  p.ldo = I;
  dim3 grid(I / 128, (M + Tma::kBM - 1) / Tma::kBM);
  gate_up_grad_kernel<<<grid, Tma::kThreads, Gug::kSmem, s>>>(
      mxn, mdy, mwg, mwu, mwd, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  Gemm r = make(dgu, 2 * I, M, 2 * I, H);  // dxn = [dg | du] [wg | wu]^T
  r.ksplit = I;
  r.ldb = I;  // wg, wu [H, I]: B^T as stored
  r.ldo = H;
  r.out[0] = dxn;
  err = gemm_tma<kStoreF32, kNK>(r, wg, wu, nullptr, s);
  if (err != cudaSuccess) return err;
  rms_norm_bwd_kernel<<<M, kRowThreads, 0, s>>>(
      static_cast<const float*>(dxn), static_cast<const bf16*>(x),
      static_cast<const bf16*>(ln), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dx), H, eps);
  return cudaGetLastError();
}
