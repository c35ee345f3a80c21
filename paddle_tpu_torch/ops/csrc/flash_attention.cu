// Flash causal attention for Hopper: a forward kernel and one backward
// (three launches: a pre-pass, the main kernel, a cast pass), bf16 in and
// out, f32 accumulation on the tensor cores.
//
// Replaces paddle_tpu/ops/pallas_ops.py's six flash bodies:
//   flash_fwd  <- _flash_fwd_kernel_resident (543) and
//                 _flash_fwd_kernel_streamed (313)
//   flash_bwd  <- _flash_bwd_dq_kernel_resident (609),
//                 _flash_bwd_dkv_kernel_resident (645) and their streamed
//                 twins (398, 439): the reference's _flash_bwd (746) as
//                 one function, (dq, dk, dv) from (q, k, v, o, lse, do)
// Resident vs streamed was a TPU VMEM-capacity split; here one kernel of
// each kind serves every S >= 1 (tail rows and keys are masked).  The
// TPU also split the backward into a dq pass and a dk/dv pass because its
// grid runs in order on one core, where a sum of dq across key tiles
// needs a second pass; on this card the key tiles' dq parts are summed
// in f32 in device memory, in key-tile order (FlashAttention-3's
// deterministic mode), so the backward does five products where the
// split did seven.
//
// Layout: q, k, v, o, do are [B, S, H, D] contiguous, read in place
// through the row stride H*D (no [B*H, S, D] transposes); lse and delta
// are [B, H, S] f32.  D is 64 or 128.
//
//   fwd:  one block per (b*h, 128-row q tile), heaviest tiles first; a
//         warpgroup (4 warps) per 64 q rows.  The q tile goes to shared
//         memory once; k and v tiles of 128 keys, only up to the causal
//         diagonal, come through a three-stage cp.async ring two tiles
//         ahead; all three are stored with the 128-byte swizzle.  Each
//         stage has two mbarriers (its copies landed; both warpgroups are
//         done with it) instead of a block barrier, so the warpgroups run
//         out of step and take turns on the tensor cores (two named
//         barriers): one's S product runs while the other does its
//         softmax.  Per key tile, two wgmma products (m64nNk16, bf16 ->
//         f32):
//           S = Q K^T (A and B from shared memory, both K-major);
//           the online softmax in registers, in log2 units (row max and
//           row sum; only the diagonal tile is masked);
//           O += P V (A = P rounded to bf16, straight from the
//           accumulators; B = V as stored, MN-major).
//         Writes o (bf16, staged through the spent q rows, 16-byte
//         stores) and lse = m + log(l) (f32, natural log).  Every output
//         element has one writer: the result is the same from run to run.
//   bwd:  1. pre-pass: delta = rowsum(do * o) in f32 (16-byte loads, D/8
//            lanes a row) and the dq turn counters zeroed, in one launch
//            (no memset: a CUDA graph replays every call).
//         2. main: one block per (b*h, key tile of 128 keys), key tile 0
//            (the one that sees the most q rows) launched first; a
//            warpgroup (4 warps) per 64 keys.  K and V stay in shared
//            memory; q, do, lse and delta come in 64-row tiles from the
//            diagonal to the end through a two-stage cp.async ring, the
//            next tile in flight while the tensor cores work on this one.
//            Per q tile, in the transposed view (rows are keys), five
//            wgmma products (m64nNk16, bf16 -> f32; B, and A where it is
//            not in registers, read by the tensor cores straight from
//            shared memory, stored with the 128-byte swizzle and named
//            by descriptors, K-major or MN-major):
//              S^T = K Q^T and dP^T = V dO^T (A and B from shared memory);
//              P^T = exp2(S^T scale log2e - lse log2e) under the mask,
//              dS^T = P^T (dP^T - delta), in registers;
//              dQ_part = dS K (A = dS^T from shared memory, read M-major;
//              each warpgroup D / 2 columns of it), added into the f32
//              accumulator in its turn (below) with 8-byte
//              red.global.add (atomicAdd(float2)) while
//              dV += P^T dO and dK += dS^T Q run (A = P^T, dS^T straight
//              from the accumulators, as registers).
//            dK (scaled) and dV stay in registers and are written once.
//         3. cast: dq = bf16(acc * scale).
// Every output is the same bits from run to run.  dk and dv have one
// writer each.  dq's parts are added in a fixed order: each (b*h, 64-row
// q tile, warpgroup) has an int32 turn counter, and key tile j, the j-th
// of the key tiles 0 .. floor(i / 2) that reach q tile i, waits until
// the counter reads j before its adds; key tile 0 stores instead of
// adding, so nothing zeroes the accumulator.  Every thread of the
// warpgroup polls (ld.acquire, one load a warp), after the dQ product is
// issued, while dV and dK run: a one-thread spin under a branch there
// made ptxas serialize the wgmma (C7518).  The next iteration's block
// barrier puts every thread's adds of q tile i before one thread's
// red.release.max, which writes j + 1.  That fence waits for the adds to
// reach L2 and holds its warpgroup's next products; it is the ordered
// sum's cost (PERF.md).  Every thread releasing instead costs 256
// same-address atomics an iteration, several times more.
// It cannot deadlock: blocks are dispatched in launch order (x = b*h
// fastest, y = key tile), so every block of key tile j - 1 was resident
// before any of key tile j; a block waits only on key tile j - 1 of its
// own b*h, that one only on j - 2, and key tile 0 on no one, so the
// oldest waiting block always has a running predecessor, at one block
// an SM (__launch_bounds__(256, 1)) or any other occupancy.
//
// What bounds it on this card: attention at S = 2048, D = 128 does ~D/2
// flops per byte of q/k/v read once, so it is bound by the tensor cores
// (989 TFLOP/s bf16 dense).  Both directions reach them through wgmma
// with operands in swizzled shared memory.  The forward pays the softmax
// between its two products of a warpgroup: the turns hide one
// warpgroup's softmax under the other's S product only, every thread
// issues copies between its products (no producer warp, no TMA), and the
// PV product of a tile is waited for before the next tile's S.
// (mma.sync from fragments was bound by its shared-memory reads in both:
// every warp re-read whole tiles.)  The backward pays besides: two block
// barriers a q tile (the tile landed; dS^T complete for dQ), the softmax
// between the products, the f32 reduction of dq (at B 4, S 2048, H 16,
// D 128: 64 heads x 272 (key, q) tile pairs x 32 KB = 0.57 GB of red
// traffic to L2) in key-tile order (a release fence and a turn a q
// tile), and the two row passes (~0.2 GB of device memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegBig = -1e30f;  // finite: -inf - -inf would be NaN

// a turn counter of the ordered dq sum, read and written at device scope
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// p = max(p, v), ordered after every memory operation before it
__device__ __forceinline__ void max_release(int* p, int v) {
  asm volatile("red.release.gpu.global.max.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// rows [row0, row0 + R) of one (b, h) slice of a [B, S, H, D] tensor (g ->
// element (b, 0, h, 0), row stride ld) into a swizzled tile, rows >= S
// zeroed; a warp copies whole 128-byte rows
template <int D, int R, int NT>
__device__ __forceinline__ void load_sw(bf16* s, const bf16* g, int row0,
                                        int S, size_t ld, int tid) {
  for (int m = tid; m < R * D / 8; m += NT) {
    const int r = m / (D / 8), cg = m - r * (D / 8);
    const bool ok = row0 + r < S;
    cp_async16(s + sw128_off<R>(r, cg * 8),
               g + (size_t)(ok ? row0 + r : 0) * ld + cg * 8, ok);
  }
}

// the operand at p read K-major, or MN-major with its panels `panel` bytes
// apart
__device__ __forceinline__ uint64_t desc_k(const bf16* p) {
  return wgmma_desc_sw128(p, 0);
}
__device__ __forceinline__ uint64_t desc_mn(const bf16* p, uint32_t panel) {
  return wgmma_desc_sw128(p, panel);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr int kFwdQ = 128;      // q rows a block, 64 a warpgroup
constexpr int kFwdK = 128;      // keys a ring stage (== kFwdQ)
constexpr int kFwdStages = 3;   // ring stages: tiles j - 1 .. j + 1
constexpr int kFwdThreads = 256;
// named barriers (0 is __syncthreads): the tensor-core turn of warpgroup
// g is 1 + g; the output staging of warpgroup g is 3 + g
constexpr int kTurnBar = 1, kStoreBar = 3;

template <int D>
struct Fwd {
  static constexpr int kStage = 2 * kFwdK * D;  // k, v (bf16)
  static constexpr int kBars = (kFwdQ * D + kFwdStages * kStage) * 2;
  static constexpr int kSmem = kBars + 2 * kFwdStages * 8;  // + mbarriers
};

// One block per (b*h, 128-row q tile); warpgroup wg owns q rows
// 64 wg .. 64 wg + 63, warp w of it 16 of them (the accumulator layout of
// wgmma_bf16.cuh).  q sits in shared memory for the block's life; k and v
// tiles of 128 keys come through a three-stage cp.async ring, two tiles
// ahead.  A stage's `full` mbarrier completes when every thread's copies
// into it have landed, its `empty` one when both warpgroups are done with
// it, so the warpgroups never meet at a block barrier and run out of
// step: they take turns on the tensor cores (named barriers), and one's
// S product runs while the other exponentiates.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, int H, float scale) {
  using C = Fwd<D>;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kFwdQ][D], swizzled
  bf16* ring = q_s + kFwdQ * D;               // stages x {k, v}
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* empty = full + kFwdStages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3, wg = warp >> 2;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;  // longest rows first
  const size_t ld = (size_t)H * D;
  const size_t base = (size_t)b * S * ld + (size_t)h * D;
  const int q0 = qt * kFwdQ;
  const int row[2] = {q0 + warp * 16 + (lane >> 2),
                      q0 + warp * 16 + (lane >> 2) + 8};
  if (tid == 0) {
    for (int i = 0; i < kFwdStages; ++i) {
      mbar_init(full + i, kFwdThreads);
      mbar_init(empty + i, kFwdThreads);
    }
  }
  __syncthreads();
  // this thread's share of k and v of key tile j (rows >= S zeroed) into
  // its stage, counted on the stage's full barrier when it lands
  auto load_kv = [&](int j) {
    bf16* ks = ring + (j % kFwdStages) * C::kStage;
    load_sw<D, kFwdK, kFwdThreads>(ks, k + base, j * kFwdK, S, ld, tid);
    load_sw<D, kFwdK, kFwdThreads>(ks + kFwdK * D, v + base, j * kFwdK, S,
                                   ld, tid);
    cp_async_mbar_arrive(full + j % kFwdStages);
  };
  load_sw<D, kFwdQ, kFwdThreads>(q_s, q + base, q0, S, ld, tid);
  load_kv(0);  // q lands with tile 0
  if (qt >= 1) load_kv(1);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;

  // warpgroup 0 takes the first turn; each turn passes to the other after
  // the S product (warpgroup 1 passes none after its last)
  if (wg == 1) bar_arrive(kTurnBar, kFwdThreads);
  for (int kt = 0; kt <= qt; ++kt) {  // kFwdK == kFwdQ: qt is the diagonal
    const int st = kt % kFwdStages, k0 = kt * kFwdK;
    mbar_wait(full + st, (kt / kFwdStages) & 1);  // tile kt has landed
    fence_async_shared();                          // ... visible to wgmma
    const bf16* k_s = ring + st * C::kStage;
    const bf16* v_s = k_s + kFwdK * D;

    // S = Q K^T: this group's 64 q rows x 128 keys
    float s[kFwdK / 8][4];
#pragma unroll
    for (int n = 0; n < kFwdK / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    bar_sync(kTurnBar + wg, kFwdThreads);  // this warpgroup's turn
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kFwdK, 0, 0>(
          s, desc_k(q_s + sw128_off<kFwdQ>(wg * 64, kk * 16)),
          desc_k(k_s + sw128_off<kFwdK>(0, kk * 16)));
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(s);
    if (wg == 0 || kt < qt) bar_arrive(kTurnBar + 1 - wg, kFwdThreads);

    // the online softmax, in log2 units; only the diagonal tile (which is
    // also the only one that can hold keys >= S) is masked
    const bool edge = kt == qt;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kFwdK / 8; ++n) {
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
    for (int n = 0; n < kFwdK / 8; ++n) {
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
    // O += P V: P (rounded to bf16) straight from the accumulators as A
    // fragments, V read as stored (keys along its rows: MN-major)
    uint32_t pa[kFwdK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kFwdK / 16; ++kk)
      c_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdK / 16; ++kk)
      wgmma_rs<D, 1>(acc, pa[kk],
                     desc_mn(v_s + sw128_off<kFwdK>(kk * 16, 0), kFwdK * 128));
    wgmma_commit();
    // tile kt + 2 into the stage tile kt - 1 held, once both warpgroups
    // are done with it
    if (kt + 2 <= qt) {
      if (kt >= 1)
        mbar_wait(empty + (kt + 2) % kFwdStages,
                  ((kt - 1) / kFwdStages) & 1);
      load_kv(kt + 2);
    }
    wgmma_wait<0>();
    wgmma_hold(acc);
#pragma unroll
    for (int kk = 0; kk < kFwdK / 16; ++kk) wgmma_hold(pa[kk]);
    mbar_arrive(empty + st);  // this thread is done with tile kt
  }
  cp_async_wait_all();

  // o = acc / l, staged through this warpgroup's rows of q's buffer (only
  // its own products read them), then 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    inv[r] = 1.f / lsum;
    if (t == 0 && row[r] < S)
      lse[(size_t)bh * S + row[r]] = m[r] * kLn2 + logf(lsum);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(
          q_s + sw128_off<kFwdQ>(row[r] - q0, n * 8 + 2 * t)) =
          pack_f32(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
  }
  bar_sync(kStoreBar + wg, 128);  // this warpgroup's 64 rows are staged
  for (int i = tid - wg * 128; i < 64 * D / 8; i += 128) {
    const int r = wg * 64 + i / (D / 8), c = (i % (D / 8)) * 8;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(o + base + (size_t)(q0 + r) * ld + c) =
          *reinterpret_cast<const uint4*>(q_s + sw128_off<kFwdQ>(r, c));
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;  // pre-pass and cast pass
constexpr int kBwdQ = 64;         // main: q rows a ring stage
constexpr int kBwdKV = 128;       // main: keys a block, 64 a warpgroup
constexpr int kBwdStages = 2;     // main: ring stages

// 1. delta = rowsum(do * o) in f32, and the n_turns dq turn counters
// zeroed: D / 8 lanes a row of [B, S, H, D], 16 bytes each, rows in
// memory order (r = (b S + s) H + h)
template <int D>
__global__ void __launch_bounds__(kRowThreads)
    flash_bwd_prep_kernel(const bf16* __restrict__ o,
                          const bf16* __restrict__ dout,
                          float* __restrict__ delta, int* __restrict__ turns,
                          int n_turns, int R, int S, int H) {
  constexpr int L = D / 8;
  const int i = blockIdx.x * kRowThreads + threadIdx.x;
  for (int t = i; t < n_turns; t += gridDim.x * kRowThreads) turns[t] = 0;
  const int r = i / L, c = (i - r * L) * 8;
  float acc = 0.f;
  if (r < R) {
    const size_t off = (size_t)r * D + c;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + off);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(a2[j]);
      const float2 y = __bfloat1622float2(b2[j]);
      acc += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)  // within the row's L lanes
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < R && c == 0) {
    const int h = r % H, bs = r / H, s = bs % S, b = bs / S;
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

// 2. the main kernel.  A warpgroup (4 warps) owns 64 keys, 16 a warp, and
// runs every product as wgmma m64nNk16 with B from shared memory: K, V,
// q, do and dS^T are stored with the 128-byte swizzle, read K-major or
// MN-major through descriptors.  P^T and dS^T are A operands
// straight from the accumulators (the mma.sync A layout, block by block).
template <int D>
struct Bwd {
  static constexpr int kGroups = kBwdKV / 64;     // warpgroups, 64 keys each
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kDQ = D / kGroups;         // dq columns a warpgroup
  static constexpr int kStage = 2 * kBwdQ * D;    // q, do (bf16)
  static constexpr int kSmem =
      (2 * kBwdKV * D + kBwdStages * kStage + kBwdKV * kBwdQ) * 2 +
      kBwdStages * 2 * kBwdQ * 4;                 // + lse, delta (f32)
};

template <int D>
__global__ void __launch_bounds__(Bwd<D>::kThreads, 1)
    flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq_acc, int* __restrict__ turns,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                     int H, float scale) {
  using C = Bwd<D>;
  constexpr int NT = C::kThreads;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);   // [kBwdKV][D], swizzled
  bf16* v_s = k_s + kBwdKV * D;                // [kBwdKV][D]
  bf16* ring = v_s + kBwdKV * D;               // stages x {q, do}
  bf16* ds_s = ring + kBwdStages * C::kStage;  // [kBwdKV][kBwdQ]: dS^T
  float* rows_s =
      reinterpret_cast<float*>(ds_s + kBwdKV * kBwdQ);  // lse, delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, w = warp & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * kBwdKV;  // key tile 0 sees the most q rows
  const size_t ld = (size_t)H * D;
  const size_t base = (size_t)b * S * ld + (size_t)h * D;
  const float* lse_bh = lse + (size_t)bh * S;
  const float* delta_bh = delta + (size_t)bh * S;
  const int j0 = k0 / kBwdQ;  // q tiles before j0 see none of these keys
  const int n_q = (S + kBwdQ - 1) / kBwdQ, n_it = n_q - j0;
  // this key tile's rank among those that reach any of its q tiles, and
  // the turn counter of this warpgroup's columns of q tile j
  const int kt = blockIdx.y;
  auto turn_at = [&](int j) {
    return turns + ((size_t)bh * n_q + j) * C::kGroups + wg;
  };
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  // K and V of the tile (rows >= S zeroed), resident for the block
  load_sw<D, kBwdKV, NT>(k_s, k + base, k0, S, ld, tid);
  load_sw<D, kBwdKV, NT>(v_s, v + base, k0, S, ld, tid);
  // q, do, lse and delta of q tile j into ring stage st (rows >= S zeroed)
  auto load_q = [&](int st, int j) {
    bf16* qs = ring + st * C::kStage;
    const int q0 = j * kBwdQ;
    load_sw<D, kBwdQ, NT>(qs, q + base, q0, S, ld, tid);
    load_sw<D, kBwdQ, NT>(qs + kBwdQ * D, dout + base, q0, S, ld, tid);
    float* rs = rows_s + st * 2 * kBwdQ;
    for (int i = tid; i < 2 * kBwdQ; i += NT) {
      const int r = i & (kBwdQ - 1);
      const bool ok = q0 + r < S;
      cp_async4(rs + i, (i < kBwdQ ? lse_bh : delta_bh) + (ok ? q0 + r : 0),
                ok);
    }
  };
  load_q(0, j0);
  cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const float sl2 = scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kBwdStages, jq = j0 + it, q0 = jq * kBwdQ;
    cp_async_wait<0>();    // this thread's copies of tile it have landed
    fence_async_shared();  // ... visible to wgmma
    __syncthreads();       // ... every thread's; iteration it - 1 is done
    // q tile jq - 1's dq adds, every thread's (the barrier), passed to
    // the next key tile by one thread a warpgroup
    if (it > 0 && (tid & 127) == 0) max_release(turn_at(jq - 1), kt + 1);
    // the next tile into the stage iteration it - 1 read
    if (it + 1 < n_it) load_q((it + 1) % kBwdStages, jq + 1);
    cp_async_commit();
    const bf16* q_s = ring + st * C::kStage;
    const bf16* do_s = q_s + kBwdQ * D;
    const float* lse_s = rows_s + st * 2 * kBwdQ;
    const float* dl_s = lse_s + kBwdQ;

    // S^T = K Q^T and dP^T = V dO^T: this group's 64 keys x 64 q rows
    float s[kBwdQ / 8][4], dp[kBwdQ / 8][4];
#pragma unroll
    for (int n = 0; n < kBwdQ / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    wgmma_hold(s);
    wgmma_hold(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kBwdQ, 0, 0>(
          s, desc_k(k_s + sw128_off<kBwdKV>(wg * 64, kk * 16)),
          desc_k(q_s + sw128_off<kBwdQ>(0, kk * 16)));
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kBwdQ, 0, 0>(
          dp, desc_k(v_s + sw128_off<kBwdKV>(wg * 64, kk * 16)),
          desc_k(do_s + sw128_off<kBwdQ>(0, kk * 16)));
    wgmma_commit();
    wgmma_wait<1>();  // S^T is in; dP^T may still be running
    wgmma_hold(s);
    // P^T under the causal mask (rows >= S too)
    const bool edge = q0 < k0 + kBwdKV || q0 + kBwdQ > S;
#pragma unroll
    for (int n = 0; n < kBwdQ / 8; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qrow = q0 + c + (i & 1);
        float p = exp2f(s[n][i] * sl2 - ((i & 1) ? l2.y : l2.x) * kLog2e);
        if (edge && (qrow < key[i >> 1] || qrow >= S)) p = 0.f;
        s[n][i] = p;
      }
    }
    wgmma_wait<0>();
    wgmma_hold(dp);
    // dS^T = P^T (dP^T - delta); to registers as A fragments (bf16, as the
    // products take them) and to shared memory for dQ
    uint32_t pa[kBwdQ / 16][4], da[kBwdQ / 16][4];
#pragma unroll
    for (int n = 0; n < kBwdQ / 8; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(dl_s + n * 8 + 2 * t);
      dp[n][0] = s[n][0] * (dp[n][0] - d2.x);
      dp[n][1] = s[n][1] * (dp[n][1] - d2.y);
      dp[n][2] = s[n][2] * (dp[n][2] - d2.x);
      dp[n][3] = s[n][3] * (dp[n][3] - d2.y);
    }
#pragma unroll
    for (int kk = 0; kk < kBwdQ / 16; ++kk) {
      c_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
      c_to_a(da[kk], dp[2 * kk], dp[2 * kk + 1]);
      const int r = warp * 16 + g, c = kk * 16 + 2 * t;
      *reinterpret_cast<uint32_t*>(ds_s + sw128_off<kBwdKV>(r, c)) =
          da[kk][0];
      *reinterpret_cast<uint32_t*>(ds_s + sw128_off<kBwdKV>(r + 8, c)) =
          da[kk][1];
      *reinterpret_cast<uint32_t*>(ds_s + sw128_off<kBwdKV>(r, c + 8)) =
          da[kk][2];
      *reinterpret_cast<uint32_t*>(ds_s + sw128_off<kBwdKV>(r + 8, c + 8)) =
          da[kk][3];
    }
    fence_async_shared();  // the dS^T stores, for the dQ product
    __syncthreads();       // dS^T of all kBwdKV keys is in shared memory
    // dQ_part = dS K over the kBwdKV keys (A = dS^T read M-major): this
    // group's columns wg * kDQ .., warp w's rows w * 16 ..; then dV += P^T
    // dO and dK += dS^T Q (K = the tile's q rows: MN-major B), running while
    // dQ is summed into dq_acc
    float qa[C::kDQ / 8][4];
#pragma unroll
    for (int n = 0; n < C::kDQ / 8; ++n)
      qa[n][0] = qa[n][1] = qa[n][2] = qa[n][3] = 0.f;
    wgmma_hold(qa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdKV / 16; ++kk)
      wgmma_ss<C::kDQ, 1, 1>(
          qa, desc_mn(ds_s + sw128_off<kBwdKV>(kk * 16, 0), kBwdKV * 128),
          desc_mn(k_s + sw128_off<kBwdKV>(kk * 16, wg * C::kDQ),
                  kBwdKV * 128));
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kBwdQ / 16; ++kk) {
      wgmma_rs<D, 1>(dva, pa[kk],
                     desc_mn(do_s + sw128_off<kBwdQ>(kk * 16, 0), kBwdQ * 128));
      wgmma_rs<D, 1>(dka, da[kk],
                     desc_mn(q_s + sw128_off<kBwdQ>(kk * 16, 0), kBwdQ * 128));
    }
    wgmma_commit();
    // this warpgroup's turn at q tile jq: key tiles 0 .. kt - 1 have
    // added theirs (every thread polls the one counter, a load a warp, so
    // no branch splits the warpgroup while dQ, dV, dK run)
    if (kt > 0)
      while (ld_acquire(turn_at(jq)) < kt) {
      }
    wgmma_wait<1>();  // dQ
    wgmma_hold(qa);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qrow = q0 + w * 16 + g + 8 * r;
      if (qrow >= S) continue;
      float* dst = dq_acc + base + (size_t)qrow * ld + wg * C::kDQ + 2 * t;
#pragma unroll
      for (int n = 0; n < C::kDQ / 8; ++n) {
        const float2 part = make_float2(qa[n][2 * r], qa[n][2 * r + 1]);
        if (kt == 0)
          *reinterpret_cast<float2*>(dst + n * 8) = part;
        else
          atomicAdd(reinterpret_cast<float2*>(dst + n * 8), part);
      }
    }
    wgmma_wait<0>();  // dV, dK
    wgmma_hold(dva);
    wgmma_hold(dka);
#pragma unroll
    for (int kk = 0; kk < kBwdQ / 16; ++kk) {
      wgmma_hold(pa[kk]);
      wgmma_hold(da[kk]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the last q tile's adds, every thread's
  if ((tid & 127) == 0) max_release(turn_at(n_q - 1), kt + 1);

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

// 3. dq = bf16(acc * scale), 8 values a thread
__global__ void __launch_bounds__(kRowThreads)
    flash_bwd_cast_kernel(const float* __restrict__ acc,
                          bf16* __restrict__ dq, size_t n8, float scale) {
  const size_t i = (size_t)blockIdx.x * kRowThreads + threadIdx.x;
  if (i >= n8) return;
  const float4 a = reinterpret_cast<const float4*>(acc)[2 * i];
  const float4 c = reinterpret_cast<const float4*>(acc)[2 * i + 1];
  reinterpret_cast<uint4*>(dq)[i] = make_uint4(
      pack_f32(a.x * scale, a.y * scale), pack_f32(a.z * scale, a.w * scale),
      pack_f32(c.x * scale, c.y * scale), pack_f32(c.z * scale, c.w * scale));
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
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, Fwd<D>::kSmem, &ready);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + kFwdQ - 1) / kFwdQ);
  flash_fwd_kernel<D><<<grid, kFwdThreads, Fwd<D>::kSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), S, H, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* dq, void* dk,
                void* dv, void* delta, void* dq_acc, void* turns, int B,
                int S, int H, float scale, cudaStream_t s) {
  using C = Bwd<D>;
  static bool ready = false;
  cudaError_t err = allow_smem(flash_bwd_kernel<D>, C::kSmem, &ready);
  if (err != cudaSuccess) return err;
  const int R = B * S * H, rows = kRowThreads / (D / 8);
  const int n_turns = B * H * ((S + kBwdQ - 1) / kBwdQ) * C::kGroups;
  flash_bwd_prep_kernel<D><<<(R + rows - 1) / rows, kRowThreads, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), static_cast<int*>(turns), n_turns, R, S,
      H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dim3 grid(B * H, (S + kBwdKV - 1) / kBwdKV);
  flash_bwd_kernel<D><<<grid, C::kThreads, C::kSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_acc), static_cast<int*>(turns),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t n8 = (size_t)R * D / 8;
  flash_bwd_cast_kernel<<<(unsigned)((n8 + kRowThreads - 1) / kRowThreads),
                          kRowThreads, 0, s>>>(
      static_cast<const float*>(dq_acc), static_cast<bf16*>(dq), n8, scale);
  return cudaGetLastError();
}

}  // namespace

// All tensors bf16 [B, S, H, D] contiguous except lse and delta (f32
// [B, H, S]); d in {64, 128}.  Each returns cudaGetLastError(), or
// cudaErrorInvalidValue for a head width it was not built for
// (the wrapper checks first).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int S, int H,
                                int d, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128) return fwd<128>(q, k, v, o, lse, B, S, H, scale, s);
  if (d == 64) return fwd<64>(q, k, v, o, lse, B, S, H, scale, s);
  return cudaErrorInvalidValue;
}

// The backward's three launches.  delta ([B, H, S] f32), dq_acc ([B, S,
// H, D] f32) and turns (int32, B H ceil(S / 64) 2: a (b*h, 64-row q tile,
// warpgroup) each) are workspaces the wrapper allocates, uninitialised:
// the pre-pass writes delta and zeroes turns, key tile 0 writes dq_acc.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* dq, void* dk, void* dv,
                                void* delta, void* dq_acc, void* turns, int B,
                                int S, int H, int d, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return bwd<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, dq_acc, turns,
                    B, S, H, scale, s);
  if (d == 64)
    return bwd<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, dq_acc, turns,
                   B, S, H, scale, s);
  return cudaErrorInvalidValue;
}
