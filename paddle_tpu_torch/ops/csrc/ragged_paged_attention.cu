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
// What it computes, for every q row: softmax(q.k * d^-1/2) v over the
// keys kpos < kvlen with kpos <= qpos = kvlen - qlen + token, in f32,
// rounded once to q's dtype; rows of padding tokens and empty slots are
// exact zeros.  No page past kvlen or past a tile's causal horizon (the
// key its last real row may see) is read, nor its scale; the null page
// (0) is never read.
//
// What bounds it on this card.  At decode (one q row per kv head, or rep
// rows under GQA) each key costs ~4 d flops per row against 2 d bytes of
// bf16 K and V (d of int8): it is bound by the bytes of the visible
// pages, 3.35 TB/s.  At the long-context cell's chunk-64 prefill steps a
// tile of 64 q rows does 64 times the flops on the same bytes, ~64 flops
// a byte: still under the bf16 tensor cores' ~295, but three times over
// the f32 cores' ~20 (67 TFLOP/s), so on the CUDA cores it would be bound
// by the operations; on the tensor cores it is bound by the bytes again.
// The TPU kernel walked a request's pages on a sequential grid axis; a
// literal port (one block walking all of a request's pages) keeps one SM
// busy on a 2048-token context while most of the card idles, and never
// has more than one page in flight.  So:
//
// 1. Split the page walk over blocks (flash decoding).  The grid is
//    (S, nkv, R * row tiles).  Split s of a (request, head, tile) owns
//    pages [s*n/S, (s+1)*n/S) of the n pages the tile may see, which the
//    block computes from seq_lens and the tile's horizon, so short
//    requests spread too and no split reads past kvlen.  S comes from
//    shapes only (the wrapper's _split_plan: several blocks per SM).
//    Each split writes (m, l, acc) to an f32 workspace; the last of the S
//    blocks to finish (an atomic ticket after __threadfence, the counter
//    reset by that block so CUDA-graph replay finds it at 0) combines
//    them in the same launch.  A split that sees no key has l = 0 and
//    weighs nothing; a row with l = 0 everywhere is written as 0.  With
//    S = 1 the block writes the output directly.
// 2. Row tiles of at most 16 rows (decode, GQA decode, Tc = 8 chunks,
//    and every f32 q) run rpa_rows_kernel: warps own 8-key chunks of the
//    split, lanes hold 16-byte slices of a key row, q stays in registers
//    (pre-scaled into log2 units), q.k is reduced with warp shuffles, and
//    each warp keeps its online softmax in registers with no block
//    barrier per tile; the four warps merge (m, l, acc) once, at the end,
//    through shared memory.  The tile has as many rows as the call has
//    (a power of two), so a decode row does no padding work.
// 3. Pages in flight: every page is read 16 bytes a thread with
//    cp.async into a ring in dynamic shared memory (rows kernel: 4 stages
//    of 8 keys a warp, 64 KB a block over bf16 pages, so 3 blocks keep
//    ~144 KB in flight on an SM where ~25 KB covers HBM latency; mma
//    kernel: 3 stages of 64 keys), and a block loads its split's
//    block-table entries and scales into shared memory before the
//    first page.
// 4. Tiles of more than 16 bf16 rows (chunk-64 prefill, GQA chunks) run
//    rpa_mma_kernel: 64 q rows a block, 16 a warp, q.k^T and p.v as
//    mma.sync m16n8k16 bf16 -> f32 (mma_bf16.cuh, shared with
//    flash_attention.cu).  int8 pages are exact in bf16: each int8 stage
//    is widened to bf16 once a tile for all four warps, a key's K scale
//    multiplies its score column after the product, and its V scale is
//    folded into p before p.v (rounded to bf16 with p).  The reference
//    scales first and dots second; this equals it up to that rounding
//    (bf16 p, as over bf16 pages: the card's checks hold both within
//    2e-2 of each row's RMS).  The rows kernel scales first, as the
//    reference does, and is exact to f32 summation order.
// 5. The combine: the last block reads every split's (m, l) into shared
//    memory, weighs split j of a row by exp2(m_j - M) (0 where l_j = 0),
//    and sums the partials 16 bytes a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr float kNegBig = -1e30f;  // finite: -inf would NaN masked rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 8;       // rows kernel: keys a ring stage (divides page)
constexpr int kRowStages = 4;   // rows kernel: ring stages a warp
constexpr int kMmaRows = 64;    // mma kernel: q rows a block (16 a warp)
constexpr int kMmaKeys = 64;    // mma kernel: keys a ring stage
constexpr int kMmaStages = 3;
constexpr int kMaxSmem = 232448;  // a block's shared memory on Hopper

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ksc;
  const float* vsc;
  const int* tbl;
  const int* lens;
  const int* qlens;
  void* out;
  float* ws;  // [R, nkv, ntiles, S, part] partials (S > 1)
  int* cnt;   // [R * nkv * ntiles] tickets, 0 between calls
  int nkv, Tr, P, page, Bmax, rep, ntiles, S, maxp;
  int part;   // floats a partial: acc [rows][d], m [rows], l [rows], padded
  float scale;
};

// 16 bytes global -> shared, bypassing L1; src_bytes 0 zero-fills and
// reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes of a key row as f32
__device__ __forceinline__ void unpack(const uint4& w, float* f, float) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float* f,
                                       __nv_bfloat16) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
// four int8 as f32, exactly: byte b + 128 becomes the low mantissa byte
// of 2^23, and the sum is taken back off (no int-to-float conversion)
__device__ __forceinline__ void i8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}
__device__ __forceinline__ void unpack(const uint4& w, float* f, int8_t) {
  i8x4(w.x, f);
  i8x4(w.y, f + 4);
  i8x4(w.z, f + 8);
  i8x4(w.w, f + 12);
}

// four outputs (16-byte aligned f32 in, 4-element aligned out)
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_f32(v.x, v.y), pack_f32(v.z, v.w));
}
__device__ __forceinline__ float4 scale4(float4 v, float k) {
  return make_float4(v.x * k, v.y * k, v.z * k, v.w * k);
}

// The pages split s of S owns of the n a tile may see: keys
// [kstart, kstop), pages j0 .. j0 + npg - 1 of the request's table.
struct Span {
  int j0, npg, kstart, kstop;
};
__device__ __forceinline__ Span split_span(int kvlen, int horizon, int page,
                                           int s, int S) {
  const int kend = min(kvlen, horizon + 1);  // keys some row may see
  const int n = kend > 0 ? (kend + page - 1) / page : 0;
  Span sp;
  sp.j0 = (int)((long long)s * n / S);
  sp.npg = (int)((long long)(s + 1) * n / S) - sp.j0;
  sp.kstart = sp.j0 * page;
  sp.kstop = sp.npg > 0 ? min((sp.j0 + sp.npg) * page, kend) : sp.kstart;
  return sp;
}

// The split's block-table entries (and scales) into shared memory.
template <bool kQuant>
__device__ __forceinline__ void load_pages(const Args& a, int r, int h,
                                           const Span& sp, int* tbl_s,
                                           float* ksc_s, float* vsc_s) {
  for (int i = threadIdx.x; i < sp.npg; i += kThreads) {
    const int phys = a.tbl[(size_t)r * a.Bmax + sp.j0 + i];
    tbl_s[i] = phys;
    if constexpr (kQuant) {
      ksc_s[i] = a.ksc[(size_t)h * a.P + phys];
      vsc_s[i] = a.vsc[(size_t)h * a.P + phys];
    }
  }
}

// The block's (acc, m, l) for rows [0, nrows) of its tile (m in log2
// units; acc_s 16-byte aligned) to the output, through the split
// combine when S > 1.  comb: 2 * S * rows + rows floats of smem.
template <typename T, int D>
__device__ void finish(const Args& a, int r, int h, int tile, int s,
                       int rows, int nrows, const float* acc_s,
                       const float* m_s, const float* l_s, float* comb,
                       int* flag_s) {
  const int tid = threadIdx.x;
  T* og = static_cast<T*>(a.out) +
          (((size_t)r * a.nkv + h) * a.Tr + (size_t)tile * rows) * D;
  if (a.S == 1) {
    for (int i = 4 * tid; i < nrows * D; i += 4 * kThreads) {
      const float l = l_s[i / D];
      store4(og + i, scale4(*reinterpret_cast<const float4*>(acc_s + i),
                            l > 0.f ? 1.f / l : 0.f));
    }
    return;
  }
  const size_t slot = ((size_t)r * a.nkv + h) * a.ntiles + tile;
  float* mine = a.ws + (slot * a.S + s) * a.part;
  for (int i = 4 * tid; i < nrows * D; i += 4 * kThreads)
    *reinterpret_cast<float4*>(mine + i) =
        *reinterpret_cast<const float4*>(acc_s + i);
  for (int i = tid; i < nrows; i += kThreads) {
    mine[rows * D + i] = m_s[i];
    mine[rows * D + rows + i] = l_s[i];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int last = atomicAdd(a.cnt + slot, 1) == a.S - 1;
    if (last) a.cnt[slot] = 0;  // ready for the next call (graph replay)
    *flag_s = last;
  }
  __syncthreads();
  if (!*flag_s) return;
  __threadfence();
  // the last block: every split's m and l into smem, one weight a
  // (split, row), then the weighted sum of the partials
  const float* all = a.ws + slot * a.S * a.part;
  float* wm = comb;                // [S][rows] m, then the split's weight
  float* wl = comb + a.S * rows;   // [S][rows] l
  float* inv = wl + a.S * rows;    // [rows] 1 / L, 0 for a row no key saw
  for (int k = tid; k < a.S * nrows; k += kThreads) {
    const int j = k / nrows, row = k - j * nrows;
    wm[j * rows + row] = __ldcg(all + j * a.part + rows * D + row);
    wl[j * rows + row] = __ldcg(all + j * a.part + rows * D + rows + row);
  }
  __syncthreads();
  for (int row = tid; row < nrows; row += kThreads) {
    float M = kNegBig;
    for (int j = 0; j < a.S; ++j)
      if (wl[j * rows + row] > 0.f) M = fmaxf(M, wm[j * rows + row]);
    float L = 0.f;
    for (int j = 0; j < a.S; ++j) {
      // a split that saw no key of this row weighs nothing
      const float l = wl[j * rows + row];
      const float w = l > 0.f ? exp2f(wm[j * rows + row] - M) : 0.f;
      wm[j * rows + row] = w;
      L += l * w;
    }
    inv[row] = L > 0.f ? 1.f / L : 0.f;
  }
  __syncthreads();
  for (int i = 4 * tid; i < nrows * D; i += 4 * kThreads) {
    const int row = i / D;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < a.S; ++j) {
      const float w = wm[j * rows + row];
      if (w != 0.f) {
        const float4 x =
            __ldcg(reinterpret_cast<const float4*>(all + j * a.part + i));
        A.x += w * x.x;
        A.y += w * x.y;
        A.z += w * x.z;
        A.w += w * x.w;
      }
    }
    store4(og + i, scale4(A, inv[row]));
  }
}

// floats of smem behind the tables: the combine's (m, l) and 1 / L
inline size_t comb_bytes(int rows, int S) {
  return S > 1 ? (size_t)(2 * S + 1) * rows * 4 : 0;
}

// ---------------------------------------------------------------------------
// rows kernel: tiles of ROWS <= 16 q rows on the CUDA cores
// ---------------------------------------------------------------------------

template <typename KV, int D> struct RowGeom {
  static constexpr int E = 16 / (int)sizeof(KV);  // elements a 16-byte slice
  static constexpr int G = D / E;                 // lanes a key row
  static constexpr int KPW = 32 / G;              // keys a warp pass
  static constexpr int U = kChunk / KPW;          // passes a chunk
  static constexpr int kRowBytes = D * (int)sizeof(KV);
  static constexpr int kChunkBytes = kChunk * kRowBytes;  // K or V
  static constexpr int kRing = kWarps * kRowStages * 2 * kChunkBytes;
  // q and acc slices in registers (ROWS * E floats each) and the chunk's
  // scores (U * ROWS) stay within the register file
  static constexpr int kMaxRows =
      (64 / E) < (32 / U) ? (64 / E) : (32 / U);
};

template <typename KV, int D, int ROWS>
size_t rows_smem(int maxp, int S) {
  return (size_t)RowGeom<KV, D>::kRing + (size_t)maxp * 12 + 16 +
         comb_bytes(ROWS, S);
}

template <typename T, typename KV, int D, int ROWS>
__global__ void __launch_bounds__(kThreads) rpa_rows_kernel(const Args a) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  using Gm = RowGeom<KV, D>;
  constexpr int E = Gm::E, G = Gm::G, KPW = Gm::KPW, U = Gm::U;
  constexpr int kRowBytes = Gm::kRowBytes, kChunkBytes = Gm::kChunkBytes;
  constexpr int kSegsRow = kRowBytes / 16;
  static_assert(ROWS <= Gm::kMaxRows && (kChunkBytes / 16) % 32 == 0,
                "rows kernel geometry");
  static_assert((kWarps + 1) * ROWS * (D + 2) * 4 <= Gm::kRing,
                "the merge area aliases the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  int* tbl_s = reinterpret_cast<int*>(smem + Gm::kRing);
  float* ksc_s = reinterpret_cast<float*>(tbl_s + a.maxp);
  float* vsc_s = ksc_s + a.maxp;
  int* flag_s = reinterpret_cast<int*>(vsc_s + a.maxp);
  float* comb = reinterpret_cast<float*>(flag_s + 4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x, h = blockIdx.y;
  const int r = blockIdx.z / a.ntiles, tile = blockIdx.z - r * a.ntiles;
  const int row0 = tile * ROWS, nrows = min(ROWS, a.Tr - row0);
  const int kvlen = a.lens[r], qlen = a.qlens[r];
  if (qlen <= 0 || row0 / a.rep >= qlen) {
    // empty slot, or a tile of padding rows only: zeros, no page
    if (s == 0) {
      T* og = static_cast<T*>(a.out) +
              (((size_t)r * a.nkv + h) * a.Tr + row0) * D;
      for (int i = 4 * tid; i < nrows * D; i += 4 * kThreads)
        store4(og + i, make_float4(0.f, 0.f, 0.f, 0.f));
    }
    return;
  }
  const int last_tok = min((row0 + nrows - 1) / a.rep, qlen - 1);
  const Span sp = split_span(kvlen, kvlen - qlen + last_tok, a.page, s, a.S);
  load_pages<kQuant>(a, r, h, sp, tbl_s, ksc_s, vsc_s);

  // this lane's slice of each q row, in log2 units; qpos -1 = no key
  const int kg = lane / G, c0 = (lane % G) * E;
  const T* qg = static_cast<const T*>(a.q) +
                (((size_t)r * a.nkv + h) * a.Tr + row0) * D + c0;
  const float sl2 = a.scale * kLog2e;
  float qr[ROWS][E], acc[ROWS][E], m[ROWS], l[ROWS];
  int qpos[ROWS];
  constexpr int kQv = 16 / (int)sizeof(T);  // q elements a 16-byte load
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int tok = (row0 + i) / a.rep;
    qpos[i] = i < nrows && tok < qlen ? kvlen - qlen + tok : -1;
#pragma unroll
    for (int e = 0; e < E; e += kQv) {
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (i < nrows)
        w = *reinterpret_cast<const uint4*>(qg + (size_t)i * D + e);
      unpack(w, &qr[i][e], T());
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[i][e] *= sl2;
      acc[i][e] = 0.f;
    }
    m[i] = kNegBig;
    l[i] = 0.f;
  }
  __syncthreads();  // tbl_s, ksc_s, vsc_s

  // the split's 8-key chunks, dealt to the warps in turn; each warp
  // streams its own through a private ring
  const int nch = (sp.kstop - sp.kstart + kChunk - 1) / kChunk;
  const int mine = (nch - warp + kWarps - 1) / kWarps;
  unsigned char* ring = smem + warp * kRowStages * 2 * kChunkBytes;
  const char* kp = static_cast<const char*>(a.kp);
  const char* vp = static_cast<const char*>(a.vp);
  const size_t head = (size_t)h * a.P;
  auto issue = [&](int c) {
    if (c < mine) {
      const int k0 = sp.kstart + (warp + c * kWarps) * kChunk;
      const int phys = tbl_s[k0 / a.page - sp.j0];
      const size_t off =
          ((head + phys) * a.page + k0 % a.page) * (size_t)kRowBytes;
      unsigned char* dst = ring + (c % kRowStages) * 2 * kChunkBytes;
#pragma unroll
      for (int v = 0; v < kChunkBytes / 16 / 32; ++v) {
        const int seg = lane + 32 * v;
        const bool ok = k0 + seg / kSegsRow < sp.kstop;
        cp_async16(dst + seg * 16, ok ? kp + off + seg * 16 : kp, ok);
        cp_async16(dst + kChunkBytes + seg * 16,
                   ok ? vp + off + seg * 16 : vp, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kRowStages - 1; ++c) issue(c);

  for (int c = 0; c < mine; ++c) {
    cp_async_wait<kRowStages - 2>();
    __syncwarp();  // chunk c landed for every lane; chunk c - 1 is spent
    issue(c + kRowStages - 1);
    const unsigned char* st = ring + (c % kRowStages) * 2 * kChunkBytes;
    const int k0 = sp.kstart + (warp + c * kWarps) * kChunk;
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {
      ksc = ksc_s[k0 / a.page - sp.j0];
      vsc = vsc_s[k0 / a.page - sp.j0];
    }
    float sc[U][ROWS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
      unpack(*reinterpret_cast<const uint4*>(
                 st + (kg + KPW * u) * kRowBytes + c0 * (int)sizeof(KV)),
             kf, KV());
      if constexpr (kQuant) {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[e] *= ksc;  // scale first, dot second
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d += qr[i][e] * kf[e];
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        sc[u][i] = d;
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float mx = m[i];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kpos = k0 + kg + KPW * u;
        if (kpos >= sp.kstop || kpos > qpos[i]) sc[u][i] = kNegBig;
        mx = fmaxf(mx, sc[u][i]);
      }
#pragma unroll
      for (int o = G; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float corr = exp2f(m[i] - mx);
      m[i] = mx;
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // explicit zero: on a row with no live key yet exp2(s - m) is 1
        const float p = sc[u][i] == kNegBig ? 0.f : exp2f(sc[u][i] - mx);
        sc[u][i] = p;
        ps += p;
      }
      l[i] = l[i] * corr + ps;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
      unpack(*reinterpret_cast<const uint4*>(st + kChunkBytes +
                                             (kg + KPW * u) * kRowBytes +
                                             c0 * (int)sizeof(KV)),
             vf, KV());
      if constexpr (kQuant) {
#pragma unroll
        for (int e = 0; e < E; ++e) vf[e] *= vsc;
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] += sc[u][i] * vf[e];
    }
  }
  cp_async_wait<0>();

  // the warp's key groups share m: sum their l and acc
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int o = G; o < 32; o <<= 1) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], o);
    }
  __syncthreads();  // every ring is spent: the merge area aliases them
  float* aw = reinterpret_cast<float*>(smem);  // [kWarps][ROWS][D]
  float* fa = aw + kWarps * ROWS * D;           // the block's acc, m, l
  float* mw = fa + ROWS * D;                    // [kWarps][ROWS]
  float* lw = mw + kWarps * ROWS;               // [kWarps][ROWS]
  float* fm = lw + kWarps * ROWS;
  float* fl = fm + ROWS;
  if (lane < G) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (lane == 0) {
        mw[warp * ROWS + i] = m[i];
        lw[warp * ROWS + i] = l[i];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) aw[(warp * ROWS + i) * D + c0 + e] = acc[i][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < ROWS * D; i += kThreads) {
    const int row = i / D;
    float M = kNegBig;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (lw[w * ROWS + row] > 0.f) M = fmaxf(M, mw[w * ROWS + row]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float lv = lw[w * ROWS + row];
      if (lv > 0.f) {
        const float wt = exp2f(mw[w * ROWS + row] - M);
        L += lv * wt;
        A += aw[w * ROWS * D + i] * wt;
      }
    }
    fa[i] = A;
    if (i % D == 0) {
      fm[row] = M;
      fl[row] = L;
    }
  }
  __syncthreads();
  finish<T, D>(a, r, h, tile, s, ROWS, nrows, fa, fm, fl, comb, flag_s);
}

// ---------------------------------------------------------------------------
// mma kernel: tiles of 64 bf16 q rows on the tensor cores
// ---------------------------------------------------------------------------

template <typename KV, int D> struct MmaGeom {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int LD = D + 8;  // bf16 a smem row: fragments miss no bank
  // bytes a K/V row in a ring stage (int8 rows padded to 16 bytes)
  static constexpr int kRowB = kQuant ? D + 16 : LD * 2;
  static constexpr int kStageB = kMmaKeys * kRowB;  // K or V
  // int8: two stages in flight, each widened into one of two bf16 K/V
  // tiles by the threads that copied it, a tile ahead of the products
  static constexpr int kStages = kQuant ? 2 : kMmaStages;
  static constexpr int kRing = kStages * 2 * kStageB;
  static constexpr int kConv = kQuant ? 2 * 2 * kMmaKeys * LD * 2 : 0;
};

template <typename KV, int D>
size_t mma_smem(int maxp, int S) {
  using Gm = MmaGeom<KV, D>;
  return (size_t)Gm::kRing + Gm::kConv + (size_t)maxp * 12 + 16 +
         comb_bytes(kMmaRows, S);
}

template <typename KV, int D>
__global__ void __launch_bounds__(kThreads) rpa_mma_kernel(const Args a) {
  using Gm = MmaGeom<KV, D>;
  constexpr bool kQuant = Gm::kQuant;
  constexpr int LD = Gm::LD, kRowB = Gm::kRowB, kStageB = Gm::kStageB;
  constexpr int kStages = Gm::kStages;
  constexpr int kSegsRow = D * (int)sizeof(KV) / 16;
  static_assert(kMmaRows * LD * 2 <= Gm::kRing &&
                    kMmaRows * (D + 2) * 4 <= Gm::kRing,
                "q tile and merge area alias the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* conv = reinterpret_cast<bf16*>(smem + Gm::kRing);  // [2][2][64][LD]
  int* tbl_s = reinterpret_cast<int*>(smem + Gm::kRing + Gm::kConv);
  float* ksc_s = reinterpret_cast<float*>(tbl_s + a.maxp);
  float* vsc_s = ksc_s + a.maxp;
  int* flag_s = reinterpret_cast<int*>(vsc_s + a.maxp);
  float* comb = reinterpret_cast<float*>(flag_s + 4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int s = blockIdx.x, h = blockIdx.y;
  const int r = blockIdx.z / a.ntiles, tile = blockIdx.z - r * a.ntiles;
  const int row0 = tile * kMmaRows, nrows = min(kMmaRows, a.Tr - row0);
  const int kvlen = a.lens[r], qlen = a.qlens[r];
  const size_t qbase = (((size_t)r * a.nkv + h) * a.Tr + row0) * D;
  if (qlen <= 0 || row0 / a.rep >= qlen) {
    if (s == 0) {
      bf16* og = static_cast<bf16*>(a.out) + qbase;
      for (int i = 4 * tid; i < nrows * D; i += 4 * kThreads)
        store4(og + i, make_float4(0.f, 0.f, 0.f, 0.f));
    }
    return;
  }
  const int last_tok = min((row0 + nrows - 1) / a.rep, qlen - 1);
  const Span sp = split_span(kvlen, kvlen - qlen + last_tok, a.page, s, a.S);
  load_pages<kQuant>(a, r, h, sp, tbl_s, ksc_s, vsc_s);

  // q tile -> smem (rows past Tr zero) -> A fragments in registers
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  const bf16* qg = static_cast<const bf16*>(a.q) + qbase;
  for (int i = 8 * tid; i < kMmaRows * D; i += 8 * kThreads) {
    const int row = i / D, c = i - row * D;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (row < nrows) w = *reinterpret_cast<const uint4*>(qg + i);
    *reinterpret_cast<uint4*>(q_s + row * LD + c) = w;
  }
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    load_a(qa[kk], q_s + warp * 16 * LD + kk * 16, LD, lane);
  __syncthreads();  // q_s is spent: the ring takes its place

  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * 16 + (lane >> 2) + 8 * i;
    const int tok = (row0 + row) / a.rep;
    qpos[i] = row < nrows && tok < qlen ? kvlen - qlen + tok : -1;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * kLog2e;

  const int ntk = (sp.kstop - sp.kstart + kMmaKeys - 1) / kMmaKeys;
  const char* kp = static_cast<const char*>(a.kp);
  const char* vp = static_cast<const char*>(a.vp);
  const size_t head = (size_t)h * a.P;
  auto issue = [&](int tt) {
    if (tt < ntk) {
      const int k0 = sp.kstart + tt * kMmaKeys;
      unsigned char* dst = smem + (tt % kStages) * 2 * kStageB;
      for (int i = tid; i < kMmaKeys * kSegsRow; i += kThreads) {
        const int key = i / kSegsRow, sg = i - key * kSegsRow;
        const int kpos = k0 + key;
        const bool ok = kpos < sp.kstop;
        size_t off = 0;
        if (ok) {
          const int phys = tbl_s[kpos / a.page - sp.j0];
          off = ((head + phys) * a.page + kpos % a.page) * (size_t)D *
                    sizeof(KV) + sg * 16;
        }
        cp_async16(dst + key * kRowB + sg * 16, kp + off, ok);
        cp_async16(dst + kStageB + key * kRowB + sg * 16, vp + off, ok);
      }
    }
    cp_async_commit();
  };
  // int8: this thread's own segments of tile tt, widened to bf16 tile
  // tt % 2 (its cp.async writes are visible to it after its wait alone)
  auto widen = [&](int tt) {
    if (tt >= ntk) return;
    const unsigned char* src = smem + (tt % kStages) * 2 * kStageB;
    bf16* dst = conv + (tt & 1) * 2 * kMmaKeys * LD;
    for (int i = tid; i < kMmaKeys * kSegsRow; i += kThreads) {
      const int key = i / kSegsRow, c = (i - key * kSegsRow) * 16;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        float f[16];
        unpack(*reinterpret_cast<const uint4*>(src + kv * kStageB +
                                               key * kRowB + c),
               f, int8_t());
        uint4* o = reinterpret_cast<uint4*>(
            dst + (kv * kMmaKeys + key) * LD + c);
        o[0] = make_uint4(pack_f32(f[0], f[1]), pack_f32(f[2], f[3]),
                          pack_f32(f[4], f[5]), pack_f32(f[6], f[7]));
        o[1] = make_uint4(pack_f32(f[8], f[9]), pack_f32(f[10], f[11]),
                          pack_f32(f[12], f[13]), pack_f32(f[14], f[15]));
      }
    }
  };
  __syncthreads();  // tbl_s
#pragma unroll
  for (int tt = 0; tt < kStages - 1; ++tt) issue(tt);
  if constexpr (kQuant) {
    issue(1);
    cp_async_wait<1>();
    widen(0);
  }

  for (int tt = 0; tt < ntk; ++tt) {
    const bf16* ks;
    if constexpr (kQuant) {
      __syncthreads();  // bf16 tile tt is whole; tile tt - 1 is spent
      issue(tt + 2);    // into the int8 stage of tile tt, widened already
      ks = conv + (tt & 1) * 2 * kMmaKeys * LD;
    } else {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // tile tt landed; tile tt - 1 is spent
      issue(tt + kStages - 1);
      ks = reinterpret_cast<const bf16*>(smem + (tt % kStages) * 2 * kStageB);
    }
    const bf16* vs = ks + kMmaKeys * LD;  // V rows follow K's in both
    const int k0 = sp.kstart + tt * kMmaKeys;

    float sf[kMmaKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n) sf[n][0] = sf[n][1] = sf[n][2] = sf[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int n = 0; n < kMmaKeys / 8; ++n) {
        uint32_t bf[2];
        load_b_nk(bf, ks + n * 8 * LD + kk * 16, LD, lane);
        mma(sf[n], qa[kk], bf);
      }
    // scale (int8: the key's K scale after the product), mask, row max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + n * 8 + 2 * t + j;
        const bool in = kpos < sp.kstop;
        float ksc = 1.f;
        if constexpr (kQuant) ksc = ksc_s[in ? kpos / a.page - sp.j0 : 0];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = sf[n][2 * i + j] * ksc * sl2;
          if (!in || kpos > qpos[i]) x = kNegBig;
          sf[n][2 * i + j] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sf[n][e];
        // explicit zero: a row with no live key yet has m = kNegBig
        const float p = x == kNegBig ? 0.f : exp2f(x - mx[e >> 1]);
        l[e >> 1] += p;
        sf[n][e] = p;
        if constexpr (kQuant) {  // the key's V scale folded into p
          const int kpos = k0 + n * 8 + 2 * t + (e & 1);
          if (kpos < sp.kstop) sf[n][e] = p * vsc_s[kpos / a.page - sp.j0];
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
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, sf[2 * kk], sf[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bf[2];
        load_b_kn(bf, vs + kk * 16 * LD + n * 8, LD, lane);
        mma(acc[n], pa, bf);
      }
    }
    if constexpr (kQuant) {
      cp_async_wait<1>();  // this thread's part of tile tt + 1 landed
      widen(tt + 1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is spent: the merge area aliases it

  float* fa = reinterpret_cast<float*>(smem);  // [64][D] acc, [64] m, l
  float* fm = fa + kMmaRows * D;
  float* fl = fm + kMmaRows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * 16 + (lane >> 2) + 8 * i;
    const float ls = quad_sum(l[i]);
    if (t == 0) {
      fm[row] = m[i];
      fl[row] = ls;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      fa[row * D + n * 8 + 2 * t] = acc[n][2 * i];
      fa[row * D + n * 8 + 2 * t + 1] = acc[n][2 * i + 1];
    }
  }
  __syncthreads();
  finish<bf16, D>(a, r, h, tile, s, kMmaRows, nrows, fa, fm, fl, comb,
                  flag_s);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch_kernel(K kern, size_t smem, const Args& a, int R,
                          cudaStream_t st, bool* attr_set) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024 && !*attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    *attr_set = true;
  }
  dim3 grid(a.S, a.nkv, R * a.ntiles);
  kern<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, typename KV, int D, int ROWS>
cudaError_t launch_rows(const Args& a, int R, cudaStream_t st) {
  static bool attr = false;
  return launch_kernel(rpa_rows_kernel<T, KV, D, ROWS>,
                       rows_smem<KV, D, ROWS>(a.maxp, a.S), a, R, st, &attr);
}

// rows: 1, 2, 4, 8 or 16, at most the geometry's kMaxRows
template <typename T, typename KV, int D, int ROWS = 1>
cudaError_t dispatch_rows(const Args& a, int rows, int R, cudaStream_t st) {
  if constexpr (ROWS > RowGeom<KV, D>::kMaxRows || ROWS > 16) {
    return cudaErrorInvalidValue;
  } else {
    if (rows == ROWS) return launch_rows<T, KV, D, ROWS>(a, R, st);
    return dispatch_rows<T, KV, D, 2 * ROWS>(a, rows, R, st);
  }
}

template <typename T, typename KV, int D>
cudaError_t dispatch_tile(const Args& a, int rows, int R, cudaStream_t st) {
  if (rows == kMmaRows) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      static bool attr = false;
      return launch_kernel(rpa_mma_kernel<KV, D>, mma_smem<KV, D>(a.maxp, a.S),
                           a, R, st, &attr);
    }
    return cudaErrorInvalidValue;  // f32 q takes the rows kernel
  }
  return dispatch_rows<T, KV, D>(a, rows, R, st);
}

// q / out dtype 0 = float32, 1 = bfloat16; pools of q's dtype (kSameAsQ)
// or int8; d in {64, 128}
template <bool kSameAsQ>
int dispatch(int dtype, int d, const Args& a, int rows, int R,
             cudaStream_t st) {
#define RPA_CASE(DT, T, DIM)                                              \
  if (dtype == DT && d == DIM)                                           \
    return dispatch_tile<T, typename std::conditional<kSameAsQ, T,       \
                                                      int8_t>::type,     \
                         DIM>(a, rows, R, st);
  RPA_CASE(1, __nv_bfloat16, 128)
  RPA_CASE(1, __nv_bfloat16, 64)
  RPA_CASE(0, float, 128)
  RPA_CASE(0, float, 64)
#undef RPA_CASE
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* kp, const void* vp,
               const void* ksc, const void* vsc, const void* tbl,
               const void* lens, const void* qlens, void* out, void* ws,
               void* cnt, int nkv, int Tr, int d, int P, int page, int Bmax,
               int rep, int rows, int ntiles, int S, float scale) {
  Args a;
  a.q = q;
  a.kp = kp;
  a.vp = vp;
  a.ksc = static_cast<const float*>(ksc);
  a.vsc = static_cast<const float*>(vsc);
  a.tbl = static_cast<const int*>(tbl);
  a.lens = static_cast<const int*>(lens);
  a.qlens = static_cast<const int*>(qlens);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.cnt = static_cast<int*>(cnt);
  a.nkv = nkv;
  a.Tr = Tr;
  a.P = P;
  a.page = page;
  a.Bmax = Bmax;
  a.rep = rep;
  a.ntiles = ntiles;
  a.S = S;
  a.maxp = (Bmax + S - 1) / S;  // most pages a split owns
  a.part = rows * d + (2 * rows + 3) / 4 * 4;
  a.scale = scale;
  return a;
}

}  // namespace

// Dense pools of q's dtype.  rows: q rows a tile (64 = the mma kernel,
// bf16 q only; else 1-16, the rows kernel), ntiles = ceil(Tr / rows),
// S splits; when S > 1 ws holds R*nkv*ntiles*S partials of rows*d +
// 4*ceil(rows/2) f32 and cnt R*nkv*ntiles zeroed ints (when S == 1 both
// go unread and may be null).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernel
// was not built for (the wrapper checks first).  q, out and the pools
// start 16-byte aligned.
extern "C" int rpa_launch(const void* q, const void* k_pages,
                          const void* v_pages, const void* block_tables,
                          const void* seq_lens, const void* q_lens, void* out,
                          void* ws, void* cnt, int dtype, int R, int nkv,
                          int Tr, int d, int P, int page, int Bmax, int rep,
                          int rows, int ntiles, int S, float scale,
                          void* stream) {
  const Args a = make_args(q, k_pages, v_pages, nullptr, nullptr,
                           block_tables, seq_lens, q_lens, out, ws, cnt, nkv,
                           Tr, d, P, page, Bmax, rep, rows, ntiles, S, scale);
  return dispatch<true>(dtype, d, a, rows, R,
                        static_cast<cudaStream_t>(stream));
}

// int8 pools with f32 scales [nkv, P]; q / out of dtype; the rest as
// rpa_launch.
extern "C" int rpa_quant_launch(const void* q, const void* k_pages,
                                const void* v_pages, const void* k_scales,
                                const void* v_scales,
                                const void* block_tables,
                                const void* seq_lens, const void* q_lens,
                                void* out, void* ws, void* cnt, int dtype,
                                int R, int nkv, int Tr, int d, int P,
                                int page, int Bmax, int rep, int rows,
                                int ntiles, int S, float scale,
                                void* stream) {
  const Args a = make_args(q, k_pages, v_pages, k_scales, v_scales,
                           block_tables, seq_lens, q_lens, out, ws, cnt, nkv,
                           Tr, d, P, page, Bmax, rep, rows, ntiles, S, scale);
  return dispatch<false>(dtype, d, a, rows, R,
                         static_cast<cudaStream_t>(stream));
}
