// Tensor-core helpers shared by the bf16 kernels: mma.sync m16n8k16
// (bf16 x bf16 -> f32) and the fragment loads from shared memory that
// feed it, the cp.async copies that fill shared memory, and the quad
// reductions over one fragment row.  Included by flash_attention.cu,
// ragged_paged_attention.cu and fused_blocks.cu; _build.py hashes an
// included header with the source that includes it.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b, m16n8k16, row-major A, column-major B, f32 accumulators.
// Fragments (g = lane / 4, t = lane % 4):
//   a[0] = A[g][2t..2t+1]   a[1] = A[g+8][2t..]   a[2] = A[g][2t+8..]
//   a[3] = A[g+8][2t+8..]   b[0] = B[2t..2t+1][g] b[1] = B[2t+8..][g]
//   c[0..1] = C[g][2t..2t+1]                      c[2..3] = C[g+8][2t..]
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of a row-major tile X (s -> X[r0][k0], row stride ld)
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int ld,
                                       int lane) {
  const bf16* p = s + (lane >> 2) * ld + 2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment with B[k][n] = Y[n][k], Y row-major (s -> Y[n0][k0])
__device__ __forceinline__ void load_b_nk(uint32_t b[2], const bf16* s,
                                          int ld, int lane) {
  const bf16* p = s + (lane >> 2) * ld + 2 * (lane & 3);
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragment with B[k][n] = Z[k][n], Z row-major (s -> Z[k0][n0])
__device__ __forceinline__ void load_b_kn(uint32_t b[2], const bf16* s,
                                          int ld, int lane) {
  const bf16* p = s + 2 * (lane & 3) * ld + (lane >> 2);
  b[0] = pack_bf16(p[0], p[ld]);
  b[1] = pack_bf16(p[8 * ld], p[9 * ld]);
}

// The A fragment of the 16 x 16 slice kk of a 16-row C-fragment tile
// (the FA2 register reuse: P or dS goes straight into the next product)
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

// ---------------------------------------------------------------------------
// cp.async: global -> shared without a register round trip
// ---------------------------------------------------------------------------

// 16 bytes, bypassing L1; ok == false reads nothing and zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes (one f32 of a row that need not be 16-byte aligned)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// wait until every cp.async copy of this thread has landed, committed or
// not
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
