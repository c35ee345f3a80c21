// int8 weight matmul for Hopper: y = dequant(quant_row(x) @ w_q).
//
// Replaces paddle_tpu/ops/pallas_ops.py::_int8_matmul_kernel (the TPU
// kernel behind int8_matmul).  Same arithmetic, op for op, as the plain
// version in ops/int8_matmul.py, so the two agree bit for bit:
//   xs  = max(absmax_k |x[m,k]|, 1e-8) * float32(1/127)
//   xq  = clamp(rint(x / xs), -127, 127)             (IEEE division)
//   acc = sum_k xq[m,k] * w_q[k,n]                   (exact, int32)
//   y   = bf16_rn((float(acc) * xs[m]) * w_scale[n])
//
// What bounds it on this card: at decode (M = 8) every call streams its
// whole int8 weight once and does only 2*M flops per weight byte, far
// below the H100's ~590 int8 ops per byte of HBM, so the bound is bytes:
// one llama7b decode step reads ~6.7 GB of int8 weights, about 2 ms at
// 3.35 TB/s.  The design therefore spends its effort on keeping many
// weight loads in flight on every SM:
//   1. row_quant: one block per row: absmax, xs, xq; it also zeroes the
//      int32 accumulator that pass 2 adds into.
//   2. gemm: a block owns 128 output columns x BM rows x one K slice.
//      Each lane reads 4 columns of 4 consecutive weight rows (a warp
//      reads 128 contiguous bytes per row), transposes the 4x4 bytes
//      with __byte_perm so each column's 4 k-values share one word, and
//      accumulates with __dp4a against xq staged in shared memory.  The
//      K axis is split across blocks until the card has ~4 blocks per
//      SM; the 8 warps of a block reduce in shared memory and the block
//      adds its partial sums into the accumulator with int32 atomics.
//      Integer addition is associative, so the split is exact and the
//      result does not depend on the order the atomics land in.
//   3. dequant: the epilogue above, one thread per output.
// The TPU kernel kept K uncut in VMEM so one grid step saw the whole
// row; here the row-quant pass does that once and the K split is free.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-8f;
constexpr float kInv127 = 1.0f / 127.0f;  // == float32(1 / 127)
constexpr int kTileN = 128;               // columns per gemm block
constexpr int kWarps = 8;                 // warps per gemm block
constexpr int kMaxKSlice = 2048;          // bytes of one xq row in smem

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

template <typename T>
__global__ void row_quant_kernel(const T* __restrict__ x,
                                 int8_t* __restrict__ xq,
                                 float* __restrict__ xs,
                                 int32_t* __restrict__ acc, int K, int N) {
  __shared__ float red[32];
  const int m = blockIdx.x;
  const T* xr = x + (size_t)m * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    amax = fmaxf(amax, fabsf(to_f32(xr[k])));
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    amax = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) red[0] = amax;
  }
  __syncthreads();
  const float s = fmaxf(red[0], kEps) * kInv127;
  if (threadIdx.x == 0) xs[m] = s;
  int8_t* qr = xq + (size_t)m * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float q = fminf(fmaxf(rintf(to_f32(xr[k]) / s), -127.f), 127.f);
    qr[k] = (int8_t)q;
  }
  int32_t* ar = acc + (size_t)m * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) ar[n] = 0;
}

// r0..r3 hold 4 columns of 4 consecutive k rows; returns in c[j] the 4
// k-values of column j, low byte first (the __dp4a operand order).
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

template <int BM>
__global__ void __launch_bounds__(kWarps * 32)
    gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                int32_t* __restrict__ acc, int M, int K, int N, int kslice) {
  extern __shared__ int32_t smem[];
  const int kw = kslice / 4;             // packed words per staged row
  int32_t* x_s = smem;                   // [BM][kw]
  int32_t* a_s = smem + BM * kw;         // [BM][4][32]: column 4*lane+j
  const int n0 = blockIdx.x * kTileN;
  const int k0 = blockIdx.y * kslice;
  const int m0 = blockIdx.z * BM;
  const int ng = (min(K, k0 + kslice) - k0) / 4;  // k groups in the slice

  for (int i = threadIdx.x; i < BM * kw; i += blockDim.x) {
    const int r = i / kw, g = i - r * kw;
    int32_t v = 0;
    if (m0 + r < M && g < ng)
      v = *reinterpret_cast<const int32_t*>(xq + (size_t)(m0 + r) * K + k0 +
                                            4 * g);
    x_s[i] = v;
  }
  for (int i = threadIdx.x; i < BM * kTileN; i += blockDim.x) a_s[i] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = n0 + 4 * lane;
  if (n < N) {  // N % 4 == 0: a lane's 4 columns are all in or all out
    int32_t a[BM][4];
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[m][j] = 0;
    const int8_t* wc = w + (size_t)k0 * N + n;
#pragma unroll 4
    for (int g = warp; g < ng; g += kWarps) {
      const int8_t* wp = wc + (size_t)(4 * g) * N;
      const uint32_t r0 = __ldg(reinterpret_cast<const uint32_t*>(wp));
      const uint32_t r1 = __ldg(reinterpret_cast<const uint32_t*>(wp + N));
      const uint32_t r2 =
          __ldg(reinterpret_cast<const uint32_t*>(wp + 2 * (size_t)N));
      const uint32_t r3 =
          __ldg(reinterpret_cast<const uint32_t*>(wp + 3 * (size_t)N));
      uint32_t c[4];
      transpose4x4(r0, r1, r2, r3, c);
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const int xv = x_s[m * kw + g];
#pragma unroll
        for (int j = 0; j < 4; ++j) a[m][j] = __dp4a((int)c[j], xv, a[m][j]);
      }
    }
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        atomicAdd(&a_s[m * kTileN + j * 32 + lane], a[m][j]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * kTileN; i += blockDim.x) {
    const int r = i / kTileN, rem = i - r * kTileN;
    const int col = n0 + 4 * (rem & 31) + (rem >> 5);
    if (m0 + r < M && col < N && a_s[i] != 0)
      atomicAdd(&acc[(size_t)(m0 + r) * N + col], a_s[i]);
  }
}

template <typename T>
__global__ void dequant_kernel(const int32_t* __restrict__ acc,
                               const float* __restrict__ xs,
                               const float* __restrict__ ws,
                               T* __restrict__ out, int M, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = (int)(i / N), n = (int)(i - (size_t)m * N);
  // the TPU epilogue's order: (acc * xs) * ws, then one rounding to T
  const float y = (__int2float_rn(acc[i]) * xs[m]) * ws[n];
  out[i] = from_f32<T>(y);
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <int BM>
cudaError_t launch_gemm(const int8_t* xq, const int8_t* w, int32_t* acc,
                        int M, int K, int N, cudaStream_t stream) {
  const int tiles = (N + kTileN - 1) / kTileN;
  const int mtiles = (M + BM - 1) / BM;
  // split K until the card holds ~4 blocks per SM
  int split = (4 * num_sms()) / (tiles * mtiles);
  if (split < 1) split = 1;
  int kslice = (K + split - 1) / split;
  kslice = ((kslice + 4 * kWarps - 1) / (4 * kWarps)) * (4 * kWarps);
  if (kslice > kMaxKSlice) kslice = kMaxKSlice;
  split = (K + kslice - 1) / kslice;
  const size_t smem = (size_t)BM * kslice + (size_t)BM * kTileN * 4;
  dim3 grid(tiles, split, mtiles);
  gemm_kernel<BM><<<grid, kWarps * 32, smem, stream>>>(xq, w, acc, M, K, N,
                                                       kslice);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const T* x, const int8_t* w, const float* ws, T* out,
                       int8_t* xq, float* xs, int32_t* acc, int M, int K,
                       int N, cudaStream_t stream) {
  row_quant_kernel<T><<<M, 256, 0, stream>>>(x, xq, xs, acc, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = M <= 8 ? launch_gemm<8>(xq, w, acc, M, K, N, stream)
               : launch_gemm<16>(xq, w, acc, M, K, N, stream);
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)M * N;
  dequant_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      acc, xs, ws, out, M, N);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] (dtype 0 = float32, 1 = bfloat16), w_q [K, N] int8, w_scale
// [N] float32, out [M, N] like x.  Scratch from the caller: xq [M, K]
// int8, xs [M] float32, acc [M, N] int32.  Needs K % 4 == 0 and
// N % 4 == 0; the wrapper checks.  Returns cudaGetLastError().
extern "C" int int8_matmul_launch(const void* x, int dtype, const void* w_q,
                                  const void* w_scale, void* out, void* xq,
                                  void* xs, void* acc, int M, int K, int N,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(w_q);
  const float* ws = static_cast<const float*>(w_scale);
  int8_t* q = static_cast<int8_t*>(xq);
  float* sc = static_cast<float*>(xs);
  int32_t* a = static_cast<int32_t*>(acc);
  if (dtype == 1)
    return launch_all(static_cast<const __nv_bfloat16*>(x), w, ws,
                      static_cast<__nv_bfloat16*>(out), q, sc, a, M, K, N,
                      s);
  return launch_all(static_cast<const float*>(x), w, ws,
                    static_cast<float*>(out), q, sc, a, M, K, N, s);
}
