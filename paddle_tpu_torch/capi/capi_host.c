/* A C serving host over the port's C ABI that checks what it serves:
 * it reads one input tensor from a raw file, creates a predictor, runs
 * it, and prints each output's dtype, shape and the SHA-256 of its
 * bytes, with the create seconds and each run's milliseconds.
 *
 * Usage:
 *   capi_host <model_prefix> <input.bin> <dtype> <ndim> <d0> ... [turns]
 *             [--badshape]
 *   dtype: 0 float32, 1 float64, 2 int32, 3 int64 (PD_DType)
 *   --badshape: after the runs, one call with dimension 0 set to -1
 *               must fail with an error (printed as BADSHAPE <message>)
 * Exit codes: 0 ok, 2 usage, 3 create failed, 4 input file, 5 run
 * failed, 6 the bad shape was accepted.
 * Build: paddle_tpu_torch.inference.capi.build_host(this file, out).
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "paddle_tpu_capi.h"

/* ---- SHA-256 (FIPS 180-4) ---- */
static const uint32_t K256[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

#define ROR(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

static void sha256_block(uint32_t h[8], const unsigned char* p) {
  uint32_t w[64];
  for (int i = 0; i < 16; ++i)
    w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
           ((uint32_t)p[4 * i + 2] << 8) | (uint32_t)p[4 * i + 3];
  for (int i = 16; i < 64; ++i) {
    uint32_t s0 = ROR(w[i - 15], 7) ^ ROR(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = ROR(w[i - 2], 17) ^ ROR(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
           g = h[6], k = h[7];
  for (int i = 0; i < 64; ++i) {
    uint32_t t1 = k + (ROR(e, 6) ^ ROR(e, 11) ^ ROR(e, 25)) +
                  ((e & f) ^ (~e & g)) + K256[i] + w[i];
    uint32_t t2 = (ROR(a, 2) ^ ROR(a, 13) ^ ROR(a, 22)) +
                  ((a & b) ^ (a & c) ^ (b & c));
    k = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += k;
}

static void sha256_hex(const unsigned char* data, size_t n, char out[65]) {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  size_t full = n / 64;
  for (size_t i = 0; i < full; ++i) sha256_block(h, data + 64 * i);
  unsigned char tail[128];
  size_t rem = n - 64 * full;
  memset(tail, 0, sizeof tail);
  memcpy(tail, data + 64 * full, rem);
  tail[rem] = 0x80;
  size_t tail_len = rem + 9 <= 64 ? 64 : 128;
  uint64_t bits = (uint64_t)n * 8;
  for (int i = 0; i < 8; ++i)
    tail[tail_len - 1 - i] = (unsigned char)(bits >> (8 * i));
  sha256_block(h, tail);
  if (tail_len == 128) sha256_block(h, tail + 64);
  for (int i = 0; i < 8; ++i) sprintf(out + 8 * i, "%08x", h[i]);
  out[64] = 0;
}

static double now_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

static size_t elem_size(int dtype) {
  return (dtype == PD_DTYPE_FLOAT32 || dtype == PD_DTYPE_INT32) ? 4 : 8;
}

int main(int argc, char** argv) {
  if (argc < 6) {
    fprintf(stderr, "usage: %s <prefix> <input.bin> <dtype> <ndim> <dims..>"
            " [turns] [--badshape]\n", argv[0]);
    return 2;
  }
  PD_TensorData in;
  memset(&in, 0, sizeof in);
  in.dtype = atoi(argv[3]);
  in.ndim = atoi(argv[4]);
  if (in.ndim < 1 || in.ndim > 8 || argc < 5 + in.ndim) return 2;
  size_t n = 1;
  for (int d = 0; d < in.ndim; ++d) {
    in.shape[d] = atoll(argv[5 + d]);
    n *= (size_t)in.shape[d];
  }
  int turns = 1, badshape = 0;
  for (int i = 5 + in.ndim; i < argc; ++i) {
    if (!strcmp(argv[i], "--badshape")) badshape = 1;
    else turns = atoi(argv[i]);
  }
  size_t nbytes = n * elem_size(in.dtype);
  in.data = malloc(nbytes ? nbytes : 1);
  FILE* f = fopen(argv[2], "rb");
  if (!f || fread(in.data, 1, nbytes, f) != nbytes) return 4;
  fclose(f);

  double t0 = now_s();
  PD_Predictor* p = PD_PredictorCreate(argv[1]);
  if (!p) {
    fprintf(stderr, "CREATE_ERROR %s\n", PD_GetLastError());
    return 3;
  }
  printf("CREATE_S %.6f\n", now_s() - t0);
  for (int t = 0; t < turns; ++t) {
    PD_TensorData* outs;
    int n_outs;
    double t1 = now_s();
    if (PD_PredictorRun(p, &in, 1, &outs, &n_outs) != 0) {
      fprintf(stderr, "RUN_ERROR %s\n", PD_GetLastError());
      return 5;
    }
    printf("RUN_MS %.4f\n", 1e3 * (now_s() - t1));
    if (t == turns - 1) {
      for (int i = 0; i < n_outs; ++i) {
        size_t m = 1;
        printf("OUTPUT %d %d %d", i, outs[i].dtype, outs[i].ndim);
        for (int d = 0; d < outs[i].ndim; ++d) {
          printf(" %lld", (long long)outs[i].shape[d]);
          m *= (size_t)outs[i].shape[d];
        }
        char hex[65];
        sha256_hex((const unsigned char*)outs[i].data,
                   m * elem_size(outs[i].dtype), hex);
        printf(" SHA256 %s\n", hex);
      }
    }
    PD_OutputsDestroy(outs, n_outs);
  }
  if (badshape) {
    PD_TensorData* outs;
    int n_outs;
    in.shape[0] = -1;
    if (PD_PredictorRun(p, &in, 1, &outs, &n_outs) == 0) return 6;
    printf("BADSHAPE %s\n", PD_GetLastError());
  }
  PD_PredictorDestroy(p);
  free(in.data);
  fflush(stdout);
  return 0;
}
