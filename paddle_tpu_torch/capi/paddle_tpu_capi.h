/* paddle_tpu_torch inference C API — native serving host (the port's
 * copy of csrc/paddle_tpu_capi.h: the same ABI).
 *
 * Reference analog: paddle/fluid/inference/capi_exp/pd_inference_api.h
 * (PD_PredictorCreate / PD_PredictorRun / PD_Tensor*), the stable C ABI a
 * non-Python serving process links against. Here the ABI fronts the
 * torch.export artifact written by paddle_tpu_torch.jit.save, run by
 * paddle_tpu_torch.inference.Predictor inside an embedded interpreter, on
 * the card (the CPU only when PADDLE_TPU_CAPI_PLATFORM=cpu).
 * PADDLE_TPU_CAPI_LAUNCHES=<file> has every run write the port's kernel
 * launch counts since the start to that file as JSON (diagnostics).
 *
 * Build: paddle_tpu_torch.inference.capi.build() compiles
 * libpaddle_tpu_capi.so; capi.build_host() links a C host against it
 * (examples: paddle_tpu_torch/examples/serve_capi.c,
 * paddle_tpu_torch/capi/capi_host.c).
 *
 * Usage:
 *   PD_Predictor* p = PD_PredictorCreate("/path/model_prefix");
 *   PD_TensorData in = {PD_DTYPE_FLOAT32, ndim, shape, data};
 *   PD_TensorData* outs; int n_out;
 *   PD_PredictorRun(p, &in, 1, &outs, &n_out);
 *   ... use outs[i].data ...
 *   PD_OutputsDestroy(outs, n_out);
 *   PD_PredictorDestroy(p);
 */
#ifndef PADDLE_TPU_CAPI_H_
#define PADDLE_TPU_CAPI_H_

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct PD_Predictor PD_Predictor;

typedef enum {
  PD_DTYPE_FLOAT32 = 0,
  PD_DTYPE_FLOAT64 = 1,
  PD_DTYPE_INT32 = 2,
  PD_DTYPE_INT64 = 3,
} PD_DType;

/* Borrowed-view tensor for inputs; owned (malloc'd) for outputs. */
typedef struct {
  int32_t dtype;      /* PD_DType */
  int32_t ndim;
  int64_t shape[8];
  void* data;         /* row-major, contiguous */
} PD_TensorData;

/* Create a predictor from a jit.save prefix (the ".pdmodel"-style prefix
 * paddle_tpu_torch.jit.save wrote). Returns NULL on failure — see
 * PD_GetLastError(). Initializes the embedded runtime on first call;
 * thread-safe. */
PD_Predictor* PD_PredictorCreate(const char* model_prefix);

/* Run inference. `inputs` is an array of n_inputs borrowed tensor views
 * (data is copied in). On success (*outputs, *n_outputs) receive a
 * malloc'd array of owned output tensors; free with PD_OutputsDestroy.
 * Returns 0 on success, nonzero on failure (PD_GetLastError()). */
int PD_PredictorRun(PD_Predictor* pred,
                    const PD_TensorData* inputs, int n_inputs,
                    PD_TensorData** outputs, int* n_outputs);

void PD_OutputsDestroy(PD_TensorData* outputs, int n_outputs);
void PD_PredictorDestroy(PD_Predictor* pred);

/* Last error message on this thread, or "" when none. The pointer stays
 * valid until the next failing call on the same thread. */
const char* PD_GetLastError(void);

#ifdef __cplusplus
}
#endif

#endif /* PADDLE_TPU_CAPI_H_ */
