/* C serving host example: link against the port's libpaddle_tpu_capi.so
 * and serve a jit.save artifact from pure C (the port of
 * examples/serve_capi.c).
 *
 * Build (from the repository root):
 *   python -c "from paddle_tpu_torch.inference import capi; \
 *       capi.build_host('paddle_tpu_torch/examples/serve_capi.c', 'serve')"
 * Run (after saving a model with paddle_tpu_torch.jit.save(net, "model",
 * input_spec=[InputSpec([1, 8], "float32")])):
 *   PYTHONPATH=$PWD ./serve model          (on the card)
 *   PADDLE_TPU_CAPI_PLATFORM=cpu PYTHONPATH=$PWD ./serve model
 */
#include <stdio.h>
#include "paddle_tpu_capi.h"

int main(int argc, char** argv) {
  if (argc < 2) { fprintf(stderr, "usage: %s <model_prefix>\n", argv[0]);
                  return 2; }
  PD_Predictor* p = PD_PredictorCreate(argv[1]);
  if (!p) { fprintf(stderr, "create failed: %s\n", PD_GetLastError());
            return 1; }
  float input[8] = {0};
  PD_TensorData in = {PD_DTYPE_FLOAT32, 2, {1, 8}, input};
  PD_TensorData* outs; int n;
  if (PD_PredictorRun(p, &in, 1, &outs, &n) != 0) {
    fprintf(stderr, "run failed: %s\n", PD_GetLastError());
    return 1;
  }
  printf("outputs: %d; first tensor dims:", n);
  for (int d = 0; d < outs[0].ndim; ++d)
    printf(" %lld", (long long)outs[0].shape[d]);
  printf("\n");
  PD_OutputsDestroy(outs, n);
  PD_PredictorDestroy(p);
  return 0;
}
