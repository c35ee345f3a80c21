// Native serving host: the C ABI over the port's Predictor (the port's
// copy of csrc/predictor_capi.cc: the same ABI, GIL and error
// discipline).
//
// Reference analog: paddle/fluid/inference/capi_exp/pd_predictor.cc — the
// C functions there forward into the C++ AnalysisPredictor; here they
// forward into an embedded CPython interpreter hosting
// paddle_tpu_torch.inference.Predictor, which runs the torch.export
// artifact (the port's CUDA kernels as custom-op nodes) on the card. The
// host process is pure C/C++: it links this library and never includes
// Python headers itself. Marshalling copies buffers at the boundary,
// matching the reference's copy_from_cpu/copy_to_cpu contract.
//
// The device: the card, unless PADDLE_TPU_CAPI_PLATFORM=cpu (the
// reference's variable) asks for the CPU; with no card the create fails.
// PADDLE_TPU_CAPI_LAUNCHES=<file>: after every run the file holds the
// port's kernel launch counts since the start, as JSON (diagnostics).
//
// Interpreter lifecycle: initialized lazily on the first PD_PredictorCreate
// and kept alive for the process (finalizing a runtime with live device
// contexts is undefined in the reference too — AnalysisPredictor never
// tears down CUDA). It starts as the interpreter the library was built
// with (PTT_PYTHON_EXECUTABLE, so a virtual environment's site-packages
// are found) and reads PYTHONPATH. All entry points take the GIL via
// PyGILState_Ensure, so any host thread may call them.

#include "paddle_tpu_capi.h"

#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

namespace {

thread_local std::string g_last_error;

void set_error(const std::string& msg) { g_last_error = msg; }

std::string fetch_py_error() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return msg;
}

const char* dtype_name(int32_t dt) {
  switch (dt) {
    case PD_DTYPE_FLOAT32: return "float32";
    case PD_DTYPE_FLOAT64: return "float64";
    case PD_DTYPE_INT32: return "int32";
    case PD_DTYPE_INT64: return "int64";
    default: return nullptr;
  }
}

int dtype_code(const char* name) {
  if (!strcmp(name, "float32")) return PD_DTYPE_FLOAT32;
  if (!strcmp(name, "float64")) return PD_DTYPE_FLOAT64;
  if (!strcmp(name, "int32")) return PD_DTYPE_INT32;
  if (!strcmp(name, "int64")) return PD_DTYPE_INT64;
  return -1;
}

size_t dtype_size(int32_t dt) {
  switch (dt) {
    case PD_DTYPE_FLOAT32: case PD_DTYPE_INT32: return 4;
    default: return 8;
  }
}

// Python-side bridge, defined once: creates predictors and runs them on
// (bytes, shape, dtype) triples so the C side only marshals PyBytes /
// PyLong / PyUnicode — no numpy C API dependency.
const char* kBootstrap = R"PY(
import os as _os
import numpy as _np

_predictors = {}
_next_id = [1]

def _capi_create(prefix):
    from paddle_tpu_torch.inference import Config, create_predictor
    cfg = Config(prefix)
    plat = _os.environ.get("PADDLE_TPU_CAPI_PLATFORM", "")
    if plat == "cpu":
        cfg.disable_gpu()
    elif plat not in ("", "gpu", "cuda"):
        raise ValueError("PADDLE_TPU_CAPI_PLATFORM=%r: expected 'cpu' or "
                         "unset (the card)" % plat)
    pred = create_predictor(cfg)
    pid = _next_id[0]; _next_id[0] += 1
    _predictors[pid] = pred
    return pid

def _capi_run(pid, inputs):
    pred = _predictors[pid]
    # frombuffer views are safe without a copy: the bytes objects stay
    # alive for the call and inputs are consumed read-only.
    arrays = [_np.frombuffer(b, dtype=dt).reshape(shape)
              for (b, shape, dt) in inputs]
    outs = pred.run(arrays)
    _note_launches()
    result = []
    for o in outs:
        a = _np.ascontiguousarray(o)
        if a.dtype == _np.bool_:
            a = a.astype(_np.int32)
        if a.dtype not in (_np.float32, _np.float64,
                           _np.int32, _np.int64):
            a = a.astype(_np.float32)
        result.append((a.tobytes(), tuple(int(d) for d in a.shape),
                       str(a.dtype)))
    return result

def _note_launches():
    # diagnostics: PADDLE_TPU_CAPI_LAUNCHES names a file that receives,
    # after every run, the port's kernel launch counts since the start
    path = _os.environ.get("PADDLE_TPU_CAPI_LAUNCHES")
    if path:
        import json
        from paddle_tpu_torch.bench import KERNELS
        with open(path, "w") as f:
            json.dump({n: w.launches for n, w in KERNELS.items()}, f)

def _capi_destroy(pid):
    _predictors.pop(pid, None)
)PY";

PyObject* g_bridge = nullptr;  // module dict holding the bridge functions
std::once_flag g_init_once;
bool g_init_ok = false;

#ifndef PTT_PYTHON_EXECUTABLE
#error "build with -DPTT_PYTHON_EXECUTABLE=<interpreter path> (capi.build)"
#endif

void init_interpreter() {
  if (!Py_IsInitialized()) {
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    config.install_signal_handlers = 0;
    // the build's interpreter: its prefix, its venv, its site-packages
    PyStatus status = PyConfig_SetBytesString(
        &config, &config.program_name, PTT_PYTHON_EXECUTABLE);
    if (!PyStatus_Exception(status)) {
      status = Py_InitializeFromConfig(&config);
    }
    PyConfig_Clear(&config);
    if (PyStatus_Exception(status)) {
      set_error(std::string("embedded interpreter failed to start: ") +
                (status.err_msg ? status.err_msg : "unknown"));
      return;
    }
    // Release the GIL acquired by initialization so PyGILState_Ensure
    // works uniformly from every thread (including this one).
    PyEval_SaveThread();
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* mod = PyImport_AddModule("__paddle_tpu_capi__");  // borrowed
  PyObject* dict = PyModule_GetDict(mod);                     // borrowed
  // __builtins__ is absent from a fresh module's dict when running
  // embedded; PyRun_String needs it resolvable.
  if (!PyDict_GetItemString(dict, "__builtins__")) {
    PyDict_SetItemString(dict, "__builtins__", PyEval_GetBuiltins());
  }
  PyObject* res = PyRun_String(kBootstrap, Py_file_input, dict, dict);
  if (!res) {
    set_error("capi bootstrap failed: " + fetch_py_error());
  } else {
    Py_DECREF(res);
    Py_INCREF(dict);
    g_bridge = dict;
    g_init_ok = true;
  }
  PyGILState_Release(gil);
}

PyObject* bridge_call(const char* fn, PyObject* args /* stolen */) {
  PyObject* f = PyDict_GetItemString(g_bridge, fn);  // borrowed
  if (!f) {
    Py_XDECREF(args);
    set_error(std::string("bridge function missing: ") + fn);
    return nullptr;
  }
  PyObject* out = PyObject_CallObject(f, args);
  Py_XDECREF(args);
  if (!out) set_error(fetch_py_error());
  return out;
}

}  // namespace

struct PD_Predictor {
  long long pid;
};

extern "C" {

PD_Predictor* PD_PredictorCreate(const char* model_prefix) {
  g_last_error.clear();
  std::call_once(g_init_once, init_interpreter);
  if (!g_init_ok) {
    // init_interpreter recorded the detail on the thread that ran it;
    // other threads still need a diagnostic on their own thread_local.
    if (g_last_error.empty()) {
      set_error("embedded runtime failed to initialize");
    }
    return nullptr;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PD_Predictor* handle = nullptr;
  PyObject* args = Py_BuildValue("(s)", model_prefix);
  PyObject* pid = bridge_call("_capi_create", args);
  if (pid) {
    handle = new PD_Predictor{PyLong_AsLongLong(pid)};
    Py_DECREF(pid);
  }
  PyGILState_Release(gil);
  return handle;
}

int PD_PredictorRun(PD_Predictor* pred,
                    const PD_TensorData* inputs, int n_inputs,
                    PD_TensorData** outputs, int* n_outputs) {
  g_last_error.clear();
  if (!pred || !outputs || !n_outputs) {
    set_error("null argument");
    return 1;
  }
  *outputs = nullptr;
  *n_outputs = 0;
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = 1;
  PyObject* in_list = PyList_New(n_inputs);
  bool build_ok = in_list != nullptr;
  for (int i = 0; build_ok && i < n_inputs; ++i) {
    const PD_TensorData& t = inputs[i];
    const char* dt = dtype_name(t.dtype);
    if (!dt || t.ndim < 0 || t.ndim > 8 || !t.data) {
      set_error("bad input dtype/ndim/data at index " + std::to_string(i));
      build_ok = false;
      break;
    }
    size_t n = 1;
    bool shape_ok = true;
    for (int d = 0; d < t.ndim; ++d) {
      // negative dims would wrap the size_t product into a huge read
      if (t.shape[d] < 0 ||
          (t.shape[d] > 0 &&
           n > static_cast<size_t>(1) << 40)) {  // cap: 1T elements
        shape_ok = false;
        break;
      }
      n *= static_cast<size_t>(t.shape[d]);
    }
    if (!shape_ok) {
      set_error("bad input shape at index " + std::to_string(i) +
                " (negative or overflowing dims)");
      build_ok = false;
      break;
    }
    PyObject* shape = PyTuple_New(t.ndim);
    for (int d = 0; shape && d < t.ndim; ++d) {
      PyTuple_SetItem(shape, d, PyLong_FromLongLong(t.shape[d]));
    }
    PyObject* bytes = PyBytes_FromStringAndSize(
        static_cast<const char*>(t.data),
        static_cast<Py_ssize_t>(n * dtype_size(t.dtype)));
    PyObject* dts = PyUnicode_FromString(dt);
    PyObject* triple = (shape && bytes && dts)
        ? PyTuple_Pack(3, bytes, shape, dts) : nullptr;
    Py_XDECREF(bytes);
    Py_XDECREF(shape);
    Py_XDECREF(dts);
    if (!triple) {
      PyErr_Clear();
      set_error("input marshalling failed at index " + std::to_string(i));
      build_ok = false;
      break;
    }
    PyList_SetItem(in_list, i, triple);  // steals
  }
  if (build_ok) {
    // "O" increfs in_list: args owns its own reference, drop ours now.
    PyObject* args = Py_BuildValue("(LO)", pred->pid, in_list);
    Py_DECREF(in_list);
    in_list = nullptr;
    PyObject* result = bridge_call("_capi_run", args);
    if (result) {
      Py_ssize_t n_out = PyList_Size(result);
      PD_TensorData* outs = static_cast<PD_TensorData*>(
          calloc(static_cast<size_t>(n_out), sizeof(PD_TensorData)));
      bool ok = true;
      for (Py_ssize_t i = 0; ok && i < n_out; ++i) {
        PyObject* triple = PyList_GetItem(result, i);  // borrowed
        PyObject* bytes = PyTuple_GetItem(triple, 0);
        PyObject* shape = PyTuple_GetItem(triple, 1);
        PyObject* dtype = PyTuple_GetItem(triple, 2);
        int code = dtype_code(PyUnicode_AsUTF8(dtype));
        Py_ssize_t ndim = PyTuple_Size(shape);
        if (code < 0 || ndim > 8) {
          set_error("unsupported output dtype/rank at " + std::to_string(i));
          ok = false;
          break;
        }
        outs[i].dtype = code;
        outs[i].ndim = static_cast<int32_t>(ndim);
        for (Py_ssize_t d = 0; d < ndim; ++d) {
          outs[i].shape[d] = PyLong_AsLongLong(PyTuple_GetItem(shape, d));
        }
        Py_ssize_t len = PyBytes_Size(bytes);
        outs[i].data = malloc(static_cast<size_t>(len));
        memcpy(outs[i].data, PyBytes_AsString(bytes),
               static_cast<size_t>(len));
      }
      if (ok) {
        *outputs = outs;
        *n_outputs = static_cast<int>(n_out);
        rc = 0;
      } else {
        PD_OutputsDestroy(outs, static_cast<int>(n_out));
      }
      Py_DECREF(result);
    }
  }
  Py_XDECREF(in_list);
  PyGILState_Release(gil);
  return rc;
}

void PD_OutputsDestroy(PD_TensorData* outputs, int n_outputs) {
  if (!outputs) return;
  for (int i = 0; i < n_outputs; ++i) free(outputs[i].data);
  free(outputs);
}

void PD_PredictorDestroy(PD_Predictor* pred) {
  if (!pred) return;
  if (g_init_ok) {
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* args = Py_BuildValue("(L)", pred->pid);
    PyObject* r = bridge_call("_capi_destroy", args);
    Py_XDECREF(r);
    PyGILState_Release(gil);
  }
  delete pred;
}

const char* PD_GetLastError(void) { return g_last_error.c_str(); }

}  // extern "C"
