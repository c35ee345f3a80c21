"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``ops/csrc/<name>.cu`` has a plain C interface and no PyTorch
header, so it compiles in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

into ``paddle_tpu_torch/build/`` at first use.  The file name carries a
hash of the source, so an edited kernel is never served by a stale
library.  ``--use_fast_math`` is deliberately absent: the int8 matmul's
bit parity with its plain version rests on IEEE division and ``rintf``.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` raises when it is not 0, because a refused launch never runs
and a later synchronise would not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

__all__ = ["SOURCES", "build_all", "load", "check", "stream_ptr"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
BUILD_DIR = _HERE.parent / "build"
SOURCES = ("int8_matmul", "ragged_paged_attention", "flash_attention",
           "fused_blocks")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit on PATH or "
                       "under CUDA_HOME)")


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


_Job = Tuple[subprocess.Popen, Path, Path]   # (nvcc, temp file, library)


def _start(name: str, ptxas_verbose: bool) -> Optional[_Job]:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: concurrent builds (test
    # workers) never load a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    if ptxas_verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job: _Job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(ptxas_verbose: bool = False) -> Dict[str, dict]:
    """Compile every kernel source that has no current library, one nvcc
    per source, all started together.  Returns ``{name: {"seconds",
    "log"}}``; an up-to-date library reports 0 seconds."""
    t0 = time.perf_counter()
    jobs = {n: _start(n, ptxas_verbose) for n in SOURCES}
    report = {}
    for n, job in jobs.items():
        log = "" if job is None else _finish(n, job)
        report[n] = {"seconds": (0.0 if job is None
                                 else time.perf_counter() - t0),
                     "log": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``ops/csrc/<name>.cu``, built on first
    use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            job = _start(name, False)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, as the int a C entry point
    takes for its ``cudaStream_t``."""
    return torch.cuda.current_stream(device).cuda_stream
