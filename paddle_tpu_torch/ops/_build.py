"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``ops/csrc/<name>.cu`` has a plain C interface and no PyTorch
header, so it compiles in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

into ``paddle_tpu_torch/build/`` at first use.  The file name carries a
hash of the source and of every header it includes with quotes
(``csrc/*.cuh``), so an edited kernel or header is never served by a
stale library.  ``--use_fast_math`` is deliberately absent: the int8 matmul's
bit parity with its plain version rests on IEEE division and ``rintf``.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` raises when it is not 0, because a refused launch never runs
and a later synchronise would not report it.

Every build reports to ``profiler.compile_tracker`` (its seconds; a
library found built is a cache hit), and ``build_all(ptxas_verbose=True)``
records each kernel's registers and static shared memory from the ptxas
log with ``profiler.xmem.record_kernel_estimate`` (``ptxas_usage``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..profiler import compile_tracker, xmem

__all__ = ["SOURCES", "build_all", "start_all", "finish_all", "load",
           "check", "stream_ptr", "sm_count", "ptxas_usage"]

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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(path: Path, seen=None) -> Dict[Path, bytes]:
    """``path`` and every header it includes with quotes, transitively."""
    seen = {} if seen is None else seen
    if path not in seen:
        seen[path] = path.read_bytes()
        for inc in _INCLUDE.findall(seen[path]):
            _sources(path.parent / inc.decode(), seen)
    return seen


def _lib_path(name: str) -> Path:
    srcs = _sources(_CSRC / f"{name}.cu")
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sorted(srcs):
        h.update(p.name.encode() + b"\0" + srcs[p])
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


# (nvcc, temp file, library, start time)
_Job = Tuple[subprocess.Popen, Path, Path, float]


def _start(name: str, ptxas_verbose: bool) -> Optional[_Job]:
    out = _lib_path(name)
    if out.exists():
        compile_tracker.record_cache_hit(name)
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
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, job: _Job) -> str:
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    compile_tracker.record_build(name, time.perf_counter() - t0)
    return log


_ENTRY = re.compile(r"entry function '(\w+)'")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def ptxas_usage(log: str) -> Dict[str, dict]:
    """``{kernel: {"registers", "smem_bytes", "spill"}}`` from a ``-Xptxas
    -v`` log (the mangled name with its anonymous namespace cut; static
    shared memory only: what a launch asks for dynamically is not in
    it)."""
    out: Dict[str, dict] = {}
    fn = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            fn = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d\d", "",
                        m.group(1))
            continue
        if fn is None:
            continue
        e = out.setdefault(fn, {"registers": None, "smem_bytes": 0,
                                "spill": ""})
        m = _USED.search(line)
        if m:
            e["registers"] = int(m.group(1))
            e["smem_bytes"] = int(m.group(2) or 0)
        elif "spill" in line:
            e["spill"] = line.split(":", 1)[-1].strip()
    return out


def build_all(ptxas_verbose: bool = False) -> Dict[str, dict]:
    """Compile every kernel source that has no current library, one nvcc
    per source, all started together.  Returns ``{name: {"seconds",
    "log"}}``; an up-to-date library reports 0 seconds."""
    return finish_all(start_all(ptxas_verbose))


def start_all(ptxas_verbose: bool = False):
    """Start ``build_all``'s nvcc processes and return at once, so the
    caller can work while they compile; ``finish_all`` waits for them.
    Nothing may load a kernel library in between."""
    return time.perf_counter(), {n: _start(n, ptxas_verbose)
                                 for n in SOURCES}


def finish_all(started) -> Dict[str, dict]:
    """Wait for ``start_all``'s builds; ``build_all``'s report, each
    build's seconds counted from the start."""
    t0, jobs = started
    report = {}
    for n, job in jobs.items():
        log = "" if job is None else _finish(n, job)
        report[n] = {"seconds": (0.0 if job is None
                                 else time.perf_counter() - t0),
                     "log": log}
        for kernel, use in ptxas_usage(log).items():
            xmem.record_kernel_estimate(kernel, use["smem_bytes"], where=n,
                                        registers=use["registers"])
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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The multiprocessors of a CUDA ``device`` (a launch plan's input)."""
    return _sm_count(device.index or 0)
