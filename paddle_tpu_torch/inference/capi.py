"""Build the C serving ABI (``paddle_tpu_torch/capi/``) and C hosts that
link it.

``build()`` compiles ``predictor_capi.cc`` with ``g++`` into
``libpaddle_tpu_capi.so`` (by default under ``paddle_tpu_torch/build/
capi/``, rebuilt when a source is newer), linked against the running
interpreter's shared libpython (``sysconfig``: its include directory,
``LIBDIR``, ``LDLIBRARY``, with an rpath), and started as that
interpreter (``PTT_PYTHON_EXECUTABLE``), so a virtual environment's
site-packages, torch's among them, are found.  ``build_host(source,
out)`` links a C program against it; ``host_env()`` is the environment
a host runs in (``PYTHONPATH`` naming this checkout, and
``PADDLE_TPU_CAPI_PLATFORM=cpu`` when the caller asks for the CPU).
"""
from __future__ import annotations

import os
import subprocess
import sys
import sysconfig
from typing import Optional

__all__ = ["CAPI_DIR", "build", "build_host", "host_env"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPI_DIR = os.path.join(_PKG, "capi")
_SOURCES = ("predictor_capi.cc", "paddle_tpu_capi.h")
_LIB = "libpaddle_tpu_capi.so"


def _libpython():
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        raise RuntimeError(
            f"{sys.executable} was built without a shared libpython "
            "(Py_ENABLE_SHARED=0): the C ABI embeds the interpreter and "
            "needs libpython*.so to link against")
    libdir = sysconfig.get_config_var("LIBDIR")
    name = sysconfig.get_config_var("LDLIBRARY")      # libpython3.X.so
    return libdir, name[len("lib"):].split(".so")[0]


def build(out_dir: Optional[str] = None) -> str:
    """The path of ``libpaddle_tpu_capi.so``, compiled into ``out_dir``
    unless one newer than its sources is there."""
    out_dir = out_dir or os.path.join(_PKG, "build", "capi")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, _LIB)
    newest = max(os.path.getmtime(os.path.join(CAPI_DIR, s))
                 for s in _SOURCES)
    if os.path.exists(lib) and os.path.getmtime(lib) >= newest:
        return lib
    libdir, pylib = _libpython()
    tmp = f"{lib}.tmp.{os.getpid()}"
    cmd = ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-pthread",
           f"-I{sysconfig.get_paths()['include']}", f"-I{CAPI_DIR}",
           f'-DPTT_PYTHON_EXECUTABLE="{sys.executable}"',
           os.path.join(CAPI_DIR, "predictor_capi.cc"), "-o", tmp,
           f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-l{pylib}"]
    _run(cmd)
    os.replace(tmp, lib)
    return lib


def build_host(source: str, out: str, lib: Optional[str] = None) -> str:
    """Compile the C program ``source`` into ``out`` against the C ABI's
    header and library (``lib``, else ``build()``'s)."""
    lib = lib or build()
    libdir = os.path.dirname(os.path.abspath(lib))
    _run(["gcc", "-O2", source, "-o", out, f"-I{CAPI_DIR}", f"-L{libdir}",
          "-lpaddle_tpu_capi", f"-Wl,-rpath,{libdir}"])
    return out


def host_env(device: Optional[str] = None) -> dict:
    """The environment for a C host: this process's, with this checkout
    on ``PYTHONPATH``; ``device="cpu"`` sets
    ``PADDLE_TPU_CAPI_PLATFORM=cpu``, otherwise the host serves on the
    card."""
    env = dict(os.environ)
    root = os.path.dirname(_PKG)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    env.pop("PADDLE_TPU_CAPI_PLATFORM", None)
    if device is not None and str(device) == "cpu":
        env["PADDLE_TPU_CAPI_PLATFORM"] = "cpu"
    return env


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
