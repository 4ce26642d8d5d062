"""Build and load the hand-written CUDA kernels (nvcc -> shared library -> ctypes).

At first use each library is compiled from ``ops/csrc/`` with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into
``build/kernels/<name>-<hash>/`` at the repository root. The hash covers the
sources, the shared headers and the flags, so a rerun on unchanged sources
loads the library that is already there. The library has a plain C
interface: every pointer and the stream go through ``ctypes.c_void_p``, and
each entry point returns ``cudaGetLastError()`` so the wrapper can raise on a
refused launch.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Tuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "kernels")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> (sources under csrc/, {C function: (argtypes, restype)})
LIBRARIES: Dict[str, Tuple[List[str], Dict[str, tuple]]] = {
    "flash_fwd": (["flash_fwd.cu"], {
        "flash_fwd": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                      + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    }),
    "flash_bwd": (["flash_bwd.cu"], {
        name: ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
               + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int)
        for name in ("flash_bwd_dq", "flash_bwd_dkv")
    }),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.isfile(DEFAULT_NVCC):
        path = DEFAULT_NVCC
    if path is None:
        raise KernelBuildError(
            f"nvcc not found on PATH or at {DEFAULT_NVCC}: the CUDA kernels of "
            "ray_tpu_torch are compiled at first use and there is no fallback")
    return path


def _digest(sources: List[str]) -> str:
    """Hash of the flags, the sources and every header under csrc/."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for src in [*sources, *headers]:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(name: str) -> str:
    """Compile library `name` unless a build of these exact sources exists;
    return the path of the shared library."""
    sources, _ = LIBRARIES[name]
    out_dir = os.path.join(BUILD_ROOT, f"{name}-{_digest(sources)}")
    lib_path = os.path.join(out_dir, f"lib{name}.so")
    if os.path.isfile(lib_path):
        return lib_path
    nvcc = nvcc_path()
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(os.path.join(CSRC, s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed ({proc.returncode}) for {name}:\n{log}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    return lib_path


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library `name`, with argtypes declared."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for fn, (argtypes, restype) in LIBRARIES[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
        return lib
