"""Build and load the hand-written CUDA kernels (route: nvcc + ctypes).

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and is compiled
at first use into ``_build/lib<name>_<hash>.so`` beside this file, where
``<hash>`` covers the source and the flags, so an edited source rebuilds.
Nothing is built at import time, and nothing falls back: a missing ``nvcc``
or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
# no --use_fast_math: it changes expf/tanhf and flushes denormals
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# compiler output of each build this process made (ptxas registers/spills)
BUILD_LOG: dict[str, str] = {}


def find_nvcc() -> str:
    """``nvcc`` on PATH, then in ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or in /usr/local/cuda/bin; "
        "the CUDA kernels of njode_tpu_torch are compiled from ops/csrc at "
        "first use")


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, built if needed."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {res.returncode}: "
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        BUILD_LOG[name] = res.stdout + res.stderr
        os.replace(tmp, lib_path)  # atomic: concurrent builders race safely
    lib = ctypes.CDLL(str(lib_path))
    lib.njode_cuda_error_string.argtypes = [ctypes.c_int]
    lib.njode_cuda_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.njode_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
