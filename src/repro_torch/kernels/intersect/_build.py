"""Build `csrc/intersect.cu` with nvcc on first use and load it with ctypes.

The source compiles to a shared library with a plain C interface (no
PyTorch headers, so nvcc takes seconds), named by a hash of the source
and flags under `build/` at the checkout's root; a later process with
the same source reuses it. Nothing here runs at import time.
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

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build in this process did: nvcc seconds (0.0 when the
# library was already built) and ptxas's register/shared-memory report
build_info: dict = {"seconds": None, "ptxas": "", "path": None}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the intersect CUDA "
            "kernels are built from source on first use")
    return found


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu")):
        digest.update(src.read_bytes())
    return _BUILD_DIR / f"libintersect-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernels if needed; returns the library's path."""
    lib_path = library_path()
    if lib_path.exists():
        build_info.update(seconds=0.0, path=str(lib_path))
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, sorted(_CSRC.glob("*.cu")))],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)        # atomic: concurrent builders agree
    build_info.update(seconds=time.perf_counter() - t0,
                      ptxas=proc.stdout + proc.stderr, path=str(lib_path))
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            vp, i = ctypes.c_void_p, ctypes.c_int
            handle.intersect_max_steps.argtypes = []
            handle.intersect_max_steps.restype = i
            handle.and_popcount_launch.argtypes = [vp, vp, vp, i, i, i, vp]
            handle.and_popcount_launch.restype = i
            handle.combine_program_launch.argtypes = [vp, vp, vp, vp,
                                                      i, i, i, i, vp]
            handle.combine_program_launch.restype = i
            _lib = handle
        return _lib
