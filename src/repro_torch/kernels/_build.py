"""Build a kernel package's `csrc/*.cu` with nvcc on first use and load
it with ctypes.

Each source directory compiles to one shared library with a plain C
interface (no PyTorch headers, so nvcc takes seconds; one nvcc a source,
started together, then one link), named by the
library's name and a hash of its own sources, the headers beside them
(`*.cuh`) and flags under `build/` at
the checkout's root; a later process with the same sources reuses it.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable

from ..analysis.locks import OrderedLock

_BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc(name: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(
            f"nvcc not found (PATH or $CUDA_HOME/bin): the {name} CUDA "
            "kernels are built from source on first use")
    return found


class Library:
    """One kernel package's library: `csrc` holds its `.cu` sources and
    `declare(handle)` sets the C functions' argtypes and restypes;
    `defines` are extra nvcc flags (`-DNAME=value`) for a build with
    other tuning constants."""

    def __init__(self, name: str, csrc: Path,
                 declare: Callable[[ctypes.CDLL], None],
                 defines: tuple[str, ...] = ()):
        self.name, self.csrc, self._declare = name, Path(csrc), declare
        self.flags = NVCC_FLAGS + tuple(defines)
        self._lock = OrderedLock(f"kernels.build.{name}")
        self._lib: ctypes.CDLL | None = None
        # what the last build in this process did: nvcc seconds (0.0 when
        # the library was already built) and ptxas's register report
        self.build_info: dict = {"seconds": None, "ptxas": "", "path": None}

    def sources(self) -> list[Path]:
        return sorted(self.csrc.glob("*.cu"))

    def library_path(self) -> Path:
        """Where the library for the current sources and flags lives."""
        digest = hashlib.sha1(" ".join(self.flags).encode())
        for src in self.sources() + sorted(self.csrc.glob("*.cuh")):
            digest.update(src.read_bytes())
        return _BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:12]}.so"

    def build(self) -> Path:
        """Compile the kernels if needed; returns the library's path."""
        lib_path = self.library_path()
        if lib_path.exists():
            self.build_info.update(seconds=0.0, path=str(lib_path))
            return lib_path
        nvcc = _nvcc(self.name)
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        sources = self.sources()
        objects = [tmp.with_name(f"{tmp.name}.{src.stem}.o")
                   for src in sources]
        compile_flags = [f for f in self.flags if f != "-shared"]
        t0 = time.perf_counter()

        def run(args: list[str]) -> subprocess.CompletedProcess:
            proc = subprocess.run([nvcc, *args], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                                   f"{self.name}:\n{proc.stdout}"
                                   f"{proc.stderr}")
            return proc

        try:   # one nvcc a source, all started together, then one link
            with ThreadPoolExecutor(len(sources)) as pool:
                procs = list(pool.map(
                    lambda so: run([*compile_flags, "-c", "-o", str(so[1]),
                                    str(so[0])]), zip(sources, objects)))
            run([*self.flags, "-o", str(tmp), *map(str, objects)])
        finally:
            for obj in objects:
                obj.unlink(missing_ok=True)
        os.replace(tmp, lib_path)        # atomic: concurrent builders agree
        self.build_info.update(seconds=time.perf_counter() - t0,
                               ptxas="".join(p.stdout + p.stderr
                                             for p in procs),
                               path=str(lib_path))
        return lib_path

    def lib(self) -> ctypes.CDLL:
        """The loaded kernel library, built on first call."""
        with self._lock:
            if self._lib is None:
                handle = ctypes.CDLL(str(self.build()))
                self._declare(handle)
                self._lib = handle
            return self._lib
