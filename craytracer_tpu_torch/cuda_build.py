"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled on its own by nvcc for sm_90a into a shared
library with a plain C interface under craytracer_tpu_torch/_build/,
named by a hash of the source, the headers it includes and the flags, and
loaded with ctypes. `build_all` starts one nvcc per source at once and
waits for all of them, so a cold start pays for the slowest build only.
A kernel's C entry point returns cudaGetLastError(); `check` raises when
it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # no FMA contraction, IEEE division and sqrt: every multiply and add
    # rounds on its own, as in the op-by-op plain PyTorch versions
    "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v",
)


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA "
                       "toolkit to build")


class CudaLibrary:
    """One csrc/ source built into one shared library. `bind(lib)` sets the
    ctypes signatures of its entry points. `defines` ((name, value) pairs)
    go to nvcc as -D flags: one source built with other defines is another
    library (`name` tells the builds apart)."""

    def __init__(self, stem: str, headers=(), bind=None, defines=()):
        self.name = stem + "".join(f"_{k.lower()}{v}" for k, v in defines)
        self.source = CSRC / f"{stem}.cu"
        self.headers = tuple(CSRC / h for h in headers)
        self.defines = tuple(f"-D{k}={v}" for k, v in defines)
        self.ptxas_log = ""
        self.build_seconds = None
        self._bind = bind
        self._lib = None
        self._proc = None

    def _paths(self):
        h = hashlib.sha256(self.source.read_bytes())
        for p in self.headers:
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS + self.defines).encode())
        tag = h.hexdigest()[:16]
        return (BUILD_DIR / f"lib{self.name}_{tag}.so",
                BUILD_DIR / f"{self.name}_{tag}.log",
                BUILD_DIR / f".lib{self.name}_{tag}.{os.getpid()}.so")

    def start(self):
        """Start nvcc in the background unless this source was built."""
        if self._lib is not None or self._proc is not None:
            return
        so, _, tmp = self._paths()
        if so.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._t0 = time.perf_counter()
        self._proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, *self.defines, "-I", str(CSRC), "-o",
             str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def load(self) -> ctypes.CDLL:
        """Wait for the build (starting it if needed) and load the
        library."""
        if self._lib is not None:
            return self._lib
        self.start()
        so, log, tmp = self._paths()
        if self._proc is not None:
            out, _ = self._proc.communicate()
            rc = self._proc.returncode
            self._proc = None
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {self.source} ({rc}):\n"
                                   f"{out}")
            self.build_seconds = time.perf_counter() - self._t0
            log.write_text(out)
            os.replace(tmp, so)
        self.ptxas_log = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(so))
        lib.cray_error_string.argtypes = [ctypes.c_int]
        lib.cray_error_string.restype = ctypes.c_char_p
        if self._bind is not None:
            self._bind(lib)
        self._lib = lib
        return lib

    def check(self, err: int, what: str):
        if err != 0:
            msg = self._lib.cray_error_string(err).decode()
            raise RuntimeError(f"{what} launch failed: {msg}")


class LaunchCount:
    """A kernel's launch count: its wrapper adds one where it launches."""

    def __init__(self):
        self.launches = 0


def build_all(libs):
    """Build every library with one nvcc each, all started together."""
    for lib in libs:
        lib.start()
    for lib in libs:
        lib.load()
