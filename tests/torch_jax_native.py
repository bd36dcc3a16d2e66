"""The JAX package's native runtime, made ready before a port test builds a
JAX mesh.

The JAX builder picks the SAH split only when its native library loads
(craytracer_tpu/scene/build.py `default_split`); `build_bvh4(...,
split="sah")` without it warns and builds a median tree, whose fat table
differs from the port's. The JAX loader (craytracer_tpu/native.py
`_load`) builds native/libcraynative.so with `make` in place and, after
one failed `ctypes.CDLL` (a half-written file under several test
workers), gives up for the rest of the process. `ensure_jax_native`
builds the library under an exclusive lock shared by every port test
worker, waits (bounded) until a library that another process is writing
loads, then resets the loader and loads it again. It raises when the
library still cannot load: a port test that compares against a JAX mesh
build fails rather than compare against a median tree.

Each port test module that builds JAX meshes imports the autouse fixture
`jax_native` and marks `SAH_WARNING_IS_ERROR`, so a lost race shows under
its own name.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import tempfile
import time

import pytest

SAH_WARNING_IS_ERROR = pytest.mark.filterwarnings(
    "error:SAH split needs the native builder:UserWarning")
WAIT_S = 180.0


def ensure_jax_native(wait_s: float = WAIT_S):
    """Load the JAX package's native runtime; raise if it cannot load."""
    from craytracer_tpu import native as jn

    if jn._LIB is not None:
        return jn._LIB
    so = os.path.join(jn._NATIVE_DIR, "libcraynative.so")
    lock = os.path.join(tempfile.gettempdir(), "craytracer_native_make.lock")
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            subprocess.run(["make", "-C", jn._NATIVE_DIR], check=True,
                           capture_output=True, timeout=300)
            deadline = time.monotonic() + wait_s
            while True:
                try:
                    ctypes.CDLL(so)
                    break
                except OSError as e:
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"{so} does not load after {wait_s:.0f} s: {e}")
                    time.sleep(0.5)
            jn._TRIED, jn._LIB = False, None
            lib = jn._load()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    if lib is None:
        raise RuntimeError("the JAX native runtime does not load")
    return lib


jax_native = pytest.fixture(autouse=True, scope="module")(ensure_jax_native)
