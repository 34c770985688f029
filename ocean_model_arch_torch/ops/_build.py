"""Build and load the port's CUDA kernels: nvcc into a shared library with
a plain C interface, bound with ctypes (the pattern of
``ocean_model_arch_tpu/io/native.py``, for CUDA).

Each ``csrc/<name>.cu`` compiles on first use into
``build/torch_kernels/lib<name>-<hash>.so`` of the checkout, keyed on a
hash of the source, the headers beside it (``csrc/*.cuh``) and the
flags, so a fresh checkout builds what it runs and an edited source or
header rebuilds. A target ``<name>@<MACRO>=<value>[@<MACRO>=<value>...]``
is the same source compiled with ``-D<MACRO>=<value>`` for each into a
library of its own: the fused step's forms are split so, by tracer count
and form, into libraries that build side by side. A failed build raises:
there is no fallback. Nothing here runs at import time.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

# No --use_fast_math: the tolerances assume IEEE f32 division and denormals.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> {"path", "seconds", "log"} of the builds made by this process
BUILDS: dict = {}
# one lock a target: a caller that asks for a library another thread is
# building waits for that build instead of starting a second one
_LOCKS: dict = {}
_LOCKS_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return path


def build(name: str) -> str:
    """Compile the target ``name`` (``<source>``, or
    ``<source>@<MACRO>=<value>`` with one or more defines) unless its
    hashed library exists; returns the library path. Another thread's
    build of the same target is waited for, not repeated."""
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        return _build_locked(name)


def _build_locked(name: str) -> str:
    source, *defines = name.split("@")
    src = os.path.join(CSRC, source + ".cu")
    flags = NVCC_FLAGS + tuple("-D" + d for d in defines)
    key = hashlib.sha256(" ".join(flags).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            key.update(f.read())
    so = os.path.join(BUILD_DIR, "lib" + name.replace("@", "-").replace(
        "=", "") + f"-{key.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc(), *flags, "-o", tmp, src]
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    os.replace(tmp, so)            # atomic: concurrent builds agree
    BUILDS[name] = {"path": so, "seconds": time.perf_counter() - t0,
                    "log": res.stdout + res.stderr}
    return so


def build_all(names) -> list:
    """Build several targets at once, one nvcc each, all started
    together; returns their library paths."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(build, names))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of the target ``name``, built if needed."""
    return ctypes.CDLL(build(name))
