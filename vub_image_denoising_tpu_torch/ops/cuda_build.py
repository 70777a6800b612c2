"""Build a CUDA source of ``csrc/`` into a shared library and load it with ctypes.

The library is compiled by ``nvcc`` at first use into ``build/torch_kernels/``
beside the package, named by a hash of its sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  Only sources in
the package are compiled; nothing is fetched.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_locks_guard = threading.Lock()
_locks = {}  # library name -> lock; libraries build in parallel, each once
_loaded = {}
build_seconds = {}  # library name -> seconds its nvcc run took (0 when cached)
ptxas_log = {}  # library name -> nvcc's stderr: ptxas registers, shared memory, spills


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit (set CUDA_HOME)")
    return found


def load_library(name: str, source: str, headers=()) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (which may include ``csrc/<headers>``) once and
    return the loaded library; thread-safe, and two libraries may build at once."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in (source, *headers):
            digest.update((CSRC / f).read_bytes())
        lib_path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
        t0 = time.monotonic()
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
            lib_path.with_suffix(".ptxas.txt").write_text(proc.stderr)
            os.replace(tmp, lib_path)
        build_seconds[name] = time.monotonic() - t0
        log = lib_path.with_suffix(".ptxas.txt")
        ptxas_log[name] = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(lib_path))
        _loaded[name] = lib
        return lib
