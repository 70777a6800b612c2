"""Native host runtime: the C++ batched patch gather, bound with ctypes.

Counterpart of ``vub_image_denoising_tpu/native``, with its own copy of
``patchio.cpp``.  The source is built once with ``g++ -O3 -shared`` into
``build/torch_native/`` beside the package, named by a hash of the source.
A failed build raises: the numpy gather is the plain version and the path
for frames with an unusual layout, not a silent stand-in for a missing
toolchain.  ``VUB_NATIVE=0`` is the one opt-out (numpy gather throughout).

API:
  gather_patches(frames, tops, lefts, patch) -> (n, patch, patch, C) uint8 batch
      frames: list of HWC uint8 arrays (one per patch; duplicates fine)
  native_available() -> bool
  gather_patches.native_calls: how many batches went through the C++ gather
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parent / "patchio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
_ABI = 1
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build_and_load() -> ctypes.CDLL:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so_path = BUILD_DIR / f"patchio_{tag}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(f".build{os.getpid()}")
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", str(_SRC),
               "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC.name}:\n{proc.stderr}")
        os.replace(tmp, so_path)  # atomic: two processes building at once both succeed
    lib = ctypes.CDLL(str(so_path))
    lib.pio_abi_version.restype = ctypes.c_int64
    lib.pio_abi_version.argtypes = []
    if lib.pio_abi_version() != _ABI:
        raise RuntimeError(f"patchio ABI mismatch: {lib.pio_abi_version()} != {_ABI}")
    lib.pio_gather_u8.restype = None
    lib.pio_gather_u8.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),   # srcs
        ctypes.POINTER(ctypes.c_int64),    # src_row_bytes
        ctypes.POINTER(ctypes.c_int64),    # tops
        ctypes.POINTER(ctypes.c_int64),    # lefts
        ctypes.c_int64,                    # n
        ctypes.c_int64,                    # patch_h
        ctypes.c_int64,                    # patch_w
        ctypes.c_int64,                    # channels
        ctypes.c_void_p,                   # out
        ctypes.c_int64,                    # n_threads
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    """The built library, or None under ``VUB_NATIVE=0``; a failed build raises
    (and is tried again at the next call)."""
    global _lib
    if os.environ.get("VUB_NATIVE", "1") == "0":
        return None
    with _lock:
        if _lib is None:
            _lib = _build_and_load()
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def _gather_numpy(frames, tops, lefts, patch: int) -> np.ndarray:
    n = len(frames)
    c = frames[0].shape[-1]
    out = np.empty((n, patch, patch, c), np.uint8)
    for i in range(n):
        t, l = tops[i], lefts[i]
        out[i] = frames[i][t : t + patch, l : l + patch]
    return out


def gather_patches(
    frames: Sequence[np.ndarray],
    tops: Sequence[int],
    lefts: Sequence[int],
    patch: int,
    n_threads: Optional[int] = None,
) -> np.ndarray:
    """Copy ``len(frames)`` HWC uint8 patches into one contiguous batch.

    Frames whose rows are not C-contiguous uint8 take the numpy gather; a
    patch window outside its frame raises ``ValueError`` before any pointer
    reaches C.
    """
    n = len(frames)
    if n == 0:
        raise ValueError("gather_patches: empty batch")
    c = frames[0].shape[-1]
    lib = _get_lib()
    if lib is None:
        return _gather_numpy(frames, tops, lefts, patch)

    srcs = (ctypes.c_void_p * n)()
    row_bytes = (ctypes.c_int64 * n)()
    tops_c = (ctypes.c_int64 * n)()
    lefts_c = (ctypes.c_int64 * n)()
    for i, f in enumerate(frames):
        if (f.dtype != np.uint8 or f.ndim != 3 or f.shape[2] != c
                or f.strides[1] != f.shape[2] or f.strides[2] != 1):
            return _gather_numpy(frames, tops, lefts, patch)  # unusual layout
        t, l = int(tops[i]), int(lefts[i])
        if t < 0 or l < 0 or t + patch > f.shape[0] or l + patch > f.shape[1]:
            raise ValueError(
                f"gather_patches: patch window [{t}:{t + patch}, {l}:{l + patch}] "
                f"exceeds frame {i} of shape {f.shape[:2]}"
            )
        srcs[i] = f.ctypes.data
        row_bytes[i] = f.strides[0]
        tops_c[i] = t
        lefts_c[i] = l
    out = np.empty((n, patch, patch, c), np.uint8)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    lib.pio_gather_u8(
        srcs, row_bytes, tops_c, lefts_c, n, patch, patch, c,
        out.ctypes.data_as(ctypes.c_void_p), n_threads,
    )
    with _lock:
        gather_patches.native_calls += 1
    return out


gather_patches.native_calls = 0
