"""Where the port's compiled artifacts persist between runs.

Counterpart of ``vub_image_denoising_tpu/utils/cache.py``, which points
JAX's persistent compilation cache at a directory.  The port compiles two
kinds of artifact: the CUDA kernel libraries, built by nvcc into
``build/torch_kernels/`` (``ops/cuda_build.py``), and the patch gather,
built by g++ into ``build/torch_native/`` (``native/``).  Both live beside
the package and are named by a hash of their sources and flags, so a later
process loads them as they are and an edited source is rebuilt.
"""

import os

from ..native import BUILD_DIR as NATIVE_DIR
from ..ops.cuda_build import BUILD_DIR as KERNEL_DIR


def enable_compilation_cache() -> str:
    """Create the build directories and return their parent, ``build/``.

    The entry points call it where the JAX ones call theirs; the cache
    itself is always on, since both build steps reuse what is there."""
    for d in (KERNEL_DIR, NATIVE_DIR):
        os.makedirs(d, exist_ok=True)
    return str(KERNEL_DIR.parent)
