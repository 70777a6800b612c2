"""Random-stream discipline: one root seed per run, and a stream for each
consumer named by a static tag and a step, so streams never collide.

Counterpart of ``vub_image_denoising_tpu/utils/prng.py`` (which replaces the
reference's global ``torch.manual_seed`` tricks, custom_dataset.py:89-95).
The JAX function folds in Python's ``hash(tag)``, which is salted per
process unless ``PYTHONHASHSEED`` is set; here the tag is folded in as its
CRC-32, which every process computes alike.  Torch generators and JAX keys
give different numbers from one seed, so no draw is compared across the two
packages either way.
"""

import zlib

import torch

from ..data.device import fold_generator


def key_for(seed: int, tag: str, step: int = 0, device="cpu") -> torch.Generator:
    """A generator on ``device`` for the stream (seed, tag, step)."""
    return fold_generator(device, seed, zlib.crc32(tag.encode()) & 0x7FFFFFFF, step)
