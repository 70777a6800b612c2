"""Tile-parallel inference over megapixel images: each rank denoises a band of rows.

Counterpart of ``vub_image_denoising_tpu/parallel/tiles.py``.  JAX shards the
image's rows over the mesh and lets GSPMD exchange the conv halos.  Here the
halo is explicit: each rank runs the model on its band of rows plus
``halo_rows()`` rows on each side (the trunk's receptive field, aligned to
8), keeps its band, and the bands are all-gathered.  Each band's
DenoisingBlocks run through kernel 1 on the card, as a whole forward's do.

The image is padded as JAX pads it: reflect (edge where reflect cannot
reach), H up to a multiple of ranks * ``pad_to``, W up to a multiple of 8.
Output rows within the receptive field of the bottom and right borders
depend on that padded extent, as in JAX.
"""

import numpy as np
import torch

from .mesh import all_gather


def receptive_radius() -> int:
    """Input rows on each side that one output row of an RDUNet or RDUNetT
    (they share the trunk, ``models/rdunet.py _RDUNetCore``) depends on,
    counted layer by layer (an upper bound): every 3x3 conv adds its scale's
    stride, every k2 s2 down or up conv one more; a DenoisingBlock chains
    four 3x3 convs; two blocks per scale and path."""
    r, j = 0, 1
    r += 2 * j                       # input block: two 3x3 convs
    for _ in range(3):
        r += 8 * j + j               # two blocks, then the k2 s2 down conv
        j *= 2
    r += 8 * j                       # the two blocks at the deepest scale
    for _ in range(3):
        j //= 2
        r += j + j + 8 * j           # k2 s2 up conv, its 3x3 conv, two blocks
    return r + 2 * j                 # output block: two 3x3 convs


def halo_rows(align: int = 8) -> int:
    """``receptive_radius`` rounded up to a multiple of ``align``."""
    return -(-receptive_radius() // align) * align


def denoise_large_image(forward, image, mesh=None, axis: str = "data", pad_to: int = 8,
                        halo=None):
    """Denoise one (H, W, C) image with its rows split over ``mesh``'s
    ``axis`` (every rank calls this with the same image).

    ``forward`` maps an (N, H, W, C) float32 tensor on the mesh's device to
    its denoised counterpart (``denoise_cli.build_apply``'s).  Returns the
    (H, W, C) float32 numpy image on every rank."""
    n = 1 if mesh is None else mesh.size(axis)
    i = 0 if mesh is None else mesh.index(axis)
    group = None if mesh is None else mesh.group(axis)
    device = torch.device("cpu") if mesh is None else mesh.device
    image = np.asarray(image, np.float32)
    h, w, _ = image.shape
    mult_h = n * pad_to
    hp = -(-h // mult_h) * mult_h
    wp = -(-w // 8) * 8
    mode = "reflect" if (hp - h) < h and (wp - w) < w else "edge"
    x = np.pad(image, ((0, hp - h), (0, wp - w), (0, 0)), mode=mode)
    halo = halo_rows() if halo is None else halo
    band = hp // n
    start, stop = max(0, i * band - halo), min(hp, (i + 1) * band + halo)
    y = forward(torch.from_numpy(np.ascontiguousarray(x[None, start:stop])).to(device))
    y = all_gather(y[:, i * band - start:i * band - start + band].contiguous(), 1, group)
    return y[0, :h, :w].cpu().numpy()
