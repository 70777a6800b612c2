"""TensorBoard image grids.

Counterpart of ``make_grid`` and ``add_image_grid`` in
``vub_image_denoising_tpu/utils/tb.py``: the reference logs per-epoch image
grids through ``torchvision.utils.make_grid`` and a SummaryWriter
(diffusion_RDUnet.py:146-159; RDUNet_model.py:226-244).  The grid is built
from NHWC numpy arrays in [0, 1]; the writer (tensorboardX) is the caller's.
"""

import numpy as np


def make_grid(images, nrow: int = 4, padding: int = 2, normalize: bool = False):
    """NHWC [0,1] batch -> one HWC grid image (torchvision.utils.make_grid semantics:
    row-major placement, ``nrow`` images per row, zero padding between cells)."""
    images = np.asarray(images, np.float32)
    if images.ndim == 3:
        images = images[None]
    n, h, w, c = images.shape
    if normalize:
        lo, hi = images.min(), images.max()
        images = (images - lo) / max(hi - lo, 1e-12)
    ncol = min(nrow, n)
    nrows = -(-n // ncol)
    grid = np.zeros(
        (nrows * (h + padding) + padding, ncol * (w + padding) + padding, c), np.float32
    )
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y0 = r * (h + padding) + padding
        x0 = col * (w + padding) + padding
        grid[y0 : y0 + h, x0 : x0 + w] = images[idx]
    return grid


def add_image_grid(writer, tag: str, images, step: int, nrow: int = 4,
                   normalize: bool = True):
    """Log an NHWC batch as one grid (tensorboardX takes HWC via dataformats)."""
    grid = make_grid(images, nrow=nrow, normalize=normalize)
    writer.add_image(tag, grid, step, dataformats="HWC")
