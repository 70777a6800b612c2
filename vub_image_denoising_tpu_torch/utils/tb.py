"""TensorBoard logging helpers.

Counterpart of ``vub_image_denoising_tpu/utils/tb.py``: the reference logs
scalar streams and per-epoch image grids through
``torchvision.utils.make_grid`` and a SummaryWriter (diffusion_RDUnet.py:131,
146-159; RDUNet_model.py:226-244), launches tensorboard as a subprocess
(:195-200), and logs activation maps through forward hooks
(paper_gan.py:292-309).  Grids are built from NHWC numpy arrays in [0, 1];
the writer is tensorboardX's, or a print-only stand-in without it.
"""

import subprocess

import numpy as np
import torch

from .profiling import first_tensor


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


def create_writer(log_dir: str):
    """SummaryWriter (tensorboardX) or a print-only fallback."""
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter(log_dir=log_dir)
    except ImportError:
        class _Null:
            def add_scalar(self, tag, value, step):
                print(f"[tb] {tag}={value} step={step}")

            def add_image(self, *a, **k):
                pass

            def flush(self):
                pass

            def close(self):
                pass

        return _Null()


def start_tensorboard(log_dir: str):
    """Best-effort tensorboard subprocess launch (diffusion_RDUnet.py:195-200)."""
    try:
        subprocess.Popen(["tensorboard", "--logdir", log_dir])
        print("TensorBoard started at http://localhost:6006")
    except OSError as e:
        print(f"Failed to start TensorBoard: {e}")


def log_activations(writer, model, batch, step: int = 0, tag_prefix: str = "debug",
                    max_layers: int = 32, **forward_kwargs):
    """Activation maps of one forward of ``model`` on ``batch`` (NCHW).

    As the reference does (paper_gan.py:292-309 ``visualize_activation`` /
    ``register_hooks``), a forward hook on every submodule (the model
    itself included, tagged ``<tag_prefix>/``) takes the first 4-D output
    of its first call; each is reduced to a channel-mean heat map per
    sample and logged as an image grid, in the order of the modules' sorted
    names (a module before its children), up to ``max_layers``.  The hooks
    are removed before this returns.  Returns the list of tags written."""
    maps = {}

    def hook(name):
        def record(module, inputs, output):
            out = first_tensor(output)
            if name not in maps and out is not None and out.dim() == 4:
                heat = out.detach().float().mean(dim=1, keepdim=True)
                maps[name] = heat.permute(0, 2, 3, 1).cpu().numpy()
        return record

    handles = [m.register_forward_hook(hook(name)) for name, m in model.named_modules()]
    try:
        with torch.no_grad():
            model(batch, **forward_kwargs)
    finally:
        for h in handles:
            h.remove()
    tags = []
    for name in sorted(maps)[:max_layers]:
        tag = f"{tag_prefix}/" + name.replace(".", "/")
        add_image_grid(writer, tag, maps[name], step, normalize=True)
        tags.append(tag)
    return tags
