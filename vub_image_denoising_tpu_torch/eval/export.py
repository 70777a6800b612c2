"""Ahead-of-time export: a ``torch.export`` program with the weights baked in.

Counterpart of ``vub_image_denoising_tpu/eval/export.py``.  The denoiser that
every inference entry point builds (``denoise_cli.build_apply``, so the
diffusion-requires-RGB guard holds here too) is traced once by
``torch.export.export`` into an ``ExportedProgram``: the parameters and, on
the card, each DenoisingBlock's packed kernel weights are constants of the
program, and the batch dimension is symbolic (``torch.export.Dim``), so one
artifact serves any batch at the spatial size it was exported for.  It maps
a normalized (N, size, size, C) [-1, 1] float32 batch to its denoised
counterpart (``--arch diffusion``: the whole T-step sampler, unrolled into
the graph).

Where it differs from the JAX artifact:

- On the card each DenoisingBlock is one node of the graph, the operator
  ``vub_torch::fused_denoising_block`` (``ops/fused_block.py``), which
  launches kernel 1 when the program runs.  Loading an artifact therefore
  needs this package's ``ops.fused_block`` imported, which
  ``load_exported`` does; the JAX artifact needs only ``jax``.
- A ``.pt2`` holds one program for one device.  ``--platforms cuda,cpu``
  exports one program per platform and writes the first to ``--out`` and
  each other beside it as ``<stem>.<platform><ext>``.  The default is the
  card alone.

Usage:
  python -m vub_image_denoising_tpu_torch.eval.export --checkpoint ck.pth \\
      --arch rdunet --size 256 --bf16 --out rdunet_256.pt2
  # then, in any process that can import this package:
  from vub_image_denoising_tpu_torch.eval.export import load_exported
  fn = load_exported("rdunet_256.pt2")   # (N,256,256,3) -> (N,256,256,3)
"""

import argparse
import os

import torch
from torch import nn

PLATFORMS = ("cuda", "cpu")


class _Denoiser(nn.Module):
    """The denoiser as a module for ``torch.export``: ``model``'s parameters
    are the program's, ``fn`` is ``build_apply``'s forward."""

    def __init__(self, fn, model):
        super().__init__()
        self.fn = fn
        self.model = model

    def forward(self, x):
        return self.fn(x)


def build_exported(
    checkpoint: str,
    arch: str = "rdunet",
    base_filters: int = 32,
    timesteps: int = 20,
    size: int = 256,
    channels: int = 3,
    bf16: bool = False,
    engine: str = "auto",
    platforms=("cuda",),
    symbolic_batch: bool = True,
    trusted: bool = False,
):
    """Export the denoiser (weights baked in): ``{platform: ExportedProgram}``.

    Each platform (``"cuda"``, ``"cpu"``) gets its own program, traced on that
    device.  The batch is symbolic (traced at batch 2, so that torch.export
    does not take a batch of 1 for a constant), or 1 with
    ``symbolic_batch=False``.  The blocks' kernel weights are packed first
    (``pack_kernel_weights``); the program holds them as constants, and each
    block is one kernel operator node (on the CPU the operator runs the plain
    block)."""
    from ..nn.blocks import pack_kernel_weights
    from .denoise_cli import build_apply

    programs = {}
    for platform in platforms:
        if platform not in PLATFORMS:
            raise ValueError(f"unknown platform {platform!r} (want one of {PLATFORMS})")
        forward, model = build_apply(checkpoint, arch, base_filters, timesteps,
                                     channels=channels, bf16=bf16, engine=engine,
                                     trusted=trusted, device=platform)
        device = next(model.parameters()).device
        example = torch.zeros(2 if symbolic_batch else 1, size, size, channels, device=device)
        pack_kernel_weights(model, torch.bfloat16 if bf16 else torch.float32)
        dynamic = ({0: torch.export.Dim("batch", min=1)},) if symbolic_batch else None
        with torch.no_grad():
            programs[platform] = torch.export.export(
                _Denoiser(forward.trace, model), (example,), dynamic_shapes=dynamic)
    return programs


def artifact_paths(path: str, platforms):
    """Where ``save_exported`` writes each platform's program: the first at
    ``path``, each other at ``<stem>.<platform><ext>``."""
    stem, ext = os.path.splitext(path)
    return {p: path if i == 0 else f"{stem}.{p}{ext or '.pt2'}"
            for i, p in enumerate(platforms)}


def save_exported(exported, path: str) -> str:
    """Write ``build_exported``'s programs (``artifact_paths``); returns
    ``path``, the first platform's file."""
    for platform, file in artifact_paths(path, list(exported)).items():
        torch.export.save(exported[platform], file)
    return path


def load_exported(path: str):
    """Load an artifact -> callable ``(N, size, size, C) -> same`` on the
    device it was exported for.  Imports this package's ``ops.fused_block``,
    which registers the kernel operator the card's programs call; needs
    neither the model code's modules nor the checkpoint."""
    from ..ops import fused_block  # noqa: F401 - registers vub_torch::fused_denoising_block

    exported = torch.export.load(path)
    module = exported.module()

    def fn(x):
        with torch.no_grad():
            return module(x)

    fn.exported = exported
    return fn


def kernel_nodes(exported) -> int:
    """Kernel-1 operator nodes in an ExportedProgram's graph."""
    target = torch.ops.vub_torch.fused_denoising_block.default
    return sum(1 for n in exported.graph.nodes if n.op == "call_function" and n.target == target)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Export a checkpoint as a self-contained torch.export artifact")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--arch", default="rdunet", choices=["rdunet", "diffusion"])
    p.add_argument("--base-filters", type=int, default=32)
    p.add_argument("--timesteps", type=int, default=20)
    p.add_argument("--size", type=int, default=256,
                   help="spatial size the artifact is exported for (batch stays symbolic)")
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--engine", default="auto", choices=["auto", "flax", "xla", "pallas"])
    p.add_argument("--platforms", default="cuda",
                   help="comma-separated: cuda, cpu (one .pt2 each; the first at --out)")
    p.add_argument("--fixed-batch", action="store_true",
                   help="export for batch 1 instead of a symbolic batch dim")
    p.add_argument("--trusted-checkpoint", action="store_true")
    p.add_argument("--out", required=True, help="output artifact path")
    args = p.parse_args(argv)

    platforms = tuple(args.platforms.split(","))
    exported = build_exported(
        args.checkpoint, args.arch, args.base_filters, args.timesteps,
        size=args.size, channels=1 if args.grayscale else 3, bf16=args.bf16,
        engine=args.engine, platforms=platforms,
        symbolic_batch=not args.fixed_batch, trusted=args.trusted_checkpoint,
    )
    path = save_exported(exported, args.out)
    for platform, file in artifact_paths(path, platforms).items():
        print(f"exported {args.arch} ({args.size}px, {platform}) -> {file} "
              f"[{os.path.getsize(file) / 1e6:.1f} MB]")
    return path


if __name__ == "__main__":
    main()
