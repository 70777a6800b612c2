"""Denoise images from the command line with a reference-layout ``.pth``.

Counterpart of ``vub_image_denoising_tpu/eval/denoise_cli.py``.  Images of any
size are reflect-padded on the host to the U-Net's stride (8) and run on the
card, where every DenoisingBlock is the fused CUDA kernel:

- ``--arch rdunet``: one RDUNet forward;
- ``--arch diffusion``: the T-step interpolation-diffusion sampler
  (``--timesteps``, default 20) on an RDUNetT, one forward of the 2N stack
  per step.

``--engine`` picks how the U-Net runs: ``flax`` the model's modules, every
DenoisingBlock a kernel launch; ``pallas`` the functional forward of
``models.fused_apply`` with the block kernel, its weights packed once per
load; ``xla`` the same forward with the eager block (cuDNN convs, no
kernel).  ``auto`` is ``flax`` in both dtypes: on the card the eager blocks
are the slow path (the JAX package's "xla under bf16" was a TPU choice).

Over several ranks (``torchrun --nproc-per-node N``; ``main`` joins the
group, nccl with a card per rank, gloo with ``--device cpu``),
``--tile-parallel`` splits each image's rows over them and
``--tensor-parallel`` the layers' channels; rank 0 writes the outputs.

Usage:
  python -m vub_image_denoising_tpu_torch.eval.denoise_cli \
      --checkpoint model.pth --input photo.png --output clean.png [--bf16]
  python -m vub_image_denoising_tpu_torch.eval.denoise_cli --arch diffusion \
      --timesteps 20 --checkpoint diffusion.pth --input photo.png
"""

import argparse
import os

import numpy as np
import torch

from ..diffusion.interpolation import InterpolationDiffusion
from ..models.fused_apply import (block_kernel_weights, prepare_fused_params,
                                  rdunet_apply_fused, rdunet_t_apply_fused)
from ..models.rdunet import RDUNet, RDUNetT
from ..utils import checkpoint as ckpt_io
from ..utils.device import resolve_device

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg")
ENGINES = ("auto", "flax", "xla", "pallas")


def build_apply(checkpoint: str, arch: str = "rdunet", base_filters: int = 32,
                timesteps: int = 20, channels: int = 3, bf16: bool = False,
                engine: str = "auto", trusted: bool = False, device=None,
                tensor_parallel: bool = False):
    """Shared model/checkpoint construction for every inference entry point:
    returns ``(forward, model)``, where ``forward(batch)`` maps a normalized
    (N, H, W, C) [-1, 1] float32 tensor on the model's device to its denoised
    counterpart, float32, same layout.

    ``arch="rdunet"`` is one RDUNet forward; ``arch="diffusion"`` loads an
    RDUNetT from ``unet.``-prefixed keys and runs ``timesteps`` steps of
    ``InterpolationDiffusion.improved_sampling``.  ``engine`` is one of
    ``ENGINES`` (module docstring); ``"auto"`` is ``"flax"``.  f32 runs with
    TF32 off (``enable_strict_precision``); ``bf16=True`` runs the
    activations in bf16 with the params in f32.  ``forward.trace`` is the
    same function outside ``torch.inference_mode``, which ``eval/export.py``
    traces; ``forward.unet`` the U-Net callable on NCHW tensors in the compute
    dtype ``forward.dtype`` (the pipelined sampler's).  ``tensor_parallel``
    splits the layers' channels over the ranks (``parallel/tp.py``; every
    rank calls ``forward`` with the same batch; its DenoisingBlocks run whole,
    through kernel 1 on the card, whatever the engine)."""
    device = resolve_device(device)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (want one of {ENGINES})")
    if engine == "auto":
        engine = "flax"
    if arch == "rdunet":
        model = RDUNet(channels=channels, base_filters=base_filters)
        prefix = ""
    elif arch == "diffusion":
        if channels != 3:
            raise ValueError(
                "--arch diffusion requires RGB input (the reference RDUNet_T is "
                "fixed at 3+t channels, Unet_model.py:92-136); drop --grayscale")
        model = RDUNetT(base_filters=base_filters)
        prefix = "unet."
    else:
        raise ValueError(f"unknown arch '{arch}' (expected rdunet|diffusion)")
    if not bf16:
        from .. import enable_strict_precision

        enable_strict_precision()
    dtype = torch.bfloat16 if bf16 else torch.float32
    ckpt_io.load_pth(checkpoint, model, prefix=prefix, allow_pickle=trusted)
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    unet = model
    if tensor_parallel:
        from ..parallel.tp import make_tp_mesh, put_tp

        tp = put_tp(model, make_tp_mesh(device=device))
        cache = tp.block_cache(dtype)
        if arch == "diffusion":
            unet = lambda x, t: tp.apply(tp.shards, x, t, cache)  # noqa: E731
        else:
            unet = lambda x: tp.apply(tp.shards, x, None, cache)  # noqa: E731
    elif engine != "flax":
        params = prepare_fused_params(model.state_dict())
        kw = block_kernel_weights(params, dtype) if engine == "pallas" else None
        if arch == "diffusion":
            unet = lambda x, t: rdunet_t_apply_fused(  # noqa: E731
                params, x, t, engine=engine, kernel_weights=kw)
        else:
            unet = lambda x: rdunet_apply_fused(  # noqa: E731
                params, x, engine=engine, kernel_weights=kw)
    if arch == "diffusion":
        diffusion = InterpolationDiffusion(timesteps=timesteps)
        apply = lambda x: diffusion.improved_sampling(unet, x)  # noqa: E731
    else:
        apply = unet

    def body(batch):
        x = batch.permute(0, 3, 1, 2).to(dtype)
        if device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        return apply(x).float().permute(0, 2, 3, 1)

    forward = torch.inference_mode()(body)
    forward.trace = body  # the same function outside inference mode, for torch.export
    forward.unet, forward.dtype = unet, dtype
    return forward, model


def _pad8(images: np.ndarray) -> np.ndarray:
    """Reflect-pad the H and W of (N, H, W, C) up to multiples of 8."""
    _, h, w, _ = images.shape
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    return np.pad(images, ((0, 0), (0, hp - h), (0, wp - w), (0, 0)), mode="reflect")


def build_denoiser(checkpoint: str, arch: str = "rdunet", base_filters: int = 32,
                   timesteps: int = 20, channels: int = 3, bf16: bool = False,
                   engine: str = "auto", trusted: bool = False, batched: bool = False,
                   device=None, tile_parallel: bool = False, tensor_parallel: bool = False):
    """(fn: (H, W, C) float32 [-1, 1] numpy -> (H, W, C) float32 numpy) from a
    ``.pth``.  With ``batched=True`` the fn maps a stacked same-size batch
    (N, H, W, C) -> (N, H, W, C) in one forward, or one sampler run (the
    server's dynamic batching).

    Over several ranks (every rank calls the fn on the same image):
    ``tile_parallel`` splits the image's rows over them
    (``parallel/tiles.py``; not with ``batched``), ``tensor_parallel`` the
    layers' channels (``parallel/tp.py``); not both."""
    if tile_parallel and tensor_parallel:
        raise ValueError("--tile-parallel and --tensor-parallel are exclusive: "
                         "rows OR channels shard over the devices, not both")
    if batched and tile_parallel:
        raise ValueError("batched denoising is incompatible with tile_parallel "
                         "(which shards the rows of ONE image over the mesh)")
    forward, model = build_apply(checkpoint, arch, base_filters, timesteps, channels=channels,
                                 bf16=bf16, engine=engine, trusted=trusted, device=device,
                                 tensor_parallel=tensor_parallel)
    device = next(model.parameters()).device
    if tile_parallel:
        from ..parallel.mesh import make_mesh
        from ..parallel.tiles import denoise_large_image

        mesh = make_mesh(device=device)
        return lambda image: denoise_large_image(forward, image, mesh)

    def denoise_batch(images):
        _, h, w, _ = images.shape
        x = torch.from_numpy(np.ascontiguousarray(_pad8(np.asarray(images, np.float32))))
        y = forward(x.to(device))
        return y[:, :h, :w].cpu().numpy()

    if batched:
        return denoise_batch
    return lambda image: denoise_batch(np.asarray(image)[None])[0]


def denoise_file(denoise_fn, in_path: str, out_path: str, grayscale: bool = False,
                 write: bool = True):
    from PIL import Image

    img = Image.open(in_path)
    img = img.convert("L") if grayscale else img.convert("RGB")
    arr = np.asarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    x = arr.astype(np.float32) / 255.0 * 2.0 - 1.0  # Normalize(0.5, 0.5)
    y = np.asarray(denoise_fn(x))
    out = np.clip((y + 1.0) * 0.5 * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if write:
        Image.fromarray(out[..., 0] if out.shape[-1] == 1 else out).save(out_path)
    return out_path


def main(argv=None):
    from ..utils.cache import enable_compilation_cache

    enable_compilation_cache()
    p = argparse.ArgumentParser(description="Denoise images with a trained checkpoint")
    p.add_argument("--checkpoint", required=True, help=".pth (reference layout)")
    p.add_argument("--arch", default="rdunet", choices=["rdunet", "diffusion"])
    p.add_argument("--input", required=True, help="image file or folder")
    p.add_argument("--output", default=None,
                   help="output file or folder (default: <input>_denoised)")
    p.add_argument("--base-filters", type=int, default=32)
    p.add_argument("--timesteps", type=int, default=20,
                   help="sampler steps of --arch diffusion")
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--engine", default="auto", choices=list(ENGINES))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--tile-parallel", action="store_true",
                   help="split image rows across the ranks (torchrun)")
    p.add_argument("--tensor-parallel", action="store_true",
                   help="split layer channels across the ranks (torchrun; multi-card "
                        "latency for images too small to tile)")
    p.add_argument("--trusted-checkpoint", action="store_true",
                   help="permit the full-unpickling torch.load fallback when the "
                        "safe weights-only load fails (trusted files only)")
    args = p.parse_args(argv)

    from ..parallel.mesh import init_distributed, is_writer

    # a no-op unless torchrun's environment is set: nccl for a card per rank,
    # gloo for CPU ranks
    init_distributed("gloo" if args.device == "cpu" else "nccl")
    channels = 1 if args.grayscale else 3
    denoise_fn = build_denoiser(args.checkpoint, args.arch, args.base_filters, args.timesteps,
                                channels=channels, bf16=args.bf16, engine=args.engine,
                                trusted=args.trusted_checkpoint, device=args.device,
                                tile_parallel=args.tile_parallel,
                                tensor_parallel=args.tensor_parallel)
    write = is_writer()  # every rank denoises each image; rank 0 writes it

    if os.path.isdir(args.input):
        out_dir = args.output or args.input.rstrip("/\\") + "_denoised"
        os.makedirs(out_dir, exist_ok=True)
        names = sorted(f for f in os.listdir(args.input)
                       if f.lower().endswith(IMAGE_EXTENSIONS))
        if not names:
            raise FileNotFoundError(f"no images in {args.input}")
        for name in names:
            print(denoise_file(denoise_fn, os.path.join(args.input, name),
                               os.path.join(out_dir, name), args.grayscale, write))
    else:
        out_path = args.output
        if out_path is None:
            stem, ext = os.path.splitext(args.input)
            out_path = f"{stem}_denoised{ext or '.png'}"
        print(denoise_file(denoise_fn, args.input, out_path, args.grayscale, write))


if __name__ == "__main__":
    main()
