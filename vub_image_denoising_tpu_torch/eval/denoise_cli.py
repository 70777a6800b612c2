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
                engine: str = "auto", trusted: bool = False, device=None):
    """Shared model/checkpoint construction for every inference entry point:
    returns ``(forward, model)``, where ``forward(batch)`` maps a normalized
    (N, H, W, C) [-1, 1] float32 tensor on the model's device to its denoised
    counterpart, float32, same layout.

    ``arch="rdunet"`` is one RDUNet forward; ``arch="diffusion"`` loads an
    RDUNetT from ``unet.``-prefixed keys and runs ``timesteps`` steps of
    ``InterpolationDiffusion.improved_sampling``.  ``engine`` is one of
    ``ENGINES`` (module docstring); ``"auto"`` is ``"flax"``.  f32 runs with
    TF32 off (``enable_strict_precision``); ``bf16=True`` runs the
    activations in bf16 with the params in f32."""
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
    if engine != "flax":
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

    def forward(batch):
        with torch.inference_mode():
            x = batch.permute(0, 3, 1, 2).to(dtype)
            if device.type == "cuda":
                x = x.contiguous(memory_format=torch.channels_last)
            return apply(x).float().permute(0, 2, 3, 1)

    return forward, model


def _pad8(images: np.ndarray) -> np.ndarray:
    """Reflect-pad the H and W of (N, H, W, C) up to multiples of 8."""
    _, h, w, _ = images.shape
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    return np.pad(images, ((0, 0), (0, hp - h), (0, wp - w), (0, 0)), mode="reflect")


def build_denoiser(checkpoint: str, arch: str = "rdunet", base_filters: int = 32,
                   timesteps: int = 20, channels: int = 3, bf16: bool = False,
                   engine: str = "auto", trusted: bool = False, batched: bool = False,
                   device=None):
    """(fn: (H, W, C) float32 [-1, 1] numpy -> (H, W, C) float32 numpy) from a
    ``.pth``.  With ``batched=True`` the fn maps a stacked same-size batch
    (N, H, W, C) -> (N, H, W, C) in one forward, or one sampler run (the
    server's dynamic batching)."""
    forward, model = build_apply(checkpoint, arch, base_filters, timesteps, channels=channels,
                                 bf16=bf16, engine=engine, trusted=trusted, device=device)
    device = next(model.parameters()).device

    def denoise_batch(images):
        _, h, w, _ = images.shape
        x = torch.from_numpy(np.ascontiguousarray(_pad8(np.asarray(images, np.float32))))
        y = forward(x.to(device))
        return y[:, :h, :w].cpu().numpy()

    if batched:
        return denoise_batch
    return lambda image: denoise_batch(np.asarray(image)[None])[0]


def denoise_file(denoise_fn, in_path: str, out_path: str, grayscale: bool = False):
    from PIL import Image

    img = Image.open(in_path)
    img = img.convert("L") if grayscale else img.convert("RGB")
    arr = np.asarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    x = arr.astype(np.float32) / 255.0 * 2.0 - 1.0  # Normalize(0.5, 0.5)
    y = np.asarray(denoise_fn(x))
    out = np.clip((y + 1.0) * 0.5 * 255.0 + 0.5, 0, 255).astype(np.uint8)
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
    p.add_argument("--trusted-checkpoint", action="store_true",
                   help="permit the full-unpickling torch.load fallback when the "
                        "safe weights-only load fails (trusted files only)")
    args = p.parse_args(argv)

    channels = 1 if args.grayscale else 3
    denoise_fn = build_denoiser(args.checkpoint, args.arch, args.base_filters, args.timesteps,
                                channels=channels, bf16=args.bf16, engine=args.engine,
                                trusted=args.trusted_checkpoint, device=args.device)

    if os.path.isdir(args.input):
        out_dir = args.output or args.input.rstrip("/\\") + "_denoised"
        os.makedirs(out_dir, exist_ok=True)
        names = sorted(f for f in os.listdir(args.input)
                       if f.lower().endswith(IMAGE_EXTENSIONS))
        if not names:
            raise FileNotFoundError(f"no images in {args.input}")
        for name in names:
            print(denoise_file(denoise_fn, os.path.join(args.input, name),
                               os.path.join(out_dir, name), args.grayscale))
    else:
        out_path = args.output
        if out_path is None:
            stem, ext = os.path.splitext(args.input)
            out_path = f"{stem}_denoised{ext or '.png'}"
        print(denoise_file(denoise_fn, args.input, out_path, args.grayscale))


if __name__ == "__main__":
    main()
