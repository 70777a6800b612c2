"""Model size, work, latency and peak memory: the reference's info.py.

Counterpart of ``vub_image_denoising_tpu/utils/info.py``.  The reference
prints ``torchinfo.summary`` for RDUNet(128) and the DiffusionModel
(RDUNet_T(32)) and measures 10-iteration average latency and CUDA peak
memory (info.py:18-48).

- ``model_summary``: parameter count and bytes, and the FLOPs of one call.
  The FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` on
  meta tensors (shapes only; nothing runs), where every DenoisingBlock takes
  its plain path: on the card the block is a kernel launch that an aten-op
  counter cannot see, so the count is that of the function, whatever
  implements it, and the same on every device.
- ``measure_inference_metrics``: average and spread of the latency (CUDA
  events on the card), peak device memory (``max_memory_allocated`` after
  ``reset_peak_memory_stats``) and the model FLOP utilization.
"""

import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..diffusion.interpolation import InterpolationDiffusion
from .device import resolve_device

# NVIDIA H100 SXM data sheet: the dense bf16 tensor-core peak, at 700 W (the
# figure chip_smoke.py holds the kernels to).
H100_BF16_PEAK_FLOPS = 989e12


class DiffusionSampler(torch.nn.Module):
    """The T-step improved sampler on a U-Net, as one module: the reference's
    DiffusionModel, which info.py summarizes whole."""

    def __init__(self, unet, timesteps: int = 20):
        super().__init__()
        self.unet = unet
        self.diffusion = InterpolationDiffusion(timesteps)

    def forward(self, noisy):
        return self.diffusion.improved_sampling(self.unet, noisy)


def _meta(v):
    return torch.empty_like(v, device="meta") if isinstance(v, torch.Tensor) else v


def count_flops(model: torch.nn.Module, *example_args) -> int:
    """FLOPs of ``model(*example_args)`` (a multiply-add counts 2), counted
    on meta copies of its state and arguments."""
    state = {k: _meta(v) for k, v in model.state_dict(keep_vars=True).items()}
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        torch.func.functional_call(model, state, tuple(_meta(a) for a in example_args))
    return int(counter.get_total_flops())


def model_summary(model: torch.nn.Module, *example_args) -> dict:
    """Params, param bytes and FLOPs of ``model(*example_args)``."""
    params = list(model.parameters())
    return {
        "params": sum(p.numel() for p in params),
        "param_bytes": sum(p.numel() * p.element_size() for p in params),
        "flops": count_flops(model, *example_args),
    }


def measure_inference_metrics(fn, *args, num_iterations: int = 10,
                              peak_flops: float = H100_BF16_PEAK_FLOPS) -> dict:
    """Latency of ``fn(*args)`` over ``num_iterations`` calls after one
    warm-up call (info.py:31-48): average and standard deviation in seconds,
    timed with CUDA events when the first tensor argument is on the card.
    There also the peak device memory of those calls, and, when ``fn`` is a
    module, its FLOPs (``count_flops``) and its MFU against ``peak_flops``."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    cuda = device.type == "cuda"
    times = []
    with torch.inference_mode():
        fn(*args)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        for _ in range(num_iterations):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1000.0)
            else:
                t0 = time.perf_counter()
                fn(*args)
                times.append(time.perf_counter() - t0)
    result = {
        "avg_inference_sec": float(np.mean(times)),
        "std_inference_sec": float(np.std(times)),
        "num_iterations": num_iterations,
        "device": torch.cuda.get_device_name(device) if cuda else str(device),
    }
    if cuda:
        result["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    if isinstance(fn, torch.nn.Module):
        result["flops"] = count_flops(fn, *args)
        result["mfu"] = result["flops"] / result["avg_inference_sec"] / peak_flops
    return result


def print_info(device=None, dtype=torch.float32) -> dict:
    """The reference info.py's ``__main__``: summarize RDUNet(128) and the
    diffusion model (the T = 20 sampler on RDUNetT(32)) on one 256x256
    image, and print their latency and peak memory.  Runs on the card
    unless ``device="cpu"``; the weights are random, from seed 0.
    RDUNet(128) takes ``dtype`` activations on the card (f32 by default, as
    in the JAX package; its c = 512 and 1024 blocks run kernel 1's wide
    form); the sampler runs f32, and the CPU takes f32 alone.  Returns the
    four dicts it printed."""
    from ..models.rdunet import RDUNet, RDUNetT

    device = resolve_device(device)
    if device.type != "cuda" and dtype != torch.float32:
        raise ValueError(f"print_info on {device.type} runs f32 only, not {dtype}")

    def place(model):
        model = model.to(device).eval()
        return model.to(memory_format=torch.channels_last) if device.type == "cuda" else model

    x = torch.zeros(1, 3, 256, 256, device=device)
    if device.type == "cuda":
        x = x.contiguous(memory_format=torch.channels_last)
    x128 = x.to(dtype)
    rdunet = place(RDUNet(3, 128, generator=torch.Generator().manual_seed(0)))
    sampler = place(DiffusionSampler(RDUNetT(32, generator=torch.Generator().manual_seed(0)), 20))
    out = {"rdunet128": model_summary(rdunet, x128), "sampler": model_summary(sampler, x)}
    print(f"RDUNet(128), {x128.dtype} activations:", out["rdunet128"])
    print("DiffusionModel(RDUNet_T(32)):", out["sampler"])
    out["rdunet128_latency"] = measure_inference_metrics(rdunet, x128)
    print("RDUNet(128) latency:", out["rdunet128_latency"])
    out["sampler_latency"] = measure_inference_metrics(sampler, x)
    print("Diffusion sampling latency:", out["sampler_latency"])
    return out


if __name__ == "__main__":
    print_info()
