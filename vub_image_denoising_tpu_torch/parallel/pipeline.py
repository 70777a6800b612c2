"""Pipeline parallelism for the T-step diffusion sampler over a ``stage`` axis.

Counterpart of ``vub_image_denoising_tpu/parallel/pipeline.py``.  Stage s of
S owns the timestep chunk ``ts[s*k:(s+1)*k]`` (k = T/S); the batch is cut
into microbatches, and each microbatch with its anchor (its starting image)
goes stage to stage by send/recv: a GPipe schedule.  JAX runs every stage
on every tick of one ``lax.scan`` and masks the bubbles' output; here a
stage runs only on the ticks that hold a microbatch (stage s works on
microbatch m at tick m + s), receiving it from stage s - 1 and sending it on
to stage s + 1.  The tail microbatch is zero-padded, as in JAX, and the last
stage's outputs are broadcast to every rank.

Each microbatch takes the steps of ``InterpolationDiffusion.
improved_sampling`` (f32 state, the U-Net on the 2N stack in the input's
dtype), so the result is that sampler's.  On a ("stage", "data") mesh
(``make_ppdp_mesh``) each microbatch's rows are split over "data" inside
every stage.
"""

from typing import Optional

import torch

from .mesh import Mesh, all_gather, broadcast, recv, send, world_size


def make_pp_mesh(device=None) -> Mesh:
    """A 1-D ("stage",) mesh over every rank."""
    return Mesh(None, ("stage",), device)


def make_ppdp_mesh(n_stages: int, device=None) -> Mesh:
    """A ("stage", "data") mesh: an ``n_stages``-deep pipeline, each stage
    data parallel over the other ranks."""
    n = world_size()
    if n % n_stages:
        raise ValueError(f"{n} ranks not divisible by n_stages={n_stages}")
    return Mesh((n_stages, n // n_stages), ("stage", "data"), device)


def best_pipeline_depth(timesteps: int, n_devices: Optional[int] = None) -> int:
    """Largest pipeline depth <= ``n_devices`` (default: the ranks) that
    divides ``timesteps``."""
    n = world_size() if n_devices is None else int(n_devices)
    for s in range(min(n, timesteps), 0, -1):
        if timesteps % s == 0:
            return s
    return 1


def _sampler_steps(unet_apply, x32, anchor32, steps, in_dtype):
    """``improved_sampling``'s update for each (alpha_t, alpha_{t-1}) of
    ``steps``, anchored at the microbatch's own starting image."""
    n = x32.shape[0]
    for alpha_t, alpha_prev in steps:
        xin = x32.to(in_dtype)
        t2 = torch.tensor([alpha_t] * n + [alpha_prev] * n, dtype=torch.float32,
                          device=x32.device).to(in_dtype)
        pred2 = unet_apply(torch.cat([xin, xin]), t2).float()
        x_tilde = (1 - alpha_t) * pred2[:n] + alpha_t * anchor32
        x_tilde_prev = (1 - alpha_prev) * pred2[n:] + alpha_prev * anchor32
        x32 = x32 - x_tilde + x_tilde_prev
    return x32


def pipelined_sampling(diffusion, unet_apply, noisy, mesh: Mesh, *, microbatch: int,
                       axis: str = "stage"):
    """``diffusion.improved_sampling(unet_apply, noisy)`` pipelined over
    ``mesh[axis]``.

    ``unet_apply(x, t)`` is the sampler's U-Net; ``noisy`` the (B, C, H, W)
    batch, the same on every rank, cut into ceil(B / microbatch)
    microbatches.  ``diffusion.timesteps`` must divide by the depth S.
    Returns the (B, C, H, W) result on every rank."""
    n_stages, s = mesh.size(axis), mesh.index(axis)
    timesteps = int(diffusion.timesteps)
    if timesteps % n_stages:
        raise ValueError(f"timesteps={timesteps} not divisible by {n_stages} pipeline stages")
    if microbatch <= 0:
        raise ValueError(f"microbatch must be positive, got {microbatch}")
    n_data, d = mesh.size("data"), mesh.index("data")
    if microbatch % n_data:
        raise ValueError(f"microbatch={microbatch} not divisible by the {n_data}-way data axis")
    k = timesteps // n_stages
    steps = list(diffusion._schedule())[s * k:(s + 1) * k]
    batch, in_dtype = noisy.shape[0], noisy.dtype
    n_micro = -(-batch // microbatch)
    pad = n_micro * microbatch - batch
    if pad:
        noisy = torch.cat([noisy, noisy.new_zeros((pad,) + tuple(noisy.shape[1:]))])
    lm = microbatch // n_data
    xs = noisy.reshape((n_micro, microbatch) + tuple(noisy.shape[1:]))[:, d * lm:(d + 1) * lm]
    stride = n_data if mesh.axis_names[0] == axis else 1  # global-rank step along the stage axis
    me = torch.distributed.get_rank() if n_stages > 1 else 0
    out = torch.zeros((n_micro,) + tuple(xs.shape[1:]), dtype=torch.float32, device=noisy.device)
    for m in range(n_micro):
        if s == 0:
            x = anchor = xs[m].float()
        else:
            x = recv(xs[m].float(), me - stride)
            anchor = recv(x, me - stride)
        y = _sampler_steps(unet_apply, x, anchor, steps, in_dtype)
        if s < n_stages - 1:
            send(y, me + stride)
            send(anchor, me + stride)
        else:
            out[m] = y
    if n_stages > 1:
        out = broadcast(out, me + (n_stages - 1 - s) * stride, mesh.group(axis))
    if n_data > 1:
        out = all_gather(out, 1, mesh.group("data"))
    return out.reshape((n_micro * microbatch,) + tuple(out.shape[2:]))[:batch].to(in_dtype)


def pipeline_sample_fn(diffusion, unet_apply, mesh: Mesh, *, microbatch: int,
                       axis: str = "stage"):
    """A ``noisy -> denoised`` closure over a fixed pipeline: the serving
    path's entry (``sidd_cli validate --pipeline-parallel``)."""
    def fn(noisy):
        return pipelined_sampling(diffusion, unet_apply, noisy, mesh, microbatch=microbatch,
                                  axis=axis)

    return fn
