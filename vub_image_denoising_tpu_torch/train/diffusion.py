"""Interpolation-diffusion trainer.  Counterpart of
``vub_image_denoising_tpu/train/diffusion.py`` (reference
diffusion_denoising/diffusion_RDUnet.py:76-315).

One train step, per micro-batch:

- per-image timesteps t in [0, T]: uniform integers as floats, or
  Beta(2, 1)*T ("biased", leaning toward T);
- the interpolation ``alpha*noisy + (1-alpha)*clean`` with alpha = t/T;
- ONE U-Net call on the interpolated image at t/T (not the sampler);
- ``combined_loss`` (default pure Charbonnier) against clean, in f32.

The micro-batch gradients are SUMMED (real accumulation, as in the JAX
package; the reference zero-grads every batch), clipped to global norm 0.1,
and one AdamW(1e-4, wd 1e-4) + StepLR step is taken.  Validation runs the
full sampler on one batch.

Batches are (N, 3, H, W) tensors in [-1, 1]; the trainer moves them to its
device (the card unless ``device="cpu"``).  ``fit``, the per-epoch
checkpoints, resume, the TensorBoard image grids and the command line
(``build_arg_parser``/``main``) are not ported yet: they wait for the data
loaders.
"""

import dataclasses
import math
from typing import Any

import torch

from ..diffusion.interpolation import InterpolationDiffusion
from ..diffusion.losses import combined_loss
from ..models.fused_apply import rdunet_t_apply_fused
from ..models.rdunet import RDUNetT
from ..utils.device import resolve_device
from .schedules import make_optimizer
from .state import TrainState
from .supervised import ENGINES, accumulate_and_apply, put_batch

SAMPLING = ("improved", "direct")


def sample_timesteps(generator, n: int, timesteps: int, distribution: str = "uniform"):
    """n per-image timesteps in [0, T] as f32, drawn from ``generator`` on its
    device: uniform integers, or Beta(2, 1)*T with ``distribution="biased"``."""
    if distribution == "biased":
        # Beta(2, 1) has CDF x^2, so sqrt(U) for U uniform on [0, 1) is Beta(2, 1)
        return torch.rand(n, generator=generator, device=generator.device).sqrt() * timesteps
    return torch.randint(0, timesteps + 1, (n,), generator=generator,
                         device=generator.device).float()


def make_diffusion_train_step(unet_apply, diffusion: InterpolationDiffusion,
                              accumulation_steps: int = 1, distribution: str = "uniform",
                              loss_weights=(0.0, 1.0, 0.0), compute_dtype=torch.float32):
    """The accumulate -> clip -> step function of the diffusion trainer.

    ``unet_apply(params, x, t) -> prediction``, with ``t`` an (N,) vector of
    normalized timesteps.  The step takes ``(state, generator, noisy,
    clean)`` and returns ``(state, mean micro-batch loss)``; each
    micro-batch draws its timesteps from ``generator``.  The interpolation
    and the U-Net run in ``compute_dtype``; params stay f32."""
    mse_w, charb_w, ssim_w = loss_weights
    T = diffusion.timesteps

    def step(state: TrainState, generator, noisy, clean):
        def micro_loss(sl):
            t = sample_timesteps(generator, clean[sl].shape[0], T, distribution).to(noisy.device)
            alpha = (t / T).reshape(-1, 1, 1, 1).to(compute_dtype)
            interpolated = (alpha * noisy[sl].to(compute_dtype)
                            + (1 - alpha) * clean[sl].to(compute_dtype))
            pred = unet_apply(state.params, interpolated, (t / T).to(compute_dtype))
            return combined_loss(pred.float(), clean[sl].float(), mse_weight=mse_w,
                                 charbonnier_weight=charb_w, ssim_weight=ssim_w)

        return accumulate_and_apply(state, noisy.shape[0], accumulation_steps, micro_loss)

    return step


@dataclasses.dataclass
class DiffusionTrainer:
    """The diffusion training loop on an ``RDUNetT(base_filters)``: AdamW and
    StepLR(3, 0.5) per epoch, with the JAX trainer's defaults.

    ``engine``: ``"flax"`` runs the model's modules (every DenoisingBlock on
    the kernel, trained through ``fused_block_trainable``); ``"xla"`` the
    eager engine of ``models.fused_apply``; ``"pallas"`` the same engine with
    the block kernel and the recompute backward.  ``sampling`` is the
    validation sampler: ``"improved"`` (T steps) or ``"direct"`` (one call at
    t = 1).  ``state.params`` are the model's own parameters."""

    base_filters: int = 32
    timesteps: int = 20
    lr: float = 1e-4
    weight_decay: float = 1e-4
    distribution_choice: str = "uniform"
    # (mse, charbonnier, ssim) weights of combined_loss
    loss_weights: tuple = (0.0, 1.0, 0.0)
    sampling: str = "improved"
    accumulation_steps: int = 4
    clip_norm: float = 0.1
    compute_dtype: Any = torch.float32
    engine: str = "flax"
    device: Any = None

    def init(self, steps_per_epoch: int, seed: int = 0) -> TrainState:
        """Builds the model from ``seed`` on the trainer's device, the
        optimizer, the step and the generator of the timesteps (also seeded
        by ``seed``)."""
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r} (want one of {ENGINES})")
        if self.sampling not in SAMPLING:
            raise ValueError(f"unknown sampling {self.sampling!r} (want one of {SAMPLING})")
        self.device = resolve_device(self.device)
        self.unet = RDUNetT(self.base_filters, generator=torch.Generator().manual_seed(seed))
        self.unet.to(self.device)
        if self.device.type == "cuda":
            self.unet.to(memory_format=torch.channels_last)
        self.diffusion = InterpolationDiffusion(timesteps=self.timesteps)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.tx = make_optimizer("adamw", lr=self.lr, weight_decay=self.weight_decay,
                                 scheduler_choice="step",
                                 steps_per_epoch=max(1, steps_per_epoch),
                                 clip_norm=self.clip_norm)
        state = TrainState.create(dict(self.unet.named_parameters()), self.tx)
        if self.engine == "flax":
            self.unet_apply = lambda p, x, t: self.unet(x, t)  # noqa: E731 — p are its parameters
        else:
            eng = self.engine
            self.unet_apply = lambda p, x, t: rdunet_t_apply_fused(  # noqa: E731
                p, x, t, engine=eng, trainable=eng == "pallas")
        self._step = make_diffusion_train_step(
            self.unet_apply, self.diffusion, self.accumulation_steps,
            distribution=self.distribution_choice, loss_weights=tuple(self.loss_weights),
            compute_dtype=self.compute_dtype)
        return state

    def put(self, batch):
        return put_batch(batch, self.device)

    def train_step(self, state, noisy, clean):
        return self._step(state, self.generator, self.put(noisy), self.put(clean))

    def train_epoch(self, state, train_loader, epoch: int = 0):
        """One pass over ``train_loader``'s (noisy, clean) batches; returns
        ``(state, mean loss)``."""
        losses = [self.train_step(state, noisy, clean)[1] for noisy, clean in train_loader]
        mean_loss = float(torch.stack(losses).mean()) if losses else math.nan
        return state, mean_loss

    def validate(self, state, noisy, clean):
        """The validation sampler on one (noisy, clean) batch: returns
        ``(combined_loss against clean, denoised)``."""
        sample = (self.diffusion.direct_sampling if self.sampling == "direct"
                  else self.diffusion.improved_sampling)
        with torch.no_grad():
            denoised = sample(lambda x, t: self.unet_apply(state.params, x, t),
                              self.put(noisy).to(self.compute_dtype))
            vloss = float(combined_loss(denoised.float(), self.put(clean).float()))
        return vloss, denoised
