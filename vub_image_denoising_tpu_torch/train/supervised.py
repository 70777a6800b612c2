"""Supervised RDUNet trainer.  Counterpart of ``vub_image_denoising_tpu/train/supervised.py``
(reference UNet/RDUNet_model.py:201-261).

- L1 loss between model(noisy) and clean.
- Gradient accumulation: the gradients of the micro-batches' mean losses are
  SUMMED, not averaged (as the reference's repeated ``backward()`` does),
  clipped to global norm 1.0, and one AdamW(1e-4, wd 1e-5) step is taken.
- StepLR(3, 0.5) per epoch, inside the per-update schedule.

Batches are (N, C, H, W) tensors in [-1, 1]; the trainer moves them to its
device (the card unless ``device="cpu"``).  Checkpointing, resume, image
grids and the data loaders are not ported yet.
"""

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from ..models.fused_apply import rdunet_apply_fused
from ..utils.device import resolve_device
from .schedules import make_optimizer
from .state import TrainState

ENGINES = ("flax", "xla", "pallas")


def effective_accumulation(n: int, requested: int) -> int:
    """Clamp the accumulation split to the batch size n: a split with more
    steps than samples would give empty micro-batches (0/0 losses); a batch
    that does not divide keeps ``requested`` micro-batches and drops the
    remainder samples."""
    return max(1, min(int(requested), int(n)))


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def make_supervised_train_step(
    apply_fn: Callable,
    accumulation_steps: int = 1,
    loss_fn: Optional[Callable] = None,
    compute_dtype=torch.float32,
):
    """The accumulate -> clip -> step function.

    ``apply_fn(params, noisy) -> denoised``.  The step takes
    ``(state, noisy, clean)`` whose leading dim is accumulation_steps *
    micro_batch and returns ``(state, mean micro-batch loss)``; the state's
    params and optimizer are updated in place.  Inputs are cast to
    ``compute_dtype``; params stay f32.  (The optimizer lives in the state,
    so this takes no ``tx``.)"""
    loss_fn = loss_fn or l1_loss

    def step(state: TrainState, noisy, clean):
        def micro_loss(sl):
            pred = apply_fn(state.params, noisy[sl].to(compute_dtype))
            return loss_fn(pred.float(), clean[sl].float())

        return accumulate_and_apply(state, noisy.shape[0], accumulation_steps, micro_loss)

    return step


def accumulate_and_apply(state: TrainState, n: int, accumulation_steps: int, micro_loss):
    """Split a batch of ``n`` into ``effective_accumulation`` micro-batches,
    SUM the gradients of ``micro_loss(slice)`` over them, and take one
    clipped optimizer step.  Returns ``(state, mean micro-batch loss)``."""
    acc = effective_accumulation(n, accumulation_steps)
    mb = n // acc
    params = list(state.params.values())
    loss_sum, grad_sum = 0.0, None
    for i in range(acc):
        loss = micro_loss(slice(i * mb, (i + 1) * mb))
        grads = torch.autograd.grad(loss, params)
        if grad_sum is None:
            grad_sum = list(grads)
        else:
            for s, g in zip(grad_sum, grads):
                s.add_(g)
        loss_sum = loss_sum + loss.detach()
    state.apply_gradients(grad_sum)
    return state, loss_sum / acc


def put_batch(batch, device):
    """A batch on ``device``, channels_last on the card."""
    x = torch.as_tensor(batch).to(device, non_blocking=True)
    return x.contiguous(memory_format=torch.channels_last) if device.type == "cuda" else x


@dataclasses.dataclass
class SupervisedTrainer:
    """The supervised training loop.

    ``engine``: ``"flax"`` runs the model's modules (every DenoisingBlock on
    the kernel, trained through ``fused_block_trainable``); ``"xla"`` the
    eager engine of ``models.fused_apply``; ``"pallas"`` the same engine with
    the block kernel and the recompute backward.  ``apply_fn(params, x)``
    overrides the engine.  ``state.params``
    are the model's own parameters."""

    model: Any
    lr: float = 1e-4
    weight_decay: float = 1e-5
    accumulation_steps: int = 4
    clip_norm: float = 1.0
    compute_dtype: Any = torch.float32
    apply_fn: Optional[Callable] = None
    engine: str = "flax"
    remat: bool = False  # recompute the eager engine's blocks in the backward
    device: Any = None

    def init(self, steps_per_epoch: int) -> TrainState:
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r} (want one of {ENGINES})")
        self.device = resolve_device(self.device)
        self.model.to(self.device)
        if self.device.type == "cuda":
            self.model.to(memory_format=torch.channels_last)
        self.tx = make_optimizer("adamw", lr=self.lr, weight_decay=self.weight_decay,
                                 scheduler_choice="step",
                                 steps_per_epoch=max(1, steps_per_epoch),
                                 clip_norm=self.clip_norm)
        state = TrainState.create(dict(self.model.named_parameters()), self.tx)
        apply = self.apply_fn
        if apply is None:
            if self.engine == "flax":
                apply = lambda p, x: self.model(x)  # noqa: E731 — p are its parameters
            else:
                eng, rm = self.engine, self.remat
                apply = lambda p, x: rdunet_apply_fused(  # noqa: E731
                    p, x, engine=eng, trainable=eng == "pallas", remat=rm)
        self.forward_fn = apply
        self._step = make_supervised_train_step(apply, self.accumulation_steps,
                                                compute_dtype=self.compute_dtype)
        return state

    def put(self, batch):
        """A batch on the trainer's device, channels_last on the card."""
        return put_batch(batch, self.device)

    def train_step(self, state, noisy, clean):
        return self._step(state, self.put(noisy), self.put(clean))

    def train_epoch(self, state, train_loader, epoch: int = 0):
        """One pass over ``train_loader``'s (noisy, clean) batches; returns
        ``(state, mean loss)``."""
        losses = [self.train_step(state, noisy, clean)[1] for noisy, clean in train_loader]
        mean_loss = float(torch.stack(losses).mean()) if losses else math.nan
        return state, mean_loss

    def evaluate_batch(self, state, noisy):
        with torch.no_grad():
            return self.forward_fn(state.params, self.put(noisy).to(self.compute_dtype))
