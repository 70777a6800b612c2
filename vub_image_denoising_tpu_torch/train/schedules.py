"""LR schedules and optimizers with the reference's torch semantics.

Counterpart of ``vub_image_denoising_tpu/train/schedules.py``:

- ``step_lr``             StepLR(step_size, gamma) stepped once per EPOCH
  (RDUNet_model.py:193-195: step_size=3, gamma=0.5);
- ``cosine_annealing_lr`` CosineAnnealingLR(T_max=10, eta_min=0) per epoch;
- ``make_optimizer``      adam (betas 0.9/0.999, cosine), adamw (StepLR(3, .5)),
  adadelta (StepLR(3, .5)), with global-norm gradient clipping in front;
- ``fast_forward_scheduler`` moves a schedule to a resumed step
  (``fast_forward_opt_state``).

Schedules are functions of the global step (``steps_per_epoch`` gives the
epoch granularity).  The optimizer steps its ``LambdaLR`` once per update,
so update k runs at ``schedule(k)``, as optax evaluates it.
"""

import dataclasses
import math
from typing import Callable, Optional

import torch


def step_lr(base_lr: float, steps_per_epoch: int, step_size: int = 3, gamma: float = 0.5):
    def schedule(step):
        epoch = step // steps_per_epoch
        return base_lr * (gamma ** (epoch // step_size))

    return schedule


def cosine_annealing_lr(base_lr: float, steps_per_epoch: int, t_max: int = 10,
                        eta_min: float = 0.0):
    def schedule(step):
        epoch = step // steps_per_epoch
        return eta_min + (base_lr - eta_min) * (
            1 + math.cos(math.pi * (epoch % (2 * t_max)) / t_max)) / 2

    return schedule


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What ``make_optimizer`` chose; ``build`` makes it for a set of params."""

    choice: str
    lr: float
    weight_decay: float
    schedule: Callable[[int], float]
    clip_norm: Optional[float]

    def build(self, params):
        """(torch optimizer, per-update LambdaLR) over ``params``."""
        params = list(params)
        if self.choice == "adam":
            opt = torch.optim.Adam(params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        elif self.choice == "adamw":
            # AdamW decays every param (biases and PReLU too), scaled by lr, as optax
            opt = torch.optim.AdamW(params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=self.weight_decay)
        else:
            opt = torch.optim.Adadelta(params, lr=self.lr, rho=0.9, eps=1e-6)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda k: self.schedule(k) / self.lr)
        return opt, sched


def make_optimizer(
    optimizer_choice: str = "adamw",
    lr: float = 1e-4,
    weight_decay: float = 1e-4,
    scheduler_choice: Optional[str] = None,
    steps_per_epoch: int = 1,
    clip_norm: Optional[float] = None,
) -> OptimizerSpec:
    """The reference's optimizer and scheduler combination."""
    if optimizer_choice not in ("adam", "adamw", "adadelta"):
        raise ValueError(f"unknown optimizer '{optimizer_choice}'")
    if scheduler_choice is None:
        scheduler_choice = "cosine" if optimizer_choice == "adam" else "step"
    if scheduler_choice == "cosine":
        schedule = cosine_annealing_lr(lr, steps_per_epoch)
    else:
        schedule = step_lr(lr, steps_per_epoch)
    return OptimizerSpec(optimizer_choice, lr, weight_decay, schedule, clip_norm)


def clip_by_global_norm_(grads, max_norm: float, sq_norm=None):
    """Scale ``grads`` in place by max_norm / ||grads|| when the global norm
    exceeds max_norm (``optax.clip_by_global_norm``); no host sync.
    ``sq_norm(grads)``, when given, is the squared global norm (of gradients
    split over ranks: ``parallel.fsdp.ShardedParams.sq_norm``)."""
    if sq_norm is not None:
        norm = torch.sqrt(sq_norm(grads))
    else:
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
    for g in grads:
        g.mul_(scale)
    return norm


def fast_forward_scheduler(scheduler, step_count: int):
    """Move a ``LambdaLR`` (and its optimizer's LR) to update ``step_count``.

    For a resume from a ``.pth`` that carries an epoch but no optimizer state
    (one the JAX package or the reference wrote): the reference restores only
    the scheduler's position (diffusion_RDUnet.py:186-189), and its fresh Adam
    restarts at t = 0 with full bias correction.  So only the LR position
    moves; the optimizer's moments and step count stay fresh (moving Adam's
    count while its moments are zero would skip the bias correction and make
    the first update about 3x too large)."""
    lrs = [base * fn(step_count) for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    scheduler.load_state_dict({**scheduler.state_dict(), "last_epoch": step_count,
                               "_last_lr": lrs})
    for group, lr in zip(scheduler.optimizer.param_groups, lrs):
        group["lr"] = lr
