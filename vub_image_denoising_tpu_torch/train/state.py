"""Train state and the resume ladder.  Counterpart of ``TrainState`` and
``ShardedTrainerMixin._resume_opt_state`` in
``vub_image_denoising_tpu/train/state.py``.

JAX's state is an immutable pytree replaced every step; here the params are
the model's own parameters, updated in place by the optimizer.  A ``.pth``
the port writes carries ``optimizer_state_dict`` and ``scheduler_state_dict``
(the reference's keys), so it resumes exactly; one the JAX package writes
carries its optax state as ``optax_leaves``, which resumes with Adam's
moments and count (``optax_leaves_to_optimizer_state``); the JAX package's
orbax sidecar has no counterpart.
"""

import dataclasses
from typing import Dict, Optional

import torch

from ..utils.checkpoint import optax_leaves_to_optimizer_state
from .schedules import clip_by_global_norm_, fast_forward_scheduler


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]  # f32 leaf tensors, reference state_dict keys
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    clip_norm: Optional[float] = None
    step: int = 0

    @classmethod
    def create(cls, params, tx):
        """``tx`` is ``make_optimizer(...)``'s spec."""
        opt, sched = tx.build(params.values())
        return cls(params=dict(params), optimizer=opt, scheduler=sched, clip_norm=tx.clip_norm)

    def apply_gradients(self, grads):
        """Clip ``grads`` (one per param, in ``params`` order) to the global
        norm, take one optimizer step at ``schedule(step)`` and count it."""
        grads = list(grads)
        if self.clip_norm is not None:
            clip_by_global_norm_(grads, self.clip_norm)
        for p, g in zip(self.params.values(), grads):
            p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.scheduler.step()
        self.step += 1

    def checkpoint_payload(self):
        """The reference's optimizer and scheduler keys, filled; tensors and
        plain values only (``torch.load(weights_only=True)`` reads them)."""
        return {"optimizer_state_dict": self.optimizer.state_dict(),
                "scheduler_state_dict": self.scheduler.state_dict()}

    def resume(self, payload, resume_step: int):
        """The resume ladder for a ``.pth`` payload (the params are loaded by
        the caller): (1) a file the port wrote (``optimizer_state_dict``
        filled): the optimizer and scheduler state exactly, and the step
        count; (2) a file the JAX package wrote (``optax_leaves``): the
        optimizer's moments and count, and the LR schedule at the position
        the leaves hold, as JAX's ``safe_to_optax_state`` restores them, and
        the step count ``resume_step``; (3) a file the reference wrote (an
        empty ``optimizer_state_dict``, or none): the LR schedule moved to
        ``resume_step``, Adam's moments and step fresh
        (``fast_forward_scheduler``)."""
        if payload and payload.get("optimizer_state_dict"):
            self.optimizer.load_state_dict(payload["optimizer_state_dict"])
            self.scheduler.load_state_dict(payload["scheduler_state_dict"])
            self.step = self.scheduler.last_epoch
        elif payload and "optax_leaves" in payload:
            choice = ("adadelta" if isinstance(self.optimizer, torch.optim.Adadelta)
                      else "adam")
            state, schedule_count = optax_leaves_to_optimizer_state(
                payload["optax_leaves"], self.params, choice)
            sd = self.optimizer.state_dict()
            self.optimizer.load_state_dict({**sd, "state": state})
            fast_forward_scheduler(self.scheduler, schedule_count)
            self.step = resume_step
        elif resume_step > 0:
            fast_forward_scheduler(self.scheduler, resume_step)
            self.step = resume_step
