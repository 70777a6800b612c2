"""Train state.  Counterpart of ``TrainState`` in ``vub_image_denoising_tpu/train/state.py``.

JAX's state is an immutable pytree replaced every step; here the params are
the model's own parameters, updated in place by the optimizer.
"""

import dataclasses
from typing import Dict, Optional

import torch

from .schedules import clip_by_global_norm_


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
