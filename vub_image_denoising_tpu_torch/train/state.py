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
from typing import Any, Dict, Optional

import torch

from ..utils.checkpoint import optax_leaves_to_optimizer_state
from .schedules import clip_by_global_norm_, fast_forward_scheduler


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]  # the leaves the step differentiates, state_dict keys
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    clip_norm: Optional[float] = None
    step: int = 0
    # the multi-device strategy (parallel/): reduces the step's gradients
    # over the ranks into the optimizer's leaves, takes the clip's global
    # norm and refreshes the model after the update; None on one device
    parallel: Any = None

    @classmethod
    def create(cls, params, tx, parallel=None):
        """``tx`` is ``make_optimizer(...)``'s spec; the optimizer takes
        ``parallel.opt_params()`` (FSDP and TP: this rank's shards) or the
        params."""
        leaves = params.values() if parallel is None else parallel.opt_params()
        opt, sched = tx.build(leaves)
        return cls(params=dict(params), optimizer=opt, scheduler=sched, clip_norm=tx.clip_norm,
                   parallel=parallel)

    def apply_gradients(self, grads):
        """Reduce ``grads`` (one per param, in ``params`` order) over the
        ranks, clip them to the global norm, take one optimizer step at
        ``schedule(step)`` and count it."""
        grads, leaves = list(grads), list(self.params.values())
        sq_norm = None
        if self.parallel is not None:
            grads, leaves = self.parallel.reduce(grads), self.parallel.opt_params()
            sq_norm = getattr(self.parallel, "sq_norm", None)
        if self.clip_norm is not None:
            clip_by_global_norm_(grads, self.clip_norm, sq_norm)
        for p, g in zip(leaves, grads):
            p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.scheduler.step()
        self.step += 1
        if self.parallel is not None:
            self.parallel.after_step()

    def optimizer_state(self):
        """The optimizer's state_dict as a replicated optimizer over the
        model's parameters would hold it (sharded moments all-gathered:
        a collective, every rank calls it)."""
        if hasattr(self.parallel, "full_optimizer_state"):
            return self.parallel.full_optimizer_state(self.optimizer)
        return self.optimizer.state_dict()

    def load_optimizer_state(self, sd):
        if hasattr(self.parallel, "shard_optimizer_state"):
            sd = self.parallel.shard_optimizer_state(sd)
        self.optimizer.load_state_dict(sd)

    def checkpoint_payload(self):
        """The reference's optimizer and scheduler keys, filled; tensors and
        plain values only (``torch.load(weights_only=True)`` reads them)."""
        return {"optimizer_state_dict": self.optimizer_state(),
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
            self.load_optimizer_state(payload["optimizer_state_dict"])
            self.scheduler.load_state_dict(payload["scheduler_state_dict"])
            self.step = self.scheduler.last_epoch
        elif payload and "optax_leaves" in payload:
            choice = ("adadelta" if isinstance(self.optimizer, torch.optim.Adadelta)
                      else "adam")
            full = getattr(self.parallel, "full", self.params)
            state, schedule_count = optax_leaves_to_optimizer_state(
                payload["optax_leaves"], full, choice)
            sd = self.optimizer.state_dict()
            self.load_optimizer_state({**sd, "state": state})
            fast_forward_scheduler(self.scheduler, schedule_count)
            self.step = resume_step
        elif resume_step > 0:
            fast_forward_scheduler(self.scheduler, resume_step)
            self.step = resume_step


PARAM_SHARDINGS = ("replicated", "fsdp", "tp")


class ShardedTrainerMixin:
    """The multi-device plumbing shared by ``SupervisedTrainer`` and
    ``DiffusionTrainer`` (JAX's ``ShardedTrainerMixin``): the mesh per
    ``param_sharding`` mode and the state's strategy.  The host dataclass
    provides ``param_sharding``, ``mesh`` and ``device``.

    ``"replicated"``: every rank holds the parameters and its rows of the
    batch, the gradients are averaged over the ranks (``DataParallel``; no
    strategy on one rank); ``"fsdp"``: the same, with the parameters and
    Adam moments sharded (``parallel/fsdp.py``); ``"tp"``: the batch
    replicated, the layers' channels split over the ranks
    (``parallel/tp.py``), the step differentiating the shards."""

    def ensure_mesh(self):
        if self.param_sharding not in PARAM_SHARDINGS:
            raise ValueError(f"unknown param_sharding {self.param_sharding!r} "
                             f"(want one of {PARAM_SHARDINGS})")
        if self.mesh is None:
            if self.param_sharding == "tp":
                from ..parallel.tp import make_tp_mesh

                self.mesh = make_tp_mesh(device=self.device)
            else:
                from ..parallel.mesh import make_mesh

                self.mesh = make_mesh(device=self.device)
        return self.mesh

    def _make_state(self, model, tx):
        """The state of ``model``'s parameters (rank 0's values on every
        rank) under ``param_sharding``; ``self.tp`` is the tensor-parallel
        strategy or None."""
        from ..parallel.fsdp import FullyShardedDataParallel
        from ..parallel.mesh import DataParallel, put_replicated
        from ..parallel.tp import TensorParallel

        mesh = self.ensure_mesh()
        put_replicated(model.state_dict(), mesh)
        params = dict(model.named_parameters())
        self.tp = None
        if self.param_sharding == "fsdp":
            parallel = FullyShardedDataParallel(params, mesh)
        elif self.param_sharding == "tp":
            parallel = self.tp = TensorParallel(model, mesh)
            params = parallel.shards
        else:
            parallel = DataParallel(params, mesh) if mesh.size("data") > 1 else None
        return TrainState.create(params, tx, parallel)

    def data_shards(self) -> int:
        return self.mesh.size("data")

    def global_mean(self, value):
        """The mean of a per-rank loss over the data axis (each rank's rows
        are an equal share of the global batch): the global batch's loss."""
        from ..parallel.mesh import all_reduce

        n = self.data_shards()
        return value if n == 1 else all_reduce(value, self.mesh.group("data")) / n

    def write_checkpoint(self, state, path, save):
        """Gather the optimizer state (a collective), ``save(path, extra)`` on
        rank 0, and wait until the file is there for every rank; returns
        ``path``."""
        from ..parallel.mesh import barrier, is_writer

        extra = state.checkpoint_payload()
        if is_writer():
            save(path, extra)
        barrier()
        return path

    def after_load(self, state):
        """A loaded model's parameters are the full values: cut the shards
        again from them."""
        if hasattr(state.parallel, "reshard"):
            state.parallel.reshard()
