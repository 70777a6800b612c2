"""Supervised RDUNet trainer.  Counterpart of ``vub_image_denoising_tpu/train/supervised.py``
(reference UNet/RDUNet_model.py:201-261).

- L1 loss between model(noisy) and clean.
- Gradient accumulation: the gradients of the micro-batches' mean losses are
  SUMMED, not averaged (as the reference's repeated ``backward()`` does),
  clipped to global norm 1.0, and one AdamW(1e-4, wd 1e-5) step is taken.
- StepLR(3, 0.5) per epoch, inside the per-update schedule.

Batches are (N, C, H, W) tensors in [-1, 1]; the trainer moves them to its
device (the card unless ``device="cpu"``).  ``fit`` runs the epochs under
``GracefulShutdown``, logs image grids when a writer is given, and writes
``{model_state_dict, epoch, optimizer_state_dict, scheduler_state_dict}``
every ``checkpoint_every`` epochs (RDUNet_model.py:252-261, both dicts
filled); ``load_checkpoint`` resumes from it exactly.  The JAX package's
orbax sidecar has no counterpart: the ``.pth`` holds the whole state.  JAX's
``fit`` has no ``start_epoch``; here it continues a resumed run.
"""

import dataclasses
import math
import os
import time
from typing import Any, Callable, Optional

import torch

from ..data.device import denormalize
from ..models.fused_apply import block_kernel_weights, rdunet_apply_fused
from ..utils import checkpoint as ckpt_io
from ..utils.device import resolve_device
from ..utils.preempt import GracefulShutdown
from ..utils.tb import add_image_grid
from .schedules import make_optimizer
from .state import ShardedTrainerMixin, TrainState

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
    kernel_weights_fn: Optional[Callable] = None,
    data_shards: int = 1,
):
    """The accumulate -> clip -> step function.

    ``apply_fn(params, noisy) -> denoised``.  The step takes
    ``(state, noisy, clean)`` whose leading dim is accumulation_steps *
    micro_batch and returns ``(state, mean micro-batch loss)``; the state's
    params and optimizer are updated in place.  Inputs are cast to
    ``compute_dtype``; params stay f32.  (The optimizer lives in the state,
    so this takes no ``tx``.)  With ``kernel_weights_fn(params)``, the
    block kernels' weights are built once per step, before its update, and
    every micro-batch's ``apply_fn(params, noisy, kernel_weights=...)``
    shares them.  With ``data_shards`` > 1 the step takes this rank's rows
    of a global batch (``data_parallel_accumulation``)."""
    loss_fn = loss_fn or l1_loss

    def step(state: TrainState, noisy, clean):
        kw = {} if kernel_weights_fn is None else {
            "kernel_weights": kernel_weights_fn(state.params)}
        acc = data_parallel_accumulation(noisy.shape[0], accumulation_steps, data_shards)

        def micro_loss(sl):
            pred = apply_fn(state.params, noisy[sl].to(compute_dtype), **kw)
            return loss_fn(pred.float(), clean[sl].float())

        return accumulate_and_apply(state, noisy.shape[0], acc, micro_loss)

    return step


def data_parallel_accumulation(n: int, accumulation_steps: int, data_shards: int = 1) -> int:
    """The micro-batches of a step on ``n`` rows of a global batch split over
    ``data_shards`` ranks: ``effective_accumulation`` of the global batch.
    Over ranks, each rank's rows must split into that many equal
    micro-batches: the mean of the ranks' micro-batch gradients is then the
    global micro-batches' (the losses are per-sample means)."""
    acc = effective_accumulation(n * data_shards, accumulation_steps)
    if data_shards > 1 and n % acc:
        raise ValueError(f"{n} rows per rank do not split into {acc} micro-batches")
    return acc


def accumulate_and_apply(state: TrainState, n: int, accumulation_steps: int, micro_loss):
    """Split a batch of ``n`` into ``effective_accumulation`` micro-batches,
    SUM the gradients of ``micro_loss(slice)`` over them, and take one
    clipped optimizer step (its gradients reduced over the ranks by
    ``state.parallel``).  Returns ``(state, mean micro-batch loss)``."""
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
class SupervisedTrainer(ShardedTrainerMixin):
    """The supervised training loop.

    ``engine``: ``"flax"`` runs the model's modules (every DenoisingBlock on
    the kernel, trained through ``fused_block_trainable``); ``"xla"`` the
    eager engine of ``models.fused_apply``; ``"pallas"`` the same engine with
    the block kernel and the recompute backward.  ``apply_fn(params, x)``
    overrides the engine.  ``state.params``
    are the model's own parameters (``param_sharding="tp"``: its shards,
    through ``parallel.tp``'s forward, whatever the engine).

    Over several ranks (``torch.distributed`` up, ``parallel.mesh``) each
    rank's ``train_step`` takes its rows of the global batch
    (``parallel.mesh.shard_batch``; with ``"tp"`` the whole batch) and
    returns the global batch's loss; ``param_sharding`` is ``"replicated"``,
    ``"fsdp"`` or ``"tp"`` (``ShardedTrainerMixin``)."""

    model: Any
    lr: float = 1e-4
    weight_decay: float = 1e-5
    accumulation_steps: int = 4
    clip_norm: float = 1.0
    checkpoint_every: int = 5
    checkpoint_dir: str = "checkpoints"
    checkpoint_name: str = "rdunet_denoising.pth"
    compute_dtype: Any = torch.float32
    writer: Any = None
    apply_fn: Optional[Callable] = None
    engine: str = "flax"
    remat: bool = False  # recompute the eager engine's blocks in the backward
    device: Any = None
    param_sharding: str = "replicated"
    mesh: Any = None  # parallel.mesh.Mesh; default: every rank on "data" ("tp": on "model")

    def init(self, steps_per_epoch: int) -> TrainState:
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r} (want one of {ENGINES})")
        self.device = resolve_device(self.device)
        self.model.to(self.device)
        if self.device.type == "cuda":
            self.model.to(memory_format=torch.channels_last)
        self.steps_per_epoch = max(1, steps_per_epoch)
        self.tx = make_optimizer("adamw", lr=self.lr, weight_decay=self.weight_decay,
                                 scheduler_choice="step", steps_per_epoch=self.steps_per_epoch,
                                 clip_norm=self.clip_norm)
        state = self._make_state(self.model, self.tx)
        apply, kernel_weights_fn = self.apply_fn, None
        if self.tp is not None:
            tp = self.tp
            apply = lambda p, x: tp.apply(p, x)  # noqa: E731
        elif apply is None:
            if self.engine == "flax":
                apply = lambda p, x: self.model(x)  # noqa: E731 — p are its parameters
            else:
                eng, rm = self.engine, self.remat
                apply = lambda p, x, kernel_weights=None: rdunet_apply_fused(  # noqa: E731
                    p, x, engine=eng, trainable=eng == "pallas", remat=rm,
                    kernel_weights=kernel_weights)
                if eng == "pallas":
                    dtype = self.compute_dtype
                    kernel_weights_fn = lambda p: block_kernel_weights(p, dtype)  # noqa: E731
        self.forward_fn = apply
        self._step = make_supervised_train_step(apply, self.accumulation_steps,
                                                compute_dtype=self.compute_dtype,
                                                kernel_weights_fn=kernel_weights_fn,
                                                data_shards=self.data_shards())
        return state

    def put(self, batch):
        """A batch on the trainer's device, channels_last on the card."""
        return put_batch(batch, self.device)

    def train_step(self, state, noisy, clean):
        state, loss = self._step(state, self.put(noisy), self.put(clean))
        return state, self.global_mean(loss)

    def train_epoch(self, state, train_loader, epoch: int = 0):
        """One pass over ``train_loader``'s (noisy, clean) batches; returns
        ``(state, mean loss)``."""
        losses = []
        for batch_idx, (noisy, clean) in enumerate(train_loader):
            state, loss = self.train_step(state, noisy, clean)
            losses.append(loss)
            if self.writer is not None:
                self.writer.add_scalar("Loss/train", float(loss),
                                       epoch * len(train_loader) + batch_idx)
        mean_loss = float(torch.stack(losses).mean()) if losses else math.nan
        return state, mean_loss

    def evaluate_batch(self, state, noisy):
        with torch.no_grad():
            return self.forward_fn(state.params, self.put(noisy).to(self.compute_dtype))

    def maybe_checkpoint(self, state, epoch: int, force: bool = False, name: str = ""):
        """Every ``checkpoint_every`` epochs (or with ``force``, on preemption)
        write the reference layout to ``checkpoint_dir/checkpoint_name``
        (``name`` overrides the file name).  Returns the path, or None."""
        if force or (epoch + 1) % self.checkpoint_every == 0:
            path = os.path.join(self.checkpoint_dir, name or self.checkpoint_name)
            return self.write_checkpoint(state, path, lambda p, extra: ckpt_io.save_pth(
                p, self.model.state_dict(), epoch=epoch + 1, extra=extra))
        return None

    def load_checkpoint(self, state, checkpoint_path):
        """Resume from a ``.pth``: returns ``(state, start_epoch)``; (state, 0)
        when there is no file.  The optimizer state follows
        ``TrainState.resume``'s ladder."""
        if checkpoint_path is None or not os.path.isfile(checkpoint_path):
            return state, 0
        _, payload = ckpt_io.load_pth(checkpoint_path, self.model, allow_pickle=True)
        self.after_load(state)
        epoch = int(payload.get("epoch", 0)) if payload else 0
        state.resume(payload, epoch * self.steps_per_epoch)
        return state, epoch

    def log_image_grids(self, state, loader, epoch: int):
        """Per-epoch clean/noisy/denoised grids of one batch (RDUNet_model.py:228-244)."""
        if self.writer is None:
            return
        try:
            noisy, clean = next(iter(loader))
        except StopIteration:
            return
        denoised = self.evaluate_batch(state, noisy)
        for tag, imgs in ((f"Epoch_{epoch + 1}/Clean Images", clean),
                          (f"Epoch_{epoch + 1}/Noisy Images", noisy),
                          (f"Epoch_{epoch + 1}/Denoised Images", denoised)):
            add_image_grid(self.writer, tag, nhwc_unit(imgs), epoch + 1)

    def fit(self, state, train_loader, num_epochs: int, val_loader=None, start_epoch: int = 0):
        """Epochs ``start_epoch .. num_epochs - 1``; a SIGTERM/SIGINT finishes
        the epoch, forces a checkpoint and stops.  Returns ``(state, history)``."""
        history = []
        with GracefulShutdown() as stop:
            for epoch in range(start_epoch, num_epochs):
                t0 = time.time()
                state, mean_loss = self.train_epoch(state, train_loader, epoch)
                self.log_image_grids(state, val_loader or train_loader, epoch)
                if stop.requested:
                    self.maybe_checkpoint(state, epoch, force=True)
                    history.append({"epoch": epoch, "loss": mean_loss, "sec": time.time() - t0})
                    print(f"[preempt] checkpointed through epoch {epoch + 1}; stopping")
                    break
                self.maybe_checkpoint(state, epoch)
                history.append({"epoch": epoch, "loss": mean_loss, "sec": time.time() - t0})
        return state, history


def nhwc_unit(x):
    """An NCHW batch in [-1, 1] as NHWC f32 numpy in [0, 1], for image grids."""
    return denormalize(x.detach().float()).permute(0, 2, 3, 1).cpu().numpy()
