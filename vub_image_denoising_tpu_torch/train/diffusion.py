"""Interpolation-diffusion trainer and its command line, the framework's
primary entry point.  Counterpart of ``vub_image_denoising_tpu/train/diffusion.py``
(reference diffusion_denoising/diffusion_RDUnet.py:76-315).

One train step, per micro-batch:

- per-image timesteps t in [0, T]: uniform integers as floats, or
  Beta(2, 1)*T ("biased", leaning toward T);
- the interpolation ``alpha*noisy + (1-alpha)*clean`` with alpha = t/T;
- ONE U-Net call on the interpolated image at t/T (not the sampler);
- ``combined_loss`` (default pure Charbonnier) against clean, in f32.

The micro-batch gradients are SUMMED (real accumulation, as in the JAX
package; the reference zero-grads every batch), clipped to global norm 0.1,
and one optimizer step is taken (default AdamW(1e-4, wd 1e-4) + StepLR(3,
0.5) per epoch).  ``train_epoch`` draws each batch's timesteps from
``fold_generator(device, seed, epoch, batch)`` (JAX: ``fold_in(fold_in(key,
epoch), batch)``), so a resumed epoch draws what a straight run draws.
Validation runs the full sampler on one batch of the val loader.  Checkpoints
are written per epoch as ``{output_dir}/diffusion_RDUNet_model_checkpointed_epoch_{n}.pth``
(:170-178) with ``unet.``-prefixed model keys and the optimizer and scheduler
state, plus a final bare state_dict (:284-286).

Batches are (N, 3, H, W) tensors in [-1, 1]; the trainer moves them to its
device (the card unless ``device="cpu"`` / ``--device cpu``).  Where the JAX
functions take a ``key``, these take the trainer's seed.  Over several
ranks (``torchrun --nproc-per-node N``; ``main`` joins the group with
``parallel.mesh.init_distributed``, as JAX's calls ``init_distributed``:
nccl with a card per rank, gloo with ``--device cpu``) each rank trains on
its rows of every global batch;
``--param-sharding`` is ``replicated``, ``fsdp`` (params and Adam moments
sharded, ``parallel/fsdp.py``) or ``tp`` (channels split,
``parallel/tp.py``).  Rank 0 writes the checkpoints.  ``DiffusionTrainer(
batch_sharding="spatial")`` splits every image's rows over the ranks
instead (``parallel/spatial.py``), as JAX's ``shard_spatial`` placement of
the same step; the CLI has no flag for it, as JAX's has none.
"""

import argparse
import dataclasses
import functools
import math
import os
import time
from typing import Any

import torch

from ..data.device import fold_generator
from ..diffusion.interpolation import InterpolationDiffusion
from ..diffusion.losses import combined_loss
from ..models.fused_apply import block_kernel_weights, rdunet_t_apply_fused
from ..models.rdunet import RDUNetT
from ..parallel.mesh import init_distributed, is_writer
from ..utils import checkpoint as ckpt_io
from ..utils.device import resolve_device
from ..utils.preempt import GracefulShutdown
from ..utils.tb import add_image_grid
from .schedules import make_optimizer
from .state import ShardedTrainerMixin, TrainState
from .supervised import (BATCH_SHARDINGS, ENGINES, accumulate_and_apply,
                         data_parallel_accumulation, nhwc_unit, put_batch)

SAMPLING = ("improved", "direct")

ASCII_BANNER = r"""
    ██    ██ ██    ██ ██████       █████  ██     ██       █████  ██████
    ██    ██ ██    ██ ██   ██     ██   ██ ██     ██      ██   ██ ██   ██
    ██    ██ ██    ██ ██████      ███████ ██     ██      ███████ ██████
     ██  ██  ██    ██ ██   ██     ██   ██ ██     ██      ██   ██ ██   ██
      ████    ██████  ██████      ██   ██ ██     ███████ ██   ██ ██████
"""


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
                              loss_weights=(0.0, 1.0, 0.0), compute_dtype=torch.float32,
                              kernel_weights_fn=None, data_shards: int = 1, data_index: int = 0,
                              loss_fn=combined_loss):
    """The accumulate -> clip -> step function of the diffusion trainer.

    ``unet_apply(params, x, t) -> prediction``, with ``t`` an (N,) vector of
    normalized timesteps.  The step takes ``(state, generator, noisy,
    clean)`` and returns ``(state, mean micro-batch loss)``; each
    micro-batch draws its timesteps from ``generator``.  The interpolation
    and the U-Net run in ``compute_dtype``; params stay f32.  With
    ``kernel_weights_fn(params)``, the block kernels' weights are built once
    per step and shared by its micro-batches, as in
    ``make_supervised_train_step``.

    With ``data_shards`` > 1 the step takes rank ``data_index``'s rows of a
    global batch (a contiguous block, ``parallel.mesh.local_batch_rows``):
    every rank draws the timesteps of the global batch, micro-batch by
    micro-batch as one rank would, and keeps its rows' (JAX draws one key
    for the global batch).  ``loss_fn(pred, target, mse_weight,
    charbonnier_weight, ssim_weight)`` is ``combined_loss`` unless given
    (the band layout's ``parallel.spatial.band_combined_loss``)."""
    mse_w, charb_w, ssim_w = loss_weights
    T = diffusion.timesteps

    def step(state: TrainState, generator, noisy, clean):
        kw = {} if kernel_weights_fn is None else {
            "kernel_weights": kernel_weights_fn(state.params)}
        n = noisy.shape[0]
        acc = data_parallel_accumulation(n, accumulation_steps, data_shards)
        mb = n * data_shards // acc
        ts = torch.cat([sample_timesteps(generator, mb, T, distribution)
                        for _ in range(acc)]).to(noisy.device)[data_index * n:(data_index + 1) * n]

        def micro_loss(sl):
            t = ts[sl]
            alpha = (t / T).reshape(-1, 1, 1, 1).to(compute_dtype)
            interpolated = (alpha * noisy[sl].to(compute_dtype)
                            + (1 - alpha) * clean[sl].to(compute_dtype))
            pred = unet_apply(state.params, interpolated, (t / T).to(compute_dtype), **kw)
            return loss_fn(pred.float(), clean[sl].float(), mse_weight=mse_w,
                           charbonnier_weight=charb_w, ssim_weight=ssim_w)

        return accumulate_and_apply(state, n, acc, micro_loss)

    return step


@dataclasses.dataclass
class DiffusionTrainer(ShardedTrainerMixin):
    """The diffusion training loop on an ``RDUNetT(base_filters)``, with the
    JAX trainer's defaults (``train(args)``, diffusion_RDUnet.py:230-288).

    ``engine``: ``"flax"`` runs the model's modules (every DenoisingBlock on
    the kernel, trained through ``fused_block_trainable``); ``"xla"`` the
    eager engine of ``models.fused_apply``; ``"pallas"`` the same engine with
    the block kernel and the recompute backward.  ``remat`` (False, True or
    ``"highres"``) is the model's (``RDUNetT(remat=...)``) with ``"flax"``,
    and recomputes the eager engines' blocks in the backward with the others.
    ``sampling`` is the validation sampler: ``"improved"`` (T steps) or
    ``"direct"`` (one call at t = 1).  ``state.params`` are the model's own
    parameters (``param_sharding="tp"``: its shards).  Over several ranks,
    as ``SupervisedTrainer`` (``param_sharding`` "replicated", "fsdp" or
    "tp"; ``train_step`` takes this rank's rows and returns the global
    loss).

    ``batch_sharding="spatial"``, as ``SupervisedTrainer``'s: every rank
    takes the whole batch and keeps its band of rows (``put``), the step
    draws the whole batch's timesteps on every rank alike, runs the band
    forward (``parallel.spatial.band_forward``: 14 DenoisingBlocks on the
    band plus its halos) and takes the rank's share of the whole image's
    loss (``band_combined_loss``: the SSIM term with a halo of its own);
    ``sample`` runs the sampler on the bands and gathers them.  Engine
    ``"flax"`` and ``param_sharding="replicated"`` only."""

    base_filters: int = 32
    timesteps: int = 20
    optimizer_choice: str = "adamw"
    scheduler_choice: str = "step"
    lr: float = 1e-4
    weight_decay: float = 1e-4
    distribution_choice: str = "uniform"
    # (mse, charbonnier, ssim) weights of combined_loss
    loss_weights: tuple = (0.0, 1.0, 0.0)
    sampling: str = "improved"
    accumulation_steps: int = 4
    clip_norm: float = 0.1
    output_dir: str = "checkpoints"
    compute_dtype: Any = torch.float32
    writer: Any = None
    engine: str = "flax"
    remat: Any = False
    device: Any = None
    param_sharding: str = "replicated"
    mesh: Any = None  # parallel.mesh.Mesh; default: every rank on "data" ("tp": on "model")
    batch_sharding: str = "batch"  # "spatial": each rank takes a band of rows of every image

    def init(self, steps_per_epoch: int, seed: int = 0) -> TrainState:
        """Builds the model from ``seed`` on the trainer's device, the
        optimizer, the step, and the generator ``train_step`` draws timesteps
        from by default (also seeded by ``seed``; ``train_epoch`` folds the
        seed with the epoch and batch instead)."""
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r} (want one of {ENGINES})")
        if self.sampling not in SAMPLING:
            raise ValueError(f"unknown sampling {self.sampling!r} (want one of {SAMPLING})")
        if self.batch_sharding not in BATCH_SHARDINGS:
            raise ValueError(f"unknown batch_sharding {self.batch_sharding!r} "
                             f"(want one of {BATCH_SHARDINGS})")
        spatial = self.batch_sharding == "spatial"
        if spatial and (self.param_sharding != "replicated" or self.engine != "flax"):
            raise ValueError("batch_sharding='spatial' takes param_sharding='replicated' and "
                             "engine='flax' (the model's modules)")
        self.device = resolve_device(self.device)
        self.seed = seed
        self.steps_per_epoch = max(1, steps_per_epoch)
        self.unet = RDUNetT(self.base_filters, generator=torch.Generator().manual_seed(seed),
                            remat=self.remat)
        self.unet.to(self.device)
        if self.device.type == "cuda":
            self.unet.to(memory_format=torch.channels_last)
        self.diffusion = InterpolationDiffusion(timesteps=self.timesteps)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.tx = make_optimizer(self.optimizer_choice, lr=self.lr,
                                 weight_decay=self.weight_decay,
                                 scheduler_choice=self.scheduler_choice,
                                 steps_per_epoch=self.steps_per_epoch, clip_norm=self.clip_norm)
        state = self._make_state(self.unet, self.tx)
        kernel_weights_fn, loss_fn = None, combined_loss
        if self.tp is not None:
            tp = self.tp
            self.unet_apply = lambda p, x, t: tp.apply(p, x, t)  # noqa: E731
        elif spatial:
            from ..parallel.spatial import band_combined_loss, band_forward

            group = self.mesh.group("data")
            self.unet_apply = lambda p, x, t: band_forward(self.unet, x, group, t)  # noqa: E731
            loss_fn = functools.partial(band_combined_loss, group=group)
        elif self.engine == "flax":
            self.unet_apply = lambda p, x, t: self.unet(x, t)  # noqa: E731 — p are its parameters
        else:
            eng, rm = self.engine, self.remat
            self.unet_apply = lambda p, x, t, kernel_weights=None: (  # noqa: E731
                rdunet_t_apply_fused(p, x, t, engine=eng, trainable=eng == "pallas", remat=rm,
                                     kernel_weights=kernel_weights))
            if eng == "pallas":
                dtype = self.compute_dtype
                kernel_weights_fn = lambda p: block_kernel_weights(p, dtype)  # noqa: E731
        self.kernel_weights_fn = kernel_weights_fn
        self._step = make_diffusion_train_step(
            self.unet_apply, self.diffusion, self.accumulation_steps,
            distribution=self.distribution_choice, loss_weights=tuple(self.loss_weights),
            compute_dtype=self.compute_dtype, kernel_weights_fn=kernel_weights_fn,
            # every rank holds every image of a band batch
            data_shards=1 if spatial else self.data_shards(),
            data_index=0 if spatial else self.mesh.index("data"), loss_fn=loss_fn)
        return state

    def put(self, batch):
        """A batch on the trainer's device, channels_last on the card (under
        ``batch_sharding="spatial"`` this rank's band of rows)."""
        if self.batch_sharding == "spatial":
            from ..parallel.mesh import shard_spatial

            batch = shard_spatial(batch, self.mesh)
        return put_batch(batch, self.device)

    def train_step(self, state, noisy, clean, generator=None):
        """One step; its timesteps come from ``generator`` (default the
        trainer's running generator)."""
        g = self.generator if generator is None else generator
        state, loss = self._step(state, g, self.put(noisy), self.put(clean))
        return state, self.global_mean(loss)

    def train_epoch(self, state, train_loader, epoch: int = 0):
        """One pass over ``train_loader``'s (noisy, clean) batches, batch b's
        timesteps drawn from ``fold_generator(device, seed, epoch, b)``;
        returns ``(state, mean loss)``."""
        losses = []
        for batch_idx, (noisy, clean) in enumerate(train_loader):
            g = fold_generator(self.device, self.seed, epoch, batch_idx)
            state, loss = self.train_step(state, noisy, clean, generator=g)
            losses.append(loss)
            if self.writer is not None:
                self.writer.add_scalar("Loss/train", float(loss),
                                       epoch * len(train_loader) + batch_idx)
        mean_loss = float(torch.stack(losses).mean()) if losses else math.nan
        return state, mean_loss

    def sample(self, state, noisy):
        """The validation sampler (``sampling``) on a batch of noisy images
        in [-1, 1], in ``compute_dtype``, without a graph (JAX's
        ``_jit_sample``); under ``batch_sharding="spatial"`` on this rank's
        band, the bands gathered into the whole images."""
        sample = (self.diffusion.direct_sampling if self.sampling == "direct"
                  else self.diffusion.improved_sampling)
        with torch.no_grad():
            kw = {} if self.kernel_weights_fn is None else {
                "kernel_weights": self.kernel_weights_fn(state.params)}
            y = sample(lambda x, t: self.unet_apply(state.params, x, t, **kw),
                       self.put(noisy).to(self.compute_dtype))
        if self.batch_sharding == "spatial":
            from ..parallel.mesh import all_gather

            y = all_gather(y, 2, self.mesh.group("data"))
        return y

    def validate(self, state, val_loader, epoch: int = 0):
        """The validation sampler on the first (noisy, clean) batch of
        ``val_loader`` (diffusion_RDUnet.py:137-159): returns
        ``(combined_loss against clean, denoised)``, or ``(nan, None)`` for
        an empty loader.  Logs the loss and image grids when a writer is given."""
        try:
            noisy, clean = next(iter(val_loader))
        except StopIteration:
            return math.nan, None
        denoised = self.sample(state, noisy)
        if self.batch_sharding == "spatial":  # every rank holds the whole images
            noisy, clean = put_batch(noisy, self.device), put_batch(clean, self.device)
            mean = float
        else:
            noisy, clean = self.put(noisy), self.put(clean)
            mean = self.global_mean
        with torch.no_grad():
            vloss = float(mean(combined_loss(denoised.float(), clean.float())))
        if self.writer is not None:
            self.writer.add_scalar("Loss/validation", vloss, epoch + 1)
            for tag, imgs in ((f"Epoch_{epoch + 1}/Clean Images", clean),
                              (f"Epoch_{epoch + 1}/Noisy Images", noisy),
                              (f"Epoch_{epoch + 1}/Denoised Images", denoised)):
                add_image_grid(self.writer, tag, nhwc_unit(imgs[:10]), epoch + 1)
        return vloss, denoised

    def save_epoch_checkpoint(self, state, epoch: int, name: str = ""):
        """The reference layout (diffusion_RDUnet.py:170-178): ``unet.``-prefixed
        model keys, ``epoch``, and the optimizer and scheduler state; ``name``
        overrides the reference file name."""
        path = os.path.join(
            self.output_dir,
            name or f"diffusion_RDUNet_model_checkpointed_epoch_{epoch + 1}.pth",
        )
        return self.write_checkpoint(state, path, lambda p, extra: ckpt_io.save_pth(
            p, self.unet.state_dict(), epoch=epoch + 1, prefix="unet.", extra=extra))

    def load_checkpoint(self, state, checkpoint_path):
        """Resume (diffusion_RDUnet.py:180-193): returns ``(state, start_epoch)``;
        starts at epoch 0 if the file is missing, like the reference.  The
        optimizer state follows ``TrainState.resume``'s ladder."""
        if checkpoint_path is None or not os.path.isfile(checkpoint_path):
            print(f"No checkpoint found at '{checkpoint_path}'")
            return state, 0
        _, payload = ckpt_io.load_pth(checkpoint_path, self.unet, prefix="unet.",
                                      allow_pickle=True)
        self.after_load(state)
        start_epoch = int(payload.get("epoch", 0)) if payload else 0
        state.resume(payload, start_epoch * self.steps_per_epoch)
        print(f"Loaded checkpoint '{checkpoint_path}' (epoch {start_epoch})")
        return state, start_epoch

    def fit(self, state, train_loader, val_loader, num_epochs: int, start_epoch: int = 0):
        """Epochs ``start_epoch .. num_epochs - 1``: train, validate, checkpoint;
        a SIGTERM/SIGINT finishes the epoch and its checkpoint, then stops.
        Returns ``(state, history)``."""
        history = []
        with GracefulShutdown() as stop:
            for epoch in range(start_epoch, num_epochs):
                t0 = time.time()
                state, loss = self.train_epoch(state, train_loader, epoch)
                vloss, _ = self.validate(state, val_loader, epoch)
                self.save_epoch_checkpoint(state, epoch)
                history.append(
                    {"epoch": epoch, "loss": loss, "val_loss": vloss, "sec": time.time() - t0}
                )
                print(
                    f"Epoch [{epoch + 1}/{num_epochs}], Loss: {loss:.4f}, "
                    f"Validation Loss: {vloss:.4f} ({history[-1]['sec']:.1f}s)"
                )
                if stop.requested:
                    print(f"[preempt] checkpointed through epoch {epoch + 1}; stopping")
                    break
        return state, history


def build_arg_parser() -> argparse.ArgumentParser:
    """CLI flag parity with diffusion_RDUnet.py:292-311 and the JAX package's extras."""
    p = argparse.ArgumentParser(
        description="Train a diffusion model with optional optimizer and scheduler choice."
    )
    p.add_argument("--dataset_choice", type=str, default="SIDD", choices=["DIV2K", "SIDD"])
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--num_epochs", type=int, default=300)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--validation_split", type=float, default=0.2)
    p.add_argument("--augment", action="store_false")
    p.add_argument("--dataset_percentage", type=float, default=0.1)
    p.add_argument("--base_filters", type=int, default=32)
    p.add_argument("--timesteps", type=int, default=20)
    p.add_argument("--optimizer_choice", type=str, default="adamw",
                   choices=["adam", "adamw", "adadelta"])
    p.add_argument("--scheduler_choice", type=str, default="step", choices=["cosine", "step"])
    p.add_argument("--output_dir", type=str, default="checkpoints")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--distribution_choice", type=str, default="uniform",
                   choices=["uniform", "biased"])
    p.add_argument("--loss_weights", type=str, default="0,1,0",
                   help="mse,charbonnier,ssim weights of combined_loss "
                        "(diffusion_RDUnet.py:60-65 defaults 0,1,0)")
    p.add_argument("--data_root", type=str, default="dataset",
                   help="root containing DIV2K_train_HR.nosync / SIDD_dataset.nosync")
    p.add_argument("--bf16", action="store_true", help="run the U-Net in bfloat16")
    p.add_argument("--engine", type=str, default="flax", choices=list(ENGINES),
                   help="U-Net engine: flax (the modules), xla (eager engine), "
                        "pallas (the block kernel, recompute backward)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the DenoisingBlocks in the backward (every engine)")
    p.add_argument("--param-sharding", type=str, default="replicated",
                   choices=["replicated", "fsdp", "tp"],
                   help="fsdp shards params + Adam moments over the data ranks "
                        "(parallel/fsdp.py); tp shards each layer's channels over the "
                        "ranks (parallel/tp.py), the batch replicated")

    p.add_argument("--device-data", action="store_true",
                   help="keep the deduped uint8 patch bank in the card's memory and draw "
                        "and degrade batches there (data/resident.py); DIV2K only")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to train: cuda (default) or cpu")
    return p


def load_data_for(args, device=None, mesh=None):
    """Dataset dispatch (diffusion_RDUnet.py:222-228); over several ranks
    each loader fetches its rank's rows of ``mesh``'s data axis."""
    from ..data.loader import load_data as load_div2k_data
    from ..data.loader import load_sidd_data

    device_data = getattr(args, "device_data", False)
    if args.dataset_choice == "DIV2K":
        folder = os.path.join(args.data_root, "DIV2K_train_HR.nosync")
        return load_div2k_data(
            folder, batch_size=args.batch_size, augment=args.augment,
            dataset_percentage=args.dataset_percentage,
            validation_split=args.validation_split, use_rgb=True,
            num_workers=args.num_workers, device=device, device_data=device_data, mesh=mesh,
        )
    if device_data:
        raise ValueError("--device-data currently supports DIV2K only (the "
                         "SIDD pair bank would double the memory footprint)")
    folder = os.path.join(args.data_root, "SIDD_dataset.nosync", "SIDD_Medium_Srgb")
    return load_sidd_data(
        folder, batch_size=args.batch_size, augment=args.augment,
        dataset_percentage=args.dataset_percentage,
        validation_split=args.validation_split, use_rgb=True,
        num_workers=args.num_workers, device=device, mesh=mesh,
    )


def train(args, train_loader=None, val_loader=None):
    """Full training entry point (diffusion_RDUnet.py:230-288).  As in the
    JAX CLI, a resumed run leaves the loaders' ``.epoch`` where it finds it;
    a caller that wants the resumed epochs to shuffle and draw noise as a
    straight run would passes loaders with ``.epoch`` set to the start epoch."""
    print(ASCII_BANNER)
    for k, v in sorted(vars(args).items()):
        print(f"{k}: {v}")

    loss_weights = getattr(args, "loss_weights", None) or (0.0, 1.0, 0.0)
    if isinstance(loss_weights, str):
        loss_weights = tuple(float(w) for w in loss_weights.split(","))
    trainer = DiffusionTrainer(
        base_filters=args.base_filters,
        timesteps=args.timesteps,
        optimizer_choice=args.optimizer_choice,
        scheduler_choice=args.scheduler_choice,
        lr=args.lr,
        weight_decay=args.weight_decay,
        distribution_choice=args.distribution_choice,
        loss_weights=loss_weights,
        output_dir=args.output_dir,
        compute_dtype=torch.bfloat16 if getattr(args, "bf16", False) else torch.float32,
        engine=getattr(args, "engine", "flax"),
        remat=getattr(args, "remat", False),
        device=getattr(args, "device", None),
        param_sharding=getattr(args, "param_sharding", "replicated"),
    )
    try:
        from tensorboardX import SummaryWriter

        log_dir = os.path.join("runs", "diffusion_checkpointed",
                               os.path.basename(args.output_dir))
        trainer.writer = SummaryWriter(log_dir=log_dir)
    except ImportError:
        pass

    trainer.device = resolve_device(trainer.device)
    mesh = trainer.ensure_mesh()
    if train_loader is None or val_loader is None:
        train_loader, val_loader = load_data_for(args, device=trainer.device, mesh=mesh)

    state = trainer.init(steps_per_epoch=len(train_loader))
    state, start_epoch = trainer.load_checkpoint(state, args.checkpoint_path)
    state, history = trainer.fit(
        state, train_loader, val_loader, args.num_epochs, start_epoch=start_epoch
    )

    final_path = os.path.join(args.output_dir, "diffusion_RDUNet_model_checkpointed_final.pth")
    if is_writer():
        ckpt_io.save_pth(final_path, trainer.unet.state_dict(), prefix="unet.", bare=True)
        print(f"Final model saved at {final_path}")
    if trainer.writer is not None:
        trainer.writer.close()
    return state, history


def main(argv=None):
    from ..utils.cache import enable_compilation_cache

    args = build_arg_parser().parse_args(argv)
    enable_compilation_cache()
    # a no-op unless torchrun's environment is set: nccl for a card per rank,
    # gloo for CPU ranks
    init_distributed("gloo" if args.device == "cpu" else "nccl")
    try:
        return train(args)
    except Exception as e:  # mirror the reference's top-level guard (:314-315)
        print(f"An error occurred: {e}")
        raise


if __name__ == "__main__":
    main()
