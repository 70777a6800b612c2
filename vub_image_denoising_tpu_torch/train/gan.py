"""RCA-GAN trainer on the card: ``train_rca_gan`` (paper_gan.py:317-457).

Counterpart of ``vub_image_denoising_tpu/train/gan.py``, on one device or
data parallel over ranks (``GANDataParallel``):

- Generator(1, 1) and Discriminator(1) on grayscale pairs; kaiming init.
- D step: d_loss = -mean(D(gt)) + mean(D(G(degraded).detach())) + GP; Adam(5e-5,
  (0.5, 0.999)) behind a global-norm clip at 1.0.
- G step: MultimodalLoss(G(degraded), gt) with (lambda1, lambda2, lambda3,
  lambda4) = (lambda_pixel, lambda_perceptual, lambda_texture, lambda_adv):
  the reference's argument names land one slot off (``lambda_pixel`` weights
  the perceptual term), and that is kept; ``lambda_adv`` (1 in the
  reference) can ramp in over ``adv_ramp_steps`` G steps; ``critic_norm``
  picks the critic's normalization.  Clip 1.0, Adam as D's.
- StepLR(10, 0.5) on both, stepped per update at the epoch's LR.
- ``checkpoint_epoch_{n}.pth``: {epoch, generator_state_dict,
  discriminator_state_dict, optimizer_G_state_dict, optimizer_D_state_dict}
  (:447-453), the optimizer entries real torch ``state_dict``s.

BatchNorm running statistics (and spectral-norm u) move as in the JAX
package, where a forward in training mode updates them only when its
``batch_stats`` are kept: G's by the D step's G forward and again by the G
step's; D's by D(gt) then D(fake), in the D step only.  Every other D
forward (the penalty's, and all of the G step's) runs in training mode on
the live parameters with a copy of D's buffers as they stood when the step
began (``frozen_apply``), so its updates are dropped, where a plain torch
forward would keep them.

Random draws (the penalty's eps, the hybrid generator's timesteps and
noise) come from a ``torch.Generator``: per batch ``fold_generator(device,
seed, epoch, batch)`` in ``train_epoch``; a step called directly takes one,
or the draws themselves (the tests hand over JAX's).  The clipped gradients
of a step stay in each parameter's ``.grad`` until the next one.
"""

import dataclasses
import inspect
import os
import time
from typing import Any, Optional

import torch
from torch import nn
from torch.func import functional_call

from ..data.device import fold_generator
from ..models.rca_gan import Discriminator, Generator
from ..models.vgg import VGG19Features, load_torch_vgg19
from ..utils.checkpoint import _atomic_torch_save, load_torch_payload
from ..utils.device import resolve_device
from .gan_losses import draw_eps, gradient_penalty, multimodal_loss
from .schedules import clip_by_global_norm_, step_lr


@dataclasses.dataclass
class GANTrainState:
    generator: nn.Module
    discriminator: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    g_sched: torch.optim.lr_scheduler.LambdaLR
    d_sched: torch.optim.lr_scheduler.LambdaLR
    step: int = 0  # G steps taken


def buffer_snapshot(module: nn.Module):
    return {k: v.clone() for k, v in module.named_buffers()}


def frozen_apply(module: nn.Module, buffers=None):
    """``module``'s forward in its current mode, on its live parameters and on
    a fresh copy of ``buffers`` (a ``buffer_snapshot``; by default its
    buffers now) for every call: BatchNorm uses batch statistics in training
    mode as usual, and the running statistics (and spectral-norm u) the call
    would store go to the copy.  The JAX package's ``d_apply_frozen``."""
    params = dict(module.named_parameters())
    buffers = buffer_snapshot(module) if buffers is None else buffers

    def apply(x):
        return functional_call(module, {**params, **{k: v.clone() for k, v in buffers.items()}},
                               (x,))

    return apply


def adam_with_step_lr(params, lr, betas, steps_per_epoch):
    """Adam (eps 1e-8) with StepLR(10, 0.5) evaluated per update."""
    opt = torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=1e-8)
    schedule = step_lr(lr, max(1, steps_per_epoch), step_size=10, gamma=0.5)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: schedule(k) / lr)


def apply_update(loss, params, opt, sched, clip_norm=None, reduce=None):
    """Gradients of ``loss`` for ``params`` alone, averaged over the ranks by
    ``reduce`` (a ``DataParallel``'s), clipped to ``clip_norm`` (optax's
    global-norm clip), left in ``.grad``, and one optimizer and schedule
    step."""
    grads = list(torch.autograd.grad(loss, params))
    if reduce is not None:
        grads = reduce(grads)
    if clip_norm is not None:
        clip_by_global_norm_(grads, clip_norm)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    sched.step()


def state_dict_cpu(module):
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


class GANDataParallel:
    """Data parallelism of a GAN trainer over ``mesh``'s data axis (JAX's
    trainers shard the batch over the mesh): rank 0's G and D on every
    rank, their BatchNorms on the global batch's statistics
    (``parallel.mesh.sync_batchnorm_``), each rank's gradients averaged
    (``reduce``), every random draw made for the global batch and cut to
    this rank's rows (``rows``), losses averaged (``mean``).  Each rank's
    steps take its rows of the global batch."""

    def __init__(self, mesh, *modules):
        from ..parallel.mesh import put_replicated, sync_batchnorm_

        self.mesh, self.n = mesh, mesh.size("data")
        self.group = mesh.group("data")  # None with one rank
        for m in modules:
            put_replicated(m.state_dict(), mesh)
            sync_batchnorm_(m, mesh)

    def reduce(self, grads):
        from ..parallel.mesh import all_reduce_mean_flat

        return all_reduce_mean_flat(grads, self.group)

    def rows(self, draw, n_local):
        """``draw(n)`` for the global batch of ``n_local`` rows per rank: this
        rank's rows of it."""
        from ..parallel.mesh import shard_batch

        return draw(n_local) if self.n == 1 else shard_batch(draw(n_local * self.n), self.mesh)

    def mean(self, value):
        from ..parallel.mesh import all_reduce

        return value if self.n == 1 else all_reduce(value, self.group) / self.n


def make_data_parallel(trainer, *modules):
    """The trainer's ``GANDataParallel`` over ``trainer.mesh`` (default:
    every rank on "data")."""
    from ..parallel.mesh import make_mesh

    if trainer.mesh is None:
        trainer.mesh = make_mesh(device=trainer.device)
    return GANDataParallel(trainer.mesh, *modules)


@dataclasses.dataclass
class RCAGANTrainer:
    in_channels: int = 1
    out_channels: int = 1
    lambda_pixel: float = 1.0
    lambda_perceptual: float = 0.01
    lambda_texture: float = 0.001
    lambda_adv: float = 1.0
    adv_ramp_steps: int = 0
    lambda_gp: float = 10.0
    lr: float = 5e-5
    betas: tuple = (0.5, 0.999)
    checkpoint_dir: str = "checkpoints"
    disc_input_hw: int = 256
    vgg_weights_path: Optional[str] = None
    writer: Any = None
    # a generator module to train in place of Generator(in, out), e.g. the
    # diffusion-GAN hybrid (GeneratorWithDiffusion): one whose forward takes
    # ``noise`` gets its timesteps and noise from the step's draws
    generator: Optional[nn.Module] = None
    critic_norm: str = "bn"
    device: Any = None
    seed: int = 0
    mesh: Any = None  # parallel.mesh.Mesh: data parallel over its "data" axis

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._gen_takes_draws = self.generator is not None and "noise" in inspect.signature(
            type(self.generator).forward).parameters

    def init(self, steps_per_epoch: int) -> GANTrainState:
        """Build G, D (for ``disc_input_hw`` inputs) and VGG19[:8] from
        ``seed`` (or a user-supplied torchvision file), and both optimizers."""
        init_gen = torch.Generator().manual_seed(self.seed)
        g = self.generator
        if g is None:
            g = Generator(self.in_channels, self.out_channels, generator=init_gen)
        d = Discriminator(self.in_channels, norm=self.critic_norm, input_hw=self.disc_input_hw,
                          generator=init_gen)
        vgg = VGG19Features(num_layers=8, generator=init_gen)
        load_torch_vgg19(vgg, self.vgg_weights_path)
        return self._make_state(g, d, vgg, steps_per_epoch)

    def _make_state(self, g, d, vgg, steps_per_epoch):
        self.vgg = vgg.to(self.device).eval().requires_grad_(False)
        g, d = g.to(self.device).train(), d.to(self.device).train()
        self.dp = make_data_parallel(self, g, d)
        g_opt, g_sched = adam_with_step_lr(g.parameters(), self.lr, self.betas, steps_per_epoch)
        d_opt, d_sched = adam_with_step_lr(d.parameters(), self.lr, self.betas, steps_per_epoch)
        self._draws = torch.Generator(device=self.device).manual_seed(self.seed)
        return GANTrainState(g, d, g_opt, d_opt, g_sched, d_sched)

    def _generate(self, g, x, generator, g_draws):
        if not self._gen_takes_draws:
            return g(x)
        t, noise = (None, None) if g_draws is None else g_draws
        if g_draws is None and self.dp.n > 1:
            # drawn for the global batch in the shape of the attention output,
            # 64 channels at the input's size (models/experimental.py)
            t, noise = self.dp.rows(lambda n: g.draw(n, (n, 64) + tuple(x.shape[2:]), x.device,
                                                     x.dtype, generator), x.shape[0])
        return g(x, t=t, noise=noise, generator=generator)

    def _eps(self, real, eps, generator):
        """The penalty's eps (default drawn for the global batch)."""
        if eps is not None or self.dp.n == 1:
            return eps
        return self.dp.rows(lambda n: draw_eps(real.new_empty((n,) + tuple(real.shape[1:])),
                                               generator), real.shape[0])

    def d_step(self, state, degraded, gt, generator=None, eps=None, g_draws=None):
        """One critic update; returns its loss.  ``eps`` (N, 1, 1, 1) and the
        hybrid's ``g_draws`` = (t, noise) default to draws from ``generator``."""
        gen = generator or self._draws
        g, d = state.generator, state.discriminator
        with torch.no_grad():
            fake = self._generate(g, degraded, gen, g_draws)
        frozen = frozen_apply(d)
        d_real, d_fake = d(gt), d(fake)
        gp = gradient_penalty(frozen, gt, fake, self._eps(gt, eps, gen), gen, self.lambda_gp)
        loss = -torch.mean(d_real) + torch.mean(d_fake) + gp
        apply_update(loss, list(d.parameters()), state.d_opt, state.d_sched, 1.0, self.dp.reduce)
        return self.dp.mean(loss.detach())

    def g_step(self, state, degraded, gt, generator=None, eps=None, g_draws=None):
        """One generator update; returns (loss, its parts)."""
        gen = generator or self._draws
        lam_adv = self.lambda_adv
        if self.adv_ramp_steps:
            lam_adv = lam_adv * min(1.0, (state.step + 1) / self.adv_ramp_steps)
        fake = self._generate(state.generator, degraded, gen, g_draws)
        total, parts = multimodal_loss(
            self.vgg, frozen_apply(state.discriminator), fake, gt, self._eps(gt, eps, gen), gen,
            lambda1=self.lambda_pixel, lambda2=self.lambda_perceptual,
            lambda3=self.lambda_texture, lambda4=lam_adv, lambda_gp=self.lambda_gp,
            batch_group=self.dp.group)
        apply_update(total, list(state.generator.parameters()), state.g_opt, state.g_sched, 1.0,
                     self.dp.reduce)
        state.step += 1
        return self.dp.mean(total.detach()), {k: self.dp.mean(v.detach())
                                              for k, v in parts.items()}

    def val_loss(self, state, degraded, gt, generator=None, eps=None, g_draws=None):
        """The reference's validation loss (paper_gan.py:415-424): the eval-mode
        generator, the full multimodal objective (the penalty's D in training
        mode, its buffer updates dropped, as the JAX package does)."""
        gen = generator or self._draws
        fake = self.generate(state, degraded, gen, g_draws)
        with torch.no_grad():
            total, _ = multimodal_loss(
                self.vgg, frozen_apply(state.discriminator), fake, gt, eps, gen,
                lambda1=self.lambda_pixel, lambda2=self.lambda_perceptual,
                lambda3=self.lambda_texture, lambda4=self.lambda_adv,
                lambda_gp=self.lambda_gp, create_graph=False, batch_group=self.dp.group)
        return total

    def generate(self, state, x, generator=None, g_draws=None):
        """The eval-mode generator forward (the hybrid's stays stochastic, as
        the reference's does in ``.eval()``)."""
        g = state.generator
        g.eval()
        try:
            with torch.no_grad():
                return self._generate(g, x, generator or self._draws, g_draws)
        finally:
            g.train()

    def put(self, batch):
        return tuple(torch.as_tensor(b).to(self.device, torch.float32) for b in batch)

    def train_epoch(self, state, train_loader, epoch: int, log_every: int = 10):
        d_losses, g_losses = [], []
        for batch_idx, batch in enumerate(train_loader):
            degraded, gt = self.put(batch)
            gen = fold_generator(self.device, self.seed, epoch, batch_idx)
            d_loss = self.d_step(state, degraded, gt, gen)
            g_loss, parts = self.g_step(state, degraded, gt, gen)
            d_losses.append(d_loss)
            g_losses.append(g_loss)
            if self.writer is not None and batch_idx % log_every == 0:
                step = epoch * len(train_loader) + batch_idx
                self.writer.add_scalar("Loss/Discriminator", float(d_loss), step)
                self.writer.add_scalar("Loss/Generator", float(g_loss), step)
                for name, tag in (("perceptual", "Perceptual"), ("content", "Content"),
                                  ("texture", "Texture"), ("adversarial", "Adversarial")):
                    self.writer.add_scalar(f"Loss/{tag}", float(parts[name]), step)
        return (state, torch.stack(d_losses).mean().item(), torch.stack(g_losses).mean().item())

    def validate(self, state, val_loader, epoch: int):
        """Mean validation loss over the loader ('Loss/Validation')."""
        losses = []
        for batch_idx, batch in enumerate(val_loader):
            degraded, gt = self.put(batch)
            gen = fold_generator(self.device, (self.seed, 1), epoch, batch_idx)
            losses.append(self.val_loss(state, degraded, gt, gen).item())
        vloss = sum(losses) / len(losses) if losses else float("nan")
        if self.writer is not None:
            self.writer.add_scalar("Loss/Validation", vloss, epoch + 1)
        return vloss

    def save_checkpoint(self, state, epoch: int):
        """``checkpoint_epoch_{epoch + 1}.pth`` in the reference's layout."""
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        path = os.path.join(self.checkpoint_dir, f"checkpoint_epoch_{epoch + 1}.pth")
        _atomic_torch_save({
            "epoch": epoch + 1,
            "generator_state_dict": state_dict_cpu(state.generator),
            "discriminator_state_dict": state_dict_cpu(state.discriminator),
            "optimizer_G_state_dict": state.g_opt.state_dict(),
            "optimizer_D_state_dict": state.d_opt.state_dict(),
        }, path)
        return path

    def load_checkpoint(self, state, path: str):
        """G and D from a ``checkpoint_epoch_{n}.pth`` (strict), and both
        optimizers' state when the file carries it (the port's files; the
        JAX package writes empty ones).  Returns the file's epoch."""
        payload = load_torch_payload(path)
        state.generator.load_state_dict(payload["generator_state_dict"], strict=True)
        state.discriminator.load_state_dict(payload["discriminator_state_dict"], strict=True)
        for key, opt in (("optimizer_G_state_dict", state.g_opt),
                         ("optimizer_D_state_dict", state.d_opt)):
            if payload.get(key):
                opt.load_state_dict(payload[key])
        return int(payload.get("epoch", 0))

    def fit(self, state, train_loader, val_loader, num_epochs: int, checkpoint_every: int = 10):
        from ..utils.preempt import GracefulShutdown

        history = []
        with GracefulShutdown() as stop:
            for epoch in range(num_epochs):
                t0 = time.time()
                state, d_loss, g_loss = self.train_epoch(state, train_loader, epoch)
                vloss = self.validate(state, val_loader, epoch)
                if stop.requested or (epoch + 1) % checkpoint_every == 0:
                    self.save_checkpoint(state, epoch)
                history.append({"epoch": epoch, "d_loss": d_loss, "g_loss": g_loss,
                                "val_loss": vloss, "sec": time.time() - t0})
                if stop.requested:
                    print(f"[preempt] checkpointed through epoch {epoch + 1}; stopping")
                    break
        return state, history


def _sample_side(sample_batch, val_loader):
    if sample_batch is None:
        sample_batch = next(iter(val_loader))[0]
    return int(sample_batch.shape[-1])


def train_rca_gan(train_loader, val_loader, num_epochs=200, lambda_pixel=1.0,
                  lambda_perceptual=0.01, lambda_texture=0.001, lr=5e-5, betas=(0.5, 0.999),
                  checkpoint_dir="checkpoints", sample_batch=None, writer=None, device=None):
    """API-parity entry point (paper_gan.py:317); batches are NCHW pairs."""
    trainer = RCAGANTrainer(lambda_pixel=lambda_pixel, lambda_perceptual=lambda_perceptual,
                            lambda_texture=lambda_texture, lr=lr, betas=betas,
                            checkpoint_dir=checkpoint_dir, writer=writer, device=device,
                            disc_input_hw=_sample_side(sample_batch, val_loader))
    state = trainer.init(steps_per_epoch=len(train_loader))
    return trainer.fit(state, train_loader, val_loader, num_epochs)


def weights_init_normal(module: nn.Module, generator=None):
    """The hybrid's init (experimental_diffusion_gan.py:405-411), in place:
    4-D (conv) weights ~ N(0, 0.02); BatchNorm weight ~ N(1, 0.02), bias 0.
    Linear layers and conv biases keep theirs."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner = module.get_submodule(name.rpartition(".")[0])
            if isinstance(owner, nn.BatchNorm2d):
                if name.endswith("weight"):
                    p.copy_(1.0 + 0.02 * torch.randn(p.shape, generator=generator))
                else:
                    p.zero_()
            elif name.endswith("weight") and p.dim() == 4:
                p.copy_(0.02 * torch.randn(p.shape, generator=generator))
    return module


def rca_gan_diffusion_trainer(steps_per_epoch, disc_input_hw=256, num_timesteps=1000,
                              **trainer_kwargs):
    """The diffusion-GAN hybrid's trainer and state (experimental_diffusion_gan.py
    :390-414): GeneratorWithDiffusion(1, 1) against the RCA-GAN critic and
    losses, both nets re-initialized with ``weights_init_normal``."""
    from ..models.experimental import GeneratorWithDiffusion

    trainer = RCAGANTrainer(
        generator=GeneratorWithDiffusion(1, 1, num_timesteps=num_timesteps,
                                         generator=torch.Generator().manual_seed(0)),
        disc_input_hw=disc_input_hw, **trainer_kwargs)
    state = trainer.init(steps_per_epoch=steps_per_epoch)
    weights_init_normal(state.generator, torch.Generator().manual_seed(1))
    weights_init_normal(state.discriminator, torch.Generator().manual_seed(2))
    return trainer, state


def train_rca_gan_diffusion(train_loader, val_loader, num_epochs=200, lambda_pixel=1.0,
                            lambda_perceptual=0.01, lambda_texture=0.001, lr=5e-5,
                            betas=(0.5, 0.999), checkpoint_dir="checkpoints", sample_batch=None,
                            writer=None, num_timesteps=1000, device=None):
    """The diffusion-GAN hybrid's ``train_rca_gan`` (experimental_diffusion_gan.py
    :390-395), trained by ``rca_gan_diffusion_trainer``'s trainer."""
    trainer, state = rca_gan_diffusion_trainer(
        len(train_loader), _sample_side(sample_batch, val_loader), num_timesteps,
        lambda_pixel=lambda_pixel, lambda_perceptual=lambda_perceptual,
        lambda_texture=lambda_texture, lr=lr, betas=betas, checkpoint_dir=checkpoint_dir,
        writer=writer, device=device)
    return trainer.fit(state, train_loader, val_loader, num_epochs)
