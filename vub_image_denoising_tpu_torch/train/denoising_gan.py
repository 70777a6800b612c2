"""Attention-U-Net / PatchGAN denoising-GAN trainer on the card.

Counterpart of ``vub_image_denoising_tpu/train/denoising_gan.py``
(``train_denoising_gan``, train_denoising_gan.py:173-294), on one device or
data parallel over ranks (``train.gan.GANDataParallel``):

- G = AttentionUNet(1, 1), D = PatchGAN(2) on cat(noisy, image), NCHW.
- Label smoothing: 0.9 / 0.1 for D, 1.0 for G.
- D loss = 0.5*(BCE(D(cat(noisy, clean)), 0.9) + BCE(D(cat(noisy, G(noisy))),
  0.1)) + lambda_gp * GP, the penalty on the gradient with respect to the
  whole concatenated input at an interpolation of clean and generated
  (compute_gradient_penalty, :128-144).
- G loss = BCE(D(cat(noisy, gen)), 1.0) + lambda_pixel*L1(gen, clean)
  + lambda_perceptual*L1(VGG19[:16](gen), VGG19[:16](clean))
  + lambda_edge*L1(Sobel(gen), Sobel(clean)) (edge_loss, :159-171).
- Adam(1e-4, (0.5, 0.999)) on both, no clip; StepLR(10, 0.5).
- ``{prefix}_generator_{epoch}.pth`` / ``{prefix}_discriminator_{epoch}.pth``,
  bare state_dicts.

BatchNorm statistics and spectral-norm u move as in the JAX package (see
``train/gan.py``): D(real) then D(fake) in the D step keep their updates;
the penalty's D and the G step's D run on a copy of D's buffers as they
stood when the step began.
"""

import dataclasses
import os
import time
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..data.device import fold_generator
from ..models.attention_unet import AttentionUNet, PatchGAN
from ..models.vgg import VGG19Features, load_torch_vgg19
from ..utils.checkpoint import _atomic_torch_save
from ..utils.device import resolve_device
from .gan import (GANTrainState, adam_with_step_lr, apply_update, frozen_apply,
                  make_data_parallel, state_dict_cpu)
from .gan_losses import draw_eps, input_gradient_norms

SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def sobel_edges(x):
    """sqrt(Gx^2 + Gy^2 + 1e-6) of a one-channel NCHW image, zero padding 1."""
    kx = torch.tensor(SOBEL_X, dtype=x.dtype, device=x.device).view(1, 1, 3, 3)
    ky = torch.tensor(SOBEL_Y, dtype=x.dtype, device=x.device).view(1, 1, 3, 3)
    return torch.sqrt(F.conv2d(x, kx, padding=1) ** 2 + F.conv2d(x, ky, padding=1) ** 2 + 1e-6)


def edge_loss(gen, clean):
    return torch.mean(torch.abs(sobel_edges(gen) - sobel_edges(clean)))


def bce(pred, target):
    """torch BCELoss on sigmoid outputs, clamped to [1e-7, 1 - 1e-7]."""
    pred = pred.clamp(1e-7, 1 - 1e-7)
    return -torch.mean(target * torch.log(pred) + (1 - target) * torch.log(1 - pred))


def conditional_gradient_penalty(d_apply, noisy, real, fake, alpha=None, generator=None,
                                 create_graph=True):
    """compute_gradient_penalty (train_denoising_gan.py:128-144): interpolate
    real and fake, put the noisy conditioning in front, and penalize the
    gradient with respect to the whole concatenated input."""
    alpha = draw_eps(real, generator) if alpha is None else alpha
    full = torch.cat([noisy, alpha * real + (1 - alpha) * fake], 1)
    norms = input_gradient_norms(d_apply, full, create_graph)
    return torch.mean((norms - 1.0) ** 2)


@dataclasses.dataclass
class DenoisingGANTrainer:
    lambda_pixel: float = 100.0
    lambda_perceptual: float = 0.1
    lambda_edge: float = 1.0
    lambda_gp: float = 10.0
    lr: float = 1e-4
    betas: tuple = (0.5, 0.999)
    checkpoint_dir: str = "checkpoints"
    checkpoint_prefix: str = "denoising_gan"
    vgg_weights_path: Optional[str] = None
    writer: Any = None
    device: Any = None
    seed: int = 0
    mesh: Any = None  # parallel.mesh.Mesh: data parallel over its "data" axis

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def init(self, steps_per_epoch: int) -> GANTrainState:
        init_gen = torch.Generator().manual_seed(self.seed)
        g = AttentionUNet(1, 1, generator=init_gen).to(self.device).train()
        d = PatchGAN(2, generator=init_gen).to(self.device).train()
        self.dp = make_data_parallel(self, g, d)
        vgg = VGG19Features(num_layers=16, generator=init_gen)
        load_torch_vgg19(vgg, self.vgg_weights_path)
        self.vgg = vgg.to(self.device).eval().requires_grad_(False)
        g_opt, g_sched = adam_with_step_lr(g.parameters(), self.lr, self.betas, steps_per_epoch)
        d_opt, d_sched = adam_with_step_lr(d.parameters(), self.lr, self.betas, steps_per_epoch)
        self._draws = torch.Generator(device=self.device).manual_seed(self.seed)
        return GANTrainState(g, d, g_opt, d_opt, g_sched, d_sched)

    def d_step(self, state, noisy, clean, generator=None, alpha=None):
        g, d = state.generator, state.discriminator
        with torch.no_grad():
            fake = g(noisy)
        frozen = frozen_apply(d)
        pred_real = d(torch.cat([noisy, clean], 1))
        pred_fake = d(torch.cat([noisy, fake], 1))
        gen = generator or self._draws
        if alpha is None and self.dp.n > 1:
            alpha = self.dp.rows(lambda n: draw_eps(clean.new_empty((n,) + tuple(clean.shape[1:])),
                                                    gen), clean.shape[0])
        gp = conditional_gradient_penalty(frozen, noisy, clean, fake, alpha, gen)
        loss = 0.5 * (bce(pred_real, 0.9) + bce(pred_fake, 0.1)) + self.lambda_gp * gp
        apply_update(loss, list(d.parameters()), state.d_opt, state.d_sched,
                     reduce=self.dp.reduce)
        return self.dp.mean(loss.detach())

    def g_step(self, state, noisy, clean):
        fake = state.generator(noisy)
        pred_fake = frozen_apply(state.discriminator)(torch.cat([noisy, fake], 1))
        parts = {"gan": bce(pred_fake, 1.0), "pixel": torch.mean(torch.abs(fake - clean)),
                 "perceptual": torch.mean(torch.abs(self.vgg(fake) - self.vgg(clean))),
                 "edge": edge_loss(fake, clean)}
        total = (parts["gan"] + self.lambda_pixel * parts["pixel"]
                 + self.lambda_perceptual * parts["perceptual"] + self.lambda_edge * parts["edge"])
        apply_update(total, list(state.generator.parameters()), state.g_opt, state.g_sched,
                     reduce=self.dp.reduce)
        state.step += 1
        return self.dp.mean(total.detach()), {k: self.dp.mean(v.detach())
                                              for k, v in parts.items()}

    def generate(self, state, x):
        g = state.generator
        g.eval()
        try:
            with torch.no_grad():
                return g(x)
        finally:
            g.train()

    def train_epoch(self, state, train_loader, epoch: int):
        d_losses, g_losses = [], []
        for batch_idx, batch in enumerate(train_loader):
            noisy, clean = (torch.as_tensor(b).to(self.device, torch.float32) for b in batch)
            d_losses.append(self.d_step(state, noisy, clean,
                                        fold_generator(self.device, self.seed, epoch, batch_idx)))
            g_loss, _ = self.g_step(state, noisy, clean)
            g_losses.append(g_loss)
            if self.writer is not None:
                step = epoch * len(train_loader) + batch_idx
                self.writer.add_scalar("Loss/D", float(d_losses[-1]), step)
                self.writer.add_scalar("Loss/G", float(g_loss), step)
        return (state, torch.stack(d_losses).mean().item(), torch.stack(g_losses).mean().item())

    def save_checkpoint(self, state, epoch: int):
        """Separate generator and discriminator files (bare state_dicts)."""
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        paths = []
        for part, module in (("generator", state.generator),
                             ("discriminator", state.discriminator)):
            path = os.path.join(self.checkpoint_dir,
                                f"{self.checkpoint_prefix}_{part}_{epoch}.pth")
            _atomic_torch_save(state_dict_cpu(module), path)
            paths.append(path)
        return tuple(paths)

    def fit(self, state, train_loader, val_loader, num_epochs: int, checkpoint_every: int = 10):
        from ..utils.preempt import GracefulShutdown

        history = []
        with GracefulShutdown() as stop:
            for epoch in range(num_epochs):
                t0 = time.time()
                state, d_loss, g_loss = self.train_epoch(state, train_loader, epoch)
                if stop.requested or (epoch + 1) % checkpoint_every == 0:
                    self.save_checkpoint(state, epoch + 1)
                history.append({"epoch": epoch, "d_loss": d_loss, "g_loss": g_loss,
                                "sec": time.time() - t0})
                if stop.requested:
                    print(f"[preempt] checkpointed through epoch {epoch + 1}; stopping")
                    break
        return state, history


def train_denoising_gan(train_loader, val_loader, num_epochs=200, lambda_pixel=100.0,
                        lambda_perceptual=0.1, lambda_edge=1.0, lambda_gp=10.0, lr=1e-4,
                        betas=(0.5, 0.999), log_dir="runs/denoising_gan",
                        checkpoint_dir="checkpoints", checkpoint_prefix="denoising_gan",
                        sample_batch=None, writer=None, device=None):
    """API-parity entry point (train_denoising_gan.py:173-175); ``log_dir`` and
    ``sample_batch`` are accepted for the reference's signature."""
    trainer = DenoisingGANTrainer(
        lambda_pixel=lambda_pixel, lambda_perceptual=lambda_perceptual,
        lambda_edge=lambda_edge, lambda_gp=lambda_gp, lr=lr, betas=betas,
        checkpoint_dir=checkpoint_dir, checkpoint_prefix=checkpoint_prefix, writer=writer,
        device=device)
    state = trainer.init(steps_per_epoch=len(train_loader))
    return trainer.fit(state, train_loader, val_loader, num_epochs)
