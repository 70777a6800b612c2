"""Interpolation-style diffusion for image denoising.

Counterpart of ``vub_image_denoising_tpu/diffusion/interpolation.py``
(reference ``DiffusionModel``, diffusion_denoising/diffusion_RDUnet.py:27-55).
Not a DDPM noise process: the forward process interpolates clean -> noisy
with alpha = t/T, and the reverse sampler runs T steps, each with two U-Net
predictions (at t and t-1, both on the current x_t) and the update
``x_t <- x_t - x_tilde_t + x_tilde_{t-1}``.

As in the JAX package, each step makes ONE U-Net call on the 2N stack
[x_t; x_t] with timesteps [t/T; (t-1)/T], which doubles the batch each
kernel sees; a plain Python loop over t = T..1 takes the place of
``lax.scan``.  ``unet_apply(x, t)`` is any callable on (N, C, H, W) tensors,
with ``t`` an (N,) vector of normalized timesteps.
"""

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class InterpolationDiffusion:
    """The reference DiffusionModel (timesteps default 20)."""

    timesteps: int = 20

    def _schedule(self):
        """(alpha_t, alpha_{t-1}) for t = T..1, each an f32 scalar: the schedule
        is computed in f32 whatever the activation dtype (bf16 cannot hold
        integers above 256, and rounds t/T by ~0.4% even at T = 20).  They are
        returned as Python floats, which hold the f32 values exactly."""
        for t in np.arange(self.timesteps, 0, -1, dtype=np.float32):
            yield (float(t / np.float32(self.timesteps)),
                   float((t - 1) / np.float32(self.timesteps)))

    def forward_diffusion(self, clean, noisy, t):
        """alpha*noisy + (1-alpha)*clean with alpha = t/T.

        ``t`` may be a scalar or a per-image (N,) vector of *unnormalized*
        timesteps in [0, T]."""
        alpha = torch.as_tensor(t, dtype=clean.dtype, device=clean.device) / self.timesteps
        if alpha.dim() == 1:
            alpha = alpha.reshape(-1, 1, 1, 1)
        return alpha * noisy + (1 - alpha) * clean

    def improved_sampling(self, unet_apply, noisy):
        """The T-step reverse sampler, one U-Net call per step on the 2N stack.

        The sampler state x_t and the update stay f32; only the U-Net's inputs
        (the stacked x_t and the 2N timesteps) are cast to ``noisy``'s dtype,
        and the result is cast back to it."""
        n = noisy.shape[0]
        in_dtype = noisy.dtype
        noisy32 = noisy.float()
        schedule = list(self._schedule())
        # (T, 2N): alpha_t n times, then alpha_{t-1} n times; built with torch
        # ops so that a symbolic batch (torch.export) stays symbolic
        t2_all = torch.tensor(schedule, dtype=torch.float32, device=noisy.device)[:, :, None]
        t2_all = t2_all.expand(-1, -1, n).reshape(len(schedule), 2 * n).to(in_dtype)
        x_t = noisy32
        for (alpha_t, alpha_prev), t2 in zip(schedule, t2_all):
            xin = x_t.to(in_dtype)
            pred2 = unet_apply(torch.cat([xin, xin]), t2).float()
            pred_t, pred_prev = pred2[:n], pred2[n:]
            x_tilde = (1 - alpha_t) * pred_t + alpha_t * noisy32
            x_tilde_prev = (1 - alpha_prev) * pred_prev + alpha_prev * noisy32
            x_t = x_t - x_tilde + x_tilde_prev
        return x_t.to(in_dtype)

    def improved_sampling_sequential(self, unet_apply, noisy):
        """The literal two-calls-per-step sampler (for parity checks against the
        batched one)."""
        n = noisy.shape[0]
        in_dtype = noisy.dtype
        noisy32 = noisy.float()
        x_t = noisy32
        for alpha_t, alpha_prev in self._schedule():
            xin = x_t.to(in_dtype)
            pred_t = unet_apply(xin, self._full(n, alpha_t, noisy)).float()
            x_tilde = (1 - alpha_t) * pred_t + alpha_t * noisy32
            pred_prev = unet_apply(xin, self._full(n, alpha_prev, noisy)).float()
            x_tilde_prev = (1 - alpha_prev) * pred_prev + alpha_prev * noisy32
            x_t = x_t - x_tilde + x_tilde_prev
        return x_t.to(in_dtype)

    def forward(self, unet_apply, clean, noisy, t):
        """Forward-diffuse, then sample the whole way back.

        As in the reference, the interpolated image is both the sampler's
        starting point x_T and its per-step anchor (the ``noisy`` of
        ``improved_sampling``)."""
        return self.improved_sampling(unet_apply, self.forward_diffusion(clean, noisy, t))

    def direct_sampling(self, unet_apply, noisy):
        """One U-Net call at t = 1.0 (the reference's direct-sampling ablation)."""
        return unet_apply(noisy, self._full(noisy.shape[0], 1.0, noisy))

    @staticmethod
    def _full(n, value, like):
        return torch.full((n,), value, dtype=like.dtype, device=like.device)
