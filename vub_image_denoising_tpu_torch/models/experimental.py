"""The experimental and legacy models: the DDPM machinery, the diffusion-GAN
hybrid's generator, and the legacy UNet_S.

Counterpart of ``vub_image_denoising_tpu/models/experimental.py``, in NCHW:

- ``GaussianDiffusion`` (experimental_diffusion_gan.py:12-55): linear betas
  1e-4 ... 0.02 over ``num_timesteps``, alpha cumprod (and its shift and the
  posterior variance), ``q_sample``, ``predict_start_from_noise``,
  ``p_losses``, ``get_noised_tensor``;
- ``SmallUNet`` (:56-87): Conv(in, 64) ReLU Conv(64, 128) ReLU | Conv(128,
  128) ReLU | Conv(128, 64) ReLU Conv(64, out); its ``t`` is unused, as in the
  reference;
- ``GeneratorWithDiffusion`` (:175-267): the RCA-GAN trunk behind a
  sequential multi-scale stem (1x1, 3x3, 5x5, 7x7 convs + ReLU), whose
  attention output goes through ``get_noised_tensor`` at a per-batch random
  timestep before the residual blocks.  The timesteps and the q_sample
  noise come from ``generator``, or are passed in (``t``, ``noise``);
- ``UNetS`` (legacy UNet_S_Checkpointed, diffusion_model.py:24-66): a
  3-scale t-conditioned U-Net (4 -> 32 -> 64 -> 128), ConvT(k2, s2) up,
  skip concatenations, conv + tanh to 3 channels; ``remat`` checkpoints each
  block (``torch.utils.checkpoint``), as the reference did.
"""

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.layers import Upsample2x2
from ..nn.torch_layers import TorchConv, max_pool_2x2
from .rca_gan import _trunk


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """DDPM schedule and losses (experimental_diffusion_gan.py:12-55); the
    schedule is f32, as the JAX package's."""

    beta_start: float = 1e-4
    beta_end: float = 0.02
    num_timesteps: int = 1000

    @property
    def betas(self):
        return torch.linspace(self.beta_start, self.beta_end, self.num_timesteps)

    @property
    def alpha_cumprod(self):
        return torch.cumprod(1.0 - self.betas, dim=0)

    @property
    def alpha_cumprod_prev(self):
        return torch.cat([torch.ones(1), self.alpha_cumprod[:-1]])

    @property
    def posterior_variance(self):
        return self.betas * (1.0 - self.alpha_cumprod_prev) / (1.0 - self.alpha_cumprod)

    def _coef(self, values, t, like):
        return values.to(like.device)[t.to(like.device)].reshape(-1, 1, 1, 1).to(like.dtype)

    def q_sample(self, x_start, t, noise):
        """sqrt(acp_t)*x0 + sqrt(1 - acp_t)*noise; ``t`` per image."""
        acp = self.alpha_cumprod
        return (self._coef(torch.sqrt(acp), t, x_start) * x_start
                + self._coef(torch.sqrt(1.0 - acp), t, x_start) * noise)

    def predict_start_from_noise(self, x_t, t, noise):
        acp = self.alpha_cumprod
        return ((x_t - self._coef(torch.sqrt(1.0 - acp), t, x_t) * noise)
                / self._coef(torch.sqrt(acp), t, x_t))

    def p_losses(self, model_apply, x_start, t, noise):
        return torch.mean((noise - model_apply(self.q_sample(x_start, t, noise), t)) ** 2)

    def get_noised_tensor(self, model_apply, x_start, t, noise):
        return model_apply(self.q_sample(x_start, t, noise), t)


class SmallUNet(nn.Module):
    """experimental_diffusion_gan.py:56-87."""

    def __init__(self, in_channels: int = 64, out_channels: int = 64, generator=None):
        super().__init__()
        self.encoder = nn.Sequential(
            TorchConv(in_channels, 64, 3, 1, 1, generator=generator), nn.ReLU(),
            TorchConv(64, 128, 3, 1, 1, generator=generator), nn.ReLU())
        self.middle = nn.Sequential(TorchConv(128, 128, 3, 1, 1, generator=generator),
                                    nn.ReLU())
        self.decoder = nn.Sequential(
            TorchConv(128, 64, 3, 1, 1, generator=generator), nn.ReLU(),
            TorchConv(64, out_channels, 3, 1, 1, generator=generator))

    def forward(self, x, t=None):
        return self.decoder(self.middle(self.encoder(x)))


class GeneratorWithDiffusion(nn.Module):
    """experimental_diffusion_gan.py:175-267."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 num_timesteps: int = 1000, generator=None):
        super().__init__()
        self.num_timesteps = num_timesteps
        self.feature_extraction = nn.Sequential(
            TorchConv(in_channels, 64, 1, 1, 0, generator=generator), nn.ReLU(),
            TorchConv(64, 64, 3, 1, 1, generator=generator), nn.ReLU(),
            TorchConv(64, 64, 5, 1, 2, generator=generator), nn.ReLU(),
            TorchConv(64, 64, 7, 1, 3, generator=generator), nn.ReLU())
        _trunk(self, in_channels, out_channels, generator)
        self.diffusion_model = GaussianDiffusion(num_timesteps=num_timesteps)
        self.unet = SmallUNet(64, 64, generator)

    def draw(self, n, shape, device, dtype, generator=None):
        """(t, noise): a timestep per image in [0, num_timesteps) and
        q_sample noise of the attention output's shape."""
        t = torch.randint(0, self.num_timesteps, (n,), generator=generator, device=device)
        return t, torch.randn(shape, generator=generator, device=device, dtype=dtype)

    def forward(self, x, t=None, noise=None, generator=None):
        feat = self.feature_extraction(x)
        d = feat
        for blk in self.denoising_blocks:
            d = blk(d)
        conv_out = self.one_conv_block(feat - d)
        att = self.cooperative_attention(conv_out)
        if t is None or noise is None:
            t, noise = self.draw(x.shape[0], att.shape, att.device, att.dtype, generator)
        r = self.diffusion_model.get_noised_tensor(self.unet, att, t, noise)
        for blk in self.residual_blocks:
            r = blk(r)
        out = r + conv_out
        for blk in self.deconv_blocks:
            out = blk(out)
        return torch.tanh(out + x)


def _conv_pair(cin, cout, generator):
    """Legacy UNet_S conv_block: Conv3x3 + ReLU, twice (diffusion_model.py:37-50)."""
    return nn.Sequential(TorchConv(cin, cout, 3, 1, 1, generator=generator), nn.ReLU(),
                         TorchConv(cout, cout, 3, 1, 1, generator=generator), nn.ReLU())


class UNetS(nn.Module):
    """Legacy UNet_S_Checkpointed (diffusion_model.py:24-66)."""

    def __init__(self, remat: bool = False, generator=None):
        super().__init__()
        self.remat = remat
        self.enc1 = _conv_pair(4, 32, generator)
        self.enc2 = _conv_pair(32, 64, generator)
        self.enc3 = _conv_pair(64, 128, generator)
        self.upconv3 = Upsample2x2(128, 64, generator)
        self.upconv2 = Upsample2x2(64, 32, generator)
        self.dec3 = _conv_pair(128, 64, generator)
        self.dec2 = _conv_pair(64, 32, generator)
        self.dec1 = nn.Sequential(TorchConv(32, 3, 3, 1, 1, generator=generator), nn.Tanh())

    def _run(self, block, x):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, use_reentrant=False)
        return block(x)

    def forward(self, x, t):
        n, _, h, w = x.shape
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1, 1, 1, 1)
        x = torch.cat([x, t.expand(n, 1, h, w)], 1)
        enc1 = self._run(self.enc1, x)
        enc2 = self._run(self.enc2, max_pool_2x2(enc1))
        enc3 = self._run(self.enc3, max_pool_2x2(enc2))
        dec3 = self._run(self.dec3, torch.cat([self.upconv3(enc3), enc2], 1))
        dec2 = self._run(self.dec2, torch.cat([self.upconv2(dec3), enc1], 1))
        return self._run(self.dec1, dec2)
