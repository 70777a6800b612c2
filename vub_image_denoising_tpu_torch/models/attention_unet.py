"""Attention U-Net generator and spectral-norm PatchGAN discriminator.

Counterpart of ``vub_image_denoising_tpu/models/attention_unet.py``
(recovered from train_denoising_gan.pyc; line numbers are the original
train_denoising_gan.py's), in NCHW with the reference's key names.

AttentionUNet (:37-89), grayscale 1 -> 1: encoders ConvPair(1 -> 64, 128,
256, 512) with MaxPool2d(2) between; ConvTranspose2d(k2, s2) up-convs; at
each scale the skip is gated by AttentionBlock(in, gating, inter) = (256,
256, 128), (128, 128, 64), (64, 64, 32) and concatenated after the up-conv's
output; dec1 = Conv3x3 + tanh.  AttentionBlock (:11-35): psi =
sigmoid(BN(1x1(relu(BN(1x1(g)) + BN(1x1(x)))))), returns x * psi.

PatchGAN (:91-112), 2 input channels (noisy, image): SN-Conv(-> 64, k4 s2
p1) LReLU, SN-Conv(-> 128, k4 s2 p1) BN LReLU, SN-Conv(-> 256, k4 s2 p1) BN
LReLU, SN-Conv(-> 512, k4 s1 p1) BN LReLU, Conv(-> 1, k4 s1 p1) sigmoid.

Spectral norm is ``SpectralNormConv``, which follows flax's
``nn.SpectralNorm`` (the JAX package's) step for step, not
``torch.nn.utils.parametrizations.spectral_norm``: one power-iteration step
from the stored u on the weight as an (kh*kw*cin) x cout matrix,
l2-normalization x * rsqrt(sum(x^2) + 1e-12), sigma = v W u^T, W / sigma; u is
a buffer (``weight_u``, shape (cout,)), updated only by a training forward.

Init (weights_init_normal, :146-153): conv weights N(0, 0.02) (biases keep
the torch default); BatchNorm weight 1, bias 0 as constructed.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.torch_layers import TorchBatchNorm, TorchConv, max_pool_2x2
from ..nn.init import torch_conv_bias


class ConvN002(TorchConv):
    """``TorchConv`` with N(0, 0.02) weights (train_denoising_gan.py:146-149)."""

    def reset_parameters(self):
        super().reset_parameters()
        with torch.no_grad():
            self.weight.copy_(0.02 * torch.randn(self.weight.shape,
                                                 generator=self._init_generator))


def _l2_normalize(x, eps=1e-12):
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNormConv(ConvN002):
    """A ``ConvN002`` whose weight is divided by its largest singular value,
    estimated as flax's ``nn.SpectralNorm`` does (one power-iteration step
    per forward from the stored ``weight_u``)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride, padding, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         generator=generator)
        self.register_buffer("weight_u", torch.randn(out_channels, generator=generator))

    def normalized_weight(self):
        """The weight over sigma; a training forward stores the new u."""
        cout = self.weight.shape[0]
        # flax's (kh*kw*cin, cout) matrix is W.T up to a permutation of its rows,
        # which leaves u, sigma and the normalized weight unchanged
        w = self.weight.reshape(cout, -1)
        with torch.no_grad():
            v = _l2_normalize(self.weight_u.to(w.dtype) @ w)
            u = _l2_normalize(w @ v)
        sigma = u @ (w @ v)
        if self.training:
            with torch.no_grad():
                self.weight_u.copy_(u)
        return self.weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x):
        return F.conv2d(x, self.normalized_weight().to(x.dtype), self.bias.to(x.dtype),
                        self.stride, self.padding)


def _conv_pair(cin, cout, generator):
    """conv_block: Conv3x3 + ReLU, twice (train_denoising_gan.py:62-69)."""
    return nn.Sequential(ConvN002(cin, cout, 3, 1, 1, generator=generator), nn.ReLU(),
                         ConvN002(cout, cout, 3, 1, 1, generator=generator), nn.ReLU())


class AttentionBlock(nn.Module):
    """Additive attention gate (train_denoising_gan.py:11-35)."""

    def __init__(self, in_channels, gating_channels, inter_channels, generator=None):
        super().__init__()
        self.W_g = nn.Sequential(ConvN002(gating_channels, inter_channels, 1, 1, 0,
                                          generator=generator), TorchBatchNorm(inter_channels))
        self.W_x = nn.Sequential(ConvN002(in_channels, inter_channels, 1, 1, 0,
                                          generator=generator), TorchBatchNorm(inter_channels))
        self.psi = nn.Sequential(ConvN002(inter_channels, 1, 1, 1, 0, generator=generator),
                                 TorchBatchNorm(1), nn.Sigmoid())

    def forward(self, x, g):
        return x * self.psi(F.relu(self.W_g(g) + self.W_x(x)))


class UpconvN002(nn.Module):
    """ConvTranspose2d(cin, cout, k2, s2) with N(0, 0.02) weights
    (train_denoising_gan.py:70-72, 146); weight (Cin, Cout, 2, 2)."""

    def __init__(self, in_channels, out_channels, generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            0.02 * torch.randn((in_channels, out_channels, 2, 2), generator=generator))
        self.bias = nn.Parameter(torch_conv_bias(out_channels * 4, (out_channels,), generator))

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), stride=2)


class AttentionUNet(nn.Module):
    """Generator (train_denoising_gan.py:37-89)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, generator=None):
        super().__init__()
        self.enc1 = _conv_pair(in_channels, 64, generator)
        self.enc2 = _conv_pair(64, 128, generator)
        self.enc3 = _conv_pair(128, 256, generator)
        self.enc4 = _conv_pair(256, 512, generator)
        self.upconv4 = UpconvN002(512, 256, generator)
        self.upconv3 = UpconvN002(256, 128, generator)
        self.upconv2 = UpconvN002(128, 64, generator)
        self.dec4 = _conv_pair(512, 256, generator)
        self.dec3 = _conv_pair(256, 128, generator)
        self.dec2 = _conv_pair(128, 64, generator)
        self.dec1 = nn.Sequential(ConvN002(64, out_channels, 3, 1, 1, generator=generator),
                                  nn.Tanh())
        self.att4 = AttentionBlock(256, 256, 128, generator)
        self.att3 = AttentionBlock(128, 128, 64, generator)
        self.att2 = AttentionBlock(64, 64, 32, generator)

    def forward(self, x):
        enc1 = self.enc1(x)
        enc2 = self.enc2(max_pool_2x2(enc1))
        enc3 = self.enc3(max_pool_2x2(enc2))
        enc4 = self.enc4(max_pool_2x2(enc3))
        up4 = self.upconv4(enc4)
        dec4 = self.dec4(torch.cat([up4, self.att4(enc3, up4)], 1))
        up3 = self.upconv3(dec4)
        dec3 = self.dec3(torch.cat([up3, self.att3(enc2, up3)], 1))
        up2 = self.upconv2(dec3)
        dec2 = self.dec2(torch.cat([up2, self.att2(enc1, up2)], 1))
        return self.dec1(dec2)


class PatchGAN(nn.Module):
    """Spectral-norm PatchGAN (train_denoising_gan.py:91-112)."""

    def __init__(self, in_channels: int = 2, generator=None):
        super().__init__()
        g = generator
        self.model = nn.Sequential(
            SpectralNormConv(in_channels, 64, 4, 2, 1, g), nn.LeakyReLU(0.2),
            SpectralNormConv(64, 128, 4, 2, 1, g), TorchBatchNorm(128), nn.LeakyReLU(0.2),
            SpectralNormConv(128, 256, 4, 2, 1, g), TorchBatchNorm(256), nn.LeakyReLU(0.2),
            SpectralNormConv(256, 512, 4, 1, 1, g), TorchBatchNorm(512), nn.LeakyReLU(0.2),
            ConvN002(512, 1, 4, 1, 1, generator=g), nn.Sigmoid())

    def forward(self, x):
        return self.model(x)
