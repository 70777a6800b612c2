"""RCA-GAN: the reference's "paper GAN" (residual cooperative-attention GAN).

Counterpart of ``vub_image_denoising_tpu/models/rca_gan.py`` (recovered from
paper_gan.pyc; line numbers are the original paper_gan.py's), in NCHW, with
the reference's module and ``.pth`` key names.

Generator (:114-172), grayscale 1 -> 1: MultiScaleConv stem -> 8 ConvBlocks
whose output is SUBTRACTED from the stem's (noise estimation, :150-153) ->
one ConvBlock -> CooperativeAttention -> 9 ResidualBlocks + a skip from the
pre-attention conv output -> 4 DeconvBlock(64, k3) + DeconvBlock(out, k1)
-> + input -> tanh.

Quirks kept as the reference has them:
- ChannelAttention (:9-25) attends with BatchNorm statistics: scalar gamma
  and beta (init 0), mean and UNBIASED variance (``torch.var``) over
  (N, H, W) of the BN output;
- ResidualBlock (:60-78): relu(conv2(bn2(relu(bn1(conv1(x))))) + x), bn2
  BEFORE conv2;
- DeconvBlock (:80-88): stride-1 transpose convs.

Discriminator (:175-200): 6 ConvBlocks (-> 64 s1, 64 s2, 128 s1, 128 s2,
256 s1, 256 s2) -> flatten -> Linear((side/8)^2 * 256, 1024) -> ReLU ->
Linear(1024, 1).  flax sizes fc1 from its first input; here the input side
is a constructor argument (262,144 inputs at 256^2).  ``norm`` is the
critic-normalization ablation: "bn" (the reference), "none", or "layernorm"
(flax's ``nn.LayerNorm()`` over each pixel's channels, eps 1e-6).

Every module takes ``generator`` for its init draws.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.torch_layers import (
    ChannelLayerNorm,
    TorchBatchNorm,
    TorchConv,
    TorchConvTranspose,
    TorchLinear,
    leaky_relu,
)


class ChannelAttention(nn.Module):
    """Its mean and variance run over the batch: over the data axis's ranks
    when ``batch_group`` is set (``parallel.mesh.sync_batchnorm_``)."""

    batch_group = None

    def __init__(self, in_channels: int):
        super().__init__()
        self.bn = TorchBatchNorm(in_channels)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.beta = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        from ..parallel.mesh import batch_moments

        bn_out = self.bn(x)
        mu, var = batch_moments(bn_out, self.batch_group)
        weights = self.gamma.to(x.dtype) / torch.sqrt(var + 1e-5)
        normalized = (bn_out - mu) / torch.sqrt(var + 1e-5)
        return torch.sigmoid(weights * normalized + self.beta.to(x.dtype)) * x


class SpatialAttention(nn.Module):
    def __init__(self, in_channels: int, generator=None):
        super().__init__()
        self.conv1 = TorchConv(2, 1, 7, 1, 3, generator=generator)

    def forward(self, x):
        combined = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return torch.sigmoid(self.conv1(combined)) * x


class CooperativeAttention(nn.Module):
    def __init__(self, in_channels: int, generator=None):
        super().__init__()
        self.channel_attention = ChannelAttention(in_channels)
        self.spatial_attention = SpatialAttention(in_channels, generator)

    def forward(self, x):
        return self.spatial_attention(self.channel_attention(x))


class ConvBlock(nn.Module):
    """lrelu0.2(norm(conv(k, s, p))) (paper_gan.py:50-58); ``norm`` "bn" (the
    reference), "none" or "layernorm"."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, padding=1,
                 norm="bn", generator=None):
        super().__init__()
        if norm not in ("bn", "none", "layernorm"):
            raise ValueError(f"unknown norm {norm!r}")
        self.norm = norm
        self.conv = TorchConv(in_channels, out_channels, kernel_size, stride, padding,
                              generator=generator)
        if norm == "bn":
            self.bn = TorchBatchNorm(out_channels)
        elif norm == "layernorm":
            self.ln = ChannelLayerNorm(out_channels)

    def forward(self, x):
        h = self.conv(x)
        if self.norm == "bn":
            h = self.bn(h)
        elif self.norm == "layernorm":
            h = self.ln(h)
        return leaky_relu(h, 0.2)


class ResidualBlock(nn.Module):
    def __init__(self, in_channels: int, generator=None):
        super().__init__()
        self.conv1 = TorchConv(in_channels, in_channels, 3, 1, 1, generator=generator)
        self.bn1 = TorchBatchNorm(in_channels)
        self.bn2 = TorchBatchNorm(in_channels)
        self.conv2 = TorchConv(in_channels, in_channels, 3, 1, 1, generator=generator)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.conv2(self.bn2(out))  # reference quirk: bn2 before conv2
        return F.relu(out + x)


class DeconvBlock(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, padding=1,
                 generator=None):
        super().__init__()
        if stride != 1:
            raise ValueError("the reference uses stride-1 deconvs only")
        self.conv_t = TorchConvTranspose(in_channels, out_channels, kernel_size, padding,
                                         generator=generator)
        self.bn = TorchBatchNorm(out_channels)

    def forward(self, x):
        return leaky_relu(self.bn(self.conv_t(x)), 0.2)


class MultiScaleConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, generator=None):
        super().__init__()
        mid = out_channels // 4
        self.conv1x1 = TorchConv(in_channels, mid, 1, 1, 0, generator=generator)
        self.conv3x3 = TorchConv(in_channels, mid, 3, 1, 1, generator=generator)
        self.conv5x5 = TorchConv(in_channels, mid, 5, 1, 2, generator=generator)
        self.conv7x7 = TorchConv(in_channels, mid, 7, 1, 3, generator=generator)
        self.final_conv = TorchConv(4 * mid, out_channels, 1, 1, 0, generator=generator)
        self.bn1x1 = TorchBatchNorm(mid)
        self.bn3x3 = TorchBatchNorm(mid)
        self.bn5x5 = TorchBatchNorm(mid)
        self.bn7x7 = TorchBatchNorm(mid)
        self.bn_final = TorchBatchNorm(out_channels)

    def forward(self, x):
        out = torch.cat([self.bn1x1(self.conv1x1(x)), self.bn3x3(self.conv3x3(x)),
                         self.bn5x5(self.conv5x5(x)), self.bn7x7(self.conv7x7(x))], 1)
        return self.bn_final(self.final_conv(out))


def _trunk(module, in_channels, out_channels, generator):
    """The layers the RCA-GAN generator and the diffusion hybrid share."""
    module.denoising_blocks = nn.ModuleList(
        [ConvBlock(64, 64, generator=generator) for _ in range(8)])
    module.one_conv_block = ConvBlock(64, 64, generator=generator)
    module.cooperative_attention = CooperativeAttention(64, generator)
    module.residual_blocks = nn.ModuleList(
        [ResidualBlock(64, generator) for _ in range(9)])
    module.deconv_blocks = nn.ModuleList(
        [DeconvBlock(64, 64, 3, 1, 1, generator=generator) for _ in range(4)]
        + [DeconvBlock(64, out_channels, 1, 1, 0, generator=generator)])


class Generator(nn.Module):
    """RCA-GAN generator (paper_gan.py:114-172)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, generator=None):
        super().__init__()
        self.initial_conv = MultiScaleConv(in_channels, 64, generator)
        _trunk(self, in_channels, out_channels, generator)

    def forward(self, x):
        initial = self.initial_conv(x)
        d = initial
        for blk in self.denoising_blocks:
            d = blk(d)
        conv_out = self.one_conv_block(initial - d)  # noise estimation (:150-153)
        r = self.cooperative_attention(conv_out)
        for blk in self.residual_blocks:
            r = blk(r)
        out = r + conv_out  # skip from the pre-attention conv output
        for blk in self.deconv_blocks:
            out = blk(out)
        return torch.tanh(out + x)


def discriminator_side(side: int) -> int:
    """The side after the critic's three stride-2 3x3 convs (padding 1)."""
    for _ in range(3):
        side = (side - 1) // 2 + 1
    return side


class Discriminator(nn.Module):
    """WGAN critic (paper_gan.py:175-200) for ``input_hw`` x ``input_hw`` inputs."""

    def __init__(self, in_channels: int = 1, norm: str = "bn", input_hw: int = 256,
                 generator=None):
        super().__init__()
        specs = [(64, 1), (64, 2), (128, 1), (128, 2), (256, 1), (256, 2)]
        cins = [in_channels] + [c for c, _ in specs[:-1]]
        self.conv_layers = nn.ModuleList(
            [ConvBlock(cin, c, 3, s, 1, norm=norm, generator=generator)
             for cin, (c, s) in zip(cins, specs)])
        self.fc_layers = nn.Sequential(
            TorchLinear(discriminator_side(input_hw) ** 2 * 256, 1024, generator),
            nn.ReLU(),
            TorchLinear(1024, 1, generator))

    def forward(self, x):
        for blk in self.conv_layers:
            x = blk(x)
        # the reference flattens NCHW (C, H, W); the JAX package's fc1 rows
        # follow its NHWC flatten, which params_to_state_dict does not reorder
        return self.fc_layers(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False,
                        nchw_flatten: bool = False):
        """``nn.Module.load_state_dict``; with ``nchw_flatten=True`` the file
        is the original PyTorch reference's critic, whose fc1 takes the
        features flattened NCHW: its input columns are permuted to this
        module's NHWC flatten (``fc1_nchw_to_nhwc``), so the critic computes
        the reference's function.  The default load takes the file as it is
        (the port's and the JAX package's NHWC order)."""
        if nchw_flatten:
            state_dict = fc1_nchw_to_nhwc(state_dict)
        return super().load_state_dict(state_dict, strict=strict, assign=assign)


def fc1_nchw_to_nhwc(state_dict, key: str = "fc_layers.0.weight", channels: int = 256):
    """A critic state_dict whose fc1 (``key``, (out, C*S*S)) reads NCHW-flat
    features, with its input columns reordered to read NHWC-flat ones:
    column (h*S + w)*C + c of the result is column c*S*S + h*S + w of the
    file's."""
    sd = dict(state_dict)
    w = sd[key]
    side = int(round((w.shape[1] // channels) ** 0.5))
    if channels * side * side != w.shape[1]:
        raise ValueError(f"{key} has {w.shape[1]} inputs, not {channels} x S x S")
    sd[key] = w.reshape(w.shape[0], channels, side, side).permute(0, 2, 3, 1).reshape(
        w.shape[0], -1).contiguous()
    return sd
