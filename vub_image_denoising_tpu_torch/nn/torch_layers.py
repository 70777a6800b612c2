"""The GAN family's layers: PyTorch's own, with the reference's init.

Counterpart of ``vub_image_denoising_tpu/nn/torch_layers.py``, which rebuilds
these torch layers in flax.  Here they are ``nn.Conv2d``,
``nn.ConvTranspose2d``, ``nn.Linear`` and ``nn.BatchNorm2d`` themselves,
initialized as the reference's ``weights_init`` (paper_gan.py:333):
kaiming_normal_(a=0, fan_in, leaky_relu) on conv and linear weights, the
torch default U(+-1/sqrt(fan_in)) on their biases, BatchNorm weight 1 and bias
0.  Every draw takes an explicit ``torch.Generator`` (``None``: torch's
global one).  Layouts are torch's (NCHW, OIHW); the JAX package's params
carry across with ``utils.checkpoint.params_to_state_dict``.

``BatchNorm2d`` (eps 1e-5, momentum 0.1) normalizes with the biased batch
variance and accumulates the unbiased one into ``running_var``, which is what
the JAX package's ``_TorchBNCore`` reproduces.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .init import torch_conv_bias


def kaiming_normal_conv(shape, generator=None):
    """kaiming_normal_(a=0, mode='fan_in') on an OIHW weight: std = sqrt(2/fan_in)."""
    cout, cin, kh, kw = shape
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / (cin * kh * kw))


def kaiming_normal_dense(shape, generator=None):
    """kaiming_normal_ on a linear weight (out, in): std = sqrt(2/in)."""
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / shape[1])


class TorchConv(nn.Conv2d):
    """``nn.Conv2d(cin, cout, k, s, p)`` with kaiming-normal weights; computes
    in the input's dtype."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, padding=0,
                 bias=True, generator=None):
        self._init_generator = generator
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, bias=bias)

    def reset_parameters(self):
        with torch.no_grad():
            self.weight.copy_(kaiming_normal_conv(self.weight.shape, self._init_generator))
            if self.bias is not None:
                fan_in = self.weight[0].numel()
                self.bias.copy_(torch_conv_bias(fan_in, self.bias.shape, self._init_generator))

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding)


class TorchConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d(cin, cout, k, stride=1, padding=p)``; weight
    (Cin, Cout, kh, kw) ~ N(0, 2 / (Cout*kh*kw)) (weights_init's fan_in of a
    transpose weight), bias U(+-1/sqrt(Cout*kh*kw))."""

    def __init__(self, in_channels, out_channels, kernel_size=3, padding=1, generator=None):
        self._init_generator = generator
        super().__init__(in_channels, out_channels, kernel_size, 1, padding)

    def reset_parameters(self):
        with torch.no_grad():
            _, cout, kh, kw = self.weight.shape
            fan_in = cout * kh * kw
            self.weight.copy_(torch.randn(self.weight.shape, generator=self._init_generator)
                              * math.sqrt(2.0 / fan_in))
            self.bias.copy_(torch_conv_bias(fan_in, self.bias.shape, self._init_generator))

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                                  padding=self.padding)


class TorchLinear(nn.Linear):
    """``nn.Linear(cin, cout)`` with kaiming-normal weights."""

    def __init__(self, in_features, out_features, generator=None):
        self._init_generator = generator
        super().__init__(in_features, out_features)

    def reset_parameters(self):
        with torch.no_grad():
            self.weight.copy_(kaiming_normal_dense(self.weight.shape, self._init_generator))
            self.bias.copy_(torch_conv_bias(self.in_features, self.bias.shape,
                                            self._init_generator))


def TorchBatchNorm(features: int) -> nn.BatchNorm2d:
    """``nn.BatchNorm2d(features)``: eps 1e-5, momentum 0.1, weight 1, bias 0."""
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


class ChannelLayerNorm(nn.Module):
    """flax's ``nn.LayerNorm()`` on an NHWC tensor, on an NCHW one: each
    pixel's channels normalized (eps 1e-6), scale and bias per channel."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), self.weight.to(x.dtype),
                         self.bias.to(x.dtype), self.eps)
        return y.permute(0, 3, 1, 2)


def leaky_relu(x, slope=0.2):
    return F.leaky_relu(x, slope)


def max_pool_2x2(x):
    """torch MaxPool2d(2)."""
    return F.max_pool2d(x, 2)
