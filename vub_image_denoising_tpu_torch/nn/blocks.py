"""RDUNet blocks.  Counterpart of ``vub_image_denoising_tpu/nn/blocks.py``.

Submodule names are the reference's attribute names (UNet/RDUNet_model.py:49-115),
so state_dict keys match a reference ``.pth`` as they are.
"""

import torch
from torch import nn

from ..ops.fused_block import (fused_denoising_block, fused_denoising_block_plain,
                               pack_block_params)
from .layers import Conv3x3, Downsample2x2, PReLU, Upsample2x2


class DownsampleBlock(nn.Module):
    """conv(k2, s2) + PReLU."""

    def __init__(self, in_channels: int, out_channels: int, generator=None):
        super().__init__()
        self.conv = Downsample2x2(in_channels, out_channels, generator)
        self.actv = PReLU(out_channels)

    def forward(self, x):
        return self.actv(self.conv(x))


class UpsampleBlock(nn.Module):
    """convT(k2, s2) + PReLU, concat with the skip, conv3x3 + PReLU.

    The skip comes FIRST in the concat (torch.cat([concat, upsample], 1))."""

    def __init__(self, in_channels: int, out_channels: int, generator=None):
        super().__init__()
        self.conv_t = Upsample2x2(in_channels, in_channels, generator)
        self.actv_t = PReLU(in_channels)
        self.conv = Conv3x3(in_channels + out_channels, out_channels, generator)
        self.actv = PReLU(out_channels)

    def forward(self, upsample, concat):
        upsample = self.actv_t(self.conv_t(upsample))
        return self.actv(self.conv(torch.cat([concat, upsample], 1)))


class InputBlock(nn.Module):
    """2x (conv3x3 + PReLU)."""

    def __init__(self, in_channels: int, out_channels: int, generator=None):
        super().__init__()
        self.conv_1 = Conv3x3(in_channels, out_channels, generator)
        self.conv_2 = Conv3x3(out_channels, out_channels, generator)
        self.actv_1 = PReLU(out_channels)
        self.actv_2 = PReLU(out_channels)

    def forward(self, x):
        return self.actv_2(self.conv_2(self.actv_1(self.conv_1(x))))


class OutputBlock(nn.Module):
    """conv3x3 + PReLU at width in_channels, then conv3x3 + PReLU to out_channels."""

    def __init__(self, in_channels: int, out_channels: int, generator=None):
        super().__init__()
        self.conv_1 = Conv3x3(in_channels, in_channels, generator)
        self.conv_2 = Conv3x3(in_channels, out_channels, generator)
        self.actv_1 = PReLU(in_channels)
        self.actv_2 = PReLU(out_channels)

    def forward(self, x):
        return self.actv_2(self.conv_2(self.actv_1(self.conv_1(x))))


class DenoisingBlock(nn.Module):
    """4-layer residual-dense block: each conv sees the concat of the block input
    and all earlier conv outputs; the last conv's output is added to the input.

    The forward is ``ops.fused_block.fused_denoising_block``: the CUDA kernel on
    the card, its plain version on the CPU (and on meta tensors, which carry
    shapes only).  When autograd needs a graph it
    is ``models.fused_apply.fused_block_trainable``: the same kernel forward,
    and a backward that differentiates the eager block.  The kernel's weight
    layout is built once per (dtype, device) and rebuilt when a parameter
    changes (``load_state_dict``, ``.to``, an optimizer step); under
    ``torch.export`` the layout that ``pack_kernel_weights`` built is taken as
    it is, so the exported program holds it as a constant, and each block is
    one kernel operator node, on the CPU too."""

    def __init__(self, in_channels: int, inner_channels: int, out_channels: int,
                 generator=None):
        super().__init__()
        self.conv_0 = Conv3x3(in_channels, inner_channels, generator)
        self.conv_1 = Conv3x3(in_channels + inner_channels, inner_channels, generator)
        self.conv_2 = Conv3x3(in_channels + 2 * inner_channels, inner_channels, generator)
        self.conv_3 = Conv3x3(in_channels + 3 * inner_channels, out_channels, generator)
        self.actv_0 = PReLU(inner_channels)
        self.actv_1 = PReLU(inner_channels)
        self.actv_2 = PReLU(inner_channels)
        self.actv_3 = PReLU(out_channels)
        self._packed_key = None
        self._packed = None

    def _kernel_weights(self, params, dtype, device):
        if torch.compiler.is_exporting():
            # the layout packed by an eager forward before the export becomes
            # a constant of the exported program (eval/export.py)
            if self._packed_key is None or self._packed_key[:2] != (dtype, device):
                raise RuntimeError("DenoisingBlock: pack_kernel_weights(model, dtype) "
                                   "before torch.export")
            return self._packed
        key = (dtype, device, tuple((p.data_ptr(), p._version) for p in params.values()))
        if key != self._packed_key:
            self._packed = pack_block_params(params, dtype, device)
            self._packed_key = key
        return self._packed

    def forward(self, x):
        from ..models.fused_apply import fused_block_trainable  # models import nn

        params = dict(self.named_parameters())
        if x.device.type == "meta":
            # shapes only, nothing runs: the plain block, whose convs an
            # operation counter sees (utils/info.py counts FLOPs this way)
            return fused_denoising_block_plain(x, params)
        weights = None
        if x.device.type != "cpu":
            x = x.contiguous(memory_format=torch.channels_last)
        if x.device.type != "cpu" or torch.compiler.is_exporting():
            weights = self._kernel_weights(params, x.dtype, x.device)
        if torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad for p in params.values())):
            return fused_block_trainable(x, params, kernel_weights=weights)
        return fused_denoising_block(x, params, weights)


def pack_kernel_weights(model, dtype):
    """Build every DenoisingBlock's kernel weight layout in ``model`` for
    ``dtype`` on the parameters' device now (``torch.export`` takes them as
    they are)."""
    for m in model.modules():
        if isinstance(m, DenoisingBlock):
            params = dict(m.named_parameters())
            m._kernel_weights(params, dtype, next(iter(params.values())).device)
