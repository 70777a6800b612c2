"""RDUNet — the supervised residual-dense U-Net denoiser — and its
time-conditioned twin RDUNetT.

Counterparts of ``RDUNet`` and ``RDUNetT`` in
``vub_image_denoising_tpu/models/rdunet.py``:

- ``RDUNet`` (reference UNet/RDUNet_model.py:117-186): 4 scales, two
  DenoisingBlocks per scale on the encoder and the decoder paths (14 in all),
  global residual ``output + input``.  base_filters=128 gives 166,375,174
  params, 64 gives 41,604,998.
- ``RDUNetT`` (reference diffusion_denoising/Unet/Unet_model.py:92-166): the
  same trunk; the normalized timestep t is broadcast to one HxW plane and
  concatenated as the last input channel, the output block always maps to
  ``out_channels`` (3), and the residual adds the 3-channel image input.
  base_filters=32 gives 10,407,142 params.

The JAX models wrap the trunk in a ``core`` level; these do not, so their
state_dict keys are the reference keys.  ``remat`` (``_RDUNetCore``)
recomputes DenoisingBlocks in the backward, as JAX's ``nn.remat`` of them
does, and leaves the keys as they are.  Input and output are (N, C, H, W);
run in bf16 by passing a bf16 input (params stay f32).  On the card, pass
channels_last memory to keep the blocks' kernel free of layout copies.
"""

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.blocks import DenoisingBlock, DownsampleBlock, InputBlock, OutputBlock, UpsampleBlock
from .fused_apply import t_plane


BLOCKS = frozenset(f"block_{s}_{i}" for s in range(4) for i in range(4 if s < 3 else 2))
# the blocks "highres" recomputes: scales 0 and 1, whose activations are the
# largest and the cheapest to recompute
HIGHRES_BLOCKS = frozenset(b for b in BLOCKS if b.startswith(("block_0_", "block_1_")))


class _RDUNetCore(nn.Module):
    """The shared encoder/decoder trunk, without the global residual.

    ``remat``: ``False``; ``True`` (or ``"all"``) runs each of the 14
    DenoisingBlocks under ``torch.utils.checkpoint`` (non-reentrant), so
    the backward recomputes its forward, on the card one more launch of
    kernel 1, instead of keeping what it saved; ``"highres"`` does so for
    the eight blocks at scales 0 and 1 (JAX's ``models/rdunet.py:25-53``).
    Only where autograd records a graph; the modules and their keys are
    the same in every mode."""

    def __init__(self, in_channels: int, base_filters: int, out_channels: int, generator=None,
                 remat=False):
        super().__init__()
        if not (isinstance(remat, bool) or remat in ("all", "highres")):
            raise ValueError(f"remat must be False, True, 'all' or 'highres', got {remat!r}")
        self.remat = remat
        self._remat_blocks = (BLOCKS if remat is True or remat == "all"
                              else HIGHRES_BLOCKS if remat == "highres" else frozenset())
        f0 = base_filters
        f1, f2, f3 = 2 * f0, 4 * f0, 8 * f0
        g = generator
        self.input_block = InputBlock(in_channels, f0, g)
        self.block_0_0 = DenoisingBlock(f0, f0 // 2, f0, g)
        self.block_0_1 = DenoisingBlock(f0, f0 // 2, f0, g)
        self.down_0 = DownsampleBlock(f0, f1, g)
        self.block_1_0 = DenoisingBlock(f1, f1 // 2, f1, g)
        self.block_1_1 = DenoisingBlock(f1, f1 // 2, f1, g)
        self.down_1 = DownsampleBlock(f1, f2, g)
        self.block_2_0 = DenoisingBlock(f2, f2 // 2, f2, g)
        self.block_2_1 = DenoisingBlock(f2, f2 // 2, f2, g)
        self.down_2 = DownsampleBlock(f2, f3, g)
        self.block_3_0 = DenoisingBlock(f3, f3 // 2, f3, g)
        self.block_3_1 = DenoisingBlock(f3, f3 // 2, f3, g)
        self.up_2 = UpsampleBlock(f3, f2, g)
        self.block_2_2 = DenoisingBlock(f2, f2 // 2, f2, g)
        self.block_2_3 = DenoisingBlock(f2, f2 // 2, f2, g)
        self.up_1 = UpsampleBlock(f2, f1, g)
        self.block_1_2 = DenoisingBlock(f1, f1 // 2, f1, g)
        self.block_1_3 = DenoisingBlock(f1, f1 // 2, f1, g)
        self.up_0 = UpsampleBlock(f1, f0, g)
        self.block_0_2 = DenoisingBlock(f0, f0 // 2, f0, g)
        self.block_0_3 = DenoisingBlock(f0, f0 // 2, f0, g)
        self.output_block = OutputBlock(f0, out_channels, g)

    def run_block(self, name, h):
        """DenoisingBlock ``name`` on h, recomputed in the backward where
        ``remat`` says so."""
        block = getattr(self, name)
        if name in self._remat_blocks and torch.is_grad_enabled():
            # the blocks draw no random numbers: no RNG state to keep
            return checkpoint(block, h, use_reentrant=False, preserve_rng_state=False)
        return block(h)

    def _pair(self, scale, first, h):
        """Blocks ``block_{scale}_{first}`` then ``_{first + 1}`` on h."""
        for i in (first, first + 1):
            h = self.run_block(f"block_{scale}_{i}", h)
        return h

    def trunk(self, x):
        out_0 = self._pair(0, 0, self.input_block(x))
        out_1 = self._pair(1, 0, self.down_0(out_0))
        out_2 = self._pair(2, 0, self.down_1(out_1))
        out_3 = self._pair(3, 0, self.down_2(out_2))
        out_4 = self._pair(2, 2, self.up_2(out_3, out_2))
        out_5 = self._pair(1, 2, self.up_1(out_4, out_1))
        out_6 = self._pair(0, 2, self.up_0(out_5, out_0))
        return self.output_block(out_6)


class RDUNet(_RDUNetCore):
    def __init__(self, channels: int = 3, base_filters: int = 64, generator=None, remat=False):
        super().__init__(channels, base_filters, channels, generator, remat)

    def forward(self, x):
        return self.trunk(x) + x


class RDUNetT(_RDUNetCore):
    """``t`` is the normalized timestep: a scalar, an (N,) vector or an
    (N, 1, H, W) plane."""

    def __init__(self, base_filters: int = 64, out_channels: int = 3, generator=None,
                 remat=False):
        super().__init__(out_channels + 1, base_filters, out_channels, generator, remat)

    def forward(self, x, t):
        return self.trunk(torch.cat([x, t_plane(t, x)], 1)) + x
