"""The tensor-core variant of the port's DenoisingBlock kernel: its tile
picker and the static rule that sends a launch to it, decided without a card.
The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import pytest
import torch

from vub_image_denoising_tpu_torch.ops import fused_block as fb

TC_SOURCE = (Path(fb.__file__).resolve().parent.parent / "csrc" / "fused_block_tc.cu")
# (N, C, H, W) of the RDUNet-32 blocks: a batch of 8 served, a micro-batch of 2 trained
RDUNET32_SHAPES = [(n, c, 8192 // c, 8192 // c) for n in (8, 2) for c in (32, 64, 128, 256)]
H100_SMS = 132  # H100 SXM; the wrapper passes the card's own count (fb.sm_count)


@pytest.mark.parametrize("shape", RDUNET32_SHAPES)
def test_tc_tile_fits_shared_memory(shape):
    n, c, h, w = shape
    variant, th, tw, smem = fb.block_tile(torch.bfloat16, n, c, h, w, H100_SMS)
    assert variant == "tc" and (th, tw) in fb.TC_TILES
    assert smem == fb.tc_smem_bytes(c, th, tw) <= 232448


def test_tc_tile_fills_the_grid_at_micro_batch_2():
    """(2, 256, 32, 32), a train step's c = 256 blocks: the CUDA-core tile
    gives bf16 32 thread blocks for 132 SMs; the tensor-core picker gives at
    least as many (4x4 tiles: 128)."""
    th, tw = fb.pick_tile(128, 2)
    old_blocks = 2 * (32 // th) * (32 // tw)
    th, tw = fb.pick_tile_tc(2, 256, 32, 32, H100_SMS)
    assert 2 * (32 // th) * (32 // tw) >= old_blocks
    assert (th, tw) == (4, 4)
    # batch 8 fills the card with 8x8
    assert fb.pick_tile_tc(8, 256, 32, 32, H100_SMS) == (8, 8)


@pytest.mark.parametrize("shape", RDUNET32_SHAPES)
def test_tc_tile_follows_the_sm_count(shape):
    """On one SM every block runs in turn, so the least halo (the largest
    tile) wins."""
    n, c, h, w = shape
    assert fb.pick_tile_tc(n, c, h, w, 1) == fb.tc_tiles(c)[0]


def test_tc_tile_reads_the_card():
    """Waves depend on the card: (2, 64, 128, 128) is 128 blocks at 16x16,
    one wave on an H100 SXM (132 SMs), two on an H100 PCIe (114)."""
    assert fb.pick_tile_tc(2, 64, 128, 128, H100_SMS) == (16, 16)
    assert fb.pick_tile_tc(2, 64, 128, 128, 114) == (8, 8)


def test_tc_smem_formula():
    """The shared-memory layout of csrc/fused_block_tc.cu at c = 32, 16x16:
    o0..o2 over 22^2 + 20^2 + 18^2 positions of 16 + 8 bf16, one x slab of
    24^2 positions of 32 + 8 bf16, two weight stages of 3 taps x 32 rows x
    (32 + 8) bf16."""
    assert fb.tc_smem_bytes(32, 16, 16) == 1208 * 48 + 576 * 80 + 2 * 3 * 32 * 80
    # c > 32 streams x in two slab buffers; N = 256 stages one tap
    assert fb.tc_smem_bytes(256, 8, 8) == 440 * 272 + 2 * 256 * 80 + 2 * 32 * 528


def test_tc_source_builds_every_tile_the_picker_may_pick():
    cases = {tuple(map(int, m)) for m in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", TC_SOURCE.read_text())}
    assert cases == {(c, *t) for c in fb.TC_WIDTHS for t in fb.tc_tiles(c)}


@pytest.mark.parametrize("dtype,c,want", [
    (torch.bfloat16, 32, "tc"), (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 256, "tc"), (torch.bfloat16, 16, "cuda_core"),
    (torch.bfloat16, 512, "cuda_core"), (torch.float32, 32, "cuda_core"),
    (torch.float32, 256, "cuda_core"),
])
def test_block_variant_rule(dtype, c, want):
    assert fb.block_variant(dtype, c) == want
    assert fb.block_tile(dtype, 1, c, 16, 16, H100_SMS)[0] == want


def test_cpu_input_runs_the_plain_version_and_counts_no_launch():
    from vub_image_denoising_tpu_torch.nn.blocks import DenoisingBlock

    block = DenoisingBlock(32, 16, 32, generator=torch.Generator().manual_seed(0))
    params = {k: v.detach() for k, v in block.named_parameters()}
    x = torch.randn(1, 32, 6, 5, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    before = (fb.fused_denoising_block.launches, fb.fused_denoising_block.tc_launches)
    y = fb.fused_denoising_block(x, params)
    assert (fb.fused_denoising_block.launches, fb.fused_denoising_block.tc_launches) == before
    torch.testing.assert_close(y, fb.fused_denoising_block_plain(x, params), rtol=0, atol=0)
