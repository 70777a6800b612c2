"""The tensor-core variant of the port's DenoisingBlock kernels (kernel 1,
and kernel 2 on the packed layout): its tile picker, the static rule that
sends a launch to it, and why its f32 path takes three TF32 products,
decided without a card.  The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vub_image_denoising_tpu_torch.nn.blocks import DenoisingBlock
from vub_image_denoising_tpu_torch.ops import fused_block as fb

TC_SOURCE = (Path(fb.__file__).resolve().parent.parent / "csrc" / "fused_block_tc.cu")
PACKED_TC_SOURCE = TC_SOURCE.with_name("fused_block_packed_tc.cu")
# (N, C, H, W) of the RDUNet-32 blocks: a batch of 8 served, a micro-batch of 2 trained
RDUNET32_SHAPES = [(n, c, 8192 // c, 8192 // c) for n in (8, 2) for c in (32, 64, 128, 256)]
H100_SMS = 132  # H100 SXM; the wrapper passes the card's own count (fb.sm_count)


@pytest.mark.parametrize("shape", RDUNET32_SHAPES)
def test_tc_tile_fits_shared_memory(shape):
    n, c, h, w = shape
    variant, th, tw, smem = fb.block_tile(torch.bfloat16, n, c, h, w, H100_SMS)
    assert variant == "tc" and (th, tw) in fb.TC_TILES
    assert smem == fb.tc_smem_bytes(c, th, tw, 2) <= 232448


@pytest.mark.parametrize("shape", RDUNET32_SHAPES)
def test_tc_tile_fits_shared_memory_f32(shape):
    n, c, h, w = shape
    variant, th, tw, smem = fb.block_tile(torch.float32, n, c, h, w, H100_SMS)
    assert variant == "tc" and (th, tw) in fb.tc_tiles(c, 4)
    assert smem == fb.tc_smem_bytes(c, th, tw, 4) <= 232448


def test_tc_tile_fills_the_grid_at_micro_batch_2():
    """(2, 256, 32, 32), a train step's c = 256 blocks: the CUDA-core tile
    gives bf16 32 thread blocks for 132 SMs; the tensor-core picker gives at
    least as many (4x4 tiles: 128)."""
    th, tw = fb.pick_tile(128, 2)
    old_blocks = 2 * (32 // th) * (32 // tw)
    th, tw = fb.pick_tile_tc(2, 256, 32, 32, H100_SMS, 2)
    assert 2 * (32 // th) * (32 // tw) >= old_blocks
    assert (th, tw) == (4, 4)
    # batch 8 fills the card with 8x8
    assert fb.pick_tile_tc(8, 256, 32, 32, H100_SMS, 2) == (8, 8)


@pytest.mark.parametrize("shape", RDUNET32_SHAPES)
def test_tc_tile_follows_the_sm_count(shape):
    """On one SM every block runs in turn, so the least halo (the largest
    tile) wins."""
    n, c, h, w = shape
    for itemsize in (2, 4):
        assert fb.pick_tile_tc(n, c, h, w, 1, itemsize) == fb.tc_tiles(c, itemsize)[0]


def test_tc_tile_reads_the_card():
    """Waves depend on the card: (2, 64, 128, 128) is 128 blocks at 16x16,
    one wave on an H100 SXM (132 SMs), two on an H100 PCIe (114)."""
    assert fb.pick_tile_tc(2, 64, 128, 128, H100_SMS, 2) == (16, 16)
    assert fb.pick_tile_tc(2, 64, 128, 128, 114, 2) == (8, 8)


def test_tc_smem_formula():
    """The shared-memory layout of csrc/fused_block_tc.cu at c = 32, 16x16:
    o0..o2 over 22^2 + 20^2 + 18^2 positions of 16 + 8 bf16, one x slab of
    24^2 positions of 32 + 8 bf16, two weight stages of 3 taps x 32 rows x
    (32 + 8) bf16."""
    assert fb.tc_smem_bytes(32, 16, 16, 2) == 1208 * 48 + 576 * 80 + 2 * 3 * 32 * 80
    # c > 32 streams x in two slab buffers; N = 256 stages one tap
    assert fb.tc_smem_bytes(256, 8, 8, 2) == 440 * 272 + 2 * 256 * 80 + 2 * 32 * 528


def test_tc_smem_formula_f32():
    """The f32 layout at c = 64, 8x8: o0..o2 over 14^2 + 12^2 + 10^2
    positions of 32 f32 + 16 bytes, two x slabs (16 f32 channels + 16 bytes)
    over 16^2 positions, two weight stages of 3 taps x 32 rows x (64 + 8)
    f32.  At c = 256 only the 4x4 tile fits: at 8x8, o0..o2 (440 positions
    of 128 f32 + 16 bytes) already fill the 232448 bytes."""
    assert fb.tc_smem_bytes(64, 8, 8, 4) == 440 * 144 + 2 * 256 * 80 + 2 * 3 * 32 * 288
    assert fb.tc_smem_bytes(256, 8, 8, 4) > 232448
    assert fb.tc_tiles(256, 4) == [(4, 4)]
    assert fb.tc_tiles(32, 4) == [(16, 16), (8, 8), (4, 4)]


def _built_cases(source):
    return {(m[0], *map(int, m[1:])) for m in re.findall(
        r"X\((bf16|f32), (\d+), (\d+), (\d+)\)", source.read_text())}


def _pickable_cases():
    return {(name, c, *t) for name, itemsize in (("bf16", 2), ("f32", 4))
            for c in fb.TC_WIDTHS for t in fb.tc_tiles(c, itemsize)}


def test_tc_source_builds_every_tile_the_picker_may_pick():
    assert _built_cases(TC_SOURCE) == _pickable_cases()


def test_packed_tc_source_builds_every_tile_the_picker_may_pick():
    """Kernel 2's tensor-core library instantiates the shared body
    (fused_block_tc.cuh) at kernel 1's cases, with the packed layout."""
    text = PACKED_TC_SOURCE.read_text()
    assert _built_cases(PACKED_TC_SOURCE) == _pickable_cases()
    assert "tc_try<T_, C_, TH_, TW_, true>" in text
    assert "tc_try<T_, C_, TH_, TW_, false>" in TC_SOURCE.read_text()


@pytest.mark.parametrize("shape", RDUNET32_SHAPES)
def test_packed_tile_is_kernel_1s_at_the_unpacked_shape(shape):
    """Kernel 2 on the even-packed (n, 4c, h/2, w/2) launches what kernel 1
    launches on (n, c, h, w): the tensor-core variant, the same tile and
    shared memory, in both dtypes."""
    n, c, h, w = shape
    for dtype in (torch.bfloat16, torch.float32):
        for sms in (H100_SMS, 114):
            got = fb.packed_block_tile(dtype, n, 4 * c, h // 2, w // 2, sms)
            assert got == fb.block_tile(dtype, n, c, h, w, sms)
            assert got[0] == "tc"


@pytest.mark.parametrize("c", [16, 48])
def test_packed_tile_outside_tc_widths_stays_on_the_cuda_cores(c):
    for dtype in (torch.bfloat16, torch.float32):
        variant, th, tw, smem = fb.packed_block_tile(dtype, 1, 4 * c, 5, 6, H100_SMS)
        assert variant == "cuda_core"
        assert (th, tw) == fb.pick_tile(c // 2, dtype.itemsize)
        assert smem == fb.smem_bytes(c // 2, th, tw, dtype.itemsize)


@pytest.mark.parametrize("dtype,c,want", [
    (torch.bfloat16, 32, "tc"), (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 256, "tc"), (torch.bfloat16, 16, "cuda_core"),
    (torch.bfloat16, 512, "tc_wide"), (torch.float32, 32, "tc"),
    (torch.float32, 256, "tc"), (torch.float32, 16, "cuda_core"),
    (torch.float32, 512, "tc_wide"),
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


def test_cpu_packed_input_runs_the_plain_version_and_counts_no_launch():
    from vub_image_denoising_tpu_torch.ops.packing import pack2x2

    block = DenoisingBlock(32, 16, 32, generator=torch.Generator().manual_seed(0))
    pq = fb.pack_block_params_packed({k: v.detach() for k, v in block.named_parameters()})
    xq = pack2x2(torch.randn(1, 32, 6, 4, generator=torch.Generator().manual_seed(1)))
    counter = fb.fused_denoising_block_packed
    before = (counter.launches, counter.tc_launches)
    yq = counter(xq, pq)
    assert (counter.launches, counter.tc_launches) == before
    torch.testing.assert_close(yq, fb.fused_denoising_block_packed_plain(xq, pq), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Why f32 takes three TF32 products: the block with every conv's operands
# rounded to TF32 (10-bit mantissa), on the CPU
# ---------------------------------------------------------------------------

def _tf32(t):
    """Round f32 to the nearest TF32 value, ties away from zero (cvt.rna),
    by bit mask."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _block_tf32(x, params, products):
    """fused_denoising_block_plain in f32 with each conv taken as TF32
    products: one (a_hi * b_hi) or three (a_lo * b_hi + a_hi * b_lo +
    a_hi * b_hi, with v = v_hi + v_lo), as the kernel's 3xTF32 takes them."""
    def level(parts, i):
        a = torch.cat(parts, 1)
        w = params[f"conv_{i}.weight"]
        a_hi, w_hi = _tf32(a), _tf32(w)
        y = F.conv2d(a_hi, w_hi, padding=1)
        if products == 3:
            a_lo, w_lo = _tf32(a - a_hi), _tf32(w - w_hi)
            y = F.conv2d(a_lo, w_hi, padding=1) + F.conv2d(a_hi, w_lo, padding=1) + y
        y = y + params[f"conv_{i}.bias"].view(1, -1, 1, 1)
        alpha = params[f"actv_{i}.weight"].view(1, -1, 1, 1)
        return torch.clamp_min(y, 0) + alpha * torch.clamp_max(y, 0)

    o0 = level([x], 0)
    o1 = level([x, o0], 1)
    o2 = level([x, o0, o1], 2)
    return level([x, o0, o1, o2], 3) + x


def test_tf32_rounding_keeps_ten_mantissa_bits():
    v = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 2.0 ** -11),
                      3.0e-3])
    r = _tf32(v)
    assert r[:5].tolist() == [1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -10, 1.0, -(1 + 2.0 ** -10)]
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(r[5].item() - 3.0e-3) <= 2.0 ** -11 * 3.0e-3


@pytest.fixture
def one_thread():
    """Convs this small run faster on one thread than on a pool that the
    other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("c", fb.TC_WIDTHS)
def test_3xtf32_block_meets_the_f32_bar(one_thread, c):
    """At every RDUNet-32 width, three TF32 products hold the block to the
    f32 plain version at atol = rtol = 1e-4 (chip_smoke.py's F32_TOL); one
    TF32 product misses that bar."""
    block = DenoisingBlock(c, c // 2, c, generator=torch.Generator().manual_seed(c))
    params = {k: v.detach() for k, v in block.named_parameters()}
    x = torch.from_numpy(np.random.default_rng(c).standard_normal((1, c, 8, 8), np.float32))
    want = fb.fused_denoising_block_plain(x, params)
    torch.testing.assert_close(_block_tf32(x, params, 3), want, atol=1e-4, rtol=1e-4)
    assert not torch.allclose(_block_tf32(x, params, 1), want, atol=1e-4, rtol=1e-4)
