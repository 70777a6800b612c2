"""The port's fused DenoisingBlock against the JAX package's.

On the CPU the wrapper runs its plain version; it is held against the JAX
Pallas kernel in interpret mode (the shapes, tiles and border case of
tests/test_fused_block.py) at 2e-5 with f32 matmuls at HIGHEST precision on
the JAX side.  The CUDA kernel itself runs only on the card:
tests/test_torch_cuda.py compares it with the plain version there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vub_image_denoising_tpu.nn.blocks import DenoisingBlock as JDenoisingBlock
from vub_image_denoising_tpu.ops.fused_block import fused_denoising_block as jax_fused_block
from vub_image_denoising_tpu_torch.nn.blocks import DenoisingBlock
from vub_image_denoising_tpu_torch.ops import fused_block as fb
from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict


def _jax_block(cin, inner, x_nhwc, seed):
    block = JDenoisingBlock(cin, inner, cin)
    variables = block.init(jax.random.PRNGKey(seed), jnp.asarray(x_nhwc))
    tree = jax.tree_util.tree_map(np.asarray, variables)
    return block, variables, params_to_state_dict(tree)


def _port(x_nhwc, sd):
    x = torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)
    return fb.fused_denoising_block(x, sd).permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("shape,cin,inner,tile", [
    ((1, 16, 16, 8), 8, 4, 8),     # multi-tile rows
    ((2, 8, 8, 8), 8, 4, 8),       # single tile, batch 2
    ((1, 12, 8, 16), 16, 8, 4),    # 3 tiles
])
def test_plain_block_matches_jax_kernel(shape, cin, inner, tile):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    _, variables, sd = _jax_block(cin, inner, x, seed=1)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_fused_block(jnp.asarray(x), variables["params"],
                                          tile_rows=tile, interpret=True))
    np.testing.assert_allclose(_port(x, sd), want, rtol=2e-5, atol=2e-5)


def test_plain_block_edge_padding_semantics():
    """Nested SAME-conv zero padding at the borders, on a constant input."""
    x = np.ones((1, 8, 8, 8), np.float32)
    _, variables, sd = _jax_block(8, 4, x, seed=2)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_fused_block(jnp.asarray(x), variables["params"],
                                          tile_rows=4, interpret=True))
    got = _port(x, sd)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert not np.allclose(got[0, 0, 4], got[0, 4, 4], atol=1e-4)


def test_plain_block_bf16_matches_flax_block():
    """bf16 activations, f32 params.  Flax rounds after the conv and again
    after its bias add; the port (like the kernel) adds the bias in f32 and
    rounds once, so they differ by a few bf16 ulps: tolerance 3% of max|y|."""
    x = np.random.RandomState(3).randn(2, 16, 16, 16).astype(np.float32)
    block, variables, sd = _jax_block(16, 8, x, seed=3)
    want = np.asarray(block.apply(variables, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    xb = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    got = fb.fused_denoising_block(xb, sd)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def test_packed_weights_are_tap_major():
    """The kernel's weight layout: conv_i is (9, K, N) with tap = 3*dy + dx;
    summing shifted inputs against it reproduces F.conv2d."""
    block = DenoisingBlock(8, 4, 8, generator=torch.Generator().manual_seed(0))
    params = dict(block.named_parameters())
    w, ba = fb.pack_block_params(params, torch.float32, torch.device("cpu"))
    x = torch.randn(1, 8, 6, 5, generator=torch.Generator().manual_seed(1))
    w0 = w[: 9 * 8 * 4].view(9, 8, 4)
    xp = F.pad(x, (1, 1, 1, 1))
    acc = sum(torch.einsum("nkhw,kc->nchw", xp[:, :, dy:dy + 6, dx:dx + 5], w0[3 * dy + dx])
              for dy in range(3) for dx in range(3))
    want = F.conv2d(x, params["conv_0.weight"], padding=1)
    torch.testing.assert_close(acc, want.detach(), rtol=1e-5, atol=1e-5)
    assert w.numel() == 9 * (8 * 4 + 12 * 4 + 16 * 4 + 20 * 8)
    torch.testing.assert_close(ba[:4], params["conv_0.bias"].detach())
    torch.testing.assert_close(ba[-8:], params["actv_3.weight"].detach())


@pytest.mark.parametrize("c", [32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_tile_fits_shared_memory(c, itemsize):
    """Every width of base 32 and 64 fits in both dtypes; c = 1024 (base 128)
    fits only in bf16 and raises in f32."""
    if c == 1024 and itemsize == 4:
        with pytest.raises(ValueError, match="no tile fits"):
            fb.pick_tile(c // 2, itemsize)
        return
    th, tw = fb.pick_tile(c // 2, itemsize)
    assert fb.smem_bytes(c // 2, th, tw, itemsize) <= 232448


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,want", [(512, "tc_wide"), (1024, "tc_wide"), (16, "tc"),
                                    (48, "tc_wide"), (256, "tc"), (304, "tc_wide"),
                                    (320, "tc_wide"), (608, "tc_wide"), (1216, "tc_wide")])
def test_wide_variant_rule(dtype, c, want):
    """c > 256 (RDUNet-64's and RDUNet-128's 512 and 1024) takes the wide
    form in both dtypes, its tile and shared memory; so does the search's
    c = 48, where it was measured faster than the fused body; c = 16 takes
    the fused body; kernel 2 takes kernel 1's variant at the unpacked
    shape."""
    assert fb.block_variant(dtype, c) == want
    got = fb.block_tile(dtype, 2, c, 20, 36, 132)
    assert got[0] == want
    assert fb.packed_block_tile(dtype, 2, 4 * c, 10, 18, 132) == got
    if want == "tc_wide":
        assert got[1:] == (*fb.WIDE_TILE, fb.wide_smem_bytes(dtype.itemsize))


def rdunet_widths(base):
    """The DenoisingBlock widths of an RDUNet of ``base`` filters."""
    return (base, 2 * base, 4 * base, 8 * base)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_rdunet_width_has_a_kernel(dtype):
    """No width an RDUNet of base 1-160 reaches lacks a kernel: block_tile
    returns a tile that fits shared memory for each, in both dtypes.  The
    fused tensor-core body takes TC_WIDTHS[dtype] (every tile it may pick
    fits); every other width takes the wide form, whatever c is modulo the
    64-channel chunk or the 16-byte piece (c = 48, 96, 192 and 40, 80, 160
    with 16-byte channel runs, 25 and 50 without, 304 ... 1216 above 256);
    none stays on the CUDA cores."""
    widths = sorted({c for base in range(1, 161) for c in rdunet_widths(base)})
    e = dtype.itemsize
    for c in widths:
        variant, th, tw, smem = fb.block_tile(dtype, 8, c, 32, 32, 132)
        assert smem <= 232448, c
        if c in fb.TC_WIDTHS[dtype]:
            assert variant == "tc" and smem == fb.tc_smem_bytes(c, th, tw, e), c
            assert all(fb.tc_smem_bytes(c, *t, e) <= 232448 for t in fb.tc_tiles(c, e))
        else:
            assert (variant, (th, tw)) == ("tc_wide", fb.WIDE_TILE), c
    assert {c for c in widths if c > 256 and c % (2 * fb.WIDE_N)} >= {304, 352, 608, 1216}
    by_variant = {v: {c for c in widths if fb.block_variant(dtype, c) == v}
                  for v in ("tc", "tc_wide", "cuda_core")}
    assert by_variant["tc"] == set(fb.TC_WIDTHS[dtype])
    assert {48, 96, 192, 40, 80, 160, 25, 50} <= by_variant["tc_wide"]
    assert (152 in by_variant["tc"]) == (dtype == torch.bfloat16)
    assert by_variant["cuda_core"] == set()


@pytest.mark.parametrize("itemsize", [2, 4])
def test_wide_smem_fits_and_mirrors_the_source(itemsize):
    """The wide form's shared memory is one size at every width, fits two
    thread blocks on an SM (2 x (bytes + 1 KB reserved) <= 228 KB), and is
    what csrc/fused_block_wide_tc.cu's kWideSmem computes."""
    import re
    from pathlib import Path

    src = (Path(fb.__file__).resolve().parent.parent / "csrc"
           / "fused_block_wide_tc.cu").read_text()
    th, tw = (int(v) for v in re.search(
        r"kWideTH = (\d+), kWideTW = (\d+);", src).groups())
    n = int(re.search(r"kWideN = (\d+);", src).group(1))
    assert (th, tw) == fb.WIDE_TILE and n == fb.WIDE_N
    x_bytes = (th + 2) * (tw + 2) * 80
    w_bytes = 9 * 64 * (n + 8)  # nine taps x (64 / e) rows x (n + 8) columns of e bytes
    assert fb.wide_smem_bytes(itemsize) == 2 * (x_bytes + w_bytes) == 111744
    assert 2 * (fb.wide_smem_bytes(itemsize) + 1024) <= 233472
    for c in (512, 1024, 2048):
        assert fb.block_tile(torch.float32 if itemsize == 4 else torch.bfloat16,
                             1, c, 64, 64, 132)[3] <= 232448


def test_wide_workspace_formula():
    """o0..o2 of every pixel, NHWC: 3 * inner channels; (8, 512, 64, 64) f32
    is 8 * 4096 * 768 * 4 bytes = 100.7 MB."""
    assert fb.wide_workspace_shape(8, 512, 64, 64) == (8, 64, 64, 768)
    assert fb.wide_workspace_shape(1, 1024, 32, 32) == (1, 32, 32, 1536)
    assert np.prod(fb.wide_workspace_shape(8, 512, 64, 64)) * 4 == 100_663_296


def test_block_flops_formula():
    assert fb.block_flops(1, 32, 256, 256) == 85.5 * 32 * 32 * 256 * 256


def test_denoising_block_caches_kernel_weights_until_load():
    block = DenoisingBlock(8, 4, 8, generator=torch.Generator().manual_seed(0))
    params = dict(block.named_parameters())
    cpu = torch.device("cpu")
    first = block._kernel_weights(params, torch.float32, cpu)
    assert block._kernel_weights(params, torch.float32, cpu) is first
    other = DenoisingBlock(8, 4, 8, generator=torch.Generator().manual_seed(1))
    block.load_state_dict(other.state_dict())
    fresh = block._kernel_weights(params, torch.float32, cpu)
    assert fresh is not first
    torch.testing.assert_close(fresh[0], fb.pack_block_params(
        dict(other.named_parameters()), torch.float32, cpu)[0])


def test_wrapper_rejects_other_devices():
    x = torch.empty(1, 8, 4, 4, device="meta")
    block = DenoisingBlock(8, 4, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        fb.fused_denoising_block(x, dict(block.named_parameters()))
