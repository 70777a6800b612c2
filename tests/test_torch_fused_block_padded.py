"""The padding that lets the tensor-core body run widths whose inner channels
do not fill whole mma steps (of the widths built, c = 16 and bf16 c = 152;
the body takes any c of 16-byte channel runs), decided on the CPU.

The kernel keeps ``tc_inner_p`` channels for each of o0..o2 (c/2 rounded up
to a 32-byte k step), zero-fills the padded channels and their weight rows,
and never reads a bias or alpha past c/2.  That is the plain block with its
inner channels zero-padded, which must give the unpadded block's output
exactly: every padded product is an exact zero.  The plain block at these
widths is held to the JAX package's Pallas kernel in interpret mode, as
tests/test_torch_fused_block.py holds it at the small widths.  The card
runs the kernel itself (tests/test_torch_cuda.py)."""

import re
from pathlib import Path

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

CUH = Path(fb.__file__).resolve().parent.parent / "csrc" / "fused_block_tc.cuh"


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pad_inner(params, inner_p):
    """The block's params with inner zero-padded to ``inner_p``: o_j's
    padded output channels get zero weights, bias and alpha; conv_i's input
    rows for them are zero."""
    c, inner = params["conv_0.weight"].shape[1], params["conv_0.weight"].shape[0]
    extra = inner_p - inner
    out = {}
    for i in range(4):
        w = params[f"conv_{i}.weight"]
        parts = [w[:, :c]] + [F.pad(w[:, c + j * inner:c + (j + 1) * inner],
                                    (0, 0, 0, 0, 0, extra)) for j in range(i)]
        w = torch.cat(parts, 1)
        if i < 3:
            w = F.pad(w, (0, 0, 0, 0, 0, 0, 0, extra))
            out[f"conv_{i}.bias"] = F.pad(params[f"conv_{i}.bias"], (0, extra))
            out[f"actv_{i}.weight"] = F.pad(params[f"actv_{i}.weight"], (0, extra))
        else:
            out[f"conv_{i}.bias"] = params[f"conv_{i}.bias"]
            out[f"actv_{i}.weight"] = params[f"actv_{i}.weight"]
        out[f"conv_{i}.weight"] = w
    return out


@pytest.mark.parametrize("c", [16, 48])
def test_plain_block_matches_jax_kernel_at_padded_widths(c):
    """c = 16 and 48 (the search's base 16 and 48) on a 64^2 image: the
    port's plain block against the JAX Pallas kernel in interpret mode, f32
    matmuls at HIGHEST, at 2e-5."""
    rng = np.random.default_rng(c)
    x = rng.standard_normal((1, 64, 64, c), np.float32)
    # the block's parameter tree by shape only (flax's init would run every
    # conv eagerly), filled from the seeded generator: kernels at He scale,
    # the 1-D leaves (biases, PReLU slopes) 0.25 +- 0.1
    shapes = jax.eval_shape(JDenoisingBlock(c, c // 2, c).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, c)))
    variables = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * (0.1 if a.ndim == 1 else
                                                   (2 / np.prod(a.shape[:-1])) ** 0.5)
                   + (0.25 if a.ndim == 1 else 0)).astype(np.float32), shapes)
    sd = params_to_state_dict(variables)
    # compiled at XLA's lowest backend optimization level: compiling is most of its cost
    fn = lambda v, p: jax_fused_block(v, p, tile_rows=32, interpret=True)  # noqa: E731
    with jax.default_matmul_precision("highest"):
        args = (jnp.asarray(x), variables["params"])
        want = np.asarray(jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})(*args))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = fb.fused_denoising_block(xt, sd).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _conv_in_order(inp, w):
    """A 3x3 SAME conv in f32 that adds its products one input channel and
    tap at a time, in one fixed order whatever the channel count (the CPU's
    conv2d blocks its sums by channel count, so a padded conv would round
    otherwise for that reason alone)."""
    n, k, h, wd = inp.shape
    xp = F.pad(inp, (1, 1, 1, 1))
    y = torch.zeros(n, w.shape[0], h, wd)
    for ch in range(k):
        for dy in range(3):
            for dx in range(3):
                y += xp[:, ch:ch + 1, dy:dy + h, dx:dx + wd] * w[:, ch, dy, dx].view(1, -1, 1, 1)
    return y


def _block_in_order(x, params):
    """fused_denoising_block_plain with ``_conv_in_order`` for F.conv2d."""
    dtype = x.dtype

    def level(parts, i):
        y = _conv_in_order(torch.cat(parts, 1).float(),
                           params[f"conv_{i}.weight"].to(dtype).float())
        y = (y + params[f"conv_{i}.bias"].float().view(1, -1, 1, 1)).to(dtype)
        alpha = params[f"actv_{i}.weight"].to(dtype).view(1, -1, 1, 1)
        return torch.clamp_min(y, 0) + alpha * torch.clamp_max(y, 0)

    o0 = level([x], 0)
    o1 = level([x, o0], 1)
    o2 = level([x, o0, o1], 2)
    return level([x, o0, o1, o2], 3) + x


@pytest.mark.parametrize("c", [16, 48, 152])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_padded_inner_block_equals_the_block(one_thread, c, dtype):
    """The block with its inner channels zero-padded to tc_inner_p (bf16:
    16, 32, 80; f32: 8, 24, 80) gives the unpadded block's output exactly,
    at the kernel's casts in f32 and in bf16, when both add their products
    in one order: the padded products are exact zeros.  That order's block
    is the plain block (to f32 rounding; bf16 to a few ulps of max|y|)."""
    inner_p = fb.tc_inner_p(c, dtype.itemsize)
    assert inner_p % (32 // dtype.itemsize) == 0 and c // 2 <= inner_p < c // 2 + 16
    block = DenoisingBlock(c, c // 2, c, generator=torch.Generator().manual_seed(c))
    params = {k: v.detach() for k, v in block.named_parameters()}
    x = torch.from_numpy(np.random.default_rng(c + 1).standard_normal((1, c, 12, 12),
                                                                      np.float32)).to(dtype)
    want = _block_in_order(x, params)
    padded = _pad_inner(params, inner_p)
    assert padded["conv_3.weight"].shape[1] == c + 3 * inner_p
    assert torch.equal(_block_in_order(x, padded), want)
    plain = fb.fused_denoising_block_plain(x, params).float()
    tol = 1e-5 if dtype == torch.float32 else 2e-2 * plain.abs().max().item()
    assert (want.float() - plain).abs().max().item() <= tol


def test_inner_padding_and_outputs_mirror_the_source():
    """tc_inner_p and tc_np as csrc/fused_block_tc.cuh computes them: a k
    step of 32 bytes, level 3 rounded to the n8 tile; nothing padded at
    c in {32, 64, 128, 256}."""
    src = CUH.read_text()
    assert "tc_k_step(int e) { return 32 / e; }" in src
    assert "return l < 3 ? tc_inner_p(c, e) : cdiv(c, 8) * 8;" in src
    for c in (32, 64, 128, 256):
        for e in (2, 4):
            assert fb.tc_inner_p(c, e) == c // 2 and fb.tc_np(c, e, 3) == c
    assert [fb.tc_inner_p(c, 2) for c in (16, 48, 96, 152, 192)] == [16, 32, 48, 80, 96]
    assert [fb.tc_inner_p(c, 4) for c in (16, 48, 96, 152, 192)] == [8, 24, 48, 80, 96]


def _cuh_smem_bytes(src, c, th, tw, e):
    """tc_smem_bytes of the .cuh, rebuilt from its constants: o0..o2 at
    tc_inner_p * e + 16 bytes a position, x slabs of kXStride bytes over
    (th+8) x (tw+8) (two when c * e > kXSlabBytes), two weight stages of
    kStageRows rows (3 taps when n <= 64) of n + 8 or n + 16 elements."""
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    slab = const["kXSlabBytes"]
    stride = slab + int(re.search(r"kXStride = kXSlabBytes \+ (\d+);", src).group(1))
    assert "return (n + (n % 16 ? 16 : 8)) * e;" in src
    assert "return n <= 64 ? 3 : 1;" in src
    k = 32 // e
    inner_p = -(-(c // 2) // k) * k
    positions = sum((th + 6 - 2 * j) * (tw + 6 - 2 * j) for j in range(3))
    o = positions * (inner_p * e + 16)
    x = (2 if c * e > slab else 1) * (th + 8) * (tw + 8) * stride

    def stage(n):
        return (3 if n <= 64 else 1) * const["kStageRows"] * (n + (16 if n % 16 else 8)) * e

    return o + x + 2 * max(stage(inner_p), stage(-(-c // 8) * 8))


@pytest.mark.parametrize("itemsize", [2, 4])
def test_padded_smem_mirrors_the_source(itemsize):
    """fb.tc_smem_bytes is the .cuh's layout at every width and tile built;
    f32 c = 48 does not fit a 16x16 tile (o0..o2 at 24 + 4 f32 a position),
    f32 c = 192 fits only 4x4."""
    src = CUH.read_text()
    for c in (16, 32, 48, 64, 96, 128, 152, 192, 256):
        for th, tw in fb.TC_TILES:
            assert fb.tc_smem_bytes(c, th, tw, itemsize) == _cuh_smem_bytes(src, c, th, tw,
                                                                             itemsize)
    if itemsize == 4:
        assert fb.tc_smem_bytes(48, 16, 16, 4) > 232448
        assert fb.tc_tiles(192, 4) == [(4, 4)]
