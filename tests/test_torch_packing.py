"""The port's 2x2 packing and packed DenoisingBlock against the JAX package's.

Packing is exact data movement, so it is held to 1e-6 (it is exact in
practice).  The packed block's plain version is held, through the contract
unpack2x2(block_packed(pack2x2(x))) == block(x), against the JAX eager block
at 2e-4 (tests/test_packing.py's tolerance), with f32 matmuls at HIGHEST
precision on the JAX side.  The CUDA kernel runs only on the card
(tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rdunet import numpy_params
from vub_image_denoising_tpu.models.fused_apply import _dense_block_xla as jax_dense_block
from vub_image_denoising_tpu.nn.blocks import DenoisingBlock as JDenoisingBlock
from vub_image_denoising_tpu.ops import fused_block as jfb
from vub_image_denoising_tpu.ops import packing as jp
from vub_image_denoising_tpu_torch.ops import fused_block as fb
from vub_image_denoising_tpu_torch.ops import packing as tp
from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict

EXACT = dict(rtol=1e-6, atol=1e-6)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


def jax_block(c, inner, seed):
    """A JAX DenoisingBlock param tree drawn with numpy, and the port's state_dict."""
    tree = numpy_params(JDenoisingBlock(c, inner, c), np.zeros((1, 8, 8, c), np.float32), seed)
    return tree["params"], params_to_state_dict(tree)


def test_pack_unpack_roundtrip():
    x = np.random.RandomState(0).randn(2, 8, 10, 3).astype(np.float32)
    q = tp.pack2x2(nchw(x))
    assert q.shape == (2, 12, 4, 5)
    np.testing.assert_allclose(nhwc(q), np.asarray(jp.pack2x2(jnp.asarray(x))), **EXACT)
    np.testing.assert_array_equal(nhwc(tp.unpack2x2(q)), x)


@pytest.mark.parametrize("shape", [(2, 7, 10, 3), (1, 8, 9, 2)])
def test_pack2x2_rejects_odd_sizes(shape):
    with pytest.raises(ValueError, match="even H and W"):
        tp.pack2x2(torch.zeros(shape))


def test_reshift2d_matches_jax():
    q = np.random.RandomState(1).randn(2, 4, 5, 24).astype(np.float32)
    want = np.asarray(jp.reshift2d(jnp.asarray(q), 6))
    np.testing.assert_allclose(nhwc(tp.reshift2d(nchw(q), 6)), want, **EXACT)
    # 'desc' is the four channel blocks in reverse (the fused kernel's order)
    desc = nhwc(tp.reshift2d(nchw(q), 6, "desc"))
    np.testing.assert_array_equal(desc, np.concatenate(np.split(want, 4, -1)[::-1], -1))


@pytest.mark.parametrize("order", ["asc", "desc"])
@pytest.mark.parametrize("segments", [[4, 6], [4, 3, 3], [4, 2, 2, 2]])
def test_pack_conv3x3_weights_matches_jax(segments, order):
    w = np.random.RandomState(2).randn(3, 3, 10, 7).astype(np.float32)
    want = np.asarray(jp.pack_conv3x3_weights(jnp.asarray(w), in_segments=segments,
                                              shifted_order=order))
    got = tp.pack_conv3x3_weights(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                                  segments, order)
    assert got.shape == want.shape == (4, 40, 28)
    np.testing.assert_allclose(got.numpy(), want, **EXACT)


def test_conv3x3_packed_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 12, 16, 6).astype(np.float32)
    w = (rng.randn(3, 3, 6, 5) * 0.2).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jp.unpack2x2(jp.conv3x3_packed_xla(jp.pack2x2(jnp.asarray(x)),
                                                             jnp.asarray(w), jnp.asarray(b))))
    got = tp.unpack2x2(tp.conv3x3_packed(tp.pack2x2(nchw(x)),
                                         torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                                         torch.from_numpy(b)))
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-5)


def test_pack_block_params_packed_matches_jax():
    jparams, sd = jax_block(8, 4, seed=4)
    want = jfb.pack_block_params_packed(jax.tree_util.tree_map(jnp.asarray, jparams))
    got = fb.pack_block_params_packed(sd)
    for i in range(4):
        np.testing.assert_allclose(got[f"conv_{i}.weight"].numpy(),
                                   np.asarray(want[f"conv_{i}"]["kernel"]), **EXACT)
        np.testing.assert_allclose(got[f"conv_{i}.bias"].numpy(),
                                   np.asarray(want[f"conv_{i}"]["bias"]), **EXACT)
        np.testing.assert_allclose(got[f"actv_{i}.weight"].numpy(),
                                   np.asarray(want[f"actv_{i}"]["alpha"]), **EXACT)


@pytest.mark.parametrize("c,inner", [(8, 4), (12, 4), (16, 8)])
def test_kernel_weight_gather_inverts_packing(c, inner):
    """The device gather that feeds kernel 2 recovers kernel 1's tap-major
    weights exactly, through the [x, o0, o1, o2] segments and 'desc' order."""
    _, sd = jax_block(c, inner, seed=c)
    want_w, want_ba = fb.pack_block_params(sd, torch.float32, torch.device("cpu"))
    got_w, got_ba = fb.kernel_weights_from_packed(fb.pack_block_params_packed(sd), torch.float32)
    assert torch.equal(got_w, want_w) and torch.equal(got_ba, want_ba)


def test_packed_plain_block_matches_jax_block():
    c = 8
    jparams, sd = jax_block(c, c // 2, seed=5)
    x = np.random.RandomState(6).randn(2, 16, 16, c).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_dense_block(jax.tree_util.tree_map(jnp.asarray, jparams),
                                          jnp.asarray(x)))
    got = tp.unpack2x2(fb.fused_denoising_block_packed(tp.pack2x2(nchw(x)),
                                                       fb.pack_block_params_packed(sd)))
    np.testing.assert_allclose(nhwc(got), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(nhwc(got), nhwc(fb.fused_denoising_block(nchw(x), sd)),
                               rtol=2e-5, atol=2e-5)


def test_packed_plain_block_bf16_rounds_like_kernel_1():
    """bf16: the packed plain version rounds where kernel 1's plain version
    does (bias in f32, one cast, PReLU and residual in bf16); only the f32
    summation order differs, so they agree to a bf16 ulp of max|y|."""
    _, sd = jax_block(8, 4, seed=7)
    x = torch.from_numpy(np.random.RandomState(8).randn(1, 8, 12, 10).astype(np.float32))
    xb = x.to(torch.bfloat16)
    got = tp.unpack2x2(fb.fused_denoising_block_packed(tp.pack2x2(xb),
                                                       fb.pack_block_params_packed(sd)))
    want = fb.fused_denoising_block_plain(xb, sd)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max() <= 2 ** -7 * want.float().abs().max()


def test_packed_wrapper_checks():
    _, sd = jax_block(8, 4, seed=9)
    pq = fb.pack_block_params_packed(sd)
    with pytest.raises(ValueError, match="unsupported device"):
        fb.fused_denoising_block_packed(torch.empty(1, 32, 4, 4, device="meta"), pq)
    with pytest.raises(ValueError, match="packed channels"):
        fb.fused_denoising_block_packed(torch.zeros(1, 16, 4, 4), pq)
