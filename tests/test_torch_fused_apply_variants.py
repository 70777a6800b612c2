"""The eager engine's variants of ``models/fused_apply.py`` against the JAX
package's, on the CPU: the precombined DenoisingBlock, its backward alone
(``_dense_block_precombined_bwd``), the space-to-depth downsample and its
matmul backward (``_down_fast_bwd``), and ``_core`` under each of the three
switches (``VUB_PRECOMBINE_MIN_C``, ``VUB_BWD_PRECOMBINE``,
``VUB_DOWN_MATMUL_BWD``).

The cases mirror tests/test_fused_apply.py's (precombined vs the plain block
rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol 1e-4, the custom
backwards' outputs rtol 1e-5 / atol 1e-6); against JAX the outputs are held
to rtol 1e-4 / atol 1e-5 and gradients to rtol 1e-4 / atol 1e-5 (the JAX
side at HIGHEST precision, compiled at XLA's lowest backend optimization
level), a model under a switch to the model tolerance 2e-4."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_apply import assert_grads_match, jnp_tree, nchw, nhwc, run_jax
from test_torch_rdunet import numpy_params, one_thread  # noqa: F401 — autouse
from vub_image_denoising_tpu.models import fused_apply as jfa
from vub_image_denoising_tpu.nn.blocks import DenoisingBlock as JDenoisingBlock
from vub_image_denoising_tpu.nn.blocks import DownsampleBlock as JDownsampleBlock
from vub_image_denoising_tpu_torch.models import RDUNet
from vub_image_denoising_tpu_torch.models import fused_apply as fa
from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict

OUT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
MODEL_TOL = 2e-4
SWITCHES = {"precombine": ("_PRECOMBINE_MIN_CHANNELS", 0),
            "bwd_precombine": ("_BWD_PRECOMBINE_MIN_C", 0),
            "down_matmul_bwd": ("_DOWN_MATMUL_BWD", True)}


def block_case(c, seed):
    tree = numpy_params(JDenoisingBlock(c, c // 2, c), np.zeros((1, 8, 8, c), np.float32), seed)
    x = np.random.RandomState(seed + 1).randn(2, 16, 16, c).astype(np.float32)
    return tree, x


def leaf_params(tree):
    return {k: v.requires_grad_() for k, v in params_to_state_dict(tree).items()}


def sq_grads(fn, params, x):
    """Output and the gradients of sum(fn(params, x)**2) for params and x."""
    xt = nchw(x).requires_grad_()
    y = fn(params, xt)
    grads = torch.autograd.grad(y.square().sum(), [*params.values(), xt])
    return y, dict(zip(params, grads[:-1])), grads[-1]


@pytest.mark.parametrize("c", [8, 16])
def test_precombined_block_matches_jax_and_the_plain_block(c):
    tree, x = block_case(c, c)

    def jax_fn(p, xx):
        def loss(pp, v):
            return jnp.sum(jfa._dense_block_xla_precombined(pp, v) ** 2)
        return jfa._dense_block_xla_precombined(p, xx), jax.grad(loss, argnums=(0, 1))(p, xx)

    want_y, (want_gp, want_gx) = run_jax(jax_fn, jnp_tree(tree["params"]), jnp.asarray(x))
    params = leaf_params(tree)
    y, gp, gx = sq_grads(fa._dense_block_xla_precombined, params, x)
    np.testing.assert_allclose(nhwc(y), np.asarray(want_y), **OUT_TOL)
    assert_grads_match(gp, want_gp)
    np.testing.assert_allclose(nhwc(gx), np.asarray(want_gx), **OUT_TOL)

    # the same linear map as the plain block, forward and gradients
    y0, gp0, gx0 = sq_grads(fa._dense_block_xla, params, x)
    np.testing.assert_allclose(y.detach().numpy(), y0.detach().numpy(), **OUT_TOL)
    for k in gp0:
        np.testing.assert_allclose(gp[k].numpy(), gp0[k].numpy(), err_msg=k, **GRAD_TOL)
    np.testing.assert_allclose(gx.numpy(), gx0.numpy(), **GRAD_TOL)


def test_precombined_backward_matches_the_plain_block():
    """Standard forward, precombined backward: the plain block's output
    exactly and its gradients, and JAX's custom-VJP block's gradients."""
    tree, x = block_case(8, 3)

    def jax_grads(p, xx):
        return jax.grad(lambda pp, v: jnp.sum(jfa._dense_block_precombined_bwd(pp, v) ** 2),
                        argnums=(0, 1))(p, xx)

    want_gp, want_gx = run_jax(jax_grads, jnp_tree(tree["params"]), jnp.asarray(x))
    params = leaf_params(tree)
    y, gp, gx = sq_grads(fa._dense_block_precombined_bwd, params, x)
    y0, gp0, gx0 = sq_grads(fa._dense_block_xla, params, x)
    np.testing.assert_allclose(y.detach().numpy(), y0.detach().numpy(), rtol=1e-5, atol=1e-6)
    for k in gp0:
        np.testing.assert_allclose(gp[k].numpy(), gp0[k].numpy(), err_msg=k, **GRAD_TOL)
    np.testing.assert_allclose(gx.numpy(), gx0.numpy(), **GRAD_TOL)
    assert_grads_match(gp, want_gp)
    np.testing.assert_allclose(nhwc(gx), np.asarray(want_gx), **OUT_TOL)


def test_down_s2d_and_matmul_backward_match_the_conv():
    """``_down_s2d`` equals ``_down`` and JAX's ``_down_s2d``; the matmul
    backward's gradients equal the conv's and JAX's ``_down_fast_bwd``'s."""
    c = 8
    x = np.random.RandomState(5).randn(2, 16, 16, c).astype(np.float32)
    tree = numpy_params(JDownsampleBlock(2 * c), x, 2)

    def jax_fn(p, xx):
        def loss(pp, v):
            return jnp.sum(jfa._down_fast_bwd(pp, v) ** 2)
        return jfa._down_s2d(p, xx), jax.grad(loss, argnums=(0, 1))(p, xx)

    want_y, (want_gp, want_gx) = run_jax(jax_fn, jnp_tree(tree["params"]), jnp.asarray(x))
    params = leaf_params(tree)
    with torch.no_grad():
        y_s2d = fa._down_s2d(params, nchw(x))
        y_conv = fa._down(params, nchw(x))
    np.testing.assert_allclose(y_s2d.numpy(), y_conv.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(nhwc(y_s2d), np.asarray(want_y), **OUT_TOL)

    y, gp, gx = sq_grads(fa._down_fast_bwd, params, x)
    y0, gp0, gx0 = sq_grads(fa._down, params, x)
    np.testing.assert_allclose(y.detach().numpy(), y0.detach().numpy(), rtol=1e-5, atol=1e-6)
    for k in gp0:
        np.testing.assert_allclose(gp[k].numpy(), gp0[k].numpy(), err_msg=k, **GRAD_TOL)
    np.testing.assert_allclose(gx.numpy(), gx0.numpy(), **GRAD_TOL)
    assert_grads_match(gp, want_gp)
    np.testing.assert_allclose(nhwc(gx), np.asarray(want_gx), **OUT_TOL)


@pytest.fixture(scope="module")
def model_case():
    model = RDUNet(3, 4, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 3, 16, 16).astype(np.float32))
    params = {k: v.detach().clone().requires_grad_() for k, v in model.state_dict().items()}
    y = fa.rdunet_apply_fused(params, x, engine="xla")
    grads = torch.autograd.grad(y.square().mean(), list(params.values()))
    return params, x, y.detach(), grads


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_core_under_each_switch_equals_off(model_case, monkeypatch, switch):
    """The "xla" engine with one switch on: the forward and every gradient
    within the model tolerance of the switch off; the kernel engine's
    trainable blocks (the plain block on the CPU) ignore the block switches."""
    params, x, y_off, g_off = model_case
    name, value = SWITCHES[switch]
    monkeypatch.setattr(fa, name, value)
    y = fa.rdunet_apply_fused(params, x, engine="xla")
    np.testing.assert_allclose(y.detach().numpy(), y_off.numpy(), atol=MODEL_TOL, rtol=MODEL_TOL)
    grads = torch.autograd.grad(y.square().mean(), list(params.values()))
    for k, a, b in zip(params, grads, g_off):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=k, rtol=MODEL_TOL,
                                   atol=MODEL_TOL * b.abs().max().item())
    y_kernel = fa.rdunet_apply_fused(params, x, engine="pallas", trainable=True)
    np.testing.assert_allclose(y_kernel.detach().numpy(), y_off.numpy(), atol=MODEL_TOL,
                               rtol=MODEL_TOL)


def test_switches_read_from_the_environment_at_import():
    """The JAX package's environment names, read at import; off by default."""
    env = dict(os.environ, VUB_PRECOMBINE_MIN_C="128", VUB_BWD_PRECOMBINE="64",
               VUB_DOWN_MATMUL_BWD="1")
    code = ("from vub_image_denoising_tpu_torch.models import fused_apply as fa; "
            "print(fa._PRECOMBINE_MIN_CHANNELS, fa._BWD_PRECOMBINE_MIN_C, fa._DOWN_MATMUL_BWD, "
            "*(fa._eager_block_for(c).__name__ for c in (32, 64, 128)))")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=120, check=True).stdout.split()
    assert out == ["128", "64", "True", "_dense_block_xla", "_dense_block_precombined_bwd",
                   "_dense_block_xla_precombined"]
    if not any(k in os.environ for k in ("VUB_PRECOMBINE_MIN_C", "VUB_BWD_PRECOMBINE",
                                         "VUB_DOWN_MATMUL_BWD")):
        assert fa._eager_block_for(1 << 20) is fa._dense_block_xla and not fa._DOWN_MATMUL_BWD
