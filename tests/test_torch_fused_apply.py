"""The port's fused engine, differentiable block and RDUNetT against the JAX package's.

Weights are drawn with numpy as JAX param trees and carried to the port with
params_to_state_dict.  On the CPU the block kernels run their plain
versions, so these tests hold the engine's plumbing and the autograd
Function to the JAX functions; the kernels are held to the plain versions on
the card (tests/test_torch_cuda.py).  Tolerances are those of
tests/test_fused_apply.py: model outputs rtol 1e-4 / atol 1e-5; the
trainable block's loss rtol 1e-5 and grads rtol 1e-4 / atol 1e-5.  JAX runs
f32 matmuls at HIGHEST precision.  No JAX model runs in Pallas interpret
mode here: the JAX side is its eager engine and flax forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rdunet import numpy_params, one_thread  # noqa: F401 — autouse
from vub_image_denoising_tpu.models import fused_apply as jfa
from vub_image_denoising_tpu.models.rdunet import RDUNet as JRDUNet
from vub_image_denoising_tpu.models.rdunet import RDUNetT as JRDUNetT
from vub_image_denoising_tpu.nn.blocks import DenoisingBlock as JDenoisingBlock
from vub_image_denoising_tpu_torch.models import RDUNet, RDUNetT
from vub_image_denoising_tpu_torch.models import fused_apply as fa
from vub_image_denoising_tpu_torch.ops import fused_block as fb
from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict

MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BASE = 4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def run_jax(fn, *args):
    """``fn(*args)`` compiled once at XLA's lowest backend optimization level
    (the JAX references are tiny; compile time is most of their cost)."""
    with jax.default_matmul_precision("highest"):
        compiled = jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    return compiled(*args)


def assert_grads_match(port_grads, jax_grad_tree):
    """Port grads (state_dict keys) against a JAX grad tree, carried across
    like the params (HWIO -> OIHW)."""
    want = params_to_state_dict(jax.tree_util.tree_map(np.asarray, jax_grad_tree))
    assert set(port_grads) == set(want)
    for k, g in port_grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("packed", [False, True])
def test_fused_block_trainable_matches_jax_grads(packed):
    """Kernel forward (plain on the CPU), eager-block backward: loss and every
    grad equal jax.value_and_grad of _dense_block_xla."""
    c = 8
    tree = numpy_params(JDenoisingBlock(c, c // 2, c), np.zeros((1, 8, 8, c), np.float32), 0)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 16, c).astype(np.float32)
    target = rng.randn(2, 16, 16, c).astype(np.float32)

    def jax_loss(p, xx):
        return jnp.mean(jnp.abs(jfa._dense_block_xla(p, xx) - target))

    want_loss, (gp, gx) = run_jax(jax.value_and_grad(jax_loss, argnums=(0, 1)),
                                  jnp_tree(tree["params"]), jnp.asarray(x))

    params = {k: v.requires_grad_() for k, v in params_to_state_dict(tree).items()}
    xt = nchw(x).requires_grad_()
    loss = torch.mean(torch.abs(fa.fused_block_trainable(xt, params, packed=packed) - nchw(target)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(gx), **GRAD_TOL)
    assert_grads_match({k: v.grad for k, v in params.items()}, {"params": gp})


def test_fused_block_trainable_grads_only_what_is_asked():
    """x alone requires grad: the backward returns its grad and no others."""
    block = fa.prepare_fused_params(RDUNet(3, BASE).state_dict())["block_0_0"]
    x = torch.randn(1, BASE, 8, 8, requires_grad=True)
    fa.fused_block_trainable(x, block).sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
    assert all(p.grad is None for p in block.values())


@pytest.fixture(scope="module")
def models():
    """A JAX RDUNet and RDUNetT (numpy weights); their outputs on one input
    from flax apply and from the JAX eager engine; the RDUNet's L1 loss
    against a target and its grads (jax.value_and_grad of flax apply); and
    the port's state_dicts."""
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, x.shape).astype(np.float32)
    t = np.array([0.25, 0.75], np.float32)
    jm, jt = JRDUNet(3, BASE), JRDUNetT(BASE)
    v = numpy_params(jm, x, 3)
    vt = numpy_params_like(jax.eval_shape(jt.init, jax.random.PRNGKey(0), x, t), 4)

    def rdunet(v):
        y = jm.apply(v, x)
        return jnp.mean(jnp.abs(y - target)), (y, jfa.rdunet_apply_fused(v, x, engine="xla"))

    (loss, (y_flax, y_xla)), grads = run_jax(jax.value_and_grad(rdunet, has_aux=True), v)
    yt_flax, yt_xla = run_jax(lambda v: (jt.apply(v, x, t), jfa.rdunet_t_apply_fused(
        v, x, t, engine="xla")), vt)
    return {"x": x, "t": t, "target": target, "loss": float(loss), "grads": grads,
            "rdunet": (params_to_state_dict(v), np.asarray(y_flax), np.asarray(y_xla)),
            "rdunet_t": (params_to_state_dict(vt), np.asarray(yt_flax), np.asarray(yt_xla))}


def numpy_params_like(shapes, seed):
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "alpha":
            return np.full(s.shape, 0.25, np.float32)
        if name == "bias":
            return rng.uniform(-0.1, 0.1, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("engine", ["xla", "pallas", "auto"])
def test_rdunet_apply_fused_matches_jax(models, engine):
    sd, want_flax, want_xla = models["rdunet"]
    with torch.no_grad():
        got = nhwc(fa.rdunet_apply_fused(sd, nchw(models["x"]), engine=engine))
    np.testing.assert_allclose(got, want_flax, **MODEL_TOL)
    np.testing.assert_allclose(got, want_xla, **MODEL_TOL)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_rdunet_t_apply_fused_matches_jax(models, engine):
    sd, want_flax, want_xla = models["rdunet_t"]
    x, t = nchw(models["x"]), torch.from_numpy(models["t"])
    with torch.no_grad():
        got = nhwc(fa.rdunet_t_apply_fused(sd, x, t, engine=engine))
        model = RDUNetT(BASE)
        model.load_state_dict(sd, strict=True)
        module = nhwc(model(x, t))
    np.testing.assert_allclose(got, want_flax, **MODEL_TOL)
    np.testing.assert_allclose(got, want_xla, **MODEL_TOL)
    np.testing.assert_allclose(module, want_flax, **MODEL_TOL)


def test_t_plane_forms_agree(models):
    """A scalar, an (N,) vector and an (N, 1, H, W) plane give one result."""
    sd = models["rdunet_t"][0]
    x = nchw(models["x"])
    with torch.no_grad():
        ys = [fa.rdunet_t_apply_fused(sd, x, t, engine="xla")
              for t in (0.5, torch.full((2,), 0.5), torch.full((2, 1, 16, 16), 0.5))]
    for y in ys[1:]:
        torch.testing.assert_close(y, ys[0], rtol=0, atol=0)


def test_rdunet_t_param_count_and_strict_load():
    x = np.zeros((1, 16, 16, 3), np.float32)
    shapes = jax.eval_shape(JRDUNetT(32).init, jax.random.PRNGKey(0), x, np.zeros((1,)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert want == 10_407_142
    model = RDUNetT(32)
    assert sum(p.numel() for p in model.parameters()) == want
    sd = params_to_state_dict(numpy_params_like(shapes, 5))
    model.load_state_dict(sd, strict=True)
    assert model.input_block.conv_1.weight.shape == (32, 4, 3, 3)
    assert model.output_block.conv_2.weight.shape == (3, 32, 3, 3)


def test_module_path_loss_and_grads_match_jax(models):
    """RDUNet's modules train: the loss and every grad through the module
    path (blocks through fused_block_trainable) equal jax.value_and_grad of
    flax RDUNet.apply."""
    x = nchw(models["x"])
    model = RDUNet(3, BASE)
    model.load_state_dict(models["rdunet"][0], strict=True)
    assert type(model.block_0_0(x.new_zeros(1, BASE, 8, 8)).grad_fn).__name__ == \
        "_FusedBlockBackward"
    loss = torch.mean(torch.abs(model(x) - nchw(models["target"])))
    loss.backward()
    np.testing.assert_allclose(loss.item(), models["loss"], rtol=1e-5)
    assert_grads_match({k: p.grad for k, p in model.named_parameters()}, models["grads"])


def test_remat_grads_equal_plain_grads(models):
    sd = {k: v.clone().requires_grad_() for k, v in models["rdunet"][0].items()}
    x = nchw(models["x"])

    def grads(remat):
        loss = (fa.rdunet_apply_fused(sd, x, engine="xla", remat=remat) ** 2).sum()
        return torch.autograd.grad(loss, list(sd.values()))

    for a, b in zip(grads(True), grads(False)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n,h,w", [(8, 512, 512), (32, 256, 256), (33, 256, 256), (1, 2048, 1025)])
def test_auto_engine_is_the_jax_rule(n, h, w):
    """fused_apply.py:321-323: the kernel engine up to 2**21 input pixels."""
    jax_pick = "pallas" if n * h * w <= (1 << 21) else "xla"
    assert fa.pick_engine("auto", torch.empty(n, 3, h, w, device="meta")) == jax_pick
    with pytest.raises(ValueError, match="unknown engine"):
        fa.pick_engine("flax", torch.empty(1, 3, 8, 8, device="meta"))


def test_channel_padded_block_matches_unpadded():
    """pad_block_params + zero-padded input channels == the block on the real
    channels, and the padded channels stay exactly zero (mirrors
    tests/test_fused_apply.py::test_channel_padded_block_matches_unpadded)."""
    cin, cpad = 8, 16
    tree = numpy_params(JDenoisingBlock(cin, 4, cin), np.zeros((1, 8, 8, cin), np.float32), 7)
    x = np.random.RandomState(8).randn(1, 16, 16, cin).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jfa._dense_block_xla(jnp_tree(tree["params"]), jnp.asarray(x)))
    padded = fb.pad_block_params(params_to_state_dict(tree), cpad)
    xp = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, cpad - cin)))
    got = nhwc(fb.fused_denoising_block(nchw(xp), padded))
    np.testing.assert_allclose(got[..., :cin], want, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got[..., cin:], 0.0)


def test_prepare_fused_params_groups_by_module():
    sd = RDUNet(3, BASE).state_dict()
    grouped = fa.prepare_fused_params(sd)
    assert set(grouped) == {k.split(".")[0] for k in sd}
    assert grouped["block_0_0"]["conv_0.weight"] is sd["block_0_0.conv_0.weight"]
    assert fa.prepare_fused_params(grouped) is grouped
