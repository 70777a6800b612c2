"""The port's RDUNet against the JAX package's, on the CPU.

Weights are initialised by the JAX model, carried across with
params_to_state_dict and loaded with strict=True; the forward must match
RDUNet.apply and rdunet_apply_fused(engine="xla") at 2e-4 (the recipe and
tolerance of tests/test_model_torch_parity.py), with f32 matmuls at HIGHEST
precision on the JAX side."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vub_image_denoising_tpu.models.fused_apply import rdunet_apply_fused
from vub_image_denoising_tpu.models.rdunet import RDUNet as JRDUNet
from vub_image_denoising_tpu.utils.checkpoint import params_to_torch_state_dict
from vub_image_denoising_tpu_torch.models import RDUNet
from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict


def numpy_params(model, x, seed):
    """A param tree of ``model`` drawn with numpy from ``seed`` (fan-in scaled
    normal kernels, small uniform biases, alpha 0.25); flax's own init is
    skipped because it takes tens of seconds to compile on the CPU."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "alpha":
            return np.full(s.shape, 0.25, np.float32)
        if name == "bias":
            return rng.uniform(-0.1, 0.1, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module that uses this fixture: the suite
    runs a worker per core, and torch's thread pool on top of those
    multiplies the time of small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried():
    base = 8
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    jmodel = JRDUNet(channels=3, base_filters=base)
    variables = numpy_params(jmodel, x, seed=0)
    with jax.default_matmul_precision("highest"):
        y_flax = np.asarray(jax.jit(jmodel.apply)(variables, x))
        y_xla = np.asarray(jax.jit(lambda v, x: rdunet_apply_fused(v, x, engine="xla"))(
            variables, x))
    model = RDUNet(channels=3, base_filters=base)
    model.load_state_dict(params_to_state_dict(variables), strict=True)
    with torch.no_grad():
        y = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    return {"variables": variables, "model": model, "y": y, "flax": y_flax, "xla": y_xla}


@pytest.mark.parametrize("engine", ["flax", "xla"])
def test_rdunet_matches_jax(carried, engine):
    np.testing.assert_allclose(carried["y"], carried[engine], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("base", [8, 32, 64])
def test_param_count_matches_jax(base):
    shapes = jax.eval_shape(JRDUNet(3, base).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in RDUNet(3, base).parameters()) == want


def test_state_dict_is_reference_layout(carried):
    """Keys and shapes equal the JAX package's own .pth export."""
    want = params_to_torch_state_dict(carried["variables"])
    got = carried["model"].state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        torch.testing.assert_close(got[k], v)


def test_rdunet_runs_14_denoising_blocks(monkeypatch):
    from vub_image_denoising_tpu_torch.nn import blocks

    calls = []
    real = blocks.fused_denoising_block
    monkeypatch.setattr(blocks, "fused_denoising_block",
                        lambda x, p, packed=None: calls.append(x.shape) or real(x, p))
    with torch.no_grad():
        RDUNet(3, 4)(torch.zeros(1, 3, 16, 16))
    assert len(calls) == 14
