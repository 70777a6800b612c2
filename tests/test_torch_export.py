"""The port's torch.export artifacts (eval/export.py) against the JAX package.

Mirrors ``tests/test_export.py``'s four cases on the CPU: one artifact at two
batch sizes against the JAX model's ``apply`` on the same weights (carried
with ``params_to_state_dict``; 2e-4, the full-model tolerance of
``tests/test_model_torch_parity.py``), the sampler against JAX's
``improved_sampling``, the command line, and the grayscale-diffusion error.
On the CPU each DenoisingBlock is one node of the kernel operator
``vub_torch::fused_denoising_block`` too, which runs the plain block there;
the card's artifacts launch kernel 1 (``tests/test_torch_cuda.py``).  The
JAX references compile at XLA's lowest backend optimization level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_apply import numpy_params_like, run_jax
from test_torch_rdunet import one_thread  # noqa: F401 — autouse
from vub_image_denoising_tpu.diffusion import InterpolationDiffusion as JDiffusion
from vub_image_denoising_tpu.models.rdunet import RDUNet as JRDUNet
from vub_image_denoising_tpu.models.rdunet import RDUNetT as JRDUNetT
from vub_image_denoising_tpu_torch.eval import export as export_cli
from vub_image_denoising_tpu_torch.eval.export import (build_exported, kernel_nodes,
                                                       load_exported, save_exported)
from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict, save_pth

SIZE, TOL, T = 16, 2e-4, 2


def _save_ckpt(tmp_path, name, model, seed, *example, prefix=""):
    params = numpy_params_like(jax.eval_shape(model.init, jax.random.PRNGKey(0), *example), seed)
    path = str(tmp_path / name)
    save_pth(path, params_to_state_dict(params), epoch=1, prefix=prefix)
    return path, params


@pytest.fixture(scope="module")
def rdunet_ck(tmp_path_factory):
    model = JRDUNet(channels=3, base_filters=4)
    ck, params = _save_ckpt(tmp_path_factory.mktemp("export"), "m.pth", model, 0,
                            jnp.zeros((1, SIZE, SIZE, 3)))
    return model, ck, params


def test_export_roundtrip_matches_jax_model_and_batch_is_symbolic(rdunet_ck, tmp_path):
    model, ck, params = rdunet_ck
    exported = build_exported(ck, arch="rdunet", base_filters=4, size=SIZE, platforms=("cpu",))
    assert kernel_nodes(exported["cpu"]) == 14
    fn = load_exported(save_exported(exported, str(tmp_path / "m.pt2")))
    rng = np.random.RandomState(1)
    for batch in (2, 5):  # symbolic batch: one artifact, any N
        x = rng.uniform(-1, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)
        want = np.asarray(run_jax(model.apply, params, jnp.asarray(x)))
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want, rtol=TOL, atol=TOL)


def test_export_diffusion_sampler(tmp_path):
    unet = JRDUNetT(base_filters=4)
    ck, params = _save_ckpt(tmp_path, "d.pth", unet, 1, jnp.zeros((1, SIZE, SIZE, 3)),
                            jnp.zeros((1,)), prefix="unet.")
    exported = build_exported(ck, arch="diffusion", base_filters=4, timesteps=T, size=SIZE,
                              platforms=("cpu",))
    assert kernel_nodes(exported["cpu"]) == 14 * T
    fn = load_exported(save_exported(exported, str(tmp_path / "d.pt2")))
    x = np.random.RandomState(2).uniform(-1, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
    diff = JDiffusion(timesteps=T)
    want = np.asarray(run_jax(lambda p, n: diff.improved_sampling(unet.apply, p, n), params,
                              jnp.asarray(x)))
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want, rtol=TOL, atol=TOL)


def test_export_cli(rdunet_ck, tmp_path):
    _, ck, _ = rdunet_ck
    out = str(tmp_path / "cli.pt2")
    export_cli.main(["--checkpoint", ck, "--arch", "rdunet", "--base-filters", "4",
                     "--size", str(SIZE), "--platforms", "cpu", "--fixed-batch", "--out", out])
    fn = load_exported(out)
    y = fn(torch.zeros(1, SIZE, SIZE, 3))
    assert y.shape == (1, SIZE, SIZE, 3) and torch.isfinite(y).all()
    with pytest.raises(Exception):  # --fixed-batch: the batch is 1
        fn(torch.zeros(3, SIZE, SIZE, 3))


def test_export_diffusion_grayscale_raises_clearly(tmp_path):
    """The shared build_apply guard (denoise_cli.py) fires here too: a clear
    ValueError, not a conv shape error mid-trace."""
    ck, _ = _save_ckpt(tmp_path, "d.pth", JRDUNetT(base_filters=4), 3,
                       jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1,)), prefix="unet.")
    with pytest.raises(ValueError, match="requires RGB"):
        build_exported(ck, arch="diffusion", base_filters=4, size=SIZE, channels=1,
                       platforms=("cpu",))
