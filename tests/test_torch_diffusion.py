"""The port's diffusion losses, interpolation-diffusion sampler and ``unet.``-prefixed
``.pth`` IO against the JAX package's.

One tiny RDUNetT (base 4, numpy weights) is carried to the port with
params_to_state_dict.  Tolerances: the losses rtol 1e-5 (SSIM's identity
case atol 1e-6, as tests/test_losses.py); the samplers atol = rtol = 1e-4,
the JAX package's own batched-against-sequential tolerance
(tests/test_diffusion.py).  The JAX references compile once, at XLA's lowest
backend optimization level, with f32 matmuls and convs at HIGHEST
precision."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_apply import nchw, nhwc, numpy_params_like, run_jax
from test_torch_rdunet import one_thread  # noqa: F401 — an autouse fixture
from vub_image_denoising_tpu.diffusion import InterpolationDiffusion as JDiffusion
from vub_image_denoising_tpu.diffusion import losses as jl
from vub_image_denoising_tpu.models.rdunet import RDUNetT as JRDUNetT
from vub_image_denoising_tpu.utils import checkpoint as jax_ckpt
from vub_image_denoising_tpu_torch.diffusion import (InterpolationDiffusion, charbonnier_loss,
                                                     combined_loss, ssim)
from vub_image_denoising_tpu_torch.models import RDUNetT
from vub_image_denoising_tpu_torch.utils import checkpoint as ckpt
from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict

SAMPLER_TOL = dict(rtol=1e-4, atol=1e-4)
T = 3


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(0)
    a = rng.rand(2, 24, 24, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("weights", [(0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                                     (0.5, 1.0, 0.25)])
def test_combined_loss_matches_jax(images, weights):
    """Each term alone and all three together."""
    a, b = images
    mse_w, charb_w, ssim_w = weights
    want = run_jax(lambda p, q: jl.combined_loss(p, q, mse_w, charb_w, ssim_w), a, b)
    got = combined_loss(nchw(a), nchw(b), mse_w, charb_w, ssim_w)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_charbonnier_and_ssim_match_jax(images):
    a, b = images
    want_charb, want_ssim = run_jax(lambda p, q: (jl.charbonnier_loss(p, q), jl.ssim(p, q)), a, b)
    np.testing.assert_allclose(charbonnier_loss(nchw(a), nchw(b)).item(), float(want_charb),
                               rtol=1e-5)
    np.testing.assert_allclose(ssim(nchw(a), nchw(b)).item(), float(want_ssim), rtol=1e-5)
    np.testing.assert_allclose(ssim(nchw(a), nchw(a)).item(), 1.0, atol=1e-6)


@pytest.fixture(scope="module")
def sampler():
    """A tiny RDUNetT in both packages, and the references from one compiled
    JAX ``forward`` on the stack [x; x] with t = [T, T, 1, 2]: at t = T the
    interpolation is x itself (alpha = 1), so the first two images are
    ``improved_sampling(x)``; the last two are ``forward`` at t = 1 and 2."""
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    clean = np.clip(x + 0.2 * rng.randn(*x.shape), -1, 1).astype(np.float32)
    t4 = np.array([T, T, 1.0, 2.0], np.float32)
    jt = JRDUNetT(4)
    vt = numpy_params_like(jax.eval_shape(jt.init, jax.random.PRNGKey(0), x, t4[:2]), 6)
    want = run_jax(lambda v: JDiffusion(timesteps=T).forward(
        jt.apply, v, np.concatenate([clean, clean]), np.concatenate([x, x]), t4),
        jax.tree_util.tree_map(jnp.asarray, vt))
    model = RDUNetT(4)
    model.load_state_dict(params_to_state_dict(vt), strict=True)
    return {"x": x, "clean": clean, "t": t4[2:], "model": model.eval(), "params": vt,
            "sample": np.asarray(want[:2]), "forward": np.asarray(want[2:])}


def test_improved_sampling_matches_jax(sampler):
    with torch.no_grad():
        got = InterpolationDiffusion(T).improved_sampling(sampler["model"], nchw(sampler["x"]))
    np.testing.assert_allclose(nhwc(got), sampler["sample"], **SAMPLER_TOL)


def test_forward_matches_jax(sampler):
    with torch.no_grad():
        got = InterpolationDiffusion(T).forward(sampler["model"], nchw(sampler["clean"]),
                                                nchw(sampler["x"]), torch.from_numpy(sampler["t"]))
    np.testing.assert_allclose(nhwc(got), sampler["forward"], **SAMPLER_TOL)


def test_batched_sampler_matches_sequential(sampler):
    """One call on the 2N stack per step against two calls per step, and the
    stack really is 2N."""
    diff = InterpolationDiffusion(T)
    calls = []

    def unet(x, t):
        calls.append((x.shape[0], t.tolist()))
        return sampler["model"](x, t)

    with torch.no_grad():
        a = diff.improved_sampling(unet, nchw(sampler["x"]))
        alphas = np.float32([3, 2, 1, 0]) / np.float32(T)
        assert calls == [(4, np.repeat(alphas[i:i + 2], 2).tolist()) for i in range(T)]
        b = diff.improved_sampling_sequential(sampler["model"], nchw(sampler["x"]))
    np.testing.assert_allclose(a.numpy(), b.numpy(), **SAMPLER_TOL)


def test_improved_sampling_reference_math():
    """The update rule against a literal loop of the reference with an affine 'net'."""
    w, steps = 0.7, 5
    noisy = np.random.RandomState(0).randn(2, 3, 4, 4).astype(np.float32)
    got = InterpolationDiffusion(steps).improved_sampling(
        lambda x, t: w * x + t.view(-1, 1, 1, 1), torch.from_numpy(noisy))
    x_t = noisy
    for t in reversed(range(1, steps + 1)):
        a_t, a_p = t / steps, (t - 1) / steps
        x_tilde = (1 - a_t) * (w * x_t + a_t) + a_t * noisy
        x_tilde_prev = (1 - a_p) * (w * x_t + a_p) + a_p * noisy
        x_t = x_t - x_tilde + x_tilde_prev
    np.testing.assert_allclose(got.numpy(), x_t, rtol=1e-5, atol=1e-5)


def test_forward_diffusion_endpoints():
    diff = InterpolationDiffusion(timesteps=20)
    clean, noisy = torch.zeros(2, 3, 8, 8), torch.ones(2, 3, 8, 8)
    np.testing.assert_array_equal(diff.forward_diffusion(clean, noisy, 0.0).numpy(), 0.0)
    np.testing.assert_array_equal(diff.forward_diffusion(clean, noisy, 20.0).numpy(), 1.0)
    mid = diff.forward_diffusion(clean, noisy, torch.tensor([10.0, 20.0])).numpy()
    np.testing.assert_array_equal(mid[0], 0.5)
    np.testing.assert_array_equal(mid[1], 1.0)


def test_direct_sampling_is_one_call_at_t1():
    calls = []

    def unet(x, t):
        calls.append(t)
        return x * 2.0

    out = InterpolationDiffusion(timesteps=20).direct_sampling(unet, torch.ones(3, 3, 4, 4))
    np.testing.assert_array_equal(out.numpy(), 2.0)
    assert len(calls) == 1
    assert calls[0].tolist() == [1.0, 1.0, 1.0]


def test_sampler_schedule_is_exact_in_bf16():
    """The schedule and the state stay f32 under bf16 activations: with a
    zero U-Net the update telescopes to x - noisy = 0 (f32 leaves ~T*eps32,
    a bf16 state O(1e-2)); the U-Net sees bf16 inputs, and the result is
    bf16 (tests/test_diffusion.py)."""
    steps = 300

    def zero_unet(x2, t2):
        assert x2.dtype == torch.bfloat16 and t2.dtype == torch.bfloat16
        return torch.zeros_like(x2)

    gen = torch.Generator().manual_seed(0)
    noisy = (torch.randn(1, 3, 4, 4, generator=gen) * 0.5).to(torch.bfloat16)
    out = InterpolationDiffusion(steps).improved_sampling(zero_unet, noisy)
    assert out.dtype == torch.bfloat16
    assert out.float().abs().max().item() < 1e-3


def test_diffusion_pth_interop_both_ways(sampler, tmp_path):
    """A diffusion .pth as the JAX trainer writes one (``unet.`` keys, the
    optimizer state as tensors beside them) loads into the port, and the
    port's loads into the JAX package."""
    params = sampler["params"]
    ck = str(tmp_path / "jax.pth")
    jax_ckpt.save_pth(ck, params, epoch=2, prefix="unet.", extra={
        "optimizer_state_dict": {}, "scheduler_state_dict": {},
        # a stand-in for the AdamW state: the leaves of a tree, as tensors
        "optax_leaves": jax_ckpt.optax_state_to_safe(params)})
    model, payload = ckpt.load_pth(ck, RDUNetT(4), prefix="unet.")
    assert payload["epoch"] == 2
    want = params_to_state_dict(params)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    ck2 = str(tmp_path / "port.pth")
    ckpt.save_pth(ck2, model.state_dict(), epoch=4, prefix="unet.")
    assert all(k.startswith("unet.") for k in torch.load(ck2)["model_state_dict"])
    back, payload2 = jax_ckpt.load_pth(ck2, params, prefix="unet.")
    assert payload2["epoch"] == 4
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_load_pth_rejects_a_key_without_the_prefix(tmp_path):
    ck = str(tmp_path / "bare.pth")
    sd = RDUNetT(4).state_dict()
    ckpt.save_pth(ck, sd)
    with pytest.raises(KeyError, match="without the prefix 'unet.'"):
        ckpt.load_pth(ck, RDUNetT(4), prefix="unet.")
    ckpt.save_pth(ck, {**{"unet." + k: v for k, v in sd.items()},
                       "conv.weight": sd["input_block.conv_1.weight"]})
    with pytest.raises(KeyError, match="conv.weight"):
        ckpt.load_pth(ck, RDUNetT(4), prefix="unet.")
