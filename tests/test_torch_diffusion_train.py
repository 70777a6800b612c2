"""The port's diffusion train step and trainer against the JAX package's.

The step is held to JAX ``make_diffusion_train_step`` over 3 steps of AdamW
(1e-4, wd 1e-4) + StepLR(3, .5) per step-epoch + clip 0.1, accumulation 2,
for uniform and biased timesteps: losses and params rtol 2e-4, the
trajectory tolerance of tests/test_torch_train.py.  Both sides see the same
timesteps: the JAX draws are recomputed from the keys its step splits
(``jax.random.split(key, acc)`` -> ``sample_timesteps``) and handed to the
port's step in place of its generator's.  The U-Net is one 3x3 conv on
[x, t plane] plus x: the step is generic in its U-Net, and a JAX RDUNetT's
gradient takes ~15 s to compile here; the RDUNetT engines are held to each
other through the trainer below.  The JAX reference compiles once, at XLA's
lowest backend optimization level, at HIGHEST precision."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_rdunet import one_thread  # noqa: F401 — an autouse fixture
from vub_image_denoising_tpu.diffusion import InterpolationDiffusion as JDiffusion
from vub_image_denoising_tpu.train import TrainState as JTrainState
from vub_image_denoising_tpu.train import schedules as js
from vub_image_denoising_tpu.train import diffusion as jd
from vub_image_denoising_tpu_torch.diffusion import InterpolationDiffusion
from vub_image_denoising_tpu_torch.train import (DiffusionTrainer, TrainState, make_optimizer,
                                                 sample_timesteps)
from vub_image_denoising_tpu_torch.train import diffusion as pd

STEPS, N, T, ACC = 3, 4, 4, 2
DISTRIBUTIONS = ("uniform", "biased")


def jax_unet(p, x, t):
    plane = jnp.broadcast_to(t.reshape(-1, 1, 1, 1).astype(x.dtype), x.shape[:3] + (1,))
    y = jax.lax.conv_general_dilated(jnp.concatenate([x, plane], -1), p["w"], (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return y + p["b"] + x


def port_unet(p, x, t):
    plane = t.reshape(-1, 1, 1, 1).to(x.dtype).expand(x.shape[0], 1, *x.shape[2:])
    return F.conv2d(torch.cat([x, plane], 1), p["w"], p["b"], padding=1) + x


@pytest.fixture(scope="module")
def jax_trajectories():
    """STEPS JAX steps from one init per distribution, with each step's
    micro-batch timesteps, in one compiled function."""
    rng = np.random.RandomState(1)
    init = {"w": (rng.randn(3, 3, 4, 3) * 0.2).astype(np.float32),
            "b": rng.uniform(-0.1, 0.1, 3).astype(np.float32)}
    noisy = rng.uniform(-1, 1, (STEPS, N, 16, 16, 3)).astype(np.float32)
    clean = np.clip(noisy + 0.3 * rng.randn(*noisy.shape), -1, 1).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), STEPS)
    tx = js.make_optimizer("adamw", 1e-4, 1e-4, "step", steps_per_epoch=1, clip_norm=0.1)

    def trajectory(state, dist):
        step = jd.make_diffusion_train_step(jax_unet, JDiffusion(T), tx, accumulation_steps=ACC,
                                            distribution=dist)

        def body(st, xs):
            key, nz, cl = xs
            st, loss = step(st, key, nz, cl)
            draws = jax.vmap(lambda k: jd.sample_timesteps(k, N // ACC, T, dist))(
                jax.random.split(key, ACC))
            return st, (loss, draws)

        return jax.lax.scan(body, state, (keys, noisy, clean))

    state = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, init), tx)
    with jax.default_matmul_precision("highest"):
        run = jax.jit(lambda s: [trajectory(s, d) for d in DISTRIBUTIONS]).lower(state).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    out = {}
    for dist, (final, (losses, draws)) in zip(DISTRIBUTIONS, run(state)):
        out[dist] = {"losses": np.asarray(losses), "draws": np.asarray(draws),
                     "params": jax.tree_util.tree_map(np.asarray, final.params)}
    return init, noisy, clean, out


@pytest.mark.parametrize("dist", DISTRIBUTIONS)
def test_diffusion_step_trajectory_matches_jax(jax_trajectories, dist, monkeypatch):
    init, noisy, clean, ref = jax_trajectories
    draws = iter(ref[dist]["draws"].reshape(STEPS * ACC, N // ACC).copy())

    def same_draws(generator, n, timesteps, distribution):
        assert (n, timesteps, distribution) == (N // ACC, T, dist)
        return torch.from_numpy(next(draws))

    monkeypatch.setattr(pd, "sample_timesteps", same_draws)
    params = {"w": torch.from_numpy(init["w"].transpose(3, 2, 0, 1).copy()).requires_grad_(),
              "b": torch.from_numpy(init["b"].copy()).requires_grad_()}
    state = TrainState.create(params, make_optimizer("adamw", 1e-4, 1e-4, "step",
                                                     steps_per_epoch=1, clip_norm=0.1))
    step = pd.make_diffusion_train_step(port_unet, InterpolationDiffusion(T), ACC,
                                        distribution=dist)
    losses = []
    for nz, cl in zip(noisy, clean):
        state, loss = step(state, None, torch.from_numpy(nz).permute(0, 3, 1, 2),
                           torch.from_numpy(cl).permute(0, 3, 1, 2))
        losses.append(loss.item())
    assert state.step == STEPS
    np.testing.assert_allclose(losses, ref[dist]["losses"], rtol=2e-4)
    np.testing.assert_allclose(params["w"].detach().numpy(),
                               ref[dist]["params"]["w"].transpose(3, 2, 0, 1), rtol=2e-4)
    np.testing.assert_allclose(params["b"].detach().numpy(), ref[dist]["params"]["b"], rtol=2e-4)


def test_sample_timesteps_ranges_and_seeding():
    """Uniform: integers in [0, T]; biased: Beta(2, 1)*T in [0, T] (mean 2T/3,
    second moment T^2/2); the same seed gives the same draws."""
    steps = 20
    for dist in DISTRIBUTIONS:
        a = sample_timesteps(torch.Generator().manual_seed(3), 200_000, steps, dist)
        b = sample_timesteps(torch.Generator().manual_seed(3), 200_000, steps, dist)
        assert a.dtype == torch.float32 and torch.equal(a, b)
        assert a.min().item() >= 0 and a.max().item() <= steps
    u = sample_timesteps(torch.Generator().manual_seed(4), 200_000, steps, "uniform")
    assert torch.equal(u, u.round()) and set(u.unique().tolist()) == set(range(steps + 1))
    beta = sample_timesteps(torch.Generator().manual_seed(5), 200_000, steps, "biased") / steps
    np.testing.assert_allclose(beta.mean().item(), 2 / 3, atol=3e-3)
    np.testing.assert_allclose((beta**2).mean().item(), 1 / 2, atol=3e-3)


def test_diffusion_trainer_engines_take_the_same_step():
    """One DiffusionTrainer step on RDUNetT from the same seed (weights and
    timesteps): the module path, the eager engine and the kernel engine
    (plain on the CPU) agree; validation runs the sampler, or with
    ``sampling="direct"`` one U-Net call at t = 1."""
    rng = np.random.RandomState(2)
    clean = torch.from_numpy(rng.uniform(-1, 1, (4, 3, 16, 16)).astype(np.float32))
    noisy = clean + 0.2 * torch.from_numpy(rng.randn(4, 3, 16, 16).astype(np.float32))
    results = {}
    for engine in ("flax", "xla", "pallas"):
        trainer = DiffusionTrainer(base_filters=4, timesteps=T, accumulation_steps=ACC,
                                   engine=engine, device="cpu")
        state = trainer.init(steps_per_epoch=1, seed=7)
        state, loss = trainer.train_epoch(state, [(noisy, clean)])
        assert np.isfinite(loss) and state.step == 1
        results[engine] = (loss, {k: v.detach().clone() for k, v in state.params.items()})
    for engine in ("xla", "pallas"):
        np.testing.assert_allclose(results[engine][0], results["flax"][0], rtol=1e-5)
        for k, v in results[engine][1].items():
            np.testing.assert_allclose(v.numpy(), results["flax"][1][k].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    vloss, denoised = trainer.validate(state, [(noisy, clean)])
    assert np.isfinite(vloss) and denoised.shape == noisy.shape
    direct = DiffusionTrainer(base_filters=4, timesteps=T, sampling="direct", device="cpu")
    state = direct.init(steps_per_epoch=1, seed=7)
    with torch.no_grad():
        want = direct.unet(noisy, torch.ones(4))
    np.testing.assert_array_equal(direct.validate(state, [(noisy, clean)])[1].numpy(),
                                  want.numpy())


def test_diffusion_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiffusionTrainer().init(steps_per_epoch=1)
    with pytest.raises(ValueError, match="unknown engine"):
        DiffusionTrainer(engine="auto", device="cpu").init(steps_per_epoch=1)
    with pytest.raises(ValueError, match="unknown sampling"):
        DiffusionTrainer(sampling="ddpm", device="cpu").init(steps_per_epoch=1)
