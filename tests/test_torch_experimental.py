"""The port's DDPM machinery, diffusion-GAN hybrid and legacy UNet_S against
the JAX package's (``models/experimental.py``), on the CPU, and one round
of the hybrid trained by ``RCAGANTrainer`` from JAX's ``weights_init_normal``
weights.

The hybrid's random timesteps and q_sample noise are JAX's draws, handed to
the port.  JAX compiles at XLA's lowest backend optimization level, matmuls
and convs at HIGHEST.  Sizes 2 x 32^2 x 1 (UNet_S: 2 x 16^2 x 3), 10
diffusion steps.  Tolerances as tests/test_torch_gan.py: schedules rtol
1e-5 / atol 5e-8; forwards 2e-4 max abs (the hybrid's held to an f64
forward where f32 rounding exceeds that, ``assert_forward_near``); the
round's losses, statistics and gradients as there (``assert_losses_near``,
``assert_stats``, ``assert_grads_near``): with weights_init_normal's
N(0, 0.02) conv weights beside the default biases, most of the hybrid's
conv outputs are bias, so its round is the family's worst conditioned in f32.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gan import (FWD_TOL, _eps, _jax_trainer, _rand, _round_inputs, assert_grads_near,
                            assert_losses_near, assert_stats, compile_o0, exact_copy,
                            frozen_optimizers, jax_round, jax_vars, nchw, nhwc, port_round,
                            run_o0)
from test_torch_rdunet import one_thread  # noqa: F401 — autouse
from vub_image_denoising_tpu.models import experimental as jexp
from vub_image_denoising_tpu.train.gan import weights_init_normal as jax_weights_init_normal
from vub_image_denoising_tpu_torch.models import experimental as pexp
from vub_image_denoising_tpu_torch.train import gan as pgan
from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict

T = 10


def test_gaussian_diffusion_schedules_match_jax():
    for args in ((1e-4, 0.02, 100), (1e-4, 0.02, 1000)):
        p, j = pexp.GaussianDiffusion(*args), jexp.GaussianDiffusion(*args)
        # alpha cumprod, a product of up to 1000 factors near 1, is rounded in
        # another order by each package (1 ulp apart), which moves 1 - acp, so
        # the posterior variance, by up to 1e-4 of itself at small t: atol 5e-8
        for name in ("betas", "alpha_cumprod", "alpha_cumprod_prev", "posterior_variance"):
            np.testing.assert_allclose(getattr(p, name).numpy(), np.asarray(getattr(j, name)),
                                       rtol=1e-5, atol=5e-8, err_msg=name)
    gd = pexp.GaussianDiffusion(num_timesteps=50)
    x0, noise = nchw(_rand(2, 8, 8, 1)), nchw(_rand(2, 9, 8, 1)[:, 1:])
    t = torch.tensor([3, 41])
    xt = gd.q_sample(x0, t, noise)
    want = jexp.GaussianDiffusion(num_timesteps=50).q_sample(
        jnp.array(nhwc(x0), jnp.float32), jnp.array([3, 41]), jnp.array(nhwc(noise), jnp.float32))
    np.testing.assert_allclose(nhwc(xt), np.asarray(want), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gd.predict_start_from_noise(xt, t, noise), x0, rtol=1e-4,
                               atol=1e-5)
    assert gd.p_losses(lambda xn, tt: noise, x0, t, noise).item() == 0.0


def test_small_unet_and_unet_s_match_jax():
    """SmallUNet ignores t; UNet_S conditions on a t plane, with and without
    remat (whose gradients equal the plain ones)."""
    x = _rand(2, 16, 16, 64) * 0.3
    su = pexp.SmallUNet(64, 64, generator=torch.Generator().manual_seed(0))
    jsu = jexp.SmallUNet(64)
    want = run_o0(lambda v, x: jsu.apply(v, x), jax_vars(jsu, su.state_dict(), jnp.array(x)),
                  jnp.array(x))
    np.testing.assert_allclose(nhwc(su(nchw(x), torch.tensor([1, 2]))), np.asarray(want),
                               atol=FWD_TOL, rtol=0)

    x, t = _rand(2, 16, 16, 3), np.array([0.25, 0.75], np.float32)
    grads = []
    for remat in (False, True):
        m = pexp.UNetS(remat=remat, generator=torch.Generator().manual_seed(1))
        jm = jexp.UNetS(remat=remat)
        want = run_o0(lambda v, x, t: jm.apply(v, x, t),
                      jax_vars(jm, m.state_dict(), jnp.array(x), jnp.array(t)),
                      jnp.array(x), jnp.array(t))
        y = m(nchw(x), torch.from_numpy(t))
        assert y.shape == (2, 3, 16, 16)
        np.testing.assert_allclose(nhwc(y), np.asarray(want), atol=FWD_TOL, rtol=0)
        y.square().sum().backward()
        grads.append([p.grad for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def _hybrid_draws(key, att_shape_nhwc):
    """(t, noise NCHW) as GeneratorWithDiffusion draws them from ``key``."""
    k_t, k_noise = jax.random.split(key)
    t = np.asarray(jax.random.randint(k_t, (att_shape_nhwc[0],), 0, T))
    noise = np.asarray(jax.random.normal(k_noise, att_shape_nhwc))
    return torch.from_numpy(t.astype(np.int64)), nchw(noise)


def test_generator_with_diffusion_matches_jax_with_the_same_draws():
    g = pexp.GeneratorWithDiffusion(1, 1, num_timesteps=T,
                                    generator=torch.Generator().manual_seed(2))
    jg = jexp.GeneratorWithDiffusion(1, 1, num_timesteps=T)
    x, key = _rand(2, 32, 32, 1) * 0.1, jax.random.PRNGKey(4)
    jv = jax_vars(jg, g.state_dict(), jnp.array(x), key, train=False)

    def fwd(v, x, key):
        y, m = jg.apply(v, x, key, train=True, mutable=["batch_stats"])
        return y, m["batch_stats"], jg.apply(v, x, key, train=False)

    y_train, stats, y_eval = run_o0(fwd, jv, jnp.array(x), key)
    t, noise = _hybrid_draws(key, (2, 32, 32, 64))
    g64 = copy.deepcopy(g).double()
    with torch.no_grad():
        for mode, want in (("eval", y_eval), ("train", y_train)):
            g.train(mode == "train"), g64.train(mode == "train")
            y = g(nchw(x), t=t, noise=noise)
            assert_forward_near(nhwc(y), np.asarray(want),
                                nhwc(g64(nchw(x).double(), t=t, noise=noise.double())))
    assert y.shape == (2, 1, 32, 32) and y.abs().max().item() <= 1.0
    assert_stats(g, stats)
    gen = torch.Generator().manual_seed(0)  # its own draws: t in [0, T), noise of att's shape
    t, noise = g.draw(2, (2, 64, 32, 32), "cpu", torch.float32, gen)
    assert t.min() >= 0 and t.max() < T and noise.shape == (2, 64, 32, 32)


def assert_forward_near(port, jx, exact):
    """Max abs 2e-4, or, where the f32 rounding of the forward is larger (the
    hybrid's f32 outputs are up to 3e-4 from an f64 forward in either
    package), the JAX output no farther from the exact one than twice the
    port's."""
    if np.abs(port - jx).max() <= FWD_TOL:
        return
    assert np.abs(jx - exact).max() <= 2 * np.abs(port - exact).max() <= 2e-3


def test_weights_init_normal_semantics():
    """Conv (4-D) weights N(0, 0.02); BatchNorm weight N(1, 0.02), bias 0;
    Linear weights and conv biases untouched."""
    d = pgan.Discriminator(1, input_hw=32, generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in d.state_dict().items()}
    pgan.weights_init_normal(d, torch.Generator().manual_seed(1))
    w = torch.cat([p.flatten() for n, p in d.named_parameters()
                   if n.endswith("conv.weight")])
    assert abs(w.std().item() - 0.02) < 1e-3 and abs(w.mean().item()) < 1e-3
    bn_w = torch.cat([p for n, p in d.named_parameters() if n.endswith("bn.weight")])
    assert abs(bn_w.mean().item() - 1) < 3e-3 and abs(bn_w.std().item() - 0.02) < 3e-3
    for n, p in d.named_parameters():
        if n.endswith("bn.bias"):
            assert torch.all(p == 0)
        if n.startswith("fc_layers") or n.endswith("conv.bias"):
            assert torch.equal(p, before[n]), n


def test_hybrid_round_matches_jax_from_jax_weights_init_normal(tmp_path):
    """RCAGANTrainer(generator=GeneratorWithDiffusion): both nets take JAX's
    weights_init_normal draws (carried across), then one D step + one G step
    with JAX's timesteps, noise and penalty draws against JAX's, held as
    tests/test_torch_gan.py holds the RCA-GAN's round."""
    x, y = _round_inputs()
    hybrid = lambda seed: pexp.GeneratorWithDiffusion(  # noqa: E731
        1, 1, num_timesteps=T, generator=torch.Generator().manual_seed(seed))
    trainer = pgan.RCAGANTrainer(disc_input_hw=32, device="cpu", checkpoint_dir=str(tmp_path),
                                 generator=hybrid(2))
    state = trainer.init(steps_per_epoch=1)
    jt, jstate = _jax_trainer(trainer, state, x, tmp_path,
                              generator=jexp.GeneratorWithDiffusion(1, 1, num_timesteps=T))
    ki, kd_init = jax.random.split(jax.random.PRNGKey(1))
    init = lambda p, k: compile_o0(jax_weights_init_normal, p, k)(p, k)  # noqa: E731
    jstate = jstate.replace(g_params=init(jstate.g_params, ki),
                            d_params=init(jstate.d_params, kd_init))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    state.generator.load_state_dict(params_to_state_dict(
        {"params": tree(jstate.g_params), "batch_stats": tree(jstate.g_stats)}), strict=True)
    state.discriminator.load_state_dict(params_to_state_dict(
        {"params": tree(jstate.d_params), "batch_stats": tree(jstate.d_stats)}), strict=True)
    frozen_optimizers(state)
    trainer64, state64 = exact_copy(pgan.RCAGANTrainer, state, trainer.vgg, tmp_path,
                                    disc_input_hw=32, generator=hybrid(3))

    kd, kg = jax.random.PRNGKey(2), jax.random.PRNGKey(3)
    jstate, jlosses, jd_grads, jg_grads = jax_round(jt, jstate, kd, kg, x, y)
    draws = {"eps": (_eps(kd), _eps(kg)),
             "g_draws": tuple(_hybrid_draws(jax.random.split(k)[0], (2, 32, 32, 64))
                              for k in (kd, kg))}
    losses, d_grads, g_grads = port_round(trainer, state, x, y, **draws)
    losses64, d64, g64 = port_round(trainer64, state64, x, y, **draws)
    assert_losses_near(losses, jlosses, losses64)
    assert_stats(state.generator, jstate.g_stats, state64.generator)
    assert_stats(state.discriminator, jstate.d_stats, state64.discriminator)
    assert_grads_near(d_grads, jd_grads, d64)
    assert_grads_near(g_grads, jg_grads, g64)


def test_train_rca_gan_diffusion_entry_point(tmp_path):
    """The hybrid's train_rca_gan: one epoch on the CPU from NCHW pairs,
    finite losses, one G step taken."""
    rs = np.random.RandomState(0)
    batch = tuple(torch.from_numpy((rs.randn(2, 1, 32, 32) * 0.1).astype(np.float32))
                  for _ in range(2))
    state, history = pgan.train_rca_gan_diffusion(
        [batch], [batch], num_epochs=1, checkpoint_dir=str(tmp_path), num_timesteps=T,
        device="cpu")
    assert len(history) == 1 and np.isfinite(
        [history[0]["d_loss"], history[0]["g_loss"], history[0]["val_loss"]]).all()
    assert state.step == 1


def test_gan_trainers_default_to_the_card(monkeypatch):
    """Without CUDA the trainers raise unless the CPU is asked for."""
    from vub_image_denoising_tpu_torch.train.denoising_gan import DenoisingGANTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (pgan.RCAGANTrainer, DenoisingGANTrainer):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls()
