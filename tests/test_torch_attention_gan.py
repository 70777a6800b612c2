"""The port's attention-U-Net / PatchGAN denoising GAN against the JAX
package's, on the CPU: the cases of tests/test_attention_gan.py, the
spectral norm's u against flax's, and one training round.

Weights are the port's, carried to JAX with the JAX package's converter; the
spectral norm's u goes to flax's ``SpectralNorm_i/model.j/kernel/u``.  JAX
compiles at XLA's lowest backend optimization level, matmuls and convs at
HIGHEST.  Sizes 2 x 32^2 x 1 (the PatchGAN shape case at 64^2).
Tolerances as tests/test_torch_gan.py: forwards 2e-4 max abs, u after one
forward rtol 1e-5 / atol 1e-7; a round: losses rtol 1e-4, running statistics
and u rtol 1e-4 / atol 1e-6, gradients ``assert_grads_near`` (rtol 1e-4 /
atol 1e-6 * max|g|, or both packages within the per-leaf limits of
tests/test_torch_gan.py of the port's round in f64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_gan import (FWD_TOL, _rand, assert_grads_near, assert_jax_round_trip, assert_stats,
                            capture, compile_o0, exact_copy, frozen_optimizers, grad_sd, jax_vars,
                            nchw, nhwc, run_o0)
from test_torch_rdunet import one_thread  # noqa: F401 — autouse
from vub_image_denoising_tpu.models.attention_unet import AttentionUNet as JUNet
from vub_image_denoising_tpu.models.attention_unet import PatchGAN as JPatchGAN
from vub_image_denoising_tpu.train import denoising_gan as jdg
from vub_image_denoising_tpu.train.gan import GANTrainState as JState
from vub_image_denoising_tpu.utils.checkpoint import torch_state_dict_to_params
from vub_image_denoising_tpu_torch.models.attention_unet import AttentionUNet, PatchGAN
from vub_image_denoising_tpu_torch.train import denoising_gan as pdg
from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict

SIDE = 32
SN_LAYERS = ("model.0", "model.2", "model.5", "model.8")


def patchgan_vars(d, x):
    """flax variables of JAX's PatchGAN from the port's: params and BN stats
    through the converter, each SN layer's u (cout,) -> (1, cout)."""
    jd = JPatchGAN(2)
    template = jax.eval_shape(lambda k: jd.init(k, jnp.array(x), train=False),
                              jax.random.PRNGKey(0))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), template)
    sd = {k: v.detach().clone() for k, v in d.state_dict().items()}
    out = torch_state_dict_to_params(sd, {"params": template["params"]})
    stats = {k: v for k, v in template["batch_stats"].items()
             if not k.startswith("SpectralNorm_")}
    out["batch_stats"] = torch_state_dict_to_params(sd, stats)
    for i, layer in enumerate(SN_LAYERS):
        u = sd[f"{layer}.weight_u"].numpy()[None]
        out["batch_stats"][f"SpectralNorm_{i}"] = {f"{layer}/kernel/u": jnp.asarray(u),
                                                   f"{layer}/kernel/sigma": jnp.ones(())}
    return jd, out


def assert_u(d, jstats, rtol=1e-5, atol=1e-7):
    for i, layer in enumerate(SN_LAYERS):
        want = np.asarray(jstats[f"SpectralNorm_{i}"][f"{layer}/kernel/u"])[0]
        np.testing.assert_allclose(d.state_dict()[f"{layer}.weight_u"].numpy(), want,
                                   rtol=rtol, atol=atol, err_msg=layer)


def test_attention_unet_shape_tanh_and_jax():
    g = AttentionUNet(generator=torch.Generator().manual_seed(0))
    x = _rand(2, SIDE, SIDE, 1) * 0.1
    jg = JUNet()
    jv = jax_vars(jg, g.state_dict(), jnp.array(x), train=False)

    def fwd(v, x):
        y, m = jg.apply(v, x, train=True, mutable=["batch_stats"])
        return y, m["batch_stats"], jg.apply(v, x, train=False)

    y_train, stats, y_eval = run_o0(fwd, jv, jnp.array(x))
    with torch.no_grad():
        g.eval()
        np.testing.assert_allclose(nhwc(g(nchw(x))), np.asarray(y_eval), atol=FWD_TOL, rtol=0)
        g.train()
        y = g(nchw(x))
    assert y.shape == (2, 1, SIDE, SIDE) and y.abs().max().item() <= 1.0
    np.testing.assert_allclose(nhwc(y), np.asarray(y_train), atol=FWD_TOL, rtol=0)
    assert_stats(g, stats)


def test_patchgan_shape_and_spectral_norm_match_flax():
    """3 stride-2 convs + 2 stride-1 k4 p1 convs: 64 -> 8 -> 7 -> 6; sigmoid
    range; the training forward matches flax's and stores flax's new u; an
    eval forward normalizes with the stored u and leaves it."""
    d = PatchGAN(2, generator=torch.Generator().manual_seed(1))
    x = np.concatenate([_rand(2, 64, 64, 1), _rand(2, 65, 64, 1)[:, 1:]], -1) * 0.5
    jd, jv = patchgan_vars(d, x)
    y, mut = run_o0(lambda v, x: jd.apply(v, x, train=True, mutable=["batch_stats"]), jv,
                    jnp.array(x))
    got = d(nchw(x))
    assert got.shape == (2, 1, 6, 6) and 0 <= got.min().item() and got.max().item() <= 1
    np.testing.assert_allclose(nhwc(got), np.asarray(y), atol=FWD_TOL, rtol=0)
    assert_u(d, mut["batch_stats"])
    assert_stats(d, {k: v for k, v in mut["batch_stats"].items()
                     if not k.startswith("SpectralNorm_")})
    d.eval()
    u_before = d.model[0].weight_u.clone()
    jd, jv = patchgan_vars(d, x)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(d(nchw(x))), np.asarray(run_o0(
            lambda v, x: jd.apply(v, x, train=False), jv, jnp.array(x))), atol=FWD_TOL, rtol=0)
    assert torch.equal(d.model[0].weight_u, u_before)


def test_jax_variables_load_strict():
    """The JAX package's variables of both nets (BatchNorm statistics and
    every spectral-norm u, moved by a training forward) load strict through
    params_to_state_dict."""
    x = np.concatenate([_rand(2, SIDE, SIDE, 1), _rand(2, SIDE + 1, SIDE, 1)[:, 1:]], -1) * 0.5
    g = AttentionUNet(generator=torch.Generator().manual_seed(2))
    d = PatchGAN(2, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        g(nchw(x[..., :1]))
        d(nchw(x))
    assert_jax_round_trip(g, jax_vars(JUNet(), g.state_dict(), jnp.array(x[..., :1]),
                                      train=False))
    assert_jax_round_trip(d, patchgan_vars(d, x)[1])


def test_sobel_bce_and_conditional_gp():
    x = _rand(2, 16, 16, 1)
    kx = torch.tensor([[1., 0, -1], [2, 0, -2], [1, 0, -1]]).reshape(1, 1, 3, 3)
    ky = torch.tensor([[1., 2, 1], [0, 0, 0], [-1, -2, -1]]).reshape(1, 1, 3, 3)
    want = torch.sqrt(F.conv2d(nchw(x), kx, padding=1) ** 2
                      + F.conv2d(nchw(x), ky, padding=1) ** 2 + 1e-6)
    torch.testing.assert_close(pdg.sobel_edges(nchw(x)), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(nhwc(pdg.sobel_edges(nchw(x))),
                               np.asarray(jdg.sobel_edges(jnp.array(x))), rtol=1e-4, atol=1e-5)
    y = _rand(2, 17, 16, 1)[:, 1:]
    np.testing.assert_allclose(pdg.edge_loss(nchw(x), nchw(y)).item(),
                               float(jdg.edge_loss(jnp.array(x), jnp.array(y))), rtol=1e-5)

    p = np.random.RandomState(0).rand(4, 6, 6, 1).astype(np.float32) * 0.98 + 0.01
    for target in (0.9, 0.1, 1.0):
        got = pdg.bce(torch.from_numpy(p), target).item()
        assert got == pytest.approx(F.binary_cross_entropy(
            torch.from_numpy(p), torch.full((4, 6, 6, 1), target)).item(), rel=1e-5)
        assert got == pytest.approx(float(jdg.bce(jnp.array(p), target)), rel=1e-5)

    w = torch.from_numpy(_rand(1, 4, 4, 2)).permute(0, 3, 1, 2) * 0.2
    noisy, real, fake = (nchw(_rand(3, 4 + i, 4, 1)[:, i:]) for i in range(3))
    gp = pdg.conditional_gradient_penalty(lambda z: (z * w).sum((1, 2, 3))[:, None],
                                          noisy, real, fake,
                                          generator=torch.Generator().manual_seed(0))
    assert gp.item() == pytest.approx((w.norm().item() - 1) ** 2, rel=1e-4)


def _trainers(tmp_path):
    trainer = pdg.DenoisingGANTrainer(device="cpu", checkpoint_dir=str(tmp_path))
    state = trainer.init(steps_per_epoch=1)
    frozen_optimizers(state)
    return trainer, state


def test_denoising_gan_round_matches_jax(tmp_path):
    """One D step + one G step from the same weights and the penalty's alpha
    (JAX's draw): losses, both nets' gradients, BN statistics and every
    spectral-norm u after the round (u moved by D(real) then D(fake) in the
    D step only; the penalty's D starts from the step's u)."""
    rs = np.random.RandomState(3)
    x, y = ((rs.randn(2, SIDE, SIDE, 1) * 0.1).astype(np.float32) for _ in range(2))
    trainer, state = _trainers(tmp_path)
    trainer64, state64 = exact_copy(pdg.DenoisingGANTrainer, state, trainer.vgg, tmp_path)
    jt = jdg.DenoisingGANTrainer(checkpoint_dir=str(tmp_path))
    gv = jax_vars(jt.generator, state.generator.state_dict(), jnp.array(x), train=False)
    _, dv = patchgan_vars(state.discriminator, np.concatenate([x, x], -1))
    jt.vgg_params = jax_vars(jt.vgg, trainer.vgg.state_dict(), jnp.array(np.tile(x, 3)))
    jt.tx_g, jt.tx_d = capture(), capture()
    jt._build_steps()
    jstate = JState(g_params=gv["params"], g_stats=gv["batch_stats"], d_params=dv["params"],
                    d_stats=dv["batch_stats"], g_opt=jt.tx_g.init(gv["params"]),
                    d_opt=jt.tx_d.init(dv["params"]), step=jnp.zeros((), jnp.int32))
    kd, kg = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    jstate, jd_loss = compile_o0(jt._jit_d_step, jstate, kd, x, y)(jstate, kd, x, y)
    jd_grads = params_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.d_opt["g"]))
    jstate, jg_loss, _ = compile_o0(jt._jit_g_step, jstate, kg, x, y, jt.vgg_params)(
        jstate, kg, x, y, jt.vgg_params)
    jg_grads = params_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.g_opt["g"]))

    alpha = torch.from_numpy(np.array(jax.random.uniform(kd, (2, 1, 1, 1))))
    d_loss = trainer.d_step(state, nchw(x), nchw(y), alpha=alpha)
    d_grads = {k: v.clone() for k, v in grad_sd(state.discriminator).items()}
    g_loss, _ = trainer.g_step(state, nchw(x), nchw(y))
    g_grads = grad_sd(state.generator)

    np.testing.assert_allclose(d_loss.item(), float(jd_loss), rtol=1e-4)
    np.testing.assert_allclose(g_loss.item(), float(jg_loss), rtol=1e-4)
    assert_stats(state.generator, jstate.g_stats)
    assert_stats(state.discriminator, {k: v for k, v in jstate.d_stats.items()
                                       if not k.startswith("SpectralNorm_")})
    assert_u(state.discriminator, jstate.d_stats, rtol=1e-4, atol=1e-6)
    trainer64.d_step(state64, nchw(x).double(), nchw(y).double(), alpha=alpha.double())
    trainer64.g_step(state64, nchw(x).double(), nchw(y).double())
    assert_grads_near(d_grads, jd_grads, grad_sd(state64.discriminator))
    assert_grads_near(g_grads, jg_grads, grad_sd(state64.generator))


def test_denoising_gan_checkpoint_files(tmp_path):
    """{prefix}_generator_{epoch}.pth and _discriminator_: bare state_dicts
    that load strict into fresh modules (the discriminator with its u)."""
    trainer = pdg.DenoisingGANTrainer(device="cpu", checkpoint_dir=str(tmp_path))
    state = trainer.init(steps_per_epoch=1)
    gpath, dpath = trainer.save_checkpoint(state, epoch=10)
    assert gpath.endswith("denoising_gan_generator_10.pth")
    assert dpath.endswith("denoising_gan_discriminator_10.pth")
    g_sd = torch.load(gpath, map_location="cpu", weights_only=True)
    d_sd = torch.load(dpath, map_location="cpu", weights_only=True)
    assert any(k.startswith("enc1") for k in g_sd) and "model.0.weight_u" in d_sd
    AttentionUNet().load_state_dict(g_sd, strict=True)
    PatchGAN().load_state_dict(d_sd, strict=True)
