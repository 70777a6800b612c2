"""The port's RCA-GAN (layers, models, losses, trainer, checkpoints) against
the JAX package's, on the CPU.

Inputs come from numpy seeds; weights are drawn by the port and carried to
the JAX side with the JAX package's own converter
(``torch_state_dict_to_params``), over a template from ``jax.eval_shape``.
The JAX side compiles at XLA's lowest backend optimization level with f32
matmuls and convs at HIGHEST precision.  Sizes: 2 x 32^2 x 1, the critic
built for 32^2 inputs.

Tolerances: layers rtol 1e-5; model forwards 2e-4 max abs (f32 rounding
through some thirty BatchNorm layers at batch 2: both packages' f32
forwards of the generator are 3e-5 to 8e-5 from an f64 one); losses and the
penalty rtol 1e-5; a training round: losses rtol 1e-4, running statistics
rtol 1e-4 / atol 1e-6, clipped gradients rtol 1e-4 / atol 1e-6 * max|g|.

A round whose generator gives a fixed image (``FakeGenerator``) meets
these in both steps: the D step, and the G step's backward through the
perceptual, content and texture losses, the frozen critic and the
penalty's second derivative.  A whole round with the real generator does
not, because it is ill-conditioned: in f64, a 1e-7 relative change of its
input moves the critic's gradients by 3e-6 of a leaf's max, a 1e-6 change
by 8% (conv outputs that are mostly bias enter BatchNorm at batch 2, and
the penalty differentiates twice through the critic's).  The generator's
own backward, given a fixed cotangent, is 2% of a leaf's max from f64 in
f32.  So where a whole round's losses, statistics or gradients miss the
tolerances above, both packages' f32 results are held to the port's round
in f64 (``assert_losses_near``, ``assert_stats``, ``assert_grads_near``),
with the limits set beside ``ROUND_LOSS_RTOL``.  JAX's own f64 mode cannot
give the exact round: its BatchNorm takes its statistics in f32.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from test_torch_rdunet import one_thread  # noqa: F401 — autouse
from vub_image_denoising_tpu.models import rca_gan as jrca
from vub_image_denoising_tpu.models.vgg import VGG19Features as JVGG
from vub_image_denoising_tpu.nn import torch_layers as jtl
from vub_image_denoising_tpu.train import gan as jgan
from vub_image_denoising_tpu.train import gan_losses as jloss
from vub_image_denoising_tpu.utils.checkpoint import torch_state_dict_to_params
from vub_image_denoising_tpu_torch.models import rca_gan as prca
from vub_image_denoising_tpu_torch.models.vgg import VGG19Features, load_torch_vgg19
from vub_image_denoising_tpu_torch.nn import torch_layers as ptl
from vub_image_denoising_tpu_torch.train import gan as pgan
from vub_image_denoising_tpu_torch.train import gan_losses as ploss
from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict

SIDE = 32
FWD_TOL = 2e-4
HIGHEST = jax.lax.Precision.HIGHEST


def _rand(*shape):
    return np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).double().numpy()


# XLA's lowest backend optimization level, and the CPU's elemental emitter in
# place of its fusion emitters: a D or G step then compiles in about 4 s in
# place of 11 (the same HLO, so the same ops and precision)
COMPILE_OPTIONS = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False}


def compile_o0(fn, *args):
    """``fn`` (a function or a ``jax.jit`` object) compiled for ``args`` with
    COMPILE_OPTIONS, matmuls and convs at HIGHEST."""
    fn = fn if hasattr(fn, "lower") else jax.jit(fn)
    with jax.default_matmul_precision("highest"):
        return fn.lower(*args).compile(compiler_options=COMPILE_OPTIONS)


def run_o0(fn, *args):
    return compile_o0(fn, *args)(*args)


def jax_vars(module, state_dict, *init_args, **init_kw):
    """The port's ``state_dict`` as ``module``'s flax variables."""
    template = jax.eval_shape(lambda k: module.init(k, *init_args, **init_kw),
                              jax.random.PRNGKey(0))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), template)
    # copies: a CPU jnp array may share the numpy view of a live torch buffer
    return torch_state_dict_to_params({k: v.detach().clone() for k, v in state_dict.items()},
                                      template)


def capture():
    """An optax stage that passes no update and keeps the gradients it is
    given in its state: after a JAX step, the clipped gradients."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda u, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, u), {"g": u}))


def frozen_optimizers(state):
    """SGD at lr 0 in place of both Adams: params stay, grads stay in .grad."""
    for net, opt, sched in (("generator", "g_opt", "g_sched"),
                            ("discriminator", "d_opt", "d_sched")):
        o = torch.optim.SGD(getattr(state, net).parameters(), lr=0.0)
        setattr(state, opt, o)
        setattr(state, sched, torch.optim.lr_scheduler.LambdaLR(o, lambda k: 1.0))


def grad_sd(module):
    return {k: p.grad for k, p in module.named_parameters()}


def assert_grads(port, want, rtol=1e-4, atol_of_max=1e-6):
    """Clipped grads (state_dict keys) to rtol, atol = atol_of_max * max|g|."""
    assert set(port) == set(want)
    gmax = max(w.abs().max().item() for w in want.values())
    for k, w in want.items():
        torch.testing.assert_close(port[k].double(), w.double(), rtol=rtol,
                                   atol=atol_of_max * gmax, msg=k)


def exact_copy(trainer_cls, state, vgg, tmp_path, **kw):
    """A second trainer whose nets and VGG are ``state``'s and ``vgg``'s in
    f64, its optimizers frozen: the port's side of a round compared in f64."""
    trainer = trainer_cls(device="cpu", checkpoint_dir=str(tmp_path), **kw)
    state64 = trainer.init(steps_per_epoch=1)
    for mine, theirs in ((state64.generator, state.generator),
                         (state64.discriminator, state.discriminator), (trainer.vgg, vgg)):
        mine.load_state_dict(theirs.state_dict())
        mine.double()
    frozen_optimizers(state64)
    return trainer, state64


# Where a whole round's f32 rounding exceeds the tolerances above (module
# docstring), both packages' f32 results are held to the port's round in
# f64: losses within ROUND_LOSS_RTOL of themselves, statistics within
# ROUND_STATS_ATOL, and every gradient leaf within ROUND_GRAD_OF_LEAF of its
# own max|g| plus ROUND_GRAD_FLOOR of the largest leaf's.  The floor holds
# the leaves whose exact gradient is zero or all but zero: a conv bias
# before a training-mode BatchNorm, a ResidualBlock's bn1 scale, which bn2
# normalizes away; f32 leaves them at up to 5.2e-5 of the largest.  The
# three GANs' rounds at 2 x 32^2 read at most 1.8e-3 (losses), 8.8e-6
# (statistics) and 0.34 of the gradient limit, JAX's or the port's.
ROUND_LOSS_RTOL, ROUND_STATS_ATOL = 5e-3, 1e-4
ROUND_GRAD_OF_LEAF, ROUND_GRAD_FLOOR = 0.5, 1e-3


def round_grad_excess(grads, exact):
    """The worst leaf's max|g - exact| over ROUND_GRAD_OF_LEAF * max|exact
    leaf| + ROUND_GRAD_FLOOR * max|exact| (state_dict keys; <= 1 holds)."""
    gmax = max(e.abs().max().item() for e in exact.values())
    return max((grads[k].double() - e).abs().max().item()
               / (ROUND_GRAD_OF_LEAF * e.abs().max().item() + ROUND_GRAD_FLOOR * gmax)
               for k, e in exact.items())


def assert_grads_near(port, want, exact):
    """Clipped grads (state_dict keys): the port's to the JAX package's
    ``want`` at rtol 1e-4 / atol 1e-6 * max|g|, or both within
    ``round_grad_excess`` of the round in f64 (``exact``)."""
    assert set(port) == set(want) == set(exact)
    gmax = max(w.abs().max().item() for w in want.values())
    if all(bool(((port[k].double() - w.double()).abs()
                 <= 1e-4 * w.double().abs() + 1e-6 * gmax).all()) for k, w in want.items()):
        return
    excess = round_grad_excess(want, exact), round_grad_excess(port, exact)
    assert max(excess) <= 1, excess


def assert_losses_near(port, want, exact):
    """Losses to rtol 1e-4, or both within ROUND_LOSS_RTOL of the f64 round's."""
    for p, w, e in zip(port, want, exact):
        assert abs(p - w) <= 1e-4 * abs(w) or max(abs(p - e), abs(w - e)) <= (
            ROUND_LOSS_RTOL * abs(e)), (p, w, e)


def assert_stats(module, jstats, exact=None):
    """Running statistics against JAX's ``batch_stats`` at rtol 1e-4 / atol
    1e-6, or, given the ``exact`` module (the port in f64) and where f32
    rounding upstream is larger, both within ROUND_STATS_ATOL of its."""
    want = params_to_state_dict({"params": {}, "batch_stats": jax.tree_util.tree_map(
        np.asarray, jstats)})
    sd = module.state_dict()
    want = {k: w for k, w in want.items() if not k.endswith("num_batches_tracked")}
    if exact is not None and not all(bool(((sd[k] - w).abs() <= 1e-4 * w.abs() + 1e-6).all())
                                     for k, w in want.items()):
        ex = exact.state_dict()

        def dist(stats):
            return max((stats[k].double() - ex[k]).abs().max().item() for k in want)

        assert max(dist(want), dist(sd)) <= ROUND_STATS_ATOL, (dist(want), dist(sd))
        return
    for k, w in want.items():
        torch.testing.assert_close(sd[k], w, rtol=1e-4, atol=1e-6,
                                   msg=lambda m, k=k: f"{k}: {m}")


# ---------------------------------------------------------------------------
# Layers (the cases of tests/test_gan.py:33-70, and BatchNorm's statistics)
# ---------------------------------------------------------------------------

def test_torch_conv_stride_padding_parity():
    x, w, b = _rand(2, 17, 17, 4), _rand(5, 5, 4, 6), _rand(6)
    conv = ptl.TorchConv(4, 6, 5, 2, 2)
    conv.load_state_dict({"weight": torch.from_numpy(w).permute(3, 2, 0, 1),
                          "bias": torch.from_numpy(b)})
    y = nhwc(conv(nchw(x)))
    want = jtl.TorchConv(6, 5, 2, 2, precision=HIGHEST).apply(
        {"params": {"kernel": jnp.array(w), "bias": jnp.array(b)}}, jnp.array(x))
    np.testing.assert_allclose(y, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,p", [(3, 1), (1, 0)])
def test_torch_conv_transpose_stride1_parity(k, p):
    x, w_torch, b = _rand(2, 9, 9, 4), _rand(4, 6, k, k), _rand(6)
    convt = ptl.TorchConvTranspose(4, 6, k, p)
    convt.load_state_dict({"weight": torch.from_numpy(w_torch), "bias": torch.from_numpy(b)})
    want = jtl.TorchConvTranspose(6, k, p, precision=HIGHEST).apply(
        {"params": {"kernel": jnp.array(w_torch.transpose(2, 3, 0, 1)), "bias": jnp.array(b)}},
        jnp.array(x))
    np.testing.assert_allclose(nhwc(convt(nchw(x))), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_torch_linear_parity():
    x, w, b = _rand(3, 10), _rand(10, 5), _rand(5)
    lin = ptl.TorchLinear(10, 5)
    lin.load_state_dict({"weight": torch.from_numpy(w.T.copy()), "bias": torch.from_numpy(b)})
    want = jtl.TorchLinear(5).apply({"params": {"kernel": jnp.array(w), "bias": jnp.array(b)}},
                                    jnp.array(x))
    np.testing.assert_allclose(lin(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_layer_inits_are_the_reference_weights_init():
    """kaiming_normal fan_in on conv / linear weights (std sqrt(2/fan_in); a
    transpose weight's fan_in is Cout*k*k), U(+-1/sqrt(fan_in)) biases."""
    gen = torch.Generator().manual_seed(0)
    conv = ptl.TorchConv(64, 128, 3, generator=gen)
    assert abs(conv.weight.std().item() / np.sqrt(2 / 576) - 1) < 0.02
    assert conv.bias.abs().max().item() <= 1 / np.sqrt(576)
    convt = ptl.TorchConvTranspose(32, 64, 3, generator=gen)
    assert abs(convt.weight.std().item() / np.sqrt(2 / 576) - 1) < 0.03
    lin = ptl.TorchLinear(4096, 64, generator=gen)
    assert abs(lin.weight.std().item() / np.sqrt(2 / 4096) - 1) < 0.02


def test_batchnorm_train_forward_and_running_stats_match_jax():
    """Normalized with the biased batch variance (JAX's train forward), the
    unbiased one folded into running_var at momentum 0.1 (_TorchBNCore's
    rule; inside the models the stats are also held to JAX's, below); eval
    normalizes with the running stats, as JAX's eval forward does."""
    x = _rand(2, 5, 7, 3) * 2 + 1
    bn = ptl.TorchBatchNorm(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([0.5, 1.5, -1.0]))
        bn.bias.copy_(torch.tensor([0.1, 0.0, -0.2]))
    jbn = jtl.TorchBatchNorm(3)
    jv = jax_vars(jbn, bn.state_dict(), jnp.zeros((1, 5, 7, 3)), train=False)
    y_train = nhwc(bn(nchw(x)))
    want = jbn.apply(jv, jnp.array(x), train=True, mutable=["batch_stats"])[0]
    np.testing.assert_allclose(y_train, np.asarray(want), rtol=1e-5, atol=1e-6)
    xd = x.astype(np.float64)
    m = xd.mean(axis=(0, 1, 2))
    v = xd.var(axis=(0, 1, 2)) * (70 / 69)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * m, rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * v, rtol=1e-5)
    assert int(bn.num_batches_tracked) == 1
    bn.eval()
    jv = jax_vars(jbn, bn.state_dict(), jnp.zeros((1, 5, 7, 3)), train=False)
    np.testing.assert_allclose(nhwc(bn(nchw(x))), np.asarray(jbn.apply(jv, jnp.array(x),
                                                                         train=False)),
                               rtol=1e-5, atol=1e-6)


def test_channel_layer_norm_is_flax_layernorm_over_channels():
    from flax import linen as fnn

    x = _rand(2, 4, 5, 6)
    ln = ptl.ChannelLayerNorm(6)
    with torch.no_grad():
        ln.weight.copy_(torch.linspace(0.5, 1.5, 6))
        ln.bias.copy_(torch.linspace(-0.1, 0.1, 6))
    want = fnn.LayerNorm().apply({"params": {"scale": jnp.asarray(ln.weight.detach().numpy()),
                                             "bias": jnp.asarray(ln.bias.detach().numpy())}},
                                 jnp.array(x))
    np.testing.assert_allclose(nhwc(ln(nchw(x))), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

def test_channel_attention_formula_and_jax():
    """gamma = beta = 0 gives 0.5 * x; with both set, the BN-statistics
    attention (unbiased variance over N, H, W) matches JAX in both modes."""
    x = _rand(2, 8, 8, 4)
    ca = prca.ChannelAttention(4)
    torch.testing.assert_close(ca(nchw(x)), nchw(x) * 0.5, rtol=1e-6, atol=1e-6)
    ca = prca.ChannelAttention(4)
    with torch.no_grad():
        ca.gamma.fill_(0.7)
        ca.beta.fill_(-0.3)
    jca = jrca.ChannelAttention(4)
    for train in (True, False):
        ca.train(train)
        jv = jax_vars(jca, ca.state_dict(), jnp.array(x), train=False)
        want = jca.apply(jv, jnp.array(x), train=train, mutable=["batch_stats"])[0]
        np.testing.assert_allclose(nhwc(ca(nchw(x))), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def nets():
    """The port's G and D (seeded), their JAX variables, and the JAX forwards
    of both in both modes compiled once: (vars_g, vars_d, x) -> (G train,
    G's stats after it, G eval, D train, D's stats after it, D eval)."""
    gen = torch.Generator().manual_seed(0)
    g, d = prca.Generator(1, 1, generator=gen), prca.Discriminator(1, input_hw=SIDE,
                                                                   generator=gen)
    x = _rand(2, SIDE, SIDE, 1) * 0.1
    jg, jd = jrca.Generator(1, 1), jrca.Discriminator(1)
    gv = jax_vars(jg, g.state_dict(), jnp.array(x), train=False)
    dv = jax_vars(jd, d.state_dict(), jnp.array(x), train=False)

    def fwd(gv, dv, x):
        gy, gm = jg.apply(gv, x, train=True, mutable=["batch_stats"])
        dy, dm = jd.apply(dv, x, train=True, mutable=["batch_stats"])
        return (gy, gm["batch_stats"], jg.apply(gv, x, train=False), dy, dm["batch_stats"],
                jd.apply(dv, x, train=False))

    return g, d, gv, dv, x, compile_o0(fwd, gv, dv, jnp.array(x))


def test_generator_and_discriminator_forwards_match_jax(nets):
    g, d, gv, dv, x, fwd = nets
    gy, gstats, gy_eval, dy, dstats, dy_eval = fwd(gv, dv, jnp.array(x))
    g.train(), d.train()
    y = g(nchw(x))
    assert y.shape == (2, 1, SIDE, SIDE) and y.abs().max().item() <= 1.0
    np.testing.assert_allclose(nhwc(y), np.asarray(gy), atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(nhwc(d(nchw(x))[:, :, None, None]),
                               np.asarray(dy)[:, None, None, :], atol=FWD_TOL, rtol=0)
    assert_stats(g, gstats)
    assert_stats(d, dstats)
    g.eval(), d.eval()
    gv_eval = {"params": gv["params"], "batch_stats": gstats}
    dv_eval = {"params": dv["params"], "batch_stats": dstats}
    _, _, gy_eval, _, _, dy_eval = fwd(gv_eval, dv_eval, jnp.array(x))
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(g(nchw(x))), np.asarray(gy_eval), atol=FWD_TOL, rtol=0)
        np.testing.assert_allclose(d(nchw(x)).numpy(), np.asarray(dy_eval), atol=FWD_TOL, rtol=0)
    g.train(), d.train()


def test_discriminator_fc_and_critic_norm_variants():
    """Linear(262144, 1024) at 256^2 inputs (built on the meta device);
    norm 'bn' keeps the reference's keys, 'none' has no norm, 'layernorm'
    LN weight/bias; each forward is finite and 'layernorm' matches JAX."""
    with torch.device("meta"):
        fc1 = prca.Discriminator(1, input_hw=256).fc_layers[0]
    assert (fc1.in_features, fc1.out_features) == (262144, 1024)
    x = _rand(2, SIDE, SIDE, 1) * 0.1
    for norm, keys in (("bn", {"conv.weight", "conv.bias", "bn.weight", "bn.bias",
                               "bn.running_mean", "bn.running_var",
                               "bn.num_batches_tracked"}),
                       ("none", {"conv.weight", "conv.bias"}),
                       ("layernorm", {"conv.weight", "conv.bias", "ln.weight", "ln.bias"})):
        d = prca.Discriminator(1, norm=norm, input_hw=SIDE,
                               generator=torch.Generator().manual_seed(1))
        assert set(d.conv_layers[0].state_dict()) == keys
        assert bool(torch.isfinite(d(nchw(x))).all())
    jd = jrca.Discriminator(1, norm="layernorm")
    want = run_o0(lambda v, x: jd.apply(v, x, train=True), jax_vars(
        jd, d.state_dict(), jnp.array(x), train=False), jnp.array(x))
    np.testing.assert_allclose(d(nchw(x)).detach().numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=0)
    with pytest.raises(ValueError):
        prca.Discriminator(1, norm="weightnorm", input_hw=SIDE)


def assert_jax_round_trip(module, variables):
    """``variables`` (the JAX package's, of ``module``) through
    params_to_state_dict load strict into a copy of ``module`` and give back
    its state_dict exactly (JAX keeps no ``num_batches_tracked``: 0)."""
    want = module.state_dict()
    fresh = copy.deepcopy(module)
    fresh.load_state_dict(params_to_state_dict(jax.tree_util.tree_map(np.asarray, variables)),
                          strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, torch.zeros_like(v) if k.endswith("num_batches_tracked")
                           else want[k]), k


def test_layernorm_critic_and_generator_variables_load_strict():
    """The JAX package's variables of the generator (BatchNorm statistics,
    moved by a training forward) and of the LayerNorm critic load strict
    through params_to_state_dict."""
    x = _rand(2, 16, 16, 1) * 0.1
    g = prca.Generator(1, 1, generator=torch.Generator().manual_seed(4))
    d = prca.Discriminator(1, norm="layernorm", input_hw=16,
                           generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        g(nchw(x))
    assert_jax_round_trip(g, jax_vars(jrca.Generator(1, 1), g.state_dict(), jnp.array(x),
                                      train=False))
    assert_jax_round_trip(d, jax_vars(jrca.Discriminator(1, norm="layernorm"), d.state_dict(),
                                      jnp.array(x), train=False))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def test_losses_match_jax():
    a, b = _rand(2, 12, 12, 1) * 0.3, _rand(2, 12, 13, 1)[:, :, :12] * 0.3
    np.testing.assert_allclose(ploss.gram_matrix(nchw(_rand(2, 4, 6, 3))).numpy(),
                               np.asarray(jloss.gram_matrix(jnp.array(_rand(2, 4, 6, 3)))),
                               rtol=1e-5, atol=1e-7)
    for pfn, jfn in ((ploss.texture_loss, jloss.texture_loss),
                     (ploss.content_loss, jloss.content_loss)):
        np.testing.assert_allclose(pfn(nchw(a), nchw(b)).item(),
                                   float(jfn(jnp.array(a), jnp.array(b))), rtol=1e-5)
    assert ploss.content_loss(torch.ones(1, 1, 4, 4), torch.zeros(1, 1, 4, 4)).item() == \
        pytest.approx(np.sqrt(1 + 1e-8), rel=1e-6)
    vgg = VGG19Features(8, generator=torch.Generator().manual_seed(3))
    jvgg = JVGG(8)
    vv = jax_vars(jvgg, vgg.state_dict(), jnp.array(a))
    want = jloss.perceptual_loss(lambda p, x: jvgg.apply(p, x), vv, jnp.array(a), jnp.array(b))
    np.testing.assert_allclose(ploss.perceptual_loss(vgg, nchw(a), nchw(b)).item(), float(want),
                               rtol=1e-5)


def test_gradient_penalty_linear_critic_and_jax_eps():
    """D(x) = <w, x>: gp = lambda*(||w|| - 1)^2; on the real critic the
    penalty equals JAX's given JAX's own eps draw."""
    w = torch.from_numpy(_rand(1, 4, 4, 1)).permute(0, 3, 1, 2) * 0.3
    real, fake = nchw(_rand(3, 4, 4, 1)), nchw(_rand(3, 5, 4, 1)[:, :4])
    gp = ploss.gradient_penalty(lambda x: (x * w).sum((1, 2, 3))[:, None], real, fake,
                                generator=torch.Generator().manual_seed(0))
    assert gp.item() == pytest.approx(10 * (w.norm().item() - 1) ** 2, rel=1e-4)

    d = prca.Discriminator(1, input_hw=SIDE, generator=torch.Generator().manual_seed(2))
    jd = jrca.Discriminator(1)
    x, y = _rand(2, SIDE, SIDE, 1) * 0.1, _rand(2, SIDE + 1, SIDE, 1)[:, 1:] * 0.1
    dv = jax_vars(jd, d.state_dict(), jnp.array(x), train=False)
    key = jax.random.PRNGKey(5)

    def jgp(params, a, b):
        return jloss.gradient_penalty(
            lambda p, z: jd.apply({"params": p, "batch_stats": dv["batch_stats"]}, z,
                                  train=True, mutable=["batch_stats"])[0], params, key, a, b)

    want = run_o0(jgp, dv["params"], jnp.array(x), jnp.array(y))
    eps = torch.from_numpy(np.asarray(jax.random.uniform(key, (2, 1, 1, 1))))
    before = {k: v.clone() for k, v in d.state_dict().items()}
    got = ploss.gradient_penalty(pgan.frozen_apply(d), nchw(x), nchw(y), eps)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for k, v in d.state_dict().items():  # the frozen forward leaves the stats
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# One training round against JAX's _jit_d_step / _jit_g_step
# ---------------------------------------------------------------------------

def _port_trainer(tmp_path, seed=0, generator=None):
    trainer = pgan.RCAGANTrainer(disc_input_hw=SIDE, device="cpu", seed=seed,
                                 checkpoint_dir=str(tmp_path), generator=generator)
    return trainer, trainer.init(steps_per_epoch=1)


def _jax_trainer(port_trainer, state, x, tmp_path, generator=None):
    """The JAX trainer on the port's weights, its optimizers replaced by a
    global-norm clip that keeps the clipped gradients (``capture``)."""
    jt = jgan.RCAGANTrainer(disc_input_hw=SIDE, checkpoint_dir=str(tmp_path),
                            generator=generator)
    sample = (jnp.array(x), jax.random.PRNGKey(0)) if jt._gen_takes_key else (jnp.array(x),)
    gv = jax_vars(jt.generator, state.generator.state_dict(), *sample, train=False)
    dv = jax_vars(jt.discriminator, state.discriminator.state_dict(), jnp.array(x), train=False)
    jt.vgg_params = jax_vars(jt.vgg, port_trainer.vgg.state_dict(), jnp.array(x))
    jt.tx_g = optax.chain(optax.clip_by_global_norm(1.0), capture())
    jt.tx_d = optax.chain(optax.clip_by_global_norm(1.0), capture())
    jt._build_steps()
    jstate = jgan.GANTrainState(
        g_params=gv["params"], g_stats=gv["batch_stats"], d_params=dv["params"],
        d_stats=dv["batch_stats"], g_opt=jt.tx_g.init(gv["params"]),
        d_opt=jt.tx_d.init(dv["params"]), step=jnp.zeros((), jnp.int32))
    return jt, jstate


def _round_inputs():
    rs = np.random.RandomState(7)
    return ((rs.randn(2, SIDE, SIDE, 1) * 0.1).astype(np.float32),
            (rs.randn(2, SIDE, SIDE, 1) * 0.1).astype(np.float32))


def _eps(key):
    """JAX's penalty draw inside a step: kf, key = split(key); U(key)."""
    return torch.from_numpy(np.array(jax.random.uniform(jax.random.split(key)[1],
                                                        (2, 1, 1, 1))))


def port_round(trainer, state, x, y, **draws):
    """One D step + one G step of the port on NHWC numpy inputs, in the
    state's dtype: (D loss, G loss), D's clipped grads, G's.  ``draws`` are
    ``eps`` = (D step's, G step's) and, for the hybrid, ``g_draws`` likewise."""
    dtype = next(state.generator.parameters()).dtype
    x, y = nchw(x).to(dtype), nchw(y).to(dtype)
    eps = draws.pop("eps")
    g_draws = draws.pop("g_draws", (None, None))
    cast = lambda d: None if d is None else (d[0], d[1].to(dtype))  # noqa: E731
    d_loss = trainer.d_step(state, x, y, eps=eps[0].to(dtype), g_draws=cast(g_draws[0]))
    d_grads = {k: v.clone() for k, v in grad_sd(state.discriminator).items()}
    g_loss, _ = trainer.g_step(state, x, y, eps=eps[1].to(dtype), g_draws=cast(g_draws[1]))
    return (d_loss.item(), g_loss.item()), d_grads, grad_sd(state.generator)


def jax_round(jt, jstate, kd, kg, x, y):
    """JAX's D step then G step: (state after, (D loss, G loss), D's clipped
    grads, G's), the grads as state_dicts."""
    jstate, jd_loss = compile_o0(jt._jit_d_step, jstate, kd, x, y)(jstate, kd, x, y)
    d_grads = params_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.d_opt[1]["g"]))
    jstate, jg_loss, _ = compile_o0(jt._jit_g_step, jstate, kg, x, y, jt.vgg_params)(
        jstate, kg, x, y, jt.vgg_params)
    g_grads = params_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.g_opt[1]["g"]))
    return jstate, (float(jd_loss), float(jg_loss)), d_grads, g_grads


@pytest.fixture(scope="module")
def rca_round(tmp_path_factory):
    """One D step + one G step of both trainers from the same weights and
    draws, and the same round of the port in f64."""
    tmp = tmp_path_factory.mktemp("rca")
    x, y = _round_inputs()
    kd, kg = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    trainer, state = _port_trainer(tmp)
    frozen_optimizers(state)
    jt, jstate = _jax_trainer(trainer, state, x, tmp)
    trainer64, state64 = exact_copy(pgan.RCAGANTrainer, state, trainer.vgg, tmp,
                                    disc_input_hw=SIDE)
    out = {"trainer": trainer, "state": state, "state64": state64, "jt": jt}
    out["jstate"], *out["jax"] = jax_round(jt, jstate, kd, kg, x, y)
    eps = (_eps(kd), _eps(kg))
    out["port"] = port_round(trainer, state, x, y, eps=eps)
    out["port64"] = port_round(trainer64, state64, x, y, eps=eps)
    return out


def test_rca_gan_round_matches_jax(rca_round):
    """Losses, running statistics and both nets' clipped gradients after one
    D step + one G step, as the module docstring says (G's statistics moved
    by both steps' G forwards, D's by D(gt) then D(fake) only)."""
    r = rca_round
    (losses, d_grads, g_grads), (losses64, d64, g64) = r["port"], r["port64"]
    jlosses, jd_grads, jg_grads = r["jax"]
    assert_losses_near(losses, jlosses, losses64)
    assert_stats(r["state"].generator, r["jstate"].g_stats, r["state64"].generator)
    assert_stats(r["state"].discriminator, r["jstate"].d_stats, r["state64"].discriminator)
    assert r["state"].step == 1
    assert_grads_near(d_grads, jd_grads, d64)
    assert_grads_near(g_grads, jg_grads, g64)


class FakeGenerator(torch.nn.Module):
    """A fixed image plus a parameter that starts at zero: in its G step the
    gradient of that parameter is the loss's gradient for the fake itself."""

    def __init__(self, fake):
        super().__init__()
        self.register_buffer("fake", fake)
        self.delta = torch.nn.Parameter(torch.zeros_like(fake))

    def forward(self, x):
        return self.fake + self.delta


@pytest.fixture(scope="module")
def fixed_fake_round(tmp_path_factory):
    """One D step + one G step of both trainers whose generators both give
    the port generator's training-mode output (``FakeGenerator`` and its
    flax twin), from the same critic, VGG and penalty draws: the critic's
    and the G loss's backward without the generator's f32 rounding."""
    from flax import linen as fnn

    tmp = tmp_path_factory.mktemp("fixed_fake")
    x, y = _round_inputs()
    trainer, state = _port_trainer(tmp)
    with torch.no_grad():
        fake = state.generator.train()(nchw(x))
    fake_nhwc = jnp.asarray(nhwc(fake).astype(np.float32))

    class Fake(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=True):
            self.variable("batch_stats", "unused", lambda: jnp.zeros(()))
            return fake_nhwc + self.param("delta", fnn.initializers.zeros, fake_nhwc.shape)

    jt, jstate = _jax_trainer(trainer, state, x, tmp)
    jt.generator = Fake()
    jt._build_steps()
    g_params = {"delta": jnp.zeros(fake_nhwc.shape)}
    jstate = jstate.replace(g_params=g_params, g_stats={"unused": jnp.zeros(())},
                            g_opt=jt.tx_g.init(g_params))
    state.generator = FakeGenerator(fake)
    frozen_optimizers(state)
    kd, kg = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    jstate, jd_loss = compile_o0(jt._jit_d_step, jstate, kd, x, y)(jstate, kd, x, y)
    out = {"jd_loss": float(jd_loss),  # numpy copies: the G step donates the state
           "jd_stats": jax.tree_util.tree_map(np.array, jstate.d_stats),
           "jd_grads": params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                   jstate.d_opt[1]["g"]))}
    jstate, jg_loss, jparts = compile_o0(jt._jit_g_step, jstate, kg, x, y, jt.vgg_params)(
        jstate, kg, x, y, jt.vgg_params)
    out.update(jg_loss=float(jg_loss), jparts={k: float(v) for k, v in jparts.items()},
               jg_grad=torch.from_numpy(np.array(jstate.g_opt[1]["g"]["delta"])))
    out["d_loss"] = trainer.d_step(state, nchw(x), nchw(y), eps=_eps(kd)).item()
    out["d_grads"] = {k: v.clone() for k, v in grad_sd(state.discriminator).items()}
    out["d_stats"] = copy.deepcopy(state.discriminator)
    g_loss, parts = trainer.g_step(state, nchw(x), nchw(y), eps=_eps(kg))
    out.update(g_loss=g_loss.item(), parts={k: v.item() for k, v in parts.items()},
               g_grad=state.generator.delta.grad.permute(0, 2, 3, 1))
    return out


def test_rca_gan_d_step_matches_jax_on_the_same_fake(fixed_fake_round):
    """The D step alone, both critics given the port generator's output:
    loss, the clipped gradients at rtol 1e-4 / atol 1e-6 * max|g|, and D's
    running stats (updated by D(gt) then D(fake), not by the penalty's
    forward)."""
    r = fixed_fake_round
    np.testing.assert_allclose(r["d_loss"], r["jd_loss"], rtol=1e-4)
    assert_grads(r["d_grads"], r["jd_grads"])
    assert_stats(r["d_stats"], r["jd_stats"])


def test_rca_gan_g_step_matches_jax_on_the_same_fake(fixed_fake_round):
    """The G step on that fake, through the same frozen critic: the total
    and each part (perceptual, content, texture, adversarial with its
    penalty) at rtol 1e-4, and the clipped gradient for the fake, which
    runs back through VGG19[:8], the Gram matrices, the critic in training
    mode and the penalty's second derivative, at rtol 1e-4 / atol 1e-6 *
    max|g|."""
    r = fixed_fake_round
    np.testing.assert_allclose(r["g_loss"], r["jg_loss"], rtol=1e-4)
    assert set(r["parts"]) == set(r["jparts"])
    for k, v in r["jparts"].items():
        np.testing.assert_allclose(r["parts"][k], v, rtol=1e-4, err_msg=k)
    assert_grads({"fake": r["g_grad"]}, {"fake": r["jg_grad"]})


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_port_checkpoint_loads_in_jax_and_back(rca_round, nets, tmp_path):
    """checkpoint_epoch_10.pth in the reference layout, loadable weights-only;
    its generator_state_dict through the JAX package's converter gives the
    port generator's eval forward; the port reads it back equal."""
    r = rca_round
    trainer, state = r["trainer"], r["state"]
    trainer.checkpoint_dir = str(tmp_path)
    path = trainer.save_checkpoint(state, epoch=9)
    assert path.endswith("checkpoint_epoch_10.pth")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert set(payload) == {"epoch", "generator_state_dict", "discriminator_state_dict",
                            "optimizer_G_state_dict", "optimizer_D_state_dict"}
    assert payload["epoch"] == 10
    g, d, gv, dv, x, fwd = nets
    template = jax.tree_util.tree_map(np.asarray, gv)
    jv = torch_state_dict_to_params(payload["generator_state_dict"], template)
    _, _, want, _, _, _ = fwd(jv, dv, jnp.array(x))
    np.testing.assert_allclose(nhwc(trainer.generate(state, nchw(x))), np.asarray(want),
                               atol=FWD_TOL, rtol=0)

    trainer2, state2 = _port_trainer(tmp_path, seed=5)
    assert trainer2.load_checkpoint(state2, path) == 10
    for a, b in ((state.generator, state2.generator), (state.discriminator,
                                                       state2.discriminator)):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k


def test_port_loads_a_jax_written_checkpoint(rca_round, tmp_path):
    """The JAX trainer's checkpoint_epoch_{n}.pth: G and D load strict
    (empty optimizer entries are skipped); its weights and statistics are
    the round's (to the round's statistics tolerance)."""
    r = rca_round
    r["jt"].checkpoint_dir = str(tmp_path)
    path = r["jt"].save_checkpoint(r["jstate"], epoch=0)
    trainer, state = _port_trainer(tmp_path, seed=9)
    assert trainer.load_checkpoint(state, path) == 1
    for a, b in ((r["state"].generator, state.generator),
                 (r["state"].discriminator, state.discriminator)):
        want = a.state_dict()
        for k, v in b.state_dict().items():
            if k.endswith("num_batches_tracked"):
                continue
            torch.testing.assert_close(v, want[k], rtol=1e-4, atol=1e-6, msg=k)


def test_vgg_loads_a_torchvision_state_dict(tmp_path, monkeypatch):
    """A torchvision-layout vgg19 state_dict (synthetic) fills conv i from
    features.{0, 2, 5, 7, ...}; no file (or no VGG19_WEIGHTS) gives None."""
    vgg = VGG19Features(16)
    sd, idx = {}, [0, 2, 5, 7, 10, 12, 14]  # the convs of features[:16]
    for i, ti in enumerate(idx):
        conv = getattr(vgg, f"conv{i}")
        sd[f"features.{ti}.weight"] = torch.full_like(conv.weight, float(i))
        sd[f"features.{ti}.bias"] = torch.full_like(conv.bias, -float(i))
    path = tmp_path / "vgg19.pth"
    torch.save(sd, path)
    monkeypatch.delenv("VGG19_WEIGHTS", raising=False)
    assert load_torch_vgg19(vgg, str(tmp_path / "missing.pth")) is None
    monkeypatch.setenv("VGG19_WEIGHTS", str(path))
    assert load_torch_vgg19(vgg) is vgg
    for i in range(7):
        assert torch.all(getattr(vgg, f"conv{i}").weight == i)
        assert torch.all(getattr(vgg, f"conv{i}").bias == -i)
    assert len(list(vgg.children())) == 7
