"""Module-level remat and the resume of a JAX-written checkpoint's Adam
state, in the port against the JAX package, on the CPU.

- ``remat`` (``RDUNet``/``RDUNetT(remat=False|True|"highres")``) changes
  what the backward keeps, never the forward or the gradients: both are
  held to ``remat=False``'s at 1e-6 relative (the tolerance of
  tests/test_models.py::test_remat_modes_preserve_forward), the state_dict
  keys are the same, and ``DiffusionTrainer(engine="flax", remat=True)``
  trains, as JAX's does.
- A ``.pth`` the JAX ``DiffusionTrainer`` writes after two steps carries its
  optax state as ``optax_leaves``; the port resumes it with Adam's moments,
  its count and the schedule's position, and its third step equals JAX's
  third step to rtol 2e-4 (the trajectory tolerance of
  tests/test_train_trajectory_parity.py), also across a StepLR boundary.

Sizes: base_filters 4 at 16x16 for remat; the resume runs a tiny JAX
RDUNetT (base 2, 8x8, accumulation 1) compiled once at XLA's lowest backend
optimisation level, at HIGHEST precision, with JAX's timestep draws handed
to the port."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rdunet import numpy_params, one_thread  # noqa: F401 — an autouse fixture
from vub_image_denoising_tpu.models.rdunet import RDUNetT as JRDUNetT
from vub_image_denoising_tpu.train import TrainState as JTrainState
from vub_image_denoising_tpu.train import diffusion as jdiff
from vub_image_denoising_tpu.train import schedules as jsched
from vub_image_denoising_tpu.utils import checkpoint as jckpt
from vub_image_denoising_tpu_torch.models import RDUNet, RDUNetT
from vub_image_denoising_tpu_torch.train import diffusion as pdiff
from vub_image_denoising_tpu_torch.utils.checkpoint import (optax_leaves_to_optimizer_state,
                                                            params_to_state_dict)

REMAT_MODES = [True, "highres"]


def _model(kind, remat, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return RDUNet(3, 4, generator=gen, remat=remat) if kind == "rdunet" else RDUNetT(
        4, generator=gen, remat=remat)


def _forward_and_grads(model, kind, x, t):
    model.zero_grad(set_to_none=True)
    xr = x.clone().requires_grad_(True)
    y = model(xr) if kind == "rdunet" else model(xr, t)
    (y.square().mean() + y.mean()).backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return y.detach(), xr.grad, grads


@pytest.mark.parametrize("kind", ["rdunet", "rdunet_t"])
@pytest.mark.parametrize("remat", REMAT_MODES)
def test_remat_modes_preserve_forward_and_grads(kind, remat):
    """remat=True and "highres" give remat=False's forward and gradients
    (the input's and every parameter's) to 1e-6 relative."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32))
    t = torch.tensor([0.25, 0.75])
    plain, wrapped = _model(kind, False), _model(kind, remat)
    wrapped.load_state_dict(plain.state_dict(), strict=True)
    want, got = _forward_and_grads(plain, kind, x, t), _forward_and_grads(wrapped, kind, x, t)
    for a, b in ((got[0], want[0]), (got[1], want[1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * b.abs().max().item())
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        torch.testing.assert_close(got[2][k], want[2][k], rtol=1e-6,
                                   atol=1e-6 * want[2][k].abs().max().item(), msg=k)


@pytest.mark.parametrize("remat", REMAT_MODES)
def test_remat_model_loads_a_plain_state_dict_strictly(remat, tmp_path):
    """The modules and keys are those of remat=False: a plain model's .pth
    loads strictly into a remat model and back."""
    plain = _model("rdunet_t", False)
    path = tmp_path / "plain.pth"
    torch.save(plain.state_dict(), path)
    wrapped = _model("rdunet_t", remat, seed=1)
    assert wrapped.state_dict().keys() == plain.state_dict().keys()
    wrapped.load_state_dict(torch.load(path, weights_only=True), strict=True)
    for k, v in plain.state_dict().items():
        assert torch.equal(wrapped.state_dict()[k], v), k


def test_remat_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="remat"):
        RDUNet(3, 4, remat="lowres")


@pytest.mark.parametrize("remat", REMAT_MODES)
def test_diffusion_trainer_trains_with_remat_on_the_default_engine(remat):
    """DiffusionTrainer(engine="flax", remat=...) inits and steps, as JAX's
    does (the JAX trainer builds RDUNetT(remat=self.remat)); its step equals
    remat=False's (same seed, same timestep draws)."""
    x = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(2)) * 2 - 1
    states = []
    for r in (False, remat):
        trainer = pdiff.DiffusionTrainer(base_filters=4, timesteps=3, accumulation_steps=2,
                                         engine="flax", remat=r, device="cpu")
        state = trainer.init(steps_per_epoch=1, seed=0)
        assert trainer.unet.remat is r
        state, loss = trainer.train_step(state, x, x.clamp(-0.5, 0.5))
        assert np.isfinite(float(loss))
        states.append((float(loss), {k: v.detach().clone() for k, v in state.params.items()}))
    (l0, p0), (l1, p1) = states
    assert l1 == pytest.approx(l0, rel=1e-6)
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], rtol=1e-5, atol=1e-7, msg=k)


# ---------------------------------------------------------------------------
# A JAX-written checkpoint resumes with its Adam state
# ---------------------------------------------------------------------------

RB, RT, RN, RHW, LR = 2, 3, 2, 8, 1e-2


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX DiffusionTrainer (AdamW, StepLR(3, 0.5) per epoch of one step,
    clip 0.1) takes four steps; after steps 2 and 3 it writes its epoch
    checkpoint.  Returns the two files, the params after steps 2-4, each
    step's batch and its timestep draws.  The trainer's optimizer and step
    are built as its ``init`` builds them, from numpy params (flax's init
    takes about 20 s to compile here), and the step is compiled at XLA's
    lowest optimisation level; its orbax sidecar, which the port does not
    read, is not written."""
    out = tmp_path_factory.mktemp("jax_run")
    trainer = jdiff.DiffusionTrainer(base_filters=RB, timesteps=RT, lr=LR, accumulation_steps=1,
                                     output_dir=str(out))
    rng = np.random.RandomState(5)
    noisy = rng.uniform(-1, 1, (4, RN, RHW, RHW, 3)).astype(np.float32)
    clean = np.clip(noisy + 0.3 * rng.randn(*noisy.shape), -1, 1).astype(np.float32)
    jmodel = JRDUNetT(base_filters=RB)
    init_xt = SimpleNamespace(init=lambda k, x: jmodel.init(k, x, jnp.zeros((RN,))))
    variables = numpy_params(init_xt, noisy[0], seed=3)
    trainer.steps_per_epoch = 1
    trainer.tx = jsched.make_optimizer(trainer.optimizer_choice, lr=trainer.lr,
                                       weight_decay=trainer.weight_decay,
                                       scheduler_choice=trainer.scheduler_choice,
                                       steps_per_epoch=1, clip_norm=trainer.clip_norm)
    state = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), trainer.tx)
    step_fn = jdiff.make_diffusion_train_step(
        trainer._unet_apply, trainer.diffusion, trainer.tx, accumulation_steps=1,
        distribution=trainer.distribution_choice, loss_weights=tuple(trainer.loss_weights))
    keys = [jax.random.PRNGKey(10 + i) for i in range(4)]
    with jax.default_matmul_precision("highest"):
        step = jax.jit(step_fn).lower(state, keys[0], noisy[0], clean[0]).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    draws = [np.array(jdiff.sample_timesteps(jax.random.split(k, 1)[0], RN, RT)) for k in keys]
    files, params = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jckpt, "save_orbax", lambda path, state: None)
        for i in range(4):
            state, _ = step(state, keys[i], noisy[i], clean[i])
            params[i + 1] = jax.tree_util.tree_map(np.asarray, state.params)
            if i + 1 in (2, 3):
                files[i + 1] = trainer.save_epoch_checkpoint(state, i, name=f"epoch_{i + 1}.pth")
    return {"files": files, "params": params, "noisy": noisy, "clean": clean, "draws": draws}


@pytest.mark.parametrize("resumed", [2, 3])
def test_jax_checkpoint_resumes_with_its_adam_state(jax_run, resumed, monkeypatch):
    """The port loads JAX's epoch file after step ``resumed`` (2: inside the
    first LR stage; 3: the next step crosses the StepLR boundary, at half
    the LR), with Adam's moments and count from ``optax_leaves``, and its
    next step, on JAX's batch and timestep draws, equals JAX's to rtol 2e-4."""
    trainer = pdiff.DiffusionTrainer(base_filters=RB, timesteps=RT, lr=LR, accumulation_steps=1,
                                     device="cpu")
    state = trainer.init(steps_per_epoch=1, seed=0)
    state, start = trainer.load_checkpoint(state, jax_run["files"][resumed])
    assert start == resumed and state.step == resumed
    want_lr = float(jsched.step_lr(LR, 1)(resumed))
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(want_lr, rel=1e-7)
    leaves = torch.load(jax_run["files"][resumed], weights_only=True)["optax_leaves"]
    opt = state.optimizer.state_dict()["state"]
    assert len(opt) == len(state.params) and all(
        float(s["step"]) == resumed for s in opt.values())
    assert sum(float(s["exp_avg"].abs().sum()) for s in opt.values()) > 0
    mu, _ = optax_leaves_to_optimizer_state(leaves, state.params, "adamw")
    for i in opt:
        assert torch.equal(opt[i]["exp_avg"], mu[i]["exp_avg"])
    for k, v in params_to_state_dict(jax_run["params"][resumed]).items():
        assert torch.equal(state.params[k].detach(), v), k

    draws = jax_run["draws"][resumed]
    monkeypatch.setattr(pdiff, "sample_timesteps",
                        lambda g, n, T, distribution="uniform": torch.from_numpy(draws))
    x = torch.from_numpy(jax_run["noisy"][resumed]).permute(0, 3, 1, 2)
    y = torch.from_numpy(jax_run["clean"][resumed]).permute(0, 3, 1, 2)
    state, _ = trainer.train_step(state, x, y)
    want = params_to_state_dict(jax_run["params"][resumed + 1])
    before = params_to_state_dict(jax_run["params"][resumed])
    moved = 0.0
    for k, v in want.items():
        torch.testing.assert_close(state.params[k].detach(), v, rtol=2e-4, atol=1e-6, msg=k)
        moved = max(moved, float((v - before[k]).abs().max()))
    assert moved > 1e-3  # the step moved the params far beyond the tolerance


def test_optax_leaves_of_another_optimizer_raise(jax_run):
    """A leaf-count mismatch (another optimizer's state) raises."""
    params = dict(RDUNetT(RB).named_parameters())
    leaves = torch.load(jax_run["files"][2], weights_only=True)["optax_leaves"]
    with pytest.raises(ValueError, match="leaves"):
        optax_leaves_to_optimizer_state(leaves[:-1], params, "adamw")
    with pytest.raises(ValueError, match="leaves"):
        optax_leaves_to_optimizer_state(leaves, params, "adadelta")
