"""The port's schedules, optimizer and supervised train step against the JAX package's.

The train step is held to the JAX step over 4 steps across the StepLR
boundary at rtol 2e-4, the trajectory tolerance of
tests/test_train_trajectory_parity.py; the weights are drawn with numpy and
carried across with params_to_state_dict.  JAX runs f32 matmuls at HIGHEST
precision."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rdunet import numpy_params, one_thread  # noqa: F401 — autouse
from vub_image_denoising_tpu.nn.blocks import DenoisingBlock as JDenoisingBlock
from vub_image_denoising_tpu.train import TrainState as JTrainState
from vub_image_denoising_tpu.train import make_supervised_train_step as jax_train_step
from vub_image_denoising_tpu.train import schedules as js
from vub_image_denoising_tpu.train.supervised import effective_accumulation as jax_eff_acc
from vub_image_denoising_tpu_torch.models import RDUNet
from vub_image_denoising_tpu_torch.models.fused_apply import fused_block_trainable
from vub_image_denoising_tpu_torch.nn.blocks import DenoisingBlock
from vub_image_denoising_tpu_torch.train import (
    SupervisedTrainer, TrainState, effective_accumulation, make_optimizer,
    make_supervised_train_step)
from vub_image_denoising_tpu_torch.train import schedules as ts
from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8, 16])
def test_effective_accumulation_matches_jax(n):
    for requested in (1, 2, 4, 5, 16):
        assert effective_accumulation(n, requested) == jax_eff_acc(n, requested)


@pytest.mark.parametrize("steps_per_epoch", [1, 2])
def test_schedules_match_jax(steps_per_epoch):
    for port, ref in ((ts.step_lr(1e-4, steps_per_epoch), js.step_lr(1e-4, steps_per_epoch)),
                      (ts.cosine_annealing_lr(2e-4, steps_per_epoch),
                       js.cosine_annealing_lr(2e-4, steps_per_epoch))):
        for step in range(13):
            np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-6)


@pytest.mark.parametrize("choice", ["adam", "adamw", "adadelta"])
def test_update_k_runs_at_schedule_k(choice):
    spec = make_optimizer(choice, lr=1e-3, weight_decay=1e-5, steps_per_epoch=2, clip_norm=1.0)
    p = torch.zeros(3, requires_grad=True)
    state = TrainState.create({"p": p}, spec)
    for k in range(8):
        np.testing.assert_allclose(state.optimizer.param_groups[0]["lr"], spec.schedule(k),
                                   rtol=1e-12)
        state.apply_gradients([torch.ones(3)])
    assert state.step == 8


def test_clip_by_global_norm_matches_optax():
    import optax

    grads = [torch.tensor([3.0, 4.0]), torch.tensor([[12.0]])]
    want = optax.clip_by_global_norm(1.0).update([g.numpy() for g in grads], None)[0]
    norm = ts.clip_by_global_norm_(grads, 1.0)
    assert norm.item() == 13.0
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.fixture(scope="module")
def jax_trajectory():
    """4 JAX steps of AdamW(1e-4, wd 1e-5) + StepLR(3, .5) per step-epoch +
    clip 1.0 on one DenoisingBlock(8, 4, 8), batch 4 at 16^2, accumulation 2."""
    c = 8
    jblock = JDenoisingBlock(c, 4, c)
    tree = numpy_params(jblock, np.zeros((1, 8, 8, c), np.float32), 0)
    rng = np.random.RandomState(1)
    batches = [(rng.randn(4, 16, 16, c).astype(np.float32),
                rng.randn(4, 16, 16, c).astype(np.float32)) for _ in range(4)]
    tx = js.make_optimizer("adamw", 1e-4, 1e-5, "step", steps_per_epoch=1, clip_norm=1.0)
    state = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, tree), tx)
    with jax.default_matmul_precision("highest"):
        step = jax.jit(jax_train_step(jblock.apply, tx, accumulation_steps=2)).lower(
            state, *batches[0]).compile(compiler_options={"xla_backend_optimization_level": 0})
    losses = []
    for noisy, clean in batches:
        state, loss = step(state, noisy, clean)
        losses.append(float(loss))
    return tree, batches, losses, params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params))


@pytest.mark.parametrize("path", ["module", "trainable_packed"])
def test_train_step_trajectory_matches_jax(jax_trajectory, path):
    """The same 4 steps in the port: summed micro-batch grads, loss = mean of
    the micro-batch losses, through the module path or the packed-kernel
    Function."""
    tree, batches, want_losses, want = jax_trajectory
    block = DenoisingBlock(8, 4, 8)
    block.load_state_dict(params_to_state_dict(tree), strict=True)
    if path == "module":
        apply = lambda p, x: block(x)  # noqa: E731
    else:
        apply = lambda p, x: fused_block_trainable(x, p, packed=True)  # noqa: E731
    state = TrainState.create(dict(block.named_parameters()),
                              make_optimizer("adamw", 1e-4, 1e-5, "step", steps_per_epoch=1,
                                             clip_norm=1.0))
    step = make_supervised_train_step(apply, accumulation_steps=2)
    losses = []
    for noisy, clean in batches:
        state, loss = step(state, torch.from_numpy(noisy).permute(0, 3, 1, 2),
                           torch.from_numpy(clean).permute(0, 3, 1, 2))
        losses.append(loss.item())
    assert state.step == len(batches)
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4)
    for k, p in block.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=2e-4, err_msg=k)


def test_trainer_engines_take_the_same_step():
    """One SupervisedTrainer step from the same weights: the module path,
    the eager engine and the kernel engine (plain on the CPU) agree."""
    rng = np.random.RandomState(2)
    clean = torch.from_numpy(rng.uniform(-1, 1, (4, 3, 16, 16)).astype(np.float32))
    noisy = clean + 0.2 * torch.from_numpy(rng.randn(4, 3, 16, 16).astype(np.float32))
    init = RDUNet(3, 4, generator=torch.Generator().manual_seed(0)).state_dict()
    results = {}
    for engine in ("flax", "xla", "pallas"):
        model = RDUNet(3, 4)
        model.load_state_dict(init)
        trainer = SupervisedTrainer(model, accumulation_steps=2, engine=engine, device="cpu")
        state = trainer.init(steps_per_epoch=1)
        state, loss = trainer.train_epoch(state, [(noisy, clean)])
        assert np.isfinite(loss) and state.step == 1
        results[engine] = (loss, {k: v.detach().clone() for k, v in state.params.items()})
        assert trainer.evaluate_batch(state, noisy).shape == noisy.shape
    for engine in ("xla", "pallas"):
        np.testing.assert_allclose(results[engine][0], results["flax"][0], rtol=1e-5)
        for k, v in results[engine][1].items():
            torch.testing.assert_close(v, results["flax"][1][k], rtol=1e-4, atol=1e-6)


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SupervisedTrainer(RDUNet(3, 4)).init(steps_per_epoch=1)
    with pytest.raises(ValueError, match="unknown engine"):
        SupervisedTrainer(RDUNet(3, 4), engine="auto", device="cpu").init(steps_per_epoch=1)
