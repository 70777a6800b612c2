"""The accuracy protocol's trainer against the JAX package's, by value and over a trajectory.

``scripts/train_accuracy.make_trainer`` builds the trainer that
``scripts/train_tpu_accuracy.py`` builds from the same flags: its settings
are held by value, for the supervised and the diffusion algorithm.

Its supervised trainer (the manifest's engine ``"flax"``, on the CPU, in
f32) then takes the steps of ``vub_image_denoising_tpu/train/supervised.py``'s
step under the JAX trainer's settings (f32 at HIGHEST precision): the same
batches of the protocol's synthetic images under sigma = 25, batch 8 in 4
micro-batches, AdamW, clip 1.0 and StepLR(3, 0.5) on one-step epochs, so
that 7 steps cross two decays (steps 3 and 6).  The model is one
DenoisingBlock(3, 8, 3), a graph whose JAX step compiles in a second; the
RDUNet forward and backward are held to JAX's in test_torch_rdunet.py.
Losses are held at rtol 2e-4 (tests/test_train_trajectory_parity.py's),
and so is each parameter leaf, in norm: element by element two f32
trajectories part where AdamW's first update lr * g / (|g| + eps) meets a
gradient within rounding of zero.  The updates are held at 1e-3 of their
own norm (they agree to about 2e-5), which a wrong learning rate,
schedule or accumulation exceeds; a weight decay moves a weight by 1e-9
of itself a step, so it is held by value.  The same step at RDUNet(3, 128)
is too heavy for this suite: ``python tests/torch_protocol_spread.py``
runs it by hand."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rdunet import numpy_params, one_thread  # noqa: F401 — autouse
from vub_image_denoising_tpu.models import RDUNet as JRDUNet
from vub_image_denoising_tpu.nn.blocks import DenoisingBlock as JDenoisingBlock
from vub_image_denoising_tpu.train import DiffusionTrainer as JDiffusionTrainer
from vub_image_denoising_tpu.train import SupervisedTrainer as JSupervisedTrainer
from vub_image_denoising_tpu.train import TrainState as JTrainState
from vub_image_denoising_tpu.train import make_supervised_train_step as jax_train_step
from vub_image_denoising_tpu.train.schedules import make_optimizer as jax_make_optimizer
from vub_image_denoising_tpu_torch.nn.blocks import DenoisingBlock
from vub_image_denoising_tpu_torch.scripts import train_accuracy as ta
from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict

SIZE, BATCH, STEPS, INNER = 32, 8, 7, 8
TRAJ_RTOL = 2e-4
UPDATE_RTOL = 1e-3
# JAX's step compiled at XLA's backend level 1 without the fusion emitters:
# at level 0 its convolutions run about 1 s a step here
COMPILE_OPTIONS = {"xla_backend_optimization_level": 1, "xla_cpu_use_fusion_emitters": False}
SETTINGS = ("lr", "weight_decay", "accumulation_steps", "clip_norm", "engine", "remat")
DIFFUSION_SETTINGS = ("optimizer_choice", "scheduler_choice", "timesteps", "loss_weights",
                      "distribution_choice")


def jax_trainer(args):
    """The trainer ``scripts/train_tpu_accuracy.py`` builds from ``args``."""
    remat = args.remat == "true"
    if args.algo == "diffusion":
        opt_kw = {}
        if args.optimizer:
            opt_kw["optimizer_choice"] = args.optimizer
        if args.scheduler:
            opt_kw["scheduler_choice"] = args.scheduler
        return JDiffusionTrainer(
            base_filters=args.base_filters, timesteps=args.timesteps, lr=args.lr,
            engine=args.engine, remat=remat, compute_dtype=jnp.bfloat16,
            loss_weights=tuple(float(w) for w in args.loss_weights.split(",")),
            distribution_choice=args.t_dist, **opt_kw)
    return JSupervisedTrainer(JRDUNet(channels=3, base_filters=args.base_filters), lr=args.lr,
                              engine=args.engine, remat=remat, compute_dtype=jnp.bfloat16)


@pytest.mark.parametrize("flags", [
    [],
    ["--algo", "diffusion"],
    ["--algo", "diffusion", "--optimizer", "adam", "--scheduler", "cosine", "--lr", "3e-4",
     "--loss-weights", "1,1,0", "--engine", "xla", "--remat", "true"],
], ids=["supervised", "diffusion", "diffusion-options"])
def test_make_trainer_settings_match_jax(tmp_path, flags):
    args = ta.build_arg_parser().parse_args(
        ["--base-filters", "4", "--device", "cpu"] + flags)
    got, want = ta.make_trainer(args, args.device, str(tmp_path)), jax_trainer(args)
    names = SETTINGS + (DIFFUSION_SETTINGS if args.algo == "diffusion" else ())
    for name in names:
        assert getattr(got, name) == getattr(want, name), name
    assert got.compute_dtype == torch.bfloat16 and want.compute_dtype == jnp.bfloat16


def protocol_batches():
    """STEPS batches of (noisy, clean) NHWC in [-1, 1]: the protocol's
    synthetic images, uint8 Gaussian noise at sigma 25 drawn with numpy."""
    rng = np.random.RandomState(0)
    clean = ta.synth_images(STEPS * BATCH, SIZE, rng)
    noisy = np.clip(clean + 25.0 * rng.randn(*clean.shape), 0, 255).astype(np.uint8)

    def norm(u):
        return (u.astype(np.float32) / 255.0 - 0.5) / 0.5

    return [(norm(noisy[i:i + BATCH]), norm(clean[i:i + BATCH]))
            for i in range(0, STEPS * BATCH, BATCH)]


def test_protocol_step_trajectory_matches_jax(tmp_path):
    batches = protocol_batches()
    args = ta.build_arg_parser().parse_args(
        ["--base-filters", "4", "--batch-size", str(BATCH), "--size", str(SIZE),
         "--device", "cpu"])
    jt = jax_trainer(args)
    jblock = JDenoisingBlock(3, INNER, 3)
    tree = numpy_params(jblock, np.zeros((1, SIZE, SIZE, 3), np.float32), 3)
    tx = jax_make_optimizer("adamw", lr=jt.lr, weight_decay=jt.weight_decay,
                            scheduler_choice="step", steps_per_epoch=1, clip_norm=jt.clip_norm)
    state = JTrainState.create(jax.tree_util.tree_map(jnp.asarray, tree), tx)
    with jax.default_matmul_precision("highest"):
        step = jax.jit(jax_train_step(jblock.apply, tx, jt.accumulation_steps)).lower(
            state, *batches[0]).compile(compiler_options=COMPILE_OPTIONS)
    want_losses = []
    for noisy, clean in batches:
        state, loss = step(state, noisy, clean)
        want_losses.append(float(loss))
    want = params_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params))

    trainer = ta.make_trainer(args, args.device, str(tmp_path))
    trainer.compute_dtype = torch.float32  # the protocol trains in bf16
    trainer.model = DenoisingBlock(3, INNER, 3)
    init = params_to_state_dict(tree)
    trainer.model.load_state_dict(init, strict=True)
    st = trainer.init(1)
    losses = []
    for noisy, clean in batches:
        st, loss = trainer.train_step(st, torch.from_numpy(noisy).permute(0, 3, 1, 2),
                                      torch.from_numpy(clean).permute(0, 3, 1, 2))
        losses.append(loss.item())

    assert st.step == STEPS
    # the last update ran at the second decay's rate; the next runs at it too
    np.testing.assert_allclose(st.optimizer.param_groups[0]["lr"], 1e-4 * 0.5 ** 2, rtol=1e-12)
    np.testing.assert_allclose(losses, want_losses, rtol=TRAJ_RTOL)
    got = trainer.model.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        p, w, w0 = got[k].double(), w.double(), init[k].double()
        assert (p - w).norm() <= TRAJ_RTOL * w.norm(), k
        assert (p - w).norm() <= UPDATE_RTOL * (w - w0).norm(), k
