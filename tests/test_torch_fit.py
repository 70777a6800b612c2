"""The port's trainers end to end on the CPU: fit, checkpoints, resume, the
diffusion CLI, preemption and the presets, against the JAX package's.

- A checkpoint the port writes loads with the JAX ``load_pth`` (``unet.``
  prefix) with its params exact; one the JAX ``save_pth`` writes (params
  and ``optax_leaves``) resumes in the port with the params exact, the LR at
  JAX's ``step_lr`` position (rtol 1e-7) and Adam's moments and count from
  the leaves; both load with ``torch.load(weights_only=True)``.
- Resume is exact: ``fit`` for 2 epochs against ``fit`` for 1 epoch, then
  ``load_checkpoint`` and ``fit(start_epoch=1)``, with the loaders' ``.epoch``
  set to the resumed epoch (the JAX package's contract): params, optimizer
  state and LR bitwise equal, for both trainers.
- The CLI's defaults equal JAX's for every flag they share.

Sizes: 32-pixel patches (``patch32`` of tests/test_torch_data.py swaps
the loaders' datasets for 32-patch ones), base_filters 4, T = 3.  No JAX model is compiled: its param tree
comes from ``jax.eval_shape``."""

import os
import signal
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_data import PATCH, patch32, write_pngs, write_sidd  # noqa: F401 — a fixture
from test_torch_rdunet import one_thread  # noqa: F401 — an autouse fixture
from vub_image_denoising_tpu.models.rdunet import RDUNetT as JRDUNetT
from vub_image_denoising_tpu.train import diffusion as jdiff
from vub_image_denoising_tpu.train import presets as jpresets
from vub_image_denoising_tpu.train import schedules as jsched
from vub_image_denoising_tpu.utils import checkpoint as jckpt
from vub_image_denoising_tpu_torch.data.loader import load_data
from vub_image_denoising_tpu_torch.models import RDUNet
from vub_image_denoising_tpu_torch.train import SupervisedTrainer
from vub_image_denoising_tpu_torch.train import diffusion as pdiff
from vub_image_denoising_tpu_torch.train import presets as ppresets
from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict

BASE, T = 4, 3
EPOCH_FILE = "diffusion_RDUNet_model_checkpointed_epoch_{}.pth"


@pytest.fixture
def folder(tmp_path, patch32):
    """One 64x64 image: 4 patches x 3 levels; split 0.5 leaves 6 train items
    (one batch of 4 per epoch) and 6 val items."""
    path = tmp_path / "DIV2K_train_HR.nosync"
    write_pngs(path, [(64, 64)])
    return str(path)


def loaders(folder, augment=True):
    return load_data(folder, batch_size=4, validation_split=0.5, augment=augment,
                     use_rgb=True, device="cpu", seed=1)


def jax_rdunet_t_shapes():
    return jax.eval_shape(JRDUNetT(base_filters=BASE).init, jax.random.PRNGKey(0),
                          np.zeros((1, PATCH, PATCH, 3), np.float32), np.zeros((1,), np.float32))


def test_port_checkpoint_loads_in_jax_and_jax_checkpoint_resumes_in_port(tmp_path):
    trainer = pdiff.DiffusionTrainer(base_filters=BASE, timesteps=T, accumulation_steps=1,
                                     output_dir=str(tmp_path), device="cpu")
    state = trainer.init(steps_per_epoch=2, seed=3)
    x = torch.rand(4, 3, PATCH, PATCH) * 2 - 1
    state, _ = trainer.train_step(state, x, x.clamp(-0.5, 0.5))
    path = trainer.save_epoch_checkpoint(state, 0)
    assert os.path.basename(path) == EPOCH_FILE.format(1)
    payload = torch.load(path, weights_only=True)
    assert payload["epoch"] == 1 and payload["optimizer_state_dict"]["state"]
    assert payload["scheduler_state_dict"]["last_epoch"] == 1
    assert all(k.startswith("unet.") for k in payload["model_state_dict"])
    template = jax_rdunet_t_shapes()
    params, jpayload = jckpt.load_pth(path, template, prefix="unet.")
    assert jpayload["epoch"] == 1
    carried = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    port_sd = trainer.unet.state_dict()
    assert carried.keys() == port_sd.keys()
    for k, v in port_sd.items():
        assert torch.equal(carried[k], v), k

    # the reverse: a JAX-written epoch-4 checkpoint with optax leaves
    steps, epoch = 2, 4
    rng = np.random.RandomState(0)
    jparams = jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(np.float32) * 0.1,
                                     template)
    tx = jsched.make_optimizer("adamw", 1e-4, 1e-4, "step", steps_per_epoch=steps, clip_norm=0.1)
    jpath = str(tmp_path / "jax.pth")
    jckpt.save_pth(jpath, jparams, epoch=epoch, prefix="unet.",
                   extra={"optimizer_state_dict": {}, "scheduler_state_dict": {},
                          "optax_leaves": jckpt.optax_state_to_safe(
                              adam_at(tx, template, epoch * steps, rng))})
    assert torch.load(jpath, weights_only=True)["optax_leaves"]
    fresh = pdiff.DiffusionTrainer(base_filters=BASE, timesteps=T, device="cpu")
    state = fresh.init(steps_per_epoch=steps, seed=0)
    state, start = fresh.load_checkpoint(state, jpath)
    assert start == epoch and state.step == epoch * steps
    want = params_to_state_dict(jparams)
    for k, v in fresh.unet.state_dict().items():
        assert torch.equal(v, want[k]), k
    lr = state.optimizer.param_groups[0]["lr"]
    np.testing.assert_allclose(lr, float(jsched.step_lr(1e-4, steps)(epoch * steps)), rtol=1e-7)
    opt = state.optimizer.state_dict()["state"]
    assert len(opt) == len(want) and all(float(v["step"]) == epoch * steps for v in opt.values())
    assert all(bool((v["exp_avg_sq"] > 0).all()) for v in opt.values())


def adam_at(tx, template, count, rng):
    """An optax state of ``tx`` over ``template`` after ``count`` updates:
    its counts set to ``count`` and its moments drawn from ``rng``."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, count, leaf.dtype)
        if jax.tree_util.keystr(path).endswith(".count")
        else rng.rand(*leaf.shape).astype(leaf.dtype) + 0.1,
        fresh_adam(tx, template))


def fresh_adam(tx, template):
    """``tx.init``'s state as numpy zeros (its shapes from ``eval_shape``;
    eager ``tx.init`` compiles one op per leaf shape)."""
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  jax.eval_shape(tx.init, template))


def _snapshot(state):
    opt = state.optimizer.state_dict()
    return ({k: v.detach().clone() for k, v in state.params.items()},
            {i: {k: v.clone() for k, v in s.items()} for i, s in opt["state"].items()},
            [g["lr"] for g in opt["param_groups"]], state.step)


def _assert_same(a, b):
    (pa, sa, la, ka), (pb, sb, lb, kb) = a, b
    assert ka == kb and la == lb and sa.keys() == sb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def test_diffusion_resume_is_exact(folder, tmp_path):
    def run(out, epochs, resume=None):
        tr, va = loaders(folder)
        trainer = pdiff.DiffusionTrainer(base_filters=BASE, timesteps=T, accumulation_steps=2,
                                         output_dir=str(out), engine="xla", device="cpu")
        state = trainer.init(steps_per_epoch=len(tr), seed=0)
        state, start = trainer.load_checkpoint(state, resume)
        tr.epoch = va.epoch = start
        state, history = trainer.fit(state, tr, va, epochs, start_epoch=start)
        return state, history

    straight, hist = run(tmp_path / "a", 2)
    assert [h["epoch"] for h in hist] == [0, 1] and all(np.isfinite(h["val_loss"]) for h in hist)
    assert straight.step == 2
    run(tmp_path / "b", 1)
    resumed, hist = run(tmp_path / "c", 2, str(tmp_path / "b" / EPOCH_FILE.format(1)))
    assert [h["epoch"] for h in hist] == [1]
    _assert_same(_snapshot(straight), _snapshot(resumed))
    for d in ("a", "c"):
        assert os.path.isfile(tmp_path / d / EPOCH_FILE.format(2))


def test_supervised_resume_is_exact(folder, tmp_path):
    def run(out, epochs, resume=None):
        tr, va = loaders(folder, augment=False)
        trainer = SupervisedTrainer(RDUNet(3, BASE, generator=torch.Generator().manual_seed(0)),
                                    accumulation_steps=2, checkpoint_every=1,
                                    checkpoint_dir=str(out), engine="xla", device="cpu")
        state = trainer.init(steps_per_epoch=len(tr))
        state, start = trainer.load_checkpoint(state, resume)
        tr.epoch = start
        return trainer.fit(state, tr, epochs, val_loader=va, start_epoch=start)

    straight, hist = run(tmp_path / "a", 2)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    run(tmp_path / "b", 1)
    path = str(tmp_path / "b" / "rdunet_denoising.pth")
    payload = torch.load(path, weights_only=True)
    assert payload["epoch"] == 1 and set(payload) == {
        "model_state_dict", "epoch", "optimizer_state_dict", "scheduler_state_dict"}
    resumed, hist = run(tmp_path / "c", 2, path)
    assert [h["epoch"] for h in hist] == [1]
    _assert_same(_snapshot(straight), _snapshot(resumed))


def test_cli_defaults_match_jax_and_train_writes_checkpoints(tmp_path, patch32, monkeypatch):
    port, ref = vars(pdiff.build_arg_parser().parse_args([])), vars(
        jdiff.build_arg_parser().parse_args([]))
    shared = port.keys() & ref.keys()
    assert shared == ref.keys() and port.keys() - shared == {"device"}
    assert {k: port[k] for k in shared} == ref
    assert port["augment"] is True and port["device"] == "cuda"

    write_pngs(tmp_path / "DIV2K_train_HR.nosync", [(64, 64)])
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # no writer: its import takes 3 s
    out = tmp_path / "ck"
    state, history = pdiff.main([
        "--dataset_choice", "DIV2K", "--data_root", str(tmp_path), "--device", "cpu",
        "--base_filters", str(BASE), "--timesteps", str(T), "--num_epochs", "1",
        "--batch_size", "4", "--dataset_percentage", "1.0", "--validation_split", "0.5",
        "--output_dir", str(out), "--engine", "pallas"])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    final = torch.load(out / "diffusion_RDUNet_model_checkpointed_final.pth", weights_only=True)
    assert "unet.input_block.conv_1.weight" in final
    assert torch.load(out / EPOCH_FILE.format(1), weights_only=True)["epoch"] == 1

    args = pdiff.build_arg_parser().parse_args(["--dataset_choice", "SIDD", "--device-data"])
    with pytest.raises(ValueError, match="DIV2K only"):
        pdiff.load_data_for(args, device="cpu")
    sidd = tmp_path / "SIDD_dataset.nosync" / "SIDD_Medium_Srgb"
    os.makedirs(sidd)
    write_sidd(sidd)
    args = pdiff.build_arg_parser().parse_args(
        ["--dataset_choice", "SIDD", "--data_root", str(tmp_path), "--batch_size", "2",
         "--dataset_percentage", "1.0"])
    tr, _ = pdiff.load_data_for(args, device="cpu")
    noisy, clean = next(iter(tr))
    assert noisy.shape == clean.shape == (2, 3, PATCH, PATCH)


class _SigtermOnce:
    """One (noisy, clean) batch per epoch; SIGTERM to this process while the
    first epoch iterates."""

    def __init__(self, batch):
        self.batch, self.sent = batch, False

    def __len__(self):
        return 1

    def __iter__(self):
        if not self.sent:
            self.sent = True
            os.kill(os.getpid(), signal.SIGTERM)
        yield self.batch


def test_sigterm_checkpoints_and_stops_after_the_epoch(tmp_path):
    x = torch.rand(2, 3, PATCH, PATCH) * 2 - 1
    previous = signal.getsignal(signal.SIGTERM)
    trainer = pdiff.DiffusionTrainer(base_filters=BASE, timesteps=T, accumulation_steps=1,
                                     sampling="direct", output_dir=str(tmp_path), device="cpu")
    state = trainer.init(steps_per_epoch=1)
    _, history = trainer.fit(state, _SigtermOnce((x, x)), [(x, x)], 3)
    assert len(history) == 1 and os.path.isfile(tmp_path / EPOCH_FILE.format(1))
    assert not os.path.exists(tmp_path / EPOCH_FILE.format(2))
    sup = SupervisedTrainer(RDUNet(3, BASE), accumulation_steps=1, checkpoint_every=5,
                            checkpoint_dir=str(tmp_path / "sup"), device="cpu")
    state = sup.init(steps_per_epoch=1)
    _, history = sup.fit(state, _SigtermOnce((x, x)), 3)
    assert len(history) == 1
    assert torch.load(tmp_path / "sup" / "rdunet_denoising.pth", weights_only=True)["epoch"] == 1
    assert signal.getsignal(signal.SIGTERM) == previous


class _Recorder:
    """Stands in for a trainer, model or loader function and records its
    arguments (JAX's ``sharding`` and the port's ``device`` left out)."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def __call__(self, *args, **kwargs):
        kwargs.pop("sharding", None), kwargs.pop("device", None)
        call = (self.name, args, {k: _dtype_name(v) for k, v in kwargs.items()})
        if self.name == "RDUNet":
            return call
        self.log.append(call)
        if self.name == "loader":
            batch = (np.zeros((1, 8, 8, 3), np.float32),) * 2
            return [batch] * 3, [batch]
        return _FakeTrainer(self.log)


def _dtype_name(v):
    return getattr(v, "__name__", str(v).split(".")[-1]) if "float" in str(v) else v


class _FakeTrainer:
    def __init__(self, log):
        self.log = log

    def batch_sharding(self):
        return None

    def init(self, *args, **kwargs):
        return "state"

    def load_checkpoint(self, state, path):
        self.log.append(("load_checkpoint", (path,), {}))
        return state, 0

    def fit(self, state, *args, **kwargs):
        ints = {k: v for k, v in kwargs.items() if isinstance(v, int)}
        self.log.append(("fit", tuple(a for a in args if isinstance(a, int)), ints))
        return state, []


@pytest.mark.parametrize("preset", ["main_diffusion_rdunet", "main_diffusion_rdunet_sidd",
                                    "diffusion_rdunet_direct", "rdunet_supervised_main"])
def test_presets_call_their_trainer_and_loader_as_jax(preset, monkeypatch):
    from vub_image_denoising_tpu.models import rdunet as jrdunet

    logs = {}
    for side, mod, model_mod in (("jax", jpresets, jrdunet), ("port", ppresets, ppresets)):
        log = logs[side] = []
        for name, kind in (("DiffusionTrainer", "trainer"), ("SupervisedTrainer", "trainer"),
                           ("load_folder_data", "loader"), ("load_sidd_data", "loader")):
            monkeypatch.setattr(mod, name, _Recorder(log, kind if kind == "loader" else name))
        monkeypatch.setattr(model_mod, "RDUNet", _Recorder(log, "RDUNet"))
        getattr(mod, preset)("data", num_epochs=7) if preset != "rdunet_supervised_main" \
            else getattr(mod, preset)("data", num_epochs=7, batch_size=4)
    assert logs["port"] == logs["jax"]
    assert any(name == "fit" for name, _, _ in logs["port"])
