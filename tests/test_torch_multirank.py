"""The port's multi-device layer on two CPU ranks against one rank and the JAX package.

One module fixture starts ONE group of two ranks (two processes,
``torch.distributed`` over gloo on the CPU, ``parallel.mesh.init_distributed``)
that runs every scenario in turn and writes each rank's results; each test
asserts its own.  The one-rank references run in this process, the JAX
references at XLA's lowest backend optimization level (tiny models: compile
time is their cost).  Scenarios:

- a supervised SGD step (accumulation 2, clip 1.0) under ``replicated``
  (data parallel), ``fsdp`` and ``tp``, and a diffusion SGD step under data
  parallelism (each rank draws the global batch's timesteps), against the
  one-rank step: params within STEP_RTOL / STEP_ATOL;
- ``--tile-parallel`` on a 500 x 24 image (bands of 256 rows, a halo of
  ``halo_rows()``) against JAX's single-device forward on the same padded
  canvas (rtol 1e-4, atol 1e-5: ``tests/test_tiles_and_tb.py``) and against
  one rank;
- the ``--tensor-parallel`` forward against JAX's forward and one rank
  (1e-4), and the server's (rank 0 leads, rank 1 follows);
- ``sidd_cli``'s pipelined sampler (S = 2, microbatch 2, a ragged tail)
  against JAX's ``improved_sampling`` (1e-4);
- an RCA-GAN round (D step and G step) in f64 with BatchNorm over both ranks'
  rows, the texture and content terms over the global batch, against one
  rank's round on the whole batch: the losses (rtol 1e-11), the clipped
  gradients each step applied (rtol 1e-9, atol 1e-11 * max|g|: both runs
  agree to about 1e-13 of max|g|) and G's running statistics (the params
  after Adam's first step are not
  compared: it moves an element by lr * sign(g), and some of G's leaves
  have an exact gradient of about zero, as ``tests/test_torch_gan.py``
  notes);
- an FSDP trainer's checkpoint resumed by a replicated trainer: params and
  the Adam state equal;
- spatially partitioned training (``batch_sharding="spatial"``): RDUNet(3, 8)
  on 2 x 3 x 64 x 64 with H split in two bands of 32 rows (4 rows a band at
  the deepest scale, exactly a DenoisingBlock's halo), JAX's weights: the
  band forward, gathered, against JAX's forward on the whole image (2e-4),
  and one SGD step against one rank's (loss rel 1e-5, as
  ``tests/test_sharding.py``'s spatial test; params within STEP_RTOL /
  STEP_ATOL); ``shard_spatial`` refuses H = 48 over the two ranks;
- the diffusion trainer on bands (``DiffusionTrainer(batch_sharding=
  "spatial")``): RDUNetT(8) on 1 x 3 x 64 x 64, loss weights (0, 1, 0.3)
  (the SSIM term's own halo), accumulation 1, every rank drawing one
  rank's timesteps: one SGD step against one rank's (STEP_RTOL /
  STEP_ATOL) and the banded sampler, gathered, against one rank's (1e-4);
  ``band_combined_loss`` with all three terms on, meaned over the ranks,
  and its gathered ``pred`` gradient against JAX's ``combined_loss`` and
  ``jax.grad`` of it on the whole image (rtol 1e-5, atol 1e-6).
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_apply import numpy_params_like, run_jax
from test_torch_rdunet import one_thread  # noqa: F401 — autouse
from vub_image_denoising_tpu.diffusion import InterpolationDiffusion as JDiffusion
from vub_image_denoising_tpu.diffusion.losses import combined_loss as jcombined_loss
from vub_image_denoising_tpu.models.rdunet import RDUNet as JRDUNet
from vub_image_denoising_tpu.models.rdunet import RDUNetT as JRDUNetT
from vub_image_denoising_tpu_torch.eval.denoise_cli import build_apply
from vub_image_denoising_tpu_torch.eval.sidd_cli import load_sampler
from vub_image_denoising_tpu_torch.models import RDUNet
from vub_image_denoising_tpu_torch.parallel.tiles import denoise_large_image
from vub_image_denoising_tpu_torch.train import DiffusionTrainer, SupervisedTrainer, TrainState
from vub_image_denoising_tpu_torch.train.gan import RCAGANTrainer
from vub_image_denoising_tpu_torch.utils.checkpoint import load_pth, params_to_state_dict, save_pth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
WORLD = 2
BAND_STEP_WEIGHTS = (0.0, 1.0, 0.3)   # the diffusion band step: Charbonnier and SSIM
BAND_LOSS_WEIGHTS = (0.5, 1.0, 0.3)   # the banded loss against JAX's: every term

# Run by each rank: python -c WORKER rank world port tmp root
WORKER = textwrap.dedent(r"""
    import sys
    import torch
    torch.set_num_threads(1)
    rank, world, port, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, sys.argv[5])
    from vub_image_denoising_tpu_torch.parallel import mesh as pm
    pm.init_distributed("gloo", f"tcp://127.0.0.1:{port}", world, rank)
    from vub_image_denoising_tpu_torch.data.device import fold_generator
    from vub_image_denoising_tpu_torch.eval.denoise_cli import build_denoiser
    from vub_image_denoising_tpu_torch.eval.serve import follow, lead
    from vub_image_denoising_tpu_torch.eval.sidd_cli import load_sampler
    from vub_image_denoising_tpu_torch.models import RDUNet
    from vub_image_denoising_tpu_torch.parallel.fsdp import sharded_fraction
    from vub_image_denoising_tpu_torch.parallel.spatial import band_combined_loss, band_forward
    from vub_image_denoising_tpu_torch.train import (DiffusionTrainer, SupervisedTrainer,
                                                     TrainState)
    from vub_image_denoising_tpu_torch.train.gan import RCAGANTrainer
    from vub_image_denoising_tpu_torch.utils.checkpoint import load_pth

    inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)  # written by the test
    out = {}

    class SGD:
        def __init__(self, clip_norm):
            self.clip_norm = clip_norm

        def build(self, leaves):
            opt = torch.optim.SGD(list(leaves), lr=1e-2)
            return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: 1.0)

    def sgd(trainer, state):
        return TrainState.create(state.params, SGD(trainer.clip_norm), state.parallel)

    for mode in ("replicated", "fsdp", "tp"):
        model = RDUNet(3, 8)
        model.load_state_dict(inp["sup_sd"])
        trainer = SupervisedTrainer(model, accumulation_steps=2, device="cpu",
                                    param_sharding=mode, checkpoint_dir=tmp)
        state = trainer.init(steps_per_epoch=1)
        out[f"{mode}_fraction"] = sharded_fraction(state)
        x, y = (inp["sup_x"], inp["sup_y"]) if mode == "tp" else (
            pm.shard_batch(inp["sup_x"], trainer.mesh), pm.shard_batch(inp["sup_y"], trainer.mesh))
        _, loss = trainer._step(sgd(trainer, state), x, y)
        out[f"{mode}_loss"] = float(trainer.global_mean(loss))
        out[f"{mode}_params"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
        if mode == "fsdp":
            state, _ = trainer.train_step(state, x, y)
            trainer.maybe_checkpoint(state, 0, force=True, name="fsdp.pth")
            out["fsdp_ckpt"] = {"params": {k: v.detach().clone()
                                           for k, v in model.state_dict().items()},
                                "opt": state.optimizer_state()}

    model, _ = load_pth(f"{tmp}/spatial.pth", RDUNet(3, 8))
    trainer = SupervisedTrainer(model, accumulation_steps=2, device="cpu",
                                batch_sharding="spatial")
    state = trainer.init(steps_per_epoch=1)
    group = trainer.mesh.group("data")
    with torch.no_grad():
        band = band_forward(model, trainer.put(inp["spatial_x"]), group)
    out["spatial_forward"] = pm.all_gather(band, 2, group)
    _, loss = trainer._step(sgd(trainer, state), trainer.put(inp["spatial_x"]),
                            trainer.put(inp["spatial_y"]))
    out["spatial_loss"] = float(trainer.global_mean(loss))
    out["spatial_params"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    try:
        pm.shard_spatial(inp["spatial_x"][:, :, :48], trainer.mesh)
    except ValueError as e:
        out["spatial_refused"] = str(e)

    trainer = DiffusionTrainer(base_filters=8, timesteps=4, accumulation_steps=1,
                               loss_weights=inp["band_step_weights"], device="cpu",
                               batch_sharding="spatial")
    state = trainer.init(steps_per_epoch=1, seed=0)
    _, loss = trainer._step(sgd(trainer, state), trainer.generator,
                            trainer.put(inp["band_noisy"]), trainer.put(inp["band_clean"]))
    out["band_diff_loss"] = float(trainer.global_mean(loss))
    out["band_diff_params"] = {k: v.detach().clone()
                               for k, v in trainer.unet.state_dict().items()}
    out["band_sample"] = trainer.sample(state, inp["band_noisy"])
    group = trainer.mesh.group("data")
    pred = trainer.put(inp["loss_pred"]).requires_grad_()
    share = band_combined_loss(pred, trainer.put(inp["loss_target"]), group,
                               *inp["band_loss_weights"])
    out["band_loss"] = float(trainer.global_mean(share.detach()))
    out["band_loss_grad"] = pm.all_gather(
        torch.autograd.grad(share / pm.group_size(group), pred)[0], 2, group)

    trainer = DiffusionTrainer(base_filters=8, timesteps=4, accumulation_steps=2, device="cpu")
    state = trainer.init(steps_per_epoch=1, seed=0)
    _, loss = trainer._step(sgd(trainer, state), trainer.generator,
                            pm.shard_batch(inp["diff_noisy"], trainer.mesh),
                            pm.shard_batch(inp["diff_clean"], trainer.mesh))
    out["diff_loss"] = float(trainer.global_mean(loss))
    out["diff_params"] = {k: v.detach().clone() for k, v in trainer.unet.state_dict().items()}

    out["tiles"] = build_denoiser(f"{tmp}/tiles.pth", base_filters=4, device="cpu",
                                  tile_parallel=True)(inp["tile_image"])
    tp_fn = build_denoiser(f"{tmp}/tp.pth", base_filters=8, device="cpu", tensor_parallel=True,
                           batched=True)
    out["tp_forward"] = tp_fn(inp["tp_x"])
    if rank == 0:  # the server's --tensor-parallel: rank 0 leads, the others follow
        served = lead(tp_fn, "cpu")
        out["tp_served"] = served(inp["tp_x"] * 0.5)
        served.close()
    else:
        follow(tp_fn, "cpu")
    out["pipeline"] = load_sampler(f"{tmp}/pp.pth", base_filters=4, timesteps=4, device="cpu",
                                   pipeline_parallel=True, pipeline_microbatch=2)(inp["pp_noisy"])

    gan = RCAGANTrainer(disc_input_hw=16, device="cpu", checkpoint_dir=tmp)
    gstate = gan.init(steps_per_epoch=1)
    for m in (gstate.generator, gstate.discriminator, gan.vgg):
        m.double()
    degraded = pm.shard_batch(inp["gan_degraded"], gan.mesh)
    gt = pm.shard_batch(inp["gan_gt"], gan.mesh)
    gen = fold_generator("cpu", 0, 0, 0)
    d_loss = gan.d_step(gstate, degraded, gt, gen)
    g_loss, _ = gan.g_step(gstate, degraded, gt, gen)
    out["gan"] = {"d_loss": float(d_loss), "g_loss": float(g_loss),
                  "g": {k: v.grad.clone() for k, v in gstate.generator.named_parameters()},
                  "d": {k: v.grad.clone() for k, v in gstate.discriminator.named_parameters()},
                  "stats": {k: v.clone() for k, v in gstate.generator.named_buffers()}}
    out["host_copies"] = pm.host_copies()
    torch.save(out, f"{tmp}/rank{rank}.pt")
    pm.barrier()
""")


class SGD:
    """An optimizer spec (``TrainState.create``'s ``tx``): SGD(1e-2), a flat
    schedule, the trainer's clip."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def build(self, leaves):
        opt = torch.optim.SGD(list(leaves), lr=1e-2)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: 1.0)


def sgd(trainer, state):
    return TrainState.create(state.params, SGD(trainer.clip_norm), state.parallel)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def jax_params(model, seed, *example):
    return numpy_params_like(jax.eval_shape(model.init, jax.random.PRNGKey(0), *example), seed)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs and checkpoints, the two ranks' results and the JAX references."""
    tmp = str(tmp_path_factory.mktemp("multirank"))
    rng = np.random.RandomState(0)
    inp = {"sup_sd": RDUNet(3, 8, generator=torch.Generator().manual_seed(0)).state_dict()}
    for k in ("sup_x", "sup_y", "diff_noisy", "diff_clean"):
        inp[k] = torch.from_numpy(rng.uniform(-1, 1, (4, 3, 16, 16)).astype(np.float32))
    inp["tile_image"] = rng.uniform(-1, 1, (500, 24, 3)).astype(np.float32) * 0.2
    inp["tp_x"] = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    inp["pp_noisy"] = torch.from_numpy(rng.uniform(-1, 1, (5, 16, 16, 3)).astype(np.float32))
    for k in ("gan_degraded", "gan_gt"):
        inp[k] = torch.from_numpy(rng.uniform(-1, 1, (4, 1, 16, 16)))
    for k in ("spatial_x", "spatial_y"):
        inp[k] = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32))
    for k in ("band_noisy", "band_clean", "loss_target"):
        inp[k] = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 64, 64)).astype(np.float32))
    inp["loss_pred"] = inp["loss_target"] + torch.from_numpy(
        0.2 * rng.randn(1, 3, 64, 64).astype(np.float32))
    inp["band_step_weights"], inp["band_loss_weights"] = BAND_STEP_WEIGHTS, BAND_LOSS_WEIGHTS
    torch.save(inp, f"{tmp}/inputs.pt")

    jax_models = {"tiles": (JRDUNet(3, 4), (jnp.zeros((1, 16, 16, 3)),)),
                  "tp": (JRDUNet(3, 8), (jnp.zeros((1, 16, 16, 3)),)),
                  "pp": (JRDUNetT(4), (jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)))),
                  "spatial": (JRDUNet(3, 8), (jnp.zeros((1, 16, 16, 3)),))}
    params = {}
    for i, (name, (model, example)) in enumerate(jax_models.items()):
        params[name] = jax_params(model, 10 + i, *example)
        save_pth(f"{tmp}/{name}.pth", params_to_state_dict(params[name]),
                 prefix="unet." if name == "pp" else "")

    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(WORLD), port, tmp, ROOT],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(WORLD)]

    pad = np.pad(inp["tile_image"], ((0, 12), (0, 0), (0, 0)), mode="reflect")[None]
    jdiff = JDiffusion(timesteps=4)
    refs = {
        "tiles": np.asarray(run_jax(jax_models["tiles"][0].apply, params["tiles"],
                                    jnp.asarray(pad)))[0, :500],
        "tp": np.asarray(run_jax(jax_models["tp"][0].apply, params["tp"],
                                 jnp.asarray(inp["tp_x"]))),
        "pp": np.asarray(run_jax(lambda p, n: jdiff.improved_sampling(
            jax_models["pp"][0].apply, p, n), params["pp"], jnp.asarray(inp["pp_noisy"].numpy()))),
        "spatial": np.asarray(run_jax(jax_models["spatial"][0].apply, params["spatial"],
                                      jnp.asarray(inp["spatial_x"].permute(0, 2, 3, 1).numpy()))),
    }
    return {"tmp": tmp, "inp": inp, "ranks": ranks, "jax": refs}


def assert_params_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=STEP_RTOL, atol=STEP_ATOL, msg=k)


def one_rank_supervised(inp):
    model = RDUNet(3, 8)
    model.load_state_dict(inp["sup_sd"])
    trainer = SupervisedTrainer(model, accumulation_steps=2, device="cpu")
    state = trainer.init(steps_per_epoch=1)
    _, loss = trainer._step(sgd(trainer, state), inp["sup_x"], inp["sup_y"])
    return float(loss), model.state_dict()


@pytest.mark.parametrize("mode", ["replicated", "fsdp", "tp"])
def test_supervised_step_over_two_ranks_equals_one_rank(run, mode):
    loss, params = one_rank_supervised(run["inp"])
    for r in run["ranks"]:
        assert r[f"{mode}_loss"] == pytest.approx(loss, rel=1e-5)
        assert_params_close(r[f"{mode}_params"], params)
        assert (r[f"{mode}_fraction"] > 0.5) == (mode != "replicated")


def test_diffusion_step_draws_the_global_batch_and_equals_one_rank(run):
    trainer = DiffusionTrainer(base_filters=8, timesteps=4, accumulation_steps=2, device="cpu")
    state = trainer.init(steps_per_epoch=1, seed=0)
    _, loss = trainer._step(sgd(trainer, state), trainer.generator, run["inp"]["diff_noisy"],
                            run["inp"]["diff_clean"])
    for r in run["ranks"]:
        assert r["diff_loss"] == pytest.approx(float(loss), rel=1e-5)
        assert_params_close(r["diff_params"], trainer.unet.state_dict())


def test_tile_parallel_matches_jax_and_one_rank(run):
    forward, _ = build_apply(f"{run['tmp']}/tiles.pth", base_filters=4, device="cpu")
    one = denoise_large_image(forward, run["inp"]["tile_image"], None, pad_to=16)
    for r in run["ranks"]:
        assert r["tiles"].shape == (500, 24, 3)
        np.testing.assert_allclose(r["tiles"], run["jax"]["tiles"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["tiles"], one, rtol=1e-4, atol=1e-5)


def test_tensor_parallel_forward_matches_jax_and_one_rank(run):
    forward, _ = build_apply(f"{run['tmp']}/tp.pth", base_filters=8, device="cpu")
    one = forward(torch.from_numpy(run["inp"]["tp_x"])).numpy()
    for r in run["ranks"]:
        got = np.asarray(r["tp_forward"])
        np.testing.assert_allclose(got, run["jax"]["tp"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, one, rtol=1e-4, atol=1e-4)
    served = forward(torch.from_numpy(run["inp"]["tp_x"] * 0.5)).numpy()
    np.testing.assert_allclose(run["ranks"][0]["tp_served"], served, rtol=1e-4, atol=1e-4)


def test_pipelined_sampler_matches_jax_improved_sampling(run):
    one = load_sampler(f"{run['tmp']}/pp.pth", base_filters=4, timesteps=4,
                       device="cpu")(run["inp"]["pp_noisy"])
    for r in run["ranks"]:
        got = np.asarray(r["pipeline"])
        assert got.shape == (5, 16, 16, 3)
        np.testing.assert_allclose(got, run["jax"]["pp"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, one.numpy(), rtol=1e-4, atol=1e-4)


def test_gan_round_with_batchnorm_over_ranks_equals_one_rank(run):
    from vub_image_denoising_tpu_torch.data.device import fold_generator

    gan = RCAGANTrainer(disc_input_hw=16, device="cpu", checkpoint_dir=run["tmp"])
    state = gan.init(steps_per_epoch=1)
    for m in (state.generator, state.discriminator, gan.vgg):
        m.double()
    gen = fold_generator("cpu", 0, 0, 0)
    d_loss = gan.d_step(state, run["inp"]["gan_degraded"], run["inp"]["gan_gt"], gen)
    g_loss, _ = gan.g_step(state, run["inp"]["gan_degraded"], run["inp"]["gan_gt"], gen)
    for r in run["ranks"]:
        assert r["gan"]["d_loss"] == pytest.approx(float(d_loss), rel=1e-11)
        assert r["gan"]["g_loss"] == pytest.approx(float(g_loss), rel=1e-11)
        for part, module in (("g", state.generator), ("d", state.discriminator)):
            grads = {k: v.grad for k, v in module.named_parameters()}
            gmax = max(g.abs().max().item() for g in grads.values())
            for k, g in grads.items():
                torch.testing.assert_close(r["gan"][part][k], g, rtol=1e-9, atol=1e-11 * gmax,
                                           msg=k)
        for k, v in state.generator.named_buffers():
            torch.testing.assert_close(r["gan"]["stats"][k], v, rtol=1e-9, atol=1e-12, msg=k)


def test_fsdp_checkpoint_resumes_in_a_replicated_trainer(run):
    model = RDUNet(3, 8, generator=torch.Generator().manual_seed(9))
    trainer = SupervisedTrainer(model, accumulation_steps=2, device="cpu")
    state = trainer.init(steps_per_epoch=1)
    state, epoch = trainer.load_checkpoint(state, f"{run['tmp']}/fsdp.pth")
    assert epoch == 1
    saved = run["ranks"][0]["fsdp_ckpt"]
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, saved["params"][k], rtol=0, atol=0)
    params = list(model.parameters())
    for i, entry in state.optimizer.state_dict()["state"].items():
        for name, v in entry.items():
            torch.testing.assert_close(v, saved["opt"]["state"][i][name], rtol=0, atol=0)
            if name != "step":
                assert v.shape == params[i].shape
    assert run["ranks"][0]["host_copies"] == 0  # CPU tensors go to gloo as they are


def test_spatial_band_forward_matches_jax_on_the_whole_image(run):
    for r in run["ranks"]:
        got = r["spatial_forward"].numpy().transpose(0, 2, 3, 1)
        assert got.shape == (2, 64, 64, 3)
        np.testing.assert_allclose(got, run["jax"]["spatial"], rtol=2e-4, atol=2e-4)
        assert "deepest" in r["spatial_refused"]


def test_spatial_step_over_two_ranks_equals_one_rank(run):
    model, _ = load_pth(f"{run['tmp']}/spatial.pth", RDUNet(3, 8))
    trainer = SupervisedTrainer(model, accumulation_steps=2, device="cpu")
    state = trainer.init(steps_per_epoch=1)
    _, loss = trainer._step(sgd(trainer, state), run["inp"]["spatial_x"],
                            run["inp"]["spatial_y"])
    for r in run["ranks"]:
        assert r["spatial_loss"] == pytest.approx(float(loss), rel=1e-5)
        assert_params_close(r["spatial_params"], model.state_dict())


@pytest.fixture(scope="module")
def one_rank_band(run):
    """The one-rank diffusion step and sampler of the band scenario."""
    trainer = DiffusionTrainer(base_filters=8, timesteps=4, accumulation_steps=1,
                               loss_weights=BAND_STEP_WEIGHTS, device="cpu")
    state = trainer.init(steps_per_epoch=1, seed=0)
    _, loss = trainer._step(sgd(trainer, state), trainer.generator, run["inp"]["band_noisy"],
                            run["inp"]["band_clean"])
    return {"loss": float(loss), "params": trainer.unet.state_dict(),
            "sample": trainer.sample(state, run["inp"]["band_noisy"])}


def test_diffusion_band_step_over_two_ranks_equals_one_rank(run, one_rank_band):
    for r in run["ranks"]:
        assert r["band_diff_loss"] == pytest.approx(one_rank_band["loss"], rel=1e-5)
        assert_params_close(r["band_diff_params"], one_rank_band["params"])


def test_banded_sampler_gathered_equals_one_rank(run, one_rank_band):
    for r in run["ranks"]:
        assert r["band_sample"].shape == (1, 3, 64, 64)
        torch.testing.assert_close(r["band_sample"], one_rank_band["sample"], rtol=1e-4,
                                   atol=1e-4)


def test_banded_combined_loss_and_grad_match_jax_on_the_whole_image(run):
    def nhwc(t):
        return jnp.asarray(t.permute(0, 2, 3, 1).numpy())

    pred, target = nhwc(run["inp"]["loss_pred"]), nhwc(run["inp"]["loss_target"])

    def loss(p, t):
        return jcombined_loss(p, t, *BAND_LOSS_WEIGHTS)

    want = float(run_jax(loss, pred, target))
    want_grad = np.asarray(run_jax(jax.grad(loss), pred, target)).transpose(0, 3, 1, 2)
    for r in run["ranks"]:
        np.testing.assert_allclose(r["band_loss"], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["band_loss_grad"].numpy(), want_grad, rtol=1e-5, atol=1e-6)
