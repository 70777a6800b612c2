"""The port's accuracy protocol (``scripts/train_accuracy.py``) against the
JAX package's (``scripts/train_tpu_accuracy.py``), on the CPU, at a tiny size
(RDUNet base 4, 32^2 images, batch 4).

- The synthetic images are byte-equal to the JAX script's functions (loaded
  from its file, each given its own cache directory).
- The protocol's evaluation equals the same evaluation built from the JAX
  package's functions (``psnr_per_image``, ``denormalize``, the model's
  forward) on the same weights and noisy images: per image within 1e-3 dB,
  in strict f32 (JAX at HIGHEST precision, XLA's lowest backend
  optimization level).
- A checkpoint the port trained (two tiny epochs of ``main``) reads through
  the JAX package's ``.pth`` loader and scores within 0.05 dB in both
  packages (the budget of ``scripts/check_torch_parity.py``).
- ``main`` end to end for supervised, blind and diffusion runs: the row's
  keys are the JAX row's (read from the JAX script's source), progress.json,
  the ``mid_`` names, a resume that continues the epoch count, the
  supervised-only guard, the partial row.
- ``DeviceBankLoader(steps_per_epoch=...)`` has the JAX loader's length.
"""

import ast
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gan import compile_o0
from test_torch_rdunet import one_thread  # noqa: F401 — autouse
from vub_image_denoising_tpu.data.device import denormalize as jdenormalize
from vub_image_denoising_tpu.data.resident import DeviceBankLoader as JDeviceBankLoader
from vub_image_denoising_tpu.eval.metrics import psnr_per_image as jpsnr_per_image
from vub_image_denoising_tpu.models.rdunet import RDUNet as JRDUNet
from vub_image_denoising_tpu.utils.checkpoint import load_torch_payload, torch_state_dict_to_params
from vub_image_denoising_tpu_torch.data.resident import DeviceBankLoader
from vub_image_denoising_tpu_torch.models import RDUNet
from vub_image_denoising_tpu_torch.scripts import train_accuracy as ta
from vub_image_denoising_tpu_torch.train.supervised import SupervisedTrainer
from vub_image_denoising_tpu_torch.utils.checkpoint import load_pth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "train_tpu_accuracy.py")
BASE, SIZE, N_TRAIN, N_VAL, BATCH = 4, 32, 8, 4, 4
EVAL_TOL_DB = 1e-3
PARITY_BUDGET_DB = 0.05


def load_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def row_keys(path, name):
    """(keys of the ``name = {...}`` dict, keys assigned as ``name["k"] = ...``)
    in the script at ``path``."""
    base, extra = set(), set()
    for node in ast.walk(ast.parse(open(path).read())):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        t = node.targets[0]
        if isinstance(t, ast.Name) and t.id == name and isinstance(node.value, ast.Dict):
            base |= {k.value for k in node.value.keys}
        elif isinstance(t, ast.Subscript) and getattr(t.value, "id", None) == name:
            extra.add(t.slice.value)
    return base, extra


def expected_keys(*extra):
    base, optional = row_keys(JAX_SCRIPT, "result")
    assert set(extra) <= optional
    return base | set(extra)


def common_args(root):
    return ["--device", "cpu", "--batch-size", str(BATCH), "--size", str(SIZE),
            "--n-train", str(N_TRAIN), "--n-val", str(N_VAL), "--base-filters", str(BASE),
            "--cache-dir", str(root / "cache"), "--out", str(root / "log.jsonl")]


@pytest.fixture(scope="module")
def supervised_runs(tmp_path_factory):
    """Two epochs of the supervised protocol (a mid_ checkpoint after the
    first), then one more resumed from that mid_ checkpoint."""
    root = tmp_path_factory.mktemp("supervised")
    ck = root / "ck"
    straight = ta.main(common_args(root) + ["--epochs", "2", "--eval-every", "1",
                                            "--ckpt-every", "1", "--device-data",
                                            "--ckpt-dir", str(ck)])
    progress = json.loads((ck / "progress.json").read_text())
    resumed = ta.main(common_args(root) + ["--epochs", "1", "--device-data",
                                           "--ckpt-dir", str(root / "ck_resumed"),
                                           "--resume", str(ck / "mid_rdunet_denoising.pth")])
    return {"root": root, "ck": ck, "straight": straight, "resumed": resumed,
            "progress": progress}


@pytest.fixture(scope="module")
def jax_eval():
    """JAX's protocol evaluation, built from the JAX package's functions:
    per-image PSNR of clip(denormalize(RDUNet.apply(params, noisy))) against
    the clean image, compiled once for BASE-width params on N_VAL images."""
    model = JRDUNet(channels=3, base_filters=BASE)
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), template)

    def evaluate(params, noisy_u8, clean_u8):
        noisy = ((noisy_u8.astype(jnp.float32) / 255.0) - 0.5) / 0.5
        out = model.apply(params, noisy)
        return jpsnr_per_image(clean_u8.astype(jnp.float32) / 255.0,
                               jnp.clip(jdenormalize(out.astype(jnp.float32)), 0.0, 1.0),
                               data_range=1.0)

    shape = jax.ShapeDtypeStruct((N_VAL, SIZE, SIZE, 3), jnp.uint8)
    compiled = compile_o0(evaluate, template, shape, shape)

    def run(state_dict, noisy_u8, clean_u8):
        sd = {k: v.detach().clone() for k, v in state_dict.items()}
        params = torch_state_dict_to_params(sd, template)
        return np.asarray(compiled(params, jnp.asarray(noisy_u8), jnp.asarray(clean_u8)),
                          np.float64)

    return run


def heldout_pairs(root):
    """The protocol's held-out pairs at the test size, from its cache."""
    _, val = ta.synth_train_val(N_TRAIN, N_VAL, SIZE, cache_dir=str(root / "cache"))
    return ta.heldout_noisy(val, np.full(len(val), 25.0, np.float32)), val


def port_psnr(model, noisy_u8, clean_u8):
    trainer = SupervisedTrainer(model, device="cpu")
    state = trainer.init(1)
    return ta.evaluate_psnr(lambda x: trainer.evaluate_batch(state, x), noisy_u8, clean_u8,
                            ta.EVAL_BATCH["supervised"], torch.device("cpu"))


def test_synthetic_images_byte_equal_to_the_jax_script(tmp_path):
    ref = load_script(JAX_SCRIPT, "train_tpu_accuracy_reference")
    np.testing.assert_array_equal(ta.synth_images(3, 24, np.random.RandomState(5)),
                                  ref.synth_images(3, 24, np.random.RandomState(5)))
    want = ref.synth_train_val(3, 2, 24, seed=4, cache_dir=str(tmp_path / "jax"))
    for _ in range(2):  # generated, then read back from the cache
        got = ta.synth_train_val(3, 2, 24, seed=4, cache_dir=str(tmp_path / "port"))
        for a, b in zip(got, want):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
    assert os.listdir(tmp_path / "port") == ["synth_4_24_3_2.npz"]


def test_evaluation_matches_jax_per_image(tmp_path, jax_eval):
    model = RDUNet(3, BASE, generator=torch.Generator().manual_seed(3))
    noisy_u8, clean_u8 = heldout_pairs(tmp_path)
    got = port_psnr(model, noisy_u8, clean_u8)
    want = jax_eval(model.state_dict(), noisy_u8, clean_u8)
    assert got.shape == want.shape == (N_VAL,)
    np.testing.assert_allclose(got, want, atol=EVAL_TOL_DB, rtol=0)


def test_port_trained_checkpoint_scores_alike_in_both_packages(supervised_runs, jax_eval):
    """The final checkpoint of the port's run, read by the JAX package's own
    ``.pth`` loader and by the port's, scored on the protocol's held-out
    pairs by both: |delta mean PSNR| < 0.05 dB."""
    path = str(supervised_runs["ck"] / "rdunet_denoising.pth")
    noisy_u8, clean_u8 = heldout_pairs(supervised_runs["root"])
    jax_sd = load_torch_payload(path)["model_state_dict"]
    want = jax_eval(jax_sd, noisy_u8, clean_u8)
    model = RDUNet(3, BASE)
    load_pth(path, model)
    got = port_psnr(model, noisy_u8, clean_u8)
    assert abs(got.mean() - want.mean()) < PARITY_BUDGET_DB
    np.testing.assert_allclose(got, want, atol=EVAL_TOL_DB, rtol=0)
    # the row's figure is this checkpoint's score, evaluated in bf16
    assert abs(supervised_runs["straight"]["psnr_denoised_db"] - got.mean()) < PARITY_BUDGET_DB


def test_main_supervised_row_progress_mid_and_resume(supervised_runs):
    straight, resumed = supervised_runs["straight"], supervised_runs["resumed"]
    assert set(straight) == expected_keys()
    assert set(resumed) == expected_keys("resumed_from_epoch")
    assert (straight["epochs"], straight["steps"], straight["lr"]) == (2, 4, 1e-4)
    assert (resumed["epochs"], resumed["resumed_from_epoch"], resumed["steps"]) == (2, 1, 4)
    assert np.isfinite([straight["psnr_denoised_db"], resumed["psnr_denoised_db"]]).all()
    assert supervised_runs["progress"]["epochs_done"] == 2
    assert sorted(os.listdir(supervised_runs["ck"])) == [
        "mid_rdunet_denoising.pth", "progress.json", "rdunet_denoising.pth"]
    rows = [json.loads(line) for line in
            (supervised_runs["root"] / "log.jsonl").read_text().splitlines()]
    assert rows == [straight, resumed]


@pytest.mark.parametrize("kind", ["blind", "diffusion"])
def test_main_blind_and_diffusion(tmp_path, kind):
    ck = tmp_path / "ck"
    extra = (["--sigma-list", "10,30"] if kind == "blind"
             else ["--algo", "diffusion", "--timesteps", "2", "--ckpt-every", "1"])
    row = ta.main(common_args(tmp_path) + ["--epochs", "2", "--eval-every", "5",
                                           "--ckpt-dir", str(ck)] + extra)
    if kind == "blind":
        assert set(row) == expected_keys("sigma_list", "psnr_by_sigma_db",
                                         "psnr_noisy_by_sigma_db")
        assert row["sigma"] is None and sorted(row["psnr_by_sigma_db"]) == ["10", "30"]
        assert row["psnr_noisy_by_sigma_db"]["10"] > row["psnr_noisy_by_sigma_db"]["30"]
        assert sorted(os.listdir(ck)) == ["progress.json", "rdunet_denoising.pth"]
    else:
        assert set(row) == expected_keys("timesteps", "loss_weights", "t_dist")
        assert (row["timesteps"], row["t_dist"], row["loss_weights"]) == (2, "uniform", "0,1,0")
        assert sorted(os.listdir(ck)) == ["diffusion_RDUNet_model_checkpointed_epoch_2.pth",
                                          "mid_checkpoint.pth", "progress.json"]
    assert json.loads((ck / "progress.json").read_text())["epochs_done"] == 2
    assert np.isfinite(row["psnr_denoised_db"])


@pytest.mark.parametrize("flag", [["--loss-weights", "1,0,0"], ["--t-dist", "biased"],
                                  ["--optimizer", "adam"], ["--scheduler", "cosine"]])
def test_supervised_only_guard_exits_before_any_work(tmp_path, flag):
    """No --device cpu: reaching the device would raise here (no CUDA), so a
    SystemExit with the guard's message shows the guard came first."""
    with pytest.raises(SystemExit, match="only apply to --algo diffusion"):
        ta.main(["--cache-dir", str(tmp_path / "cache"), "--out", str(tmp_path / "log"),
                 *flag])
    assert os.listdir(tmp_path) == []


def test_partial_row_writer(tmp_path):
    out = str(tmp_path / "runs" / "log.jsonl")
    partial = {"metric": "rdunet_supervised_synthetic_psnr", "epochs_target": 4}
    assert ta.write_partial_row(partial, out) is None
    assert not os.path.exists(out)
    partial.update(epochs_done=2, psnr_denoised_db=25.0, psnr_best_db=25.5)
    rec = ta.write_partial_row(partial, out)
    assert rec == {**partial, "partial": True} and "partial" not in partial
    assert [json.loads(line) for line in open(out)] == [rec]


@pytest.mark.parametrize("mode,n,batch,steps", [
    ("sample", 12, 4, None), ("sample", 12, 4, 7), ("permute", 12, 4, 2),
    ("sequential", 10, 4, None), ("sequential", 10, 4, 2)])
def test_device_bank_steps_per_epoch_len_matches_jax(mode, n, batch, steps):
    bank = np.zeros((n, 4, 4, 3), np.uint8)
    port = DeviceBankLoader(bank, batch, mode=mode, steps_per_epoch=steps, device="cpu")
    assert len(port) == len(JDeviceBankLoader(bank, batch, mode=mode, steps_per_epoch=steps))
    assert len(list(port)) == len(port)


def test_device_bank_permute_rejects_too_many_steps():
    with pytest.raises(ValueError, match="exceeds"):
        DeviceBankLoader(np.zeros((8, 4, 4, 3), np.uint8), 4, mode="permute",
                         steps_per_epoch=3, device="cpu")


def test_comparative_runner_on_the_protocol_checkpoint(supervised_runs, tmp_path, monkeypatch):
    """``run_comparative_suite`` on the protocol's U-Net checkpoint and a
    diffusion one: the noise levels cycle over {10..50} on RandomState(7)'s
    images, and the summary has the JAX runner's keys (figures skipped
    without matplotlib, as on the card's machine)."""
    from vub_image_denoising_tpu_torch.models import RDUNetT
    from vub_image_denoising_tpu_torch.scripts import run_comparative_suite as rcs
    from vub_image_denoising_tpu_torch.utils.checkpoint import save_pth

    diff = str(tmp_path / "diffusion.pth")
    save_pth(diff, RDUNetT(BASE, generator=torch.Generator().manual_seed(1)).state_dict(),
             epoch=1, prefix="unet.")
    monkeypatch.setattr(rcs, "have_matplotlib", lambda: False)
    summary = rcs.main(["--device", "cpu", "--no-bm3d", "--n-images", "3", "--size", str(SIZE),
                        "--batch-size", "2", "--timesteps", "2", "--base-filters", str(BASE),
                        "--epoch-label", "1", "--save-dir", str(tmp_path / "out"),
                        "--unet-ckpt", str(supervised_runs["ck"] / "rdunet_denoising.pth"),
                        "--diffusion-ckpt", diff])
    want = {"wall_seconds", "n_images", "convention", "inference_ms_mean"} | {
        f"{k}_{v}_by_sigma" for k in ("psnr", "ssim") for v in ("degraded", "unet", "diffusion")}
    assert set(summary) == want
    assert [lv for lv, p in summary["psnr_degraded_by_sigma"].items() if p is not None] == [
        "10", "20", "30"]
    assert json.loads((tmp_path / "out" / "summary.json").read_text()) == summary
