"""The port's GAN accuracy runs (``scripts/train_gan_accuracy.py``) against
the JAX package's (``scripts/train_tpu_gan_accuracy.py``), on the CPU, at a
tiny size (32^2 grayscale pairs, batch 2).

- ``main`` for each of ``rca``, ``attention`` and ``hybrid``: the row's keys
  are the JAX row's (read from the JAX script's source), progress.json and
  the checkpoint files are written, the PSNR is finite.
- The attention-only guard exits before any work.
- The attention GAN's held-out evaluation (``evaluate_gan``) equals the
  same evaluation built from the JAX package's functions on the port's
  weights carried over, within 1e-3 dB (JAX at HIGHEST precision, XLA's
  lowest backend optimization level).
- ``PairLoader`` batches are the JAX loader's normalization of the same rows.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_accuracy import row_keys
from test_torch_gan import jax_vars, run_o0
from test_torch_rdunet import one_thread  # noqa: F401 — autouse
from vub_image_denoising_tpu.eval.metrics import psnr_per_image as jpsnr_per_image
from vub_image_denoising_tpu.models.attention_unet import AttentionUNet as JUNet
from vub_image_denoising_tpu_torch.scripts import train_accuracy as ta
from vub_image_denoising_tpu_torch.scripts import train_gan_accuracy as tg
from vub_image_denoising_tpu_torch.train.denoising_gan import DenoisingGANTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "train_tpu_gan_accuracy.py")
SIZE = 32
EVAL_TOL_DB = 1e-3
# the final save names epoch index epochs - 1: the attention GAN's files as
# given, the RCA critic's trainers' as epoch + 1
CKPT_FILES = {"attention": ["denoising_gan_discriminator_0.pth", "denoising_gan_generator_0.pth"],
              "rca": ["checkpoint_epoch_1.pth"], "hybrid": ["checkpoint_epoch_1.pth"]}


def tiny_args(root, algo):
    return ["--device", "cpu", "--algo", algo, "--epochs", "1", "--batch-size", "2",
            "--size", str(SIZE), "--n-train", "4", "--n-val", "4", "--eval-every", "1",
            "--num-timesteps", "10", "--cache-dir", str(root / "cache"),
            "--ckpt-dir", str(root / "ck"), "--out", str(root / "log.jsonl")]


@pytest.mark.parametrize("algo", ["rca", "attention", "hybrid"])
def test_main_row_progress_and_checkpoint(tmp_path, algo):
    rec = tg.main(tiny_args(tmp_path, algo))
    base, _ = row_keys(JAX_SCRIPT, "rec")
    assert set(rec) == base
    assert (rec["algo"], rec["epochs"], rec["steps"], rec["size"]) == (algo, 1, 2, SIZE)
    assert rec["critic_norm"] == (None if algo == "attention" else "bn")
    assert np.isfinite([rec["psnr_denoised_db"], rec["psnr_best_db"], rec["d_loss_final"],
                        rec["g_loss_final"]]).all()
    progress = json.loads((tmp_path / "ck" / "progress.json").read_text())
    assert progress["epochs_done"] == 1 and progress["psnr_best_db"] == rec["psnr_best_db"]
    files = sorted(f for f in os.listdir(tmp_path / "ck") if f.endswith(".pth"))
    assert files == CKPT_FILES[algo]
    assert [json.loads(line) for line in (tmp_path / "log.jsonl").read_text().splitlines()] == [rec]


@pytest.mark.parametrize("flag", [["--critic-norm", "none"], ["--lam-adv", "0.5"],
                                  ["--adv-ramp-steps", "10"]])
def test_attention_guard_exits_before_any_work(tmp_path, flag):
    with pytest.raises(SystemExit, match="only apply to --algo rca/hybrid"):
        tg.main(["--algo", "attention", "--cache-dir", str(tmp_path / "cache"), *flag])
    assert os.listdir(tmp_path) == []


def test_attention_gan_evaluation_matches_jax(tmp_path):
    trainer = DenoisingGANTrainer(checkpoint_dir=str(tmp_path), device="cpu")
    state = trainer.init(1)
    _, val = ta.synth_train_val(2, 4, SIZE, cache_dir=str(tmp_path / "cache"))
    gt = val.mean(axis=-1, keepdims=True).astype(np.uint8)
    deg = ta.heldout_noisy(gt, np.full(len(gt), 25.0, np.float32))
    got = tg.evaluate_gan(lambda x, s: trainer.generate(state, x), deg, gt, torch.device("cpu"))

    jg = JUNet()
    x = deg.astype(np.float32) / 255.0 * 2.0 - 1.0
    variables = jax_vars(jg, state.generator.state_dict(), jnp.asarray(x), train=False)

    def evaluate(v, xx, gt01):
        out = jg.apply(v, xx, train=False)
        return jpsnr_per_image(gt01, jnp.clip((out.astype(jnp.float32) + 1.0) * 0.5, 0.0, 1.0),
                               data_range=1.0)

    want = run_o0(evaluate, variables, jnp.asarray(x),
                  jnp.asarray(gt.astype(np.float32) / 255.0))
    assert abs(got - float(np.mean(np.asarray(want, np.float64)))) <= EVAL_TOL_DB


def test_pair_loader_normalizes_like_jax():
    deg = np.random.RandomState(0).randint(0, 256, (5, 4, 4, 1)).astype(np.uint8)
    gt = np.random.RandomState(1).randint(0, 256, (5, 4, 4, 1)).astype(np.uint8)
    loader = tg.PairLoader(deg, gt, 2, seed=1)
    order = np.random.RandomState(1).permutation(5)
    batches = list(loader)
    assert len(batches) == len(loader) == 2
    for s, (d, g) in enumerate(batches):
        idx = order[2 * s:2 * s + 2]
        for got, u8 in ((d, deg[idx]), (g, gt[idx])):
            want = u8.astype(np.float32) / 255.0 * 2.0 - 1.0
            np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
