"""The port's runner scripts against the JAX package's.

- ``c13_winner``: the pick and the retrain command on
  ``tests/test_round4_scripts.py``'s CSV, flag for flag the JAX script's
  command, and every flag one that the port's ``train_accuracy`` takes;
- ``run_search`` and ``run_gan_search`` at one trial of one epoch on tiny
  images (16^2; the GAN's critic takes no less than 32^2): the trial CSV's
  columns are the JAX searches' parameter names (read from their source)
  and their value column, ``run_search``'s sidecar has the JAX runner's keys.
  The diffusion study runs on the built-in engine from seed 64, whose first
  trial is base 16, T = 10, with adamw (so the CSV has the
  ``weight_decay`` column): seed 0's is base 64, whose 40M parameters take
  about 9 s a trial on one core;
- ``measure_sidd_eval`` through ``measure`` (what its ``main`` calls) on one
  scene of small blocks at base 4, every engine within 0.05 dB; the CLI
  keeps JAX's defaults (RDUNetT-32, 24 blocks of 256^2 a scene).
"""

import ast
import csv
import importlib.util
import inspect
import json
import math
import os

import numpy as np
import pytest
import torch

from test_torch_rdunet import one_thread  # noqa: F401 — autouse
from vub_image_denoising_tpu_torch.scripts import (c13_winner, measure_sidd_eval, run_gan_search,
                                                   run_search, train_accuracy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_source(path):
    with open(os.path.join(REPO, path)) as f:
        return ast.parse(f.read())


def suggested_names(path):
    """The parameter names a JAX search suggests, in source order."""
    return [node.args[0].value for node in ast.walk(jax_source(path))
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr.startswith("suggest_")]


def read_header(path):
    with open(path) as f:
        return next(csv.reader(f))


def test_c13_winner_pick_and_command_match_the_jax_script(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location("jax_c13_winner",
                                                  os.path.join(REPO, "scripts", "c13_winner.py"))
    jax_c13 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_c13)
    csvp = tmp_path / "trials.csv"
    csvp.write_text(
        "base_filters,timesteps,optimizer_choice,scheduler_choice,lr,psnr\n"
        "64,15,adam,step,0.0008,20.97\n"
        "16,10,adam,cosine,0.0004,23.03\n"
        "48,20,adamw,step,0.0006,24.89\n")
    row = c13_winner.pick_winner(str(csvp))
    assert row == jax_c13.pick_winner(str(csvp))
    assert (row["base_filters"], row["optimizer_choice"]) == ("48", "adamw")
    cmd = c13_winner.winner_command(row, epochs=200)
    assert cmd[:3] == ["python", "-m", "vub_image_denoising_tpu_torch.scripts.train_accuracy"]
    jax_cmd = jax_c13.winner_command(row, epochs=200)
    assert cmd[3:-1] == jax_cmd[2:-1]  # all but the checkpoint directory
    for flag, value in (("--base-filters", "48"), ("--optimizer", "adamw"),
                        ("--scheduler", "step"), ("--timesteps", "20"), ("--lr", "0.0006"),
                        ("--tag", "c13-winner")):
        assert cmd[cmd.index(flag) + 1] == value
    args = train_accuracy.build_arg_parser().parse_args(cmd[3:])
    assert (args.algo, args.base_filters, args.device_data) == ("diffusion", 48, True)
    assert c13_winner.main(["--csv", str(csvp)]) == 0
    assert "retrain command: python -m vub_image_denoising_tpu_torch" in capsys.readouterr().out


def test_run_search_writes_the_jax_runners_columns(tmp_path, monkeypatch):
    from vub_image_denoising_tpu_torch.search import hyperparams, optuna_compat

    monkeypatch.setattr(hyperparams, "create_study", lambda direction, seed: (
        optuna_compat.create_study(direction, seed=64, prefer_optuna=False)))
    out = str(tmp_path / "trials.csv")
    assert run_search.main(["--trials", "1", "--epochs", "1", "--size", "16", "--n-train", "2",
                            "--n-val", "1", "--batch-size", "1", "--device", "cpu",
                            "--csv", out, "--cache-dir", str(tmp_path / "cache")]) == 0
    header = read_header(out)
    names = suggested_names("vub_image_denoising_tpu/search/hyperparams.py")
    with open(out) as f:
        row = next(csv.DictReader(f))
    assert (row["base_filters"], row["optimizer_choice"]) == ("16", "adamw")
    assert header == names + ["psnr"]
    assert math.isfinite(float(row["psnr"]))
    with open(out + ".study.json") as f:
        summary = json.load(f)
    jax_keys = next(node for node in ast.walk(jax_source("scripts/run_search_tpu.py"))
                    if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "summary").value
    assert list(summary) == [k.value for k in jax_keys.keys]
    protocol = jax_keys.values[[k.value for k in jax_keys.keys].index("protocol")]
    assert list(summary["protocol"]) == [k.value for k in protocol.keys]
    assert (summary["trials"], summary["completed"], summary["failed"]) == (1, 1, 0)


def test_run_gan_search_writes_the_jax_runners_columns(tmp_path):
    out = str(tmp_path / "gan_trials.csv")
    assert run_gan_search.main(["--trials", "1", "--epochs", "1", "--size", "32", "--n-train",
                                "2", "--n-val", "1", "--batch-size", "1", "--device", "cpu",
                                "--csv", out, "--cache-dir", str(tmp_path / "cache")]) == 0
    assert read_header(out) == suggested_names("vub_image_denoising_tpu/search/gan_search.py") + [
        "val_l1"]
    with open(out) as f:
        assert math.isfinite(float(next(csv.DictReader(f))["val_l1"]))


def test_measure_sidd_eval_engines_agree():
    res = measure_sidd_eval.measure(["flax", "xla", "pallas"], scenes=1, base_filters=4,
                                    timesteps=2, blocks_per_scene=2, size=16, device="cpu")
    assert list(res) == ["flax", "xla", "pallas"]
    for r in res.values():
        assert r["n_blocks"] == 2 and math.isfinite(r["avg_psnr"]) and 0 < r["avg_ssim"] <= 1
        assert abs(r["avg_psnr"] - res["flax"]["avg_psnr"]) < measure_sidd_eval.ENGINE_PSNR_TOL
    defaults = inspect.signature(measure_sidd_eval.measure).parameters
    assert defaults["base_filters"].default == 32 and defaults["timesteps"].default == 20
    assert (measure_sidd_eval.BLOCKS_PER_SCENE, measure_sidd_eval.BLOCK_SIZE) == (24, 256)


def test_measure_sidd_eval_synthetic_blocks(tmp_path):
    from vub_image_denoising_tpu_torch.data.device import add_gaussian_noise_u8
    from vub_image_denoising_tpu_torch.eval.sidd import SIDDMatBlocks

    noisy_mat, gt_mat = measure_sidd_eval.write_blocks(str(tmp_path), 1, "synthetic", 25.0, 2, 32)
    blocks = SIDDMatBlocks(noisy_mat, gt_mat)
    imgs = train_accuracy.synth_images(2, 32, np.random.RandomState(0))
    noisy = add_gaussian_noise_u8(torch.Generator().manual_seed(measure_sidd_eval.NOISE_SEED),
                                  torch.from_numpy(imgs), 25.0).numpy()
    for i in range(2):
        np.testing.assert_array_equal(blocks[i][1], imgs[i])
        np.testing.assert_array_equal(blocks[i][0], noisy[i])
    with pytest.raises(SystemExit):
        measure_sidd_eval.main(["--content", "bogus"])
