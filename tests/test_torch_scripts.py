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
import importlib
import importlib.util
import inspect
import json
import math
import os
import shlex

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


# ---- the protocol's tooling against the repo's scripts/ ----

def load_jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


GAP_BASE = {"tag": "gap-base", "psnr_best_db": 26.18, "lr": 2e-4, "loss_weights": "0,1,0",
            "t_dist": "uniform", "timesteps": 20, "base_filters": 32, "train_seconds": 1278.0,
            "epochs": 40}
# stage-1 logs: the cases of tests/test_round4_scripts.py
STAGE1_CASES = {
    "picks_best": [dict(GAP_BASE, psnr_best_db=26.1),
                   dict(GAP_BASE, tag="gap-ssim", psnr_best_db=27.3, loss_weights="0,1,0.3"),
                   {"tag": "gap-stage2", "psnr_best_db": 99.0},
                   {"tag": "ablate64", "psnr_best_db": 50.0}],
    "partial_and_stage3": [dict(GAP_BASE, psnr_best_db=26.1),
                           {"tag": "gap-lr4", "psnr_best_db": 99.0, "partial": True},
                           dict(GAP_BASE, tag="gap-stage3", psnr_best_db=98.0, lr=4e-4,
                                loss_weights="0,1,0.3", t_dist="biased")],
    "greedy": [GAP_BASE,
               dict(GAP_BASE, tag="gap-biased", t_dist="biased", psnr_best_db=26.92,
                    train_seconds=1236.0),
               dict(GAP_BASE, tag="gap-lr4", lr=4e-4, psnr_best_db=27.1, train_seconds=1240.0),
               dict(GAP_BASE, tag="gap-mse", loss_weights="1,1,0", psnr_best_db=25.51),
               dict(GAP_BASE, tag="gap-ssim-biased", loss_weights="0,1,0.3", t_dist="biased",
                    psnr_best_db=26.5)],
    "measured_combo": [dict(GAP_BASE, psnr_best_db=26.0),
                       dict(GAP_BASE, tag="gap-biased", t_dist="biased", psnr_best_db=26.9),
                       dict(GAP_BASE, tag="gap-ssim", loss_weights="0,1,0.3", psnr_best_db=26.4),
                       dict(GAP_BASE, tag="gap-ssim-biased", t_dist="biased",
                            loss_weights="0,1,0.3", psnr_best_db=26.2)],
    "heavy": [dict(GAP_BASE, tag="gap-bf64", psnr_best_db=27.0, base_filters=64,
                   train_seconds=2600.0)],
}


def knob_flags(cmd):
    """The flags after the runner's module or script path."""
    start = next(i for i, a in enumerate(cmd) if a.startswith("--"))
    return cmd[start:]


@pytest.mark.parametrize("case", sorted(STAGE1_CASES))
def test_stage2_agrees_with_the_jax_script(case, tmp_path, capsys):
    from vub_image_denoising_tpu_torch.scripts import run_diffusion_gap_stage2 as stage2

    jax_stage2 = load_jax_script("run_diffusion_gap_stage2")
    assert (stage2.KNOBS, stage2.MIN_GAIN_DB, stage2.STAGE1_CONFIGS) == (
        jax_stage2.KNOBS, jax_stage2.MIN_GAIN_DB, jax_stage2.STAGE1_CONFIGS)
    rows = STAGE1_CASES[case]
    log = tmp_path / "log.jsonl"
    log.write_text("".join(json.dumps(r) + "\n" for r in rows))
    assert stage2.pick_winner(str(log)) == jax_stage2.pick_winner(str(log))
    gaps = stage2.load_stage1(str(log))
    assert gaps == jax_stage2.load_stage1(str(log))
    assert stage2.compose_winner(gaps) == jax_stage2.compose_winner(gaps)
    best = stage2.compose_winner(gaps) or stage2.pick_winner(str(log))
    for epochs, budget in ((200, 8600), (200, 3000), (120, None)):
        if budget:
            assert (stage2.fit_epochs_to_budget(best, epochs, budget)
                    == jax_stage2.fit_epochs_to_budget(best, epochs, budget))
        cmd = stage2.stage2_command(best, epochs, budget, tag="gap-stage3",
                                    ckpt_dir="runs/torch_gap_stage3")
        jax_cmd = jax_stage2.stage2_command(best, epochs, budget, tag="gap-stage3",
                                            ckpt_dir="runs/gap_stage3")
        assert cmd[:3] == ["python", "-m", "vub_image_denoising_tpu_torch.scripts.train_accuracy"]
        assert knob_flags(cmd)[:-1] == knob_flags(jax_cmd)[:-1]  # all but the directory
        train_accuracy.build_arg_parser().parse_args(cmd[3:])
    capsys.readouterr()
    assert stage2.main(["--log", str(log), "--dry-run"]) == 0
    port_out = capsys.readouterr().out
    assert jax_stage2.main(["--log", str(log), "--dry-run"]) == 0
    jax_out = capsys.readouterr().out

    def running(out):
        return knob_flags(next(ln for ln in out.splitlines()
                               if ln.startswith("running:")).split())[:-1]

    assert running(port_out) == running(jax_out)


def sh_runs(name):
    """The runs of a repo ``.sh`` sweep: each ``python scripts/...`` command
    with ``$COMMON`` expanded, split into words."""
    with open(os.path.join(REPO, "scripts", name)) as f:
        text = f.read().replace("\\\n", " ")
    common = ""
    if 'COMMON="' in text:
        common = text.split('COMMON="', 1)[1].split('"', 1)[0]
    return [shlex.split(line.replace("$COMMON", common)) for line in text.splitlines()
            if line.startswith("python scripts/")]


@pytest.mark.parametrize("name, sh, runner", [
    ("run_diffusion_gap", "run_diffusion_gap.sh", "train_accuracy"),
    ("run_rca_ablation", "run_rca_ablation.sh", "train_gan_accuracy"),
    ("run_rca_balance", "run_rca_balance.sh", "train_gan_accuracy")])
def test_grids_carry_the_sh_files_flags_run_for_run(name, sh, runner, capsys):
    module = importlib.import_module(f"vub_image_denoising_tpu_torch.scripts.{name}")
    runs = sh_runs(sh)
    grid = module.grid()
    assert len(grid) == len(runs) > 0
    parser = importlib.import_module(
        f"vub_image_denoising_tpu_torch.scripts.{runner}").build_arg_parser()
    for (run_name, argv), words in zip(grid, runs):
        i = words.index("--ckpt-dir")
        jax_dir = words[i + 1]
        assert argv[:-2] == words[2:i] + words[i + 2:] and argv[-2] == "--ckpt-dir"
        assert argv[-1] == "runs/torch_" + jax_dir[len("runs/"):]
        parser.parse_args(argv)
    assert module.main(["--dry-run", "--only", grid[-1][0], "--epochs", "1"]) == 0
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("+ ")]
    assert printed == ["+ python -m vub_image_denoising_tpu_torch.scripts." + runner + " "
                       + " ".join(grid[-1][1] + ["--epochs", "1"])]


def test_grid_runs_each_config_and_reports_failures(monkeypatch):
    from vub_image_denoising_tpu_torch.scripts import run_diffusion_gap, sweep

    ran = []
    monkeypatch.setattr(sweep, "run_command", lambda module, argv: ran.append(argv) or (
        3 if "gap-mse" in argv else 0))
    assert run_diffusion_gap.main(["--only", "gap-base", "--only", "gap-ssim"]) == 0
    assert [a[a.index("--tag") + 1] for a in ran] == ["gap-base", "gap-ssim"]
    assert run_diffusion_gap.main([]) == 1 and len(ran) == 2 + 8
    with pytest.raises(SystemExit):
        run_diffusion_gap.main(["--only", "gap-nope"])


def test_regen_artifacts_check_reads_the_markers(tmp_path, capsys, monkeypatch):
    from vub_image_denoising_tpu_torch.scripts import regen_artifacts as ra

    names = [e[0] for e in ra.MANIFEST]
    assert len(set(names)) == len(names)
    for name, artifact, marker, cmd, minutes, record in ra.MANIFEST:
        assert artifact.startswith("runs/torch_") and marker.startswith("runs/torch_")
        words = shlex.split(cmd)
        module = importlib.import_module(words[2])
        assert hasattr(module, "main") and words[:2] == ["python", "-m"], name
        assert "TPU" not in minutes and ("H100" in minutes or "not" in minutes)
    # a finished run (its marker), a cut one (its directory and a mid_ file only)
    (tmp_path / "runs/torch_accuracy_ckpt_s25").mkdir(parents=True)
    (tmp_path / "runs/torch_accuracy_ckpt_s25/rdunet_denoising.pth").write_bytes(b"x")
    (tmp_path / "runs/torch_gap_stage2").mkdir(parents=True)
    (tmp_path / "runs/torch_gap_stage2/mid_checkpoint.pth").write_bytes(b"x")
    assert ra.main(["--check", "--root", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out.splitlines()[-1])
    assert summary == {"live": 1, "missing": [n for n in names if n != "s25"]}
    assert any(ln.startswith("live") and " s25 " in ln for ln in out.splitlines())
    ran = []
    monkeypatch.setattr(ra.subprocess, "Popen", lambda argv, cwd: ran.append(argv) or type(
        "P", (), {"wait": lambda self: 0, "poll": lambda self: 0})())
    ra.main(["--regen", "s25", "gan_search", "--root", str(tmp_path)])
    assert [a[2] for a in ran] == ["vub_image_denoising_tpu_torch.scripts.run_gan_search"]
    ra.main(["--regen", "s25", "--force", "--root", str(tmp_path)])
    assert ran[-1][2:4] == ["vub_image_denoising_tpu_torch.scripts.train_accuracy", "--epochs"]
    with pytest.raises(SystemExit) as e:
        ra.main(["--regen", "definitely-not-an-entry", "--root", str(tmp_path)])
    assert e.value.code not in (0, None)


# the repo's runner scripts and the port's module for each; its searches'
# entries lose the "_tpu" in the port's manifest
JAX_RUNNERS = {"train_tpu_accuracy": "train_accuracy",
               "train_tpu_gan_accuracy": "train_gan_accuracy",
               "run_comparative_suite": "run_comparative_suite",
               "run_search_tpu": "run_search", "run_gan_search_tpu": "run_gan_search",
               "run_diffusion_gap_stage2": "run_diffusion_gap_stage2"}


def test_regen_artifacts_has_every_jax_entry():
    """Every entry of scripts/regen_artifacts.py's MANIFEST (read from its
    AST) but the benchmark's serve_sweep has a port entry, under its name or
    without "_tpu", that runs the port's counterpart of its script with the
    same flags, the paths under runs/torch_*."""
    from vub_image_denoising_tpu_torch.scripts import regen_artifacts as ra

    tree = jax_source("scripts/regen_artifacts.py")
    jax_manifest = next(ast.literal_eval(node.value) for node in tree.body
                        if isinstance(node, ast.Assign) and node.targets[0].id == "MANIFEST")
    port = {e[0]: shlex.split(e[3]) for e in ra.MANIFEST}
    for name, _, _, cmd, _, _ in jax_manifest:
        if name == "serve_sweep":
            continue
        words = port[name[:-len("_tpu")] if name.endswith("_tpu") else name]
        jax_words = shlex.split(cmd)
        script = os.path.splitext(os.path.basename(jax_words[1]))[0]
        assert words[2] == "vub_image_denoising_tpu_torch.scripts." + JAX_RUNNERS[script], name
        want = [w.replace("runs/", "runs/torch_").replace("_tpu", "")
                for w in knob_flags(jax_words)]
        assert knob_flags(words) == want, name
    assert "run_diffusion_gap_stage2" not in " ".join(port["gap_stage2"])


def test_job_dispatches_its_three_tasks(monkeypatch, capsys):
    from vub_image_denoising_tpu_torch.scripts import job
    from vub_image_denoising_tpu_torch.search import hyperparams
    from vub_image_denoising_tpu_torch.train import diffusion, presets

    calls = []
    monkeypatch.setattr(diffusion, "main", lambda argv: calls.append(("diffusion", argv)))
    monkeypatch.setattr(presets, "rdunet_supervised_main",
                        lambda folder: calls.append(("supervised", folder)))
    monkeypatch.setattr(diffusion, "load_data_for", lambda args, device, mesh: (
        calls.append(("data", args.dataset_choice, str(device), mesh.size("data"))) or ("tl", "vl")))
    monkeypatch.setattr(hyperparams, "run_search", lambda tl, vl, **kw: calls.append(
        ("search", tl, vl, kw["n_trials"], kw["num_epochs"], str(kw["trainer_kwargs"]["device"]))))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert job.main(["diffusion", "--num_epochs", "1"]) == 0
    assert job.main([]) == 0
    assert job.main(["supervised", "images"]) == 0
    assert job.main(["search", "--dataset_choice", "DIV2K", "--device", "cpu"]) == 0
    assert calls == [("diffusion", ["--num_epochs", "1"]), ("diffusion", []),
                     ("supervised", "images"), ("data", "DIV2K", "cpu", 1),
                     ("search", "tl", "vl", 50, 5, "cpu")]
    assert job.main(["train"]) == 2
    assert "unknown task: train" in capsys.readouterr().err
