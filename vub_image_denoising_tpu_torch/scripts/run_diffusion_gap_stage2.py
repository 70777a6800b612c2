"""Diffusion quality-gap stage 2: promote the stage-1 winner to the full budget.

Counterpart of ``scripts/run_diffusion_gap_stage2.py``.  Stage 1
(``run_diffusion_gap``) ranks eight configurations at a 640-step budget and
appends each row, tagged ``gap-*``, to ``runs/torch_accuracy_log.jsonl``.
The stage-1 grid is one knob at a time around the ``gap-base`` re-anchor,
so this script promotes by greedy knob composition (coordinate ascent):
every knob whose single-knob row beat the baseline by at least
``MIN_GAIN_DB`` is adopted into one composed configuration, which is
re-run at the full budget (200 epochs) through the port's
``train_accuracy``.  It falls back to the best single row when there is no
baseline row or no knob helped, and to the single winner when the grid
already measured the composed configuration and it lost.

Usage: python -m vub_image_denoising_tpu_torch.scripts.run_diffusion_gap_stage2
           [--log runs/torch_accuracy_log.jsonl] [--dry-run]
"""

import argparse
import json
import subprocess
import sys

from .run_diffusion_gap import MODULE

LOG = "runs/torch_accuracy_log.jsonl"
STAGE1_CONFIGS = 8  # run_diffusion_gap trains exactly these
KNOBS = ("lr", "loss_weights", "t_dist", "timesteps", "base_filters")
MIN_GAIN_DB = 0.15  # a knob must beat the baseline by this much to be adopted


def load_stage1(log_path, expected=STAGE1_CONFIGS):
    """The stage-1 rows of the log: tagged ``gap-*``, not the promoted
    ``gap-stage2``/``gap-stage3`` rows and not ``{"partial": true}`` rows
    (a cut run's snapshot lacks the knob fields).  Exits without any; warns
    when fewer than ``expected`` (the winner is then the best of a partial
    grid)."""
    with open(log_path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    gaps = [r for r in rows
            if (r.get("tag") or "").startswith("gap-")
            and r.get("tag") not in ("gap-stage2", "gap-stage3")
            and not r.get("partial")]
    if not gaps:
        sys.exit(f"no stage-1 'gap-*' rows found in {log_path}")
    if len(gaps) < expected:
        print(f"WARNING: only {len(gaps)}/{expected} stage-1 rows present "
              f"({sorted(r['tag'] for r in gaps)}); promoting the best of a "
              f"PARTIAL grid", flush=True)
    return gaps


def pick_winner(log_path, expected=STAGE1_CONFIGS):
    return max(load_stage1(log_path, expected), key=lambda r: r["psnr_best_db"])


def compose_winner(gaps):
    """Greedy knob composition over a one-knob-at-a-time grid.

    For every stage-1 row that differs from the ``gap-base`` row in exactly
    one of KNOBS and beats it by at least MIN_GAIN_DB, adopt that knob's
    value (of rows changing the same knob, the higher PSNR's).  Returns a
    pseudo-row with the composed configuration, or None when there is no
    baseline row or no knob helped.  Its ``train_seconds`` is the baseline's
    times each adopted row's cost ratio (the knobs' costs are independent),
    so the budget cap sees an estimate."""
    base = next((r for r in gaps if r.get("tag") == "gap-base"), None)
    if base is None:
        return None
    adopted = {}  # knob -> winning row
    for row in gaps:
        if row is base:
            continue
        diffs = [k for k in KNOBS if row.get(k, base.get(k)) != base.get(k)]
        if len(diffs) != 1 or row["psnr_best_db"] < base["psnr_best_db"] + MIN_GAIN_DB:
            continue
        k = diffs[0]
        if k not in adopted or row["psnr_best_db"] > adopted[k]["psnr_best_db"]:
            adopted[k] = row
    if not adopted:
        return None
    composed = {k: base.get(k) for k in KNOBS}
    composed.update({"tag": "gap-composed", "epochs": base.get("epochs"),
                     "psnr_best_db": max(r["psnr_best_db"] for r in adopted.values())})
    cost = float(base.get("train_seconds") or 0.0)
    for k, row in adopted.items():
        composed[k] = row.get(k)
        if cost and base.get("train_seconds") and row.get("train_seconds"):
            cost *= row["train_seconds"] / base["train_seconds"]
    if cost:
        composed["train_seconds"] = cost
    print("composed knobs: " + ", ".join(
        f"{k}={composed[k]!r} (+{adopted[k]['psnr_best_db'] - base['psnr_best_db']:.2f} dB "
        f"from {adopted[k]['tag']})" for k in sorted(adopted)), flush=True)
    return composed


def fit_epochs_to_budget(best, epochs, budget_s):
    """Cap the stage-2 epochs so the run fits a wall-clock budget: the
    stage-1 row's ``train_seconds`` over its ``epochs`` predicts the cost of
    an epoch (same configuration, same step shape); 500 s are kept for the
    data, the set-up and the final sampler evaluation, and the count lands
    on a multiple of the 20-epoch evaluation, at least 40."""
    t1, e1 = best.get("train_seconds"), best.get("epochs")
    if not t1 or not e1:
        return epochs
    per_epoch = t1 / e1
    fit = int((budget_s - 500) / per_epoch)
    fit -= fit % 20  # keep eval-every-20 boundaries so the last epoch evals
    capped = max(40, min(epochs, fit))
    if capped < epochs:
        print(f"WARNING: winner costs ~{per_epoch:.1f}s/epoch; capping stage 2 "
              f"at {capped} epochs to fit the {budget_s}s budget", flush=True)
    return capped


def stage2_command(best, epochs=200, budget_s=None, tag="gap-stage2",
                   ckpt_dir="runs/torch_gap_stage2"):
    """The full-budget run of ``best``'s knobs; ``--ckpt-every 40`` leaves a
    resumable ``mid_checkpoint.pth`` if the run is cut."""
    if budget_s:
        epochs = fit_epochs_to_budget(best, epochs, budget_s)
    return ["python", "-m", MODULE, "--algo", "diffusion",
            "--epochs", str(epochs), "--batch-size", "128", "--n-train", "2048",
            "--sched-steps-per-epoch", "300", "--device-data", "--eval-every", "20",
            "--ckpt-every", "40",
            "--lr", str(best.get("lr", 2e-4)),
            "--loss-weights", best.get("loss_weights", "0,1,0"),
            "--t-dist", best.get("t_dist", "uniform"),
            "--timesteps", str(best.get("timesteps", 20)),
            "--base-filters", str(best.get("base_filters", 32)),
            "--tag", tag, "--ckpt-dir", ckpt_dir]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log", default=LOG)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--budget-s", type=int, default=8600,
                    help="wall budget the run must fit; 0 disables the epoch cap")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the winner and the command without training")
    ap.add_argument("--tag", default="gap-stage2",
                    help="the promoted row's tag (gap-stage3 for a re-composition over a "
                         "completed grid, so it never shadows the stage-2 record)")
    ap.add_argument("--ckpt-dir", default="runs/torch_gap_stage2")
    args = ap.parse_args(argv)
    gaps = load_stage1(args.log)
    single = max(gaps, key=lambda r: r["psnr_best_db"])
    best = compose_winner(gaps) or single
    # a composed configuration the grid already measured (its ssim + biased
    # row) and that lost to the best single row: the knobs interact badly
    measured = next((r for r in gaps if all(
        r.get(k, best.get(k)) == best.get(k) for k in KNOBS)), None)
    if measured is not None and measured["psnr_best_db"] < single["psnr_best_db"]:
        print(f"composed config was already measured ({measured['tag']}: "
              f"{measured['psnr_best_db']} dB) and LOST to {single['tag']} "
              f"({single['psnr_best_db']} dB); promoting the single winner", flush=True)
        best = single
    print("stage-1 winner:", json.dumps(best), flush=True)
    print("best single row:", json.dumps(single), flush=True)
    cmd = stage2_command(best, epochs=args.epochs, budget_s=args.budget_s, tag=args.tag,
                         ckpt_dir=args.ckpt_dir)
    print("running:", " ".join(cmd), flush=True)
    if args.dry_run:
        return 0
    return subprocess.call([sys.executable, *cmd[1:]])


if __name__ == "__main__":
    sys.exit(main())
