"""Turn the C13 study's winner into a full-budget retrain of the accuracy protocol.

Counterpart of ``scripts/c13_winner.py``: read the study CSV
(``run_search``'s), pick the best completed trial, and print (or run, with
``--train``) the diffusion accuracy-protocol command
(``python -m vub_image_denoising_tpu_torch.scripts.train_accuracy``) at the
winner's config, tagged ``c13-winner``.

The study's objective is the reference's 20*log10(1/sqrt(mse)) PSNR on
[-1, 1] validation tensors at a short budget; the retrain scores the whole
T-step sampler on the held-out protocol, so the two numbers do not compare.

Usage: python -m vub_image_denoising_tpu_torch.scripts.c13_winner [--csv ...] [--train]
"""

import argparse
import csv
import json
import os
import subprocess
import sys


def load_rows(csv_path):
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        sys.exit(f"no trial rows in {csv_path}")
    for r in rows:
        r["psnr"] = float(r["psnr"])
    return rows


def pick_winner(csv_path):
    """Best completed trial; the sidecar, where present, is printed beside it."""
    rows = load_rows(csv_path)
    sidecar = csv_path + ".study.json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            print(f"study sidecar: {json.dumps(json.load(f))}", flush=True)
    return max(rows, key=lambda r: r["psnr"])


def winner_command(row, epochs=200, tag="c13-winner", ckpt_dir="runs/torch_c13_winner"):
    """The accuracy-protocol retrain command at the winner's config: lr,
    optimizer, scheduler, base filters and timesteps from the trial; the
    protocol's settings (batch 128, 2048 images, 300 schedule steps per
    virtual epoch, device data, eval and checkpoint cadence) as the JAX
    script's."""
    return ["python", "-m", "vub_image_denoising_tpu_torch.scripts.train_accuracy",
            "--algo", "diffusion",
            "--epochs", str(epochs), "--batch-size", "128", "--n-train", "2048",
            "--sched-steps-per-epoch", "300", "--device-data",
            "--eval-every", "20", "--ckpt-every", "40",
            "--lr", str(float(row["lr"])),
            "--optimizer", row["optimizer_choice"],
            "--scheduler", row["scheduler_choice"],
            "--timesteps", str(int(row["timesteps"])),
            "--base-filters", str(int(row["base_filters"])),
            "--tag", tag, "--ckpt-dir", ckpt_dir]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csv", default="runs/torch_trial_results_ref_scale.csv")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--tag", default="c13-winner")
    ap.add_argument("--ckpt-dir", default="runs/torch_c13_winner")
    ap.add_argument("--train", action="store_true",
                    help="run the retrain (default: print the command only)")
    args = ap.parse_args(argv)
    row = pick_winner(args.csv)
    print("winner trial:", json.dumps(row), flush=True)
    cmd = winner_command(row, epochs=args.epochs, tag=args.tag, ckpt_dir=args.ckpt_dir)
    print("retrain command:", " ".join(cmd), flush=True)
    if args.train:
        return subprocess.call([sys.executable, *cmd[1:]])
    return 0


if __name__ == "__main__":
    sys.exit(main())
