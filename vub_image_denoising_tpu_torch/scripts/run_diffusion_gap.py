"""Diffusion quality-gap sweep, stage 1: rank eight configurations of the
diffusion accuracy protocol at a 640-step budget.

Counterpart of ``scripts/run_diffusion_gap.sh``: the reference's own tuning
knobs (combined_loss weights mse/charbonnier/ssim, diffusion_RDUnet.py:60-65;
Beta(2, 1)-biased t, :71-73; timesteps; base_filters; lr), one at a time
around the ``gap-base`` re-anchor, plus SSIM with biased t.  The same
``COMMON`` flags and knobs, each run through the port's ``train_accuracy``
with ``--ckpt-dir runs/torch_gap_*``; each appends its row (tag
``gap-*``) to ``runs/torch_accuracy_log.jsonl``, which
``run_diffusion_gap_stage2`` reads.

Usage: python -m vub_image_denoising_tpu_torch.scripts.run_diffusion_gap
           [--dry-run] [--only TAG ...] [train_accuracy flags appended to each run]
"""

import sys

from . import sweep

MODULE = "vub_image_denoising_tpu_torch.scripts.train_accuracy"
COMMON = ["--algo", "diffusion", "--epochs", "40", "--batch-size", "128", "--n-train", "2048",
          "--sched-steps-per-epoch", "300", "--device-data", "--eval-every", "20"]
# (tag, knobs), in the .sh file's order
CONFIGS = (
    ("gap-base", ["--lr", "2e-4"]),                            # charbonnier only, uniform t
    ("gap-biased", ["--lr", "2e-4", "--t-dist", "biased"]),    # Beta(2, 1)-biased t
    ("gap-ssim", ["--lr", "2e-4", "--loss-weights", "0,1,0.3"]),
    ("gap-mse", ["--lr", "2e-4", "--loss-weights", "1,1,0"]),
    ("gap-lr4", ["--lr", "4e-4"]),
    ("gap-T10", ["--lr", "2e-4", "--timesteps", "10"]),
    ("gap-bf64", ["--lr", "2e-4", "--base-filters", "64"]),
    ("gap-ssim-biased", ["--lr", "2e-4", "--loss-weights", "0,1,0.3", "--t-dist", "biased"]),
)


def ckpt_dir(tag):
    return "runs/torch_" + tag.replace("-", "_")


def grid():
    """``(tag, train_accuracy argv)`` of each stage-1 run."""
    return [(tag, [*COMMON, *knobs, "--tag", tag, "--ckpt-dir", ckpt_dir(tag)])
            for tag, knobs in CONFIGS]


def main(argv=None):
    return sweep.main(grid(), MODULE, __doc__.splitlines()[0], argv)


if __name__ == "__main__":
    sys.exit(main())
