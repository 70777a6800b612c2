"""RCA-GAN G-objective balance study: four runs of the GAN accuracy protocol.

Counterpart of ``scripts/run_rca_balance.sh`` (the follow-up of
``run_rca_ablation``): with the reference's slot weights the pixel L1 gets
0.01 while the feature MSE and the WGAN adversarial term get 1; these runs
isolate each term (adversarial off; content-dominated with the BN critic
and without it; adversarial and feature off).  The same flags run for run,
through the port's ``train_gan_accuracy``, with ``--ckpt-dir runs/torch_*``.

Usage: python -m vub_image_denoising_tpu_torch.scripts.run_rca_balance
           [--dry-run] [--only NAME ...] [train_gan_accuracy flags appended to each run]
"""

import sys

from . import sweep

MODULE = "vub_image_denoising_tpu_torch.scripts.train_gan_accuracy"
TOY = ["--epochs", "40", "--size", "64", "--n-train", "256"]
BALANCED = ["--lam-feat", "0.05", "--lam-content", "100", "--lam-adv", "1"]
# (name: the checkpoint directory's, flags), in the .sh file's order
RUNS = (
    ("balance_noadv", ["--algo", "rca", "--critic-norm", "bn", *TOY, "--lam-adv", "0",
                       "--tag", "balance-noadv"]),
    ("balance_l1", ["--algo", "rca", "--critic-norm", "bn", *TOY, *BALANCED,
                    "--tag", "balance-l1"]),
    ("balance_l1_nonorm", ["--algo", "rca", "--critic-norm", "none", *TOY, *BALANCED,
                           "--tag", "balance-l1-nonorm"]),
    ("balance_l1tiny", ["--algo", "rca", "--critic-norm", "bn", *TOY, "--lam-feat", "0",
                        "--lam-adv", "0", "--tag", "balance-l1tiny"]),
)


def grid():
    return [(name, [*flags, "--ckpt-dir", f"runs/torch_{name}"]) for name, flags in RUNS]


def main(argv=None):
    return sweep.main(grid(), MODULE, __doc__.splitlines()[0], argv)


if __name__ == "__main__":
    sys.exit(main())
