"""RCA-GAN critic-normalization ablation and scale step: six runs of the GAN
accuracy protocol.

Counterpart of ``scripts/run_rca_ablation.sh``: the reference-architecture
RCA-GAN (WGAN-GP, BatchNorm critic) at the 64^2 toy protocol with the
critic's BN kept, removed and swapped for LayerNorm; two runs at 128^2 on
four times the images; and the diffusion-GAN hybrid's short row.  The same
flags run for run, through the port's ``train_gan_accuracy``, with
``--ckpt-dir runs/torch_*``; each run appends its row to the port's
accuracy log.

Usage: python -m vub_image_denoising_tpu_torch.scripts.run_rca_ablation
           [--dry-run] [--only NAME ...] [train_gan_accuracy flags appended to each run]
"""

import sys

from . import sweep

MODULE = "vub_image_denoising_tpu_torch.scripts.train_gan_accuracy"
TOY = ["--epochs", "40", "--size", "64", "--n-train", "256"]
SCALE = ["--epochs", "40", "--size", "128", "--n-train", "1024"]
# (name: the checkpoint directory's, flags), in the .sh file's order
RUNS = (
    ("ablate_rca_bn64", ["--algo", "rca", "--critic-norm", "bn", *TOY, "--tag", "ablate64"]),
    ("ablate_rca_none64", ["--algo", "rca", "--critic-norm", "none", *TOY, "--tag", "ablate64"]),
    ("ablate_rca_ln64", ["--algo", "rca", "--critic-norm", "layernorm", *TOY,
                         "--tag", "ablate64"]),
    ("ablate_rca_bn128", ["--algo", "rca", "--critic-norm", "bn", *SCALE, "--tag", "scale128"]),
    ("ablate_rca_none128", ["--algo", "rca", "--critic-norm", "none", *SCALE,
                            "--tag", "scale128"]),
    ("ablate_hybrid64", ["--algo", "hybrid", "--epochs", "10", "--size", "64", "--n-train", "256",
                         "--tag", "c17smoke"]),
)


def grid():
    return [(name, [*flags, "--ckpt-dir", f"runs/torch_{name}"]) for name, flags in RUNS]


def main(argv=None):
    return sweep.main(grid(), MODULE, __doc__.splitlines()[0], argv)


if __name__ == "__main__":
    sys.exit(main())
