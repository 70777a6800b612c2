"""Run the C16 GAN hyperparameter search (attention-U-Net GAN) end to end on the card.

Counterpart of ``scripts/run_gan_search_tpu.py``: ``search/gan_search.py``'s
``run_gan_search`` (the attention-U-Net GAN trainer, per-epoch
``trial.report`` and median pruning, the lambdas and lr as the search
space) over the synthetic grayscale pairs of ``train_gan_accuracy``, the
trial CSV with its ``val_l1`` column.

Differences from the JAX script: the pairs' noise comes from CPU torch
generators seeded 7 and 123 (JAX: ``PRNGKey(7)``, ``PRNGKey(123)``); the CSV
defaults to the port's own path; added flags ``--device`` (the card unless
``cpu``) and ``--cache-dir``.

Usage:  python -m vub_image_denoising_tpu_torch.scripts.run_gan_search --trials 8 --epochs 5
"""

import argparse
import os
import time

import numpy as np

from .run_search import degrade
from .train_accuracy import CACHE_DIR, synth_train_val
from .train_gan_accuracy import PairLoader

CSV = "runs/torch_gan_trial_results.csv"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--n-train", type=int, default=256)
    ap.add_argument("--n-val", type=int, default=64)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--sigma", type=float, default=25.0)
    ap.add_argument("--csv", default=CSV)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    ap.add_argument("--cache-dir", default=CACHE_DIR,
                    help="where the synthetic images are cached")
    args = ap.parse_args(argv)

    from ..search.gan_search import run_gan_search

    train_rgb, val_rgb = synth_train_val(args.n_train, args.n_val, args.size,
                                         cache_dir=args.cache_dir)
    train_gt = train_rgb.mean(axis=-1, keepdims=True).astype(np.uint8)
    val_gt = val_rgb.mean(axis=-1, keepdims=True).astype(np.uint8)
    train_loader = PairLoader(degrade(train_gt, args.sigma, 7), train_gt, args.batch_size, seed=1)
    val_loader = PairLoader(degrade(val_gt, args.sigma, 123), val_gt, args.batch_size, seed=2,
                            shuffle=False)

    os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
    if os.path.exists(args.csv):
        os.remove(args.csv)
    t0 = time.time()
    study = run_gan_search(train_loader, val_loader, n_trials=args.trials,
                           num_epochs=args.epochs, csv_path=args.csv, device=args.device)
    pruned = sum(1 for t in study.trials if t.value is None)
    print(f"gan search wall: {time.time() - t0:.0f}s; trials {args.trials} "
          f"({pruned} pruned); best val_l1 {study.best_trial.value:.4f}; "
          f"best params {study.best_trial.params}; csv -> {args.csv}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
