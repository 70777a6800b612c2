"""Pruning-aware GAN hyperparameter search.

Counterpart of ``vub_image_denoising_tpu/search/gan_search.py`` (the
bytecode-only ``train_denoising_gan_hyperparameters``,
__pycache__/train_denoising_gan_hyperparameters.cpython-312.pyc) over the
port's ``DenoisingGANTrainer``: each trial reports the validation L1 of its
generator per epoch via ``trial.report`` and raises TrialPruned when
``trial.should_prune()`` fires, returning the final validation value.
``device`` is the trainers' (the card by default).
"""

from typing import Optional

import numpy as np
import torch

from ..train.denoising_gan import DenoisingGANTrainer
from .optuna_compat import TrialPruned, create_study


def _val_l1(trainer, state, val_loader) -> float:
    losses = []
    for noisy, clean in val_loader:
        fake = trainer.generate(state, torch.as_tensor(noisy).to(trainer.device, torch.float32))
        clean = torch.as_tensor(clean).to(trainer.device, torch.float32)
        losses.append(float(torch.mean(torch.abs(fake - clean))))
    return float(np.mean(losses)) if losses else float("nan")


def objective_gan(trial, train_loader, val_loader, num_epochs: int = 5,
                  checkpoint_dir: str = "checkpoints", device=None):
    """Search space over the GAN lambdas + lr with per-epoch pruning."""
    lambda_pixel = trial.suggest_float("lambda_pixel", 10.0, 200.0, log=True)
    lambda_perceptual = trial.suggest_float("lambda_perceptual", 0.01, 1.0, log=True)
    lambda_edge = trial.suggest_float("lambda_edge", 0.1, 10.0, log=True)
    lr = trial.suggest_float("lr", 1e-5, 1e-3, log=True)

    trainer = DenoisingGANTrainer(
        lambda_pixel=lambda_pixel, lambda_perceptual=lambda_perceptual,
        lambda_edge=lambda_edge, lr=lr,
        checkpoint_dir=f"{checkpoint_dir}/gan_trial_{trial.number}",
        device=device, seed=trial.number,
    )
    state = trainer.init(steps_per_epoch=len(train_loader))
    value = float("nan")
    for epoch in range(num_epochs):
        state, _, _ = trainer.train_epoch(state, train_loader, epoch)
        value = _val_l1(trainer, state, val_loader)
        trial.report(value, epoch)
        if trial.should_prune():
            try:
                import optuna

                raise optuna.TrialPruned()
            except ImportError:
                raise TrialPruned()
    return value


def run_gan_search(train_loader, val_loader, n_trials: int = 20,
                   num_epochs: int = 5, seed: int = 0,
                   csv_path: Optional[str] = None, device=None):
    study = create_study(direction="minimize", seed=seed)
    callbacks = []
    if csv_path:

        from .hyperparams import save_trial_results

        def _save(_study, trial):
            if trial.value is not None:
                # minimized directly (val L1, not a -PSNR): negate=False
                save_trial_results(trial, trial.value, csv_path,
                                   value_column="val_l1", negate=False)

        callbacks.append(_save)
    study.optimize(
        lambda t: objective_gan(t, train_loader, val_loader, num_epochs=num_epochs,
                                device=device),
        n_trials=n_trials,
        callbacks=callbacks,
    )
    return study
