"""Hyperparameter search over the diffusion trainer.

Counterpart of ``vub_image_denoising_tpu/search/hyperparams.py`` (reference
diffusion_denoising/hyperparams_search.py:11-104) over the port's
``DiffusionTrainer``, with the same search space: base_filters in
{16,32,48,64}, timesteps in {10,15,20}, optimizer in {adam,adamw},
scheduler in {cosine,step}, lr loguniform 1e-5..1e-3, weight_decay
loguniform for adamw; objective = -PSNR on one validation batch after a
short training run, PSNR in the search's 20*log10(1/sqrt(mse)) convention
on denormalized [0,1] images (:11-16); results appended to
trial_results.csv (:72-79) by read-merge-rewrite in pandas' layout, without
pandas (``utils/table.py``); study summary via tabulate (:102-104).

Trials train and sample on the trainer's device (the card unless
``trainer_kwargs={"device": "cpu"}``), so every DenoisingBlock of a trial
runs kernel 1.  Data loaders are built once and shared across trials
(:82-91).
"""

import os
from typing import Optional

import numpy as np
import torch

from ..data.device import denormalize
from ..train.diffusion import DiffusionTrainer
from ..utils.table import append_row, read_csv
from .optuna_compat import create_study


def calculate_psnr(img1, img2):
    """hyperparams_search.py:11-16 convention: 20*log10(1/sqrt(mse))."""
    mse = float(torch.mean((img1.float() - img2.float()) ** 2))
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(1.0 / np.sqrt(mse))


def evaluate_trial_psnr(trainer: DiffusionTrainer, state, val_loader) -> float:
    """Mean per-image PSNR of the full reverse sampler on ONE val batch
    (:18-30), the per-image PSNRs in one batched call."""
    from ..eval.metrics import psnr_per_image

    def nhwc01(x):
        return denormalize(x.float().permute(0, 2, 3, 1))

    noisy, clean = next(iter(val_loader))
    vals = psnr_per_image(nhwc01(trainer.sample(state, noisy)), nhwc01(trainer.put(clean)),
                          data_range=1.0)
    return float(torch.mean(vals))


def objective(trial, train_loader, val_loader, num_epochs: int = 5,
              output_root: str = "checkpoints", trainer_kwargs: Optional[dict] = None):
    """Search-space parity with hyperparams_search.py:32-70.

    ``trainer_kwargs`` go to every trial's ``DiffusionTrainer`` (e.g.
    engine, compute_dtype, device) without touching the search space."""
    base_filters = trial.suggest_int("base_filters", 16, 64, step=16)
    timesteps = trial.suggest_int("timesteps", 10, 20, step=5)
    optimizer_choice = trial.suggest_categorical("optimizer_choice", ["adam", "adamw"])
    scheduler_choice = trial.suggest_categorical("scheduler_choice", ["cosine", "step"])
    lr = trial.suggest_float("lr", 1e-5, 1e-3, log=True)
    weight_decay = 1e-4
    if optimizer_choice == "adamw":
        weight_decay = trial.suggest_float("weight_decay", 1e-5, 1e-3, log=True)

    print("\nTrial parameters:")
    for key, value in trial.params.items():
        print(f"{key}: {value}")

    trainer = DiffusionTrainer(
        base_filters=base_filters, timesteps=timesteps,
        optimizer_choice=optimizer_choice, scheduler_choice=scheduler_choice,
        lr=lr, weight_decay=weight_decay,
        output_dir=os.path.join(output_root, f"trial_{trial.number}"),
        **(trainer_kwargs or {}),
    )
    state = trainer.init(steps_per_epoch=len(train_loader), seed=trial.number)
    for epoch in range(num_epochs):
        state, _ = trainer.train_epoch(state, train_loader, epoch)
        # pruning hook (train_denoising_gan_hyperparameters.pyc pattern):
        psnr = evaluate_trial_psnr(trainer, state, val_loader)
        trial.report(-psnr, epoch)
        if trial.should_prune():
            from .optuna_compat import TrialPruned

            try:
                import optuna

                raise optuna.TrialPruned()
            except ImportError:
                raise TrialPruned()

    return -evaluate_trial_psnr(trainer, state, val_loader)


def save_trial_results(trial, value, csv_path="trial_results.csv",
                       value_column="psnr", negate=True):
    """hyperparams_search.py:72-79, by read-merge-rewrite: trials can have
    different param sets (weight_decay only for adamw), so a header-less
    append would misalign values under the first trial's header.
    ``value_column``/``negate`` let other studies share it (gan_search
    minimizes val L1 directly, no -PSNR flip)."""
    row = dict(trial.params)
    row[value_column] = -value if negate else value
    append_row(csv_path, row)


def run_search(train_loader, val_loader, n_trials: int = 50, num_epochs: int = 5,
               csv_path: str = "trial_results.csv", seed: int = 0,
               trainer_kwargs: Optional[dict] = None, catch=(),
               fail_wait_s: float = 0.0):
    """Study driver (hyperparams_search.py:93-104).

    ``catch`` is forwarded to Study.optimize (optuna semantics): matching
    exceptions fail the trial, not the study.  ``fail_wait_s`` sleeps after
    a failed trial so a brief outage has time to clear before the next
    trial retries the device."""
    import time as _time

    study = create_study(direction="minimize", seed=seed)

    def _on_trial(s, t):
        if t.value is not None:
            save_trial_results(t, t.value, csv_path)
        elif fail_wait_s and "FAIL" in str(getattr(t, "state", "")):
            _time.sleep(fail_wait_s)

    study.optimize(
        lambda t: objective(t, train_loader, val_loader, num_epochs=num_epochs,
                            trainer_kwargs=trainer_kwargs),
        n_trials=n_trials,
        callbacks=[_on_trial],
        catch=catch,
    )
    try:
        print(f"Best trial: {study.best_trial.value}")
        print("Best hyperparameters: ")
        for key, value in study.best_trial.params.items():
            print(f"{key}: {value}")
    except ValueError:
        print("Best trial: none (no trial completed)")
    try:
        from tabulate import tabulate

        header, columns = read_csv(csv_path)
        print("\nAll trial results:")
        print(tabulate(list(zip(*(columns[h] for h in header))), headers=header,
                       tablefmt="pretty"))
    except Exception:
        pass
    return study
