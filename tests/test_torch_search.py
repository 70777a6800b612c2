"""The port's hyperparameter search (``search/``) against the JAX package's,
on the CPU.

- The copied study engine gives exactly the JAX engine's suggestions and
  values for the same seed and objective, and keeps its behaviour
  (pruning, ``catch``, TPE against random search, the reference's integer
  and log-uniform spaces; tests/test_search_and_eval.py:15-129).
- ``save_trial_results`` writes the bytes JAX's pandas read-merge-rewrite
  writes, with adam and adamw trials mixed so that ``weight_decay`` first
  appears in a later trial.
- ``evaluate_trial_psnr`` on the same weights (carried across) and batch is
  within 1e-3 dB of JAX's; ``objective`` runs one fixed base-16, T = 10
  trial at 32x32; ``objective_gan`` one epoch of one batch.

JAX's sampler compiles with most XLA optimisations off; base 4, T = 3,
16x16 images for the PSNR check."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rdunet import numpy_params, one_thread  # noqa: F401 — an autouse fixture
from vub_image_denoising_tpu.models.rdunet import RDUNetT as JRDUNetT
from vub_image_denoising_tpu.search import hyperparams as jhp
from vub_image_denoising_tpu.search import optuna_compat as joc
from vub_image_denoising_tpu.train import diffusion as jdiff
from vub_image_denoising_tpu_torch.search import gan_search, hyperparams
from vub_image_denoising_tpu_torch.search.optuna_compat import TrialPruned, create_study
from vub_image_denoising_tpu_torch.train.diffusion import DiffusionTrainer
from vub_image_denoising_tpu_torch.utils.checkpoint import params_to_state_dict


def mixed_objective(trial):
    x = trial.suggest_float("x", -10, 10)
    lr = trial.suggest_float("lr", 1e-5, 1e-1, log=True)
    bf = trial.suggest_int("base_filters", 16, 64, step=16)
    opt = trial.suggest_categorical("opt", ["adam", "adamw", "sgd"])
    return (x - 3) ** 2 + abs(np.log10(lr) + 3) + bf / 64 + (opt != "adamw")


def test_copied_study_suggests_what_jax_suggests():
    """Same seed, same objective: the same parameters and values, trial by
    trial, through the startup and the TPE phase."""
    runs = []
    for make in (create_study, joc.create_study):
        study = make(direction="minimize", seed=11, prefer_optuna=False)
        study.optimize(mixed_objective, n_trials=30)
        runs.append([(t.params, t.value, t.state) for t in study.trials])
    assert runs[0] == runs[1]


def test_study_prunes_catches_and_concentrates():
    """Median pruning prunes some of 10 trials; a caught failure fails one
    trial and the study goes on, callbacks still fire, an uncaught type
    propagates; TPE's best-of-50 beats random search's on the quadratic."""
    import random

    study = create_study(direction="minimize", seed=0, prefer_optuna=False)

    def pruned(trial):
        base = trial.suggest_float("base", 0, 1)
        for step in range(3):
            trial.report(base + step, step)
            if trial.should_prune():
                raise TrialPruned()
        return base

    study.optimize(pruned, n_trials=10)
    states = [t.state for t in study.trials]
    assert "COMPLETE" in states and "PRUNED" in states

    study = create_study(direction="minimize", seed=3, prefer_optuna=False)
    seen = []

    def flaky(trial):
        x = trial.suggest_float("x", -1, 1)
        if trial.number == 1:
            raise RuntimeError("simulated device blip")
        return x ** 2

    study.optimize(flaky, n_trials=5, catch=(RuntimeError,),
                   callbacks=[lambda s, t: seen.append((t.number, t.state))])
    assert [t.state for t in study.trials].count("FAIL") == 1 and seen[1] == (1, "FAIL")
    assert study.best_trial.value >= 0
    with pytest.raises(ValueError):
        study.optimize(lambda t: (_ for _ in ()).throw(ValueError("boom")), n_trials=1,
                       catch=(RuntimeError,))

    def best_tpe(seed):
        s = create_study(direction="minimize", seed=seed, prefer_optuna=False)
        s.optimize(lambda t: (t.suggest_float("x", -10, 10) - 3.0) ** 2, n_trials=50)
        return s.best_value

    def best_random(seed):
        rng = random.Random(seed)
        return min((rng.uniform(-10, 10) - 3.0) ** 2 for _ in range(50))

    tpe = np.mean([best_tpe(s) for s in range(5)])
    assert tpe < np.mean([best_random(s) for s in range(5)]) and tpe < 0.05


def test_suggest_spaces_of_the_reference():
    """suggest_int keeps the search space's steps; the deprecated
    suggest_loguniform stays in range with a median near the geometric mean."""
    study = create_study(direction="minimize", seed=1, prefer_optuna=False)
    seen, lrs = set(), []

    def objective(trial):
        bf = trial.suggest_int("base_filters", 16, 64, step=16)
        ts = trial.suggest_int("timesteps", 10, 20, step=5)
        lrs.append(trial.suggest_loguniform("lr", 1e-5, 1e-3))
        seen.add((bf, ts))
        assert bf in (16, 32, 48, 64) and ts in (10, 15, 20)
        return 0.0

    study.optimize(objective, n_trials=50)
    assert len(seen) > 4
    assert min(lrs) >= 1e-5 and max(lrs) <= 1e-3 and 2e-5 < float(np.median(lrs)) < 5e-4


TRIALS = [
    {"base_filters": 16, "timesteps": 10, "optimizer_choice": "adam",
     "scheduler_choice": "cosine", "lr": 0.00012345678901234567},
    {"base_filters": 48, "timesteps": 20, "optimizer_choice": "adamw",
     "scheduler_choice": "step", "lr": 3.3e-05, "weight_decay": 0.000271828182845904},
    {"base_filters": 32, "timesteps": 15, "optimizer_choice": "adam",
     "scheduler_choice": "step", "lr": 1e-3},
    {"base_filters": 64, "timesteps": 10, "optimizer_choice": "adamw",
     "scheduler_choice": "cosine", "lr": 2.5e-4, "weight_decay": 1e-05},
]


def test_trial_csv_is_byte_equal_to_pandas(tmp_path):
    """The port's read-merge-rewrite (no pandas) writes JAX's pandas CSV
    byte for byte after every trial: column union in order of appearance,
    weight_decay after psnr, empty fields for adam trials, repr floats."""
    port, ref = tmp_path / "port.csv", tmp_path / "jax.csv"
    values = [-21.123456789012345, -19.5, -30.000000000000004, -25.25]
    for i, (params, value) in enumerate(zip(TRIALS, values)):
        trial = SimpleNamespace(params=params, number=i)
        hyperparams.save_trial_results(trial, value, str(port))
        jhp.save_trial_results(trial, value, str(ref))
        assert port.read_bytes() == ref.read_bytes(), i
    study = create_study(direction="minimize", seed=5, prefer_optuna=False)
    for trial_number in range(len(TRIALS), len(TRIALS) + 8):
        # the search space's own draws: 17-digit floats, which pandas reads
        # back to 17 digits counting leading zeros
        trial = joc._Trial(trial_number, 5, study)
        trial.suggest_float("lr", 1e-5, 1e-3, log=True)
        if trial.suggest_categorical("optimizer_choice", ["adam", "adamw"]) == "adamw":
            trial.suggest_float("weight_decay", 1e-5, 1e-3, log=True)
        value = -trial.suggest_float("psnr", 10, 40)
        hyperparams.save_trial_results(trial, value, str(port))
        jhp.save_trial_results(trial, value, str(ref))
        assert port.read_bytes() == ref.read_bytes(), trial_number
    header = port.read_text().splitlines()[0].split(",")
    assert header == ["base_filters", "timesteps", "optimizer_choice", "scheduler_choice", "lr",
                      "psnr", "weight_decay"]
    gan, gan_ref = tmp_path / "gan.csv", tmp_path / "gan_jax.csv"
    for i, v in enumerate((0.125, 0.0625)):
        trial = SimpleNamespace(params={"lambda_pixel": 100.0 + i, "lr": 1e-4}, number=i)
        hyperparams.save_trial_results(trial, v, str(gan), value_column="val_l1", negate=False)
        jhp.save_trial_results(trial, v, str(gan_ref), value_column="val_l1", negate=False)
    assert gan.read_bytes() == gan_ref.read_bytes()


@pytest.fixture
def no_jax_opt():
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def test_evaluate_trial_psnr_matches_jax(no_jax_opt):
    """The same RDUNetT weights (carried across) and validation batch: the
    port's sampler PSNR is within 1e-3 dB of JAX's."""
    base, steps, n = 4, 3, 2
    rng = np.random.RandomState(4)
    clean = rng.uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32)
    noisy = np.clip(clean + 0.2 * rng.randn(*clean.shape), -1, 1).astype(np.float32)
    jmodel = JRDUNetT(base_filters=base)
    variables = numpy_params(SimpleNamespace(init=lambda k, x: jmodel.init(k, x, jnp.zeros((n,)))),
                             noisy, seed=2)
    jtrainer = jdiff.DiffusionTrainer(base_filters=base, timesteps=steps)
    jtrainer._jit_sample = jax.jit(lambda p, x: jtrainer.diffusion.improved_sampling(
        jtrainer._unet_apply, p, x))
    with jax.default_matmul_precision("highest"):
        want = jhp.evaluate_trial_psnr(jtrainer, SimpleNamespace(params=variables),
                                       [(noisy, clean)])
    trainer = DiffusionTrainer(base_filters=base, timesteps=steps, device="cpu")
    state = trainer.init(steps_per_epoch=1)
    trainer.unet.load_state_dict(params_to_state_dict(variables), strict=True)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    got = hyperparams.evaluate_trial_psnr(trainer, state, [(nchw(noisy), nchw(clean))])
    assert np.isfinite(got) and abs(got - want) < 1e-3


class FixedTrial:
    """A trial that answers every suggestion from ``values``."""

    def __init__(self, values, number=0):
        self.values, self.number, self.params, self.reports = values, number, {}, []

    def _take(self, name, *args, **kwargs):
        self.params[name] = self.values[name]
        return self.values[name]

    suggest_int = suggest_float = suggest_categorical = _take

    def report(self, value, step):
        self.reports.append((step, value))

    def should_prune(self):
        return False


def test_objective_runs_a_fixed_trial(tmp_path):
    """One base-16, T = 10 trial, one epoch of one 32x32 batch: the value
    is the negated PSNR of the last report."""
    trial = FixedTrial({"base_filters": 16, "timesteps": 10, "optimizer_choice": "adamw",
                        "scheduler_choice": "step", "lr": 1e-4, "weight_decay": 1e-4}, 3)
    gen = torch.Generator().manual_seed(0)
    clean = torch.rand(2, 3, 32, 32, generator=gen) * 2 - 1
    batch = [((clean + 0.2 * torch.randn(clean.shape, generator=gen)).clamp(-1, 1), clean)]
    value = hyperparams.objective(trial, batch, batch, num_epochs=1,
                                  output_root=str(tmp_path),
                                  trainer_kwargs={"device": "cpu", "accumulation_steps": 1})
    assert np.isfinite(value) and trial.reports == [(0, value)]
    assert set(trial.params) == set(trial.values)


def test_run_search_writes_the_trial_csv(tmp_path, monkeypatch, capsys):
    """The study driver over a stand-in objective: one CSV row per
    completed trial, the summary table printed."""
    monkeypatch.setattr(hyperparams, "objective", lambda t, *a, **k: -float(
        t.suggest_int("base_filters", 16, 64, step=16) + t.suggest_float("lr", 1e-5, 1e-3,
                                                                          log=True)))
    path = tmp_path / "trials.csv"
    study = hyperparams.run_search(None, None, n_trials=3, csv_path=str(path))
    assert len(study.trials) == 3
    assert path.read_text().splitlines()[0] == "base_filters,lr,psnr"
    assert len(path.read_text().splitlines()) == 4
    assert "All trial results" in capsys.readouterr().out


def test_objective_gan_runs_one_epoch(tmp_path):
    trial = FixedTrial({"lambda_pixel": 100.0, "lambda_perceptual": 0.1, "lambda_edge": 1.0,
                        "lr": 1e-4}, 1)
    gen = torch.Generator().manual_seed(0)
    clean = torch.rand(2, 1, 32, 32, generator=gen) * 2 - 1
    batch = [((clean + 0.2 * torch.randn(clean.shape, generator=gen)).clamp(-1, 1), clean)]
    value = gan_search.objective_gan(trial, batch, batch, num_epochs=1,
                                     checkpoint_dir=str(tmp_path), device="cpu")
    assert np.isfinite(value) and value > 0 and trial.reports == [(0, value)]
