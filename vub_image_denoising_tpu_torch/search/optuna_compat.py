"""Optuna-compatible search engine.  A copy of
``vub_image_denoising_tpu/search/optuna_compat.py`` (pure Python), so the
port imports nothing of the JAX package.

The reference drives hyperparameter search with optuna
(diffusion_denoising/hyperparams_search.py:93-94 and the pruning-aware GAN trainer in
__pycache__/train_denoising_gan_hyperparameters.pyc).  ``create_study`` returns real
optuna when importable, else a built-in engine with the same Trial/Study API
(suggest_categorical / suggest_float(log=) / suggest_int, trial.report +
should_prune with median pruning, study.best_trial / best_params / trials).

The fallback sampler is TPE (Tree-structured Parzen Estimator, the same family as
optuna's default): after ``n_startup_trials`` random trials, each parameter is
suggested by splitting completed trials into the best ``gamma`` fraction ("good")
and the rest ("bad"), sampling candidates from a Parzen density over the good
observations, and picking the candidate maximizing the good/bad likelihood ratio
(independent per-parameter, like optuna's multivariate=False default).  Fully
deterministic under a fixed seed: the same seed and objective give the JAX
package's suggestions exactly.
"""

import math
import random
from typing import Any, Callable, Dict, List, Optional


class TrialPruned(Exception):
    """Raised inside an objective to signal a pruned trial (optuna.TrialPruned)."""


class _Trial:
    def __init__(self, number: int, seed: int, study: "_Study"):
        self.number = number
        self._rng = random.Random(seed * 9973 + number)
        self._study = study
        self.params: Dict[str, Any] = {}
        self.intermediate: Dict[int, float] = {}
        self.value: Optional[float] = None
        self.state = "RUNNING"
        self.user_attrs: Dict[str, Any] = {}

    # --- TPE machinery ---
    def _good_bad(self, name):
        """Completed observations of ``name`` split into (good, bad) by value."""
        done = [
            t for t in self._study.trials
            if t.state == "COMPLETE" and name in t.params and t.value is not None
        ]
        if len(done) < self._study.n_startup_trials:
            return None
        sign = 1.0 if self._study.direction == "minimize" else -1.0
        done.sort(key=lambda t: sign * t.value)
        n_good = max(1, int(self._study.gamma * len(done)))
        n_good = min(n_good, len(done) - 1)
        return ([t.params[name] for t in done[:n_good]],
                [t.params[name] for t in done[n_good:]])

    @staticmethod
    def _parzen_pdf(x, centers, bw):
        return sum(math.exp(-0.5 * ((x - c) / bw) ** 2) for c in centers) / (
            len(centers) * bw * math.sqrt(2 * math.pi)
        )

    def _tpe_numeric(self, low, high, good, bad, log=False, n_candidates=24):
        """Sample candidates from the good-Parzen mixture, score by l(x)/g(x)."""
        tf = math.log if log else (lambda v: v)
        lo, hi = tf(low), tf(high)
        gg = [tf(v) for v in good]
        bb = [tf(v) for v in bad]
        bw = max((hi - lo) / max(2.0, math.sqrt(len(gg))), 1e-12)
        best_x, best_score = None, -math.inf
        for _ in range(n_candidates):
            c = self._rng.choice(gg)
            x = min(hi, max(lo, self._rng.gauss(c, bw)))
            score = self._parzen_pdf(x, gg, bw) / (self._parzen_pdf(x, bb, bw) + 1e-12)
            if score > best_score:
                best_x, best_score = x, score
        v = math.exp(best_x) if log else best_x
        return min(high, max(low, v))  # exp(log(low)) can undershoot low by 1 ulp

    def _tpe_categorical(self, choices, good, bad, eps=0.1):
        """Add-one-smoothed category likelihood ratio; sample from the good dist,
        keep the best-ratio candidate.  An eps-uniform draw guards against a
        category being starved before its region of the joint space is explored."""
        if self._rng.random() < eps:
            return self._rng.choice(list(choices))

        def weights(obs):
            return {c: (1.0 + sum(1 for o in obs if o == c)) / (len(choices) + len(obs))
                    for c in choices}

        wl, wg = weights(good), weights(bad)
        cands = self._rng.choices(list(choices),
                                  weights=[wl[c] for c in choices], k=8)
        return max(cands, key=lambda c: wl[c] / wg[c])

    # --- suggest API ---
    def suggest_categorical(self, name, choices):
        choices = list(choices)
        split = self._good_bad(name)
        v = (self._rng.choice(choices) if split is None
             else self._tpe_categorical(choices, *split))
        self.params[name] = v
        return v

    def suggest_float(self, name, low, high, log=False, step=None):
        split = self._good_bad(name)
        if split is not None and step is None:
            v = self._tpe_numeric(low, high, *split, log=log)
        elif log:
            v = math.exp(self._rng.uniform(math.log(low), math.log(high)))
        elif step:
            n = int((high - low) / step)
            v = low + step * self._rng.randint(0, n)
        else:
            v = self._rng.uniform(low, high)
        self.params[name] = v
        return v

    # optuna's deprecated spellings used by older code
    def suggest_loguniform(self, name, low, high):
        return self.suggest_float(name, low, high, log=True)

    def suggest_uniform(self, name, low, high):
        return self.suggest_float(name, low, high)

    def suggest_int(self, name, low, high, step=1):
        split = self._good_bad(name)
        if split is not None:
            x = self._tpe_numeric(low, high, *split)
            v = low + int(round((x - low) / step)) * step
            v = min(high, max(low, v))
        else:
            v = self._rng.randrange(low, high + 1, step)
        self.params[name] = v
        return v

    # --- pruning API ---
    def report(self, value, step):
        self.intermediate[step] = float(value)

    def should_prune(self) -> bool:
        """Median pruner: prune if the latest intermediate value is worse than the
        median of completed trials' values at the same step (>=1 completed trial)."""
        if not self.intermediate:
            return False
        step = max(self.intermediate)
        peers = [
            t.intermediate[step]
            for t in self._study.trials
            if t.state == "COMPLETE" and step in t.intermediate
        ]
        if not peers:
            return False
        peers.sort()
        median = peers[len(peers) // 2]
        mine = self.intermediate[step]
        return mine > median if self._study.direction == "minimize" else mine < median

    def set_user_attr(self, key, value):
        self.user_attrs[key] = value


class _Study:
    def __init__(self, direction="minimize", seed=0, n_startup_trials=10, gamma=0.25):
        self.direction = direction
        self.seed = seed
        self.n_startup_trials = n_startup_trials
        self.gamma = gamma
        self.trials: List[_Trial] = []

    def optimize(self, objective: Callable, n_trials: int, callbacks=None,
                 catch=()):
        """optuna-parity driver.  ``catch`` (a tuple of exception types, like
        optuna's Study.optimize(catch=...)) marks a matching failure as a FAIL
        trial and continues the study instead of aborting it — a transient
        device/tunnel error then costs one trial, not the whole study."""
        for i in range(n_trials):
            trial = _Trial(i, self.seed, self)
            self.trials.append(trial)
            try:
                trial.value = float(objective(trial))
                trial.state = "COMPLETE"
            except TrialPruned:
                trial.state = "PRUNED"
            except catch as exc:  # noqa: E722 — tuple provided by caller
                trial.state = "FAIL"
                print(f"[optuna-compat] trial {i} FAILED ({type(exc).__name__}): "
                      f"{exc}", flush=True)
            for cb in callbacks or []:
                cb(self, trial)

    @property
    def best_trial(self) -> _Trial:
        done = [t for t in self.trials if t.state == "COMPLETE"]
        if not done:
            raise ValueError("no completed trials")
        key = (lambda t: t.value) if self.direction == "minimize" else (lambda t: -t.value)
        return min(done, key=key)

    @property
    def best_params(self):
        return self.best_trial.params

    @property
    def best_value(self):
        return self.best_trial.value


def create_study(direction: str = "minimize", seed: int = 0, prefer_optuna: bool = True):
    """Real optuna study when available, else the built-in engine."""
    if prefer_optuna:
        try:
            import optuna

            # seed the TPE sampler so "deterministic under a fixed seed" holds
            # with real optuna too, not only with the built-in engine
            return optuna.create_study(
                direction=direction,
                sampler=optuna.samplers.TPESampler(seed=seed),
            )
        except ImportError:
            pass
    return _Study(direction=direction, seed=seed)
