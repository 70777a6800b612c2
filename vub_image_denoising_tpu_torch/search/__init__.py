from .optuna_compat import TrialPruned, create_study
from .hyperparams import objective, run_search
