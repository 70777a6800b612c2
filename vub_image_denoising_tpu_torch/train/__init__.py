"""Training: optimizers and schedules, the train state, the supervised trainer."""

from .schedules import cosine_annealing_lr, make_optimizer, step_lr
from .state import TrainState
from .supervised import SupervisedTrainer, effective_accumulation, make_supervised_train_step

__all__ = ["cosine_annealing_lr", "make_optimizer", "step_lr", "TrainState",
           "SupervisedTrainer", "effective_accumulation", "make_supervised_train_step"]
