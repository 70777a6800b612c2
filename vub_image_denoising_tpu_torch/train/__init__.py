"""Training: optimizers and schedules, the train state, the supervised and
the diffusion trainers."""

from .diffusion import DiffusionTrainer, make_diffusion_train_step, sample_timesteps
from .schedules import cosine_annealing_lr, make_optimizer, step_lr
from .state import TrainState
from .supervised import SupervisedTrainer, effective_accumulation, make_supervised_train_step

__all__ = ["cosine_annealing_lr", "make_optimizer", "step_lr", "TrainState",
           "SupervisedTrainer", "effective_accumulation", "make_supervised_train_step",
           "DiffusionTrainer", "make_diffusion_train_step", "sample_timesteps"]
