"""Training: AdamW, the train step and synthetic data (port of
``repro/training``; the reference's ``opt_state_pspecs`` waits for the
distributed port)."""
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)
from repro_torch.training.train_step import TrainStepConfig, make_train_step
from repro_torch.training.data import SyntheticDataset

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state",
           "TrainStepConfig", "make_train_step", "SyntheticDataset"]
