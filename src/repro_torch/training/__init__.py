"""Training: AdamW (with its ZeRO-1 state specs), the train step (with the
int8 pod exchange) and synthetic data (port of ``repro/training``)."""
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state, opt_state_pspecs)
from repro_torch.training.train_step import TrainStepConfig, make_train_step
from repro_torch.training.data import SyntheticDataset

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state",
           "opt_state_pspecs", "TrainStepConfig", "make_train_step",
           "SyntheticDataset"]
