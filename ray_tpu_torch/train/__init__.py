"""Training: the train step, the optimizer and the grad sync (port of
ray_tpu/train/step.py and grad_sync.py)."""
from .grad_sync import GradSyncConfig
from .step import TrainState, init_state, make_optimizer, make_train_step

__all__ = ["GradSyncConfig", "TrainState", "init_state", "make_optimizer", "make_train_step"]
