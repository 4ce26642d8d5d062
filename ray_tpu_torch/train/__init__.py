"""Training: the train step and the optimizer (port of ray_tpu/train/step.py)."""
from .step import TrainState, init_state, make_optimizer, make_train_step

__all__ = ["TrainState", "init_state", "make_optimizer", "make_train_step"]
