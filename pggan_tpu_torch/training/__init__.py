from pggan_tpu_torch.training.schedule import (
    depth_alpha_schedule,
    lr_rampup,
    minibatch_for_depth,
    tick_kimg_for_depth,
)
from pggan_tpu_torch.training.state import Adam, TrainState, init_state
from pggan_tpu_torch.training.steps import TrainStepBuilder
from pggan_tpu_torch.training.trainer import Trainer

__all__ = ["Adam", "TrainState", "TrainStepBuilder", "Trainer",
           "depth_alpha_schedule", "init_state", "lr_rampup",
           "minibatch_for_depth", "tick_kimg_for_depth"]
