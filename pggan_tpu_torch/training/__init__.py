from pggan_tpu_torch.training.state import Adam, TrainState, init_state
from pggan_tpu_torch.training.steps import TrainStepBuilder

__all__ = ["Adam", "TrainState", "TrainStepBuilder", "init_state"]
