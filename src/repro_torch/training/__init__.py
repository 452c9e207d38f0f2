"""Training substrate of the port: TrainState, step factory, fault-tolerant
trainer (the dense family and the VLM; ``ModelFns.loss``)."""

from repro_torch.training.state import TrainState, init_train_state
from repro_torch.training.step import make_train_step

__all__ = ["TrainState", "init_train_state", "make_train_step"]
