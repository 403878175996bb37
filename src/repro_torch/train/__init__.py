"""Training/serving substrate of the port (``repro.train``): step
factories + fault-tolerant trainer."""
from . import train_step, trainer
from .train_step import (
    TrainState, init_state, make_prefill_step, make_serve_step, make_train_step,
)
from .trainer import Trainer, TrainerConfig

__all__ = [
    "train_step", "trainer", "TrainState", "init_state", "make_prefill_step",
    "make_serve_step", "make_train_step", "Trainer", "TrainerConfig",
]
