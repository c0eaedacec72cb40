from deepvcp.train.metrics import MetricsLogger, load_metrics
from deepvcp.train.trainer import (
    TrainState,
    Trainer,
    create_train_state,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "Trainer",
    "TrainState",
    "create_train_state",
    "make_train_step",
    "make_eval_step",
    "MetricsLogger",
    "load_metrics",
]
