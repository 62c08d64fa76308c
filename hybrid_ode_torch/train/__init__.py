"""Training: optimizer, train / eval steps, `train_model`, online adaptation, CLI."""

from hybrid_ode_torch.train.online import adapt_subject, online_adaptation_eval
from hybrid_ode_torch.train.loop import (
    TrainState,
    make_optimizer,
    make_train_step,
    make_eval_step,
    train_model,
)

__all__ = [
    "TrainState",
    "make_optimizer",
    "make_train_step",
    "make_eval_step",
    "train_model",
    "adapt_subject",
    "online_adaptation_eval",
]
