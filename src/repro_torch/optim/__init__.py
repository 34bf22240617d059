from .optimizers import Optimizer, adamw, sgd
from .schedules import constant, cosine_decay, warmup_cosine

__all__ = ["Optimizer", "sgd", "adamw", "constant", "cosine_decay", "warmup_cosine"]
