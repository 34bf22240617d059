from .optimizers import Optimizer, adamw, leafwise, sgd
from .schedules import constant, cosine_decay, warmup_cosine

__all__ = ["Optimizer", "sgd", "adamw", "leafwise", "constant", "cosine_decay", "warmup_cosine"]
