from .base import FLConfig, ModelConfig, get_config, list_archs, register
from . import paper_cnn  # noqa: F401  (registration side effect)

__all__ = ["FLConfig", "ModelConfig", "register", "get_config", "list_archs"]
