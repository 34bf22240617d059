"""The model zoo and the paper's CNNs: the port of ``repro.models``."""
from . import sharding  # noqa: F401
from .api import Model, build_model, cross_entropy, input_specs

__all__ = ["Model", "build_model", "cross_entropy", "input_specs", "sharding"]
