"""The paper's CNNs and the model façade (the ``cnn`` family of
``repro.models``)."""
from .api import Model, build_model, cross_entropy

__all__ = ["Model", "build_model", "cross_entropy"]
