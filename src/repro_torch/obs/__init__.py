from .trace import stage

__all__ = ["stage"]
