from .base import FLConfig

__all__ = ["FLConfig"]
