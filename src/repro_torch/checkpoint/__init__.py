"""Tree checkpoints of the port (``repro.checkpoint``'s interface)."""
from .checkpoint import latest_checkpoint, restore, save

__all__ = ["save", "restore", "latest_checkpoint"]
