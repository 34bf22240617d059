from .paths import autotune_dir, autotune_path, results_root
from .trace import stage

__all__ = ["stage", "results_root", "autotune_dir", "autotune_path"]
