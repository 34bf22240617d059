"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device without CUDA raises: nothing
    carries on on the CPU unless the caller asks for it with ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev
