"""PyTorch/CUDA port of the client-selection engine in ``repro``.

The package mirrors ``repro``'s layout and names.  It imports ``torch`` and
numpy only: no ``jax`` and nothing of ``repro``, whose modules it copies
where it needs them.  Entry points run on a CUDA device unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper takes its plain
PyTorch version (``repro_torch.kernels.ref``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
