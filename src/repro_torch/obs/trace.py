"""Stage annotations: ``stage(name)`` names a region of the round in
``torch.profiler`` traces and, on a CUDA host, as an NVTX range."""
from __future__ import annotations

import contextlib

import torch

__all__ = ["stage"]


@contextlib.contextmanager
def stage(name: str):
    """Annotate a named pipeline stage (allocate / sample / observe / update /
    credit) for the profiler timeline."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
