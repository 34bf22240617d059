"""Parameter factory: the port of ``repro.models.layers.ParamBuilder``
(norms, MLPs and position encodings come with the model zoo, ROADMAP A13)."""
from __future__ import annotations

import math
from typing import Dict

import torch

__all__ = ["ParamBuilder"]


class ParamBuilder:
    """Creates parameters and records their logical sharding axes.

    ``pb = ParamBuilder(generator, dtype)`` then
    ``w = pb.p("wq", (d, H, hd), ("embed", "q_heads", "head_dim"), fan_in=d)``.
    ``pb.params`` / ``pb.specs`` hold mirrored dicts.  Random inits draw, in
    the order the parameters are made, from ``generator`` on its device
    (the JAX package folds a counter into its key instead: the draws differ,
    their law does not).
    """

    def __init__(self, generator: torch.Generator, dtype=torch.float32):
        self.generator = generator
        self.device = generator.device
        self.dtype = dtype
        self.params: Dict = {}
        self.specs: Dict = {}

    def _normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, dtype=torch.float32, device=self.device).to(self.dtype)

    def p(self, name, shape, axes, init="normal", fan_in=None, scale=None):
        assert len(shape) == len(axes), (name, shape, axes)
        if init == "zeros":
            v = torch.zeros(shape, dtype=self.dtype, device=self.device)
        elif init == "ones":
            v = torch.ones(shape, dtype=self.dtype, device=self.device)
        elif init == "normal":
            std = scale if scale is not None else 1.0 / math.sqrt(fan_in or shape[0])
            v = self._normal(shape) * std
        elif init == "embed":
            v = self._normal(shape) * (scale or 0.02)
        else:
            raise ValueError(init)
        self.params[name] = v
        self.specs[name] = tuple(axes)
        return v
