"""Model façade, the port of ``repro.models.api`` for the ``cnn`` family.

``build_model(cfg)`` returns a ``Model`` with plain functions:
    init(generator) -> (params, specs)   drawn on the generator's device
    loss(params, batch, rng=None) -> (loss, metrics)
    forward(params, batch) -> logits

``params`` is a dict of tensors; ``loss`` and ``forward`` run the family's
module through ``torch.func.functional_call``, so they vectorise with
``torch.func.vmap``.  ``forward`` runs its convolutions in IEEE float32
(``cnn.fp32_convs``); a caller that differentiates it scopes its backward
the same way (the FL round does).  The CNN has no serving path (``prefill``, ``decode``,
``init_caches`` raise), and the other families come with the model zoo
(ROADMAP A13).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig

from . import cnn as cnn_mod

__all__ = ["Model", "build_model", "cross_entropy"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token CE in fp32. logits (..., V), labels (...) int."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable
    loss: Callable
    forward: Callable
    prefill: Callable
    decode: Callable
    init_caches: Callable
    module: torch.nn.Module


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "cnn":
        return _build_cnn(cfg)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet: the model zoo is ROADMAP A13 (only 'cnn' runs)"
    )


def _build_cnn(cfg):
    module = cnn_mod.PaperCNN(cfg)

    def init(generator):
        return cnn_mod.cnn_init(generator, cfg)

    def forward(params, batch):
        with cnn_mod.fp32_convs():
            return functional_call(module, params, (batch["x"],))

    def loss(params, batch, rng=None):
        logits = forward(params, batch)
        ce = cross_entropy(logits, batch["y"])
        acc = torch.mean((torch.argmax(logits, -1) == batch["y"]).to(torch.float32))
        return ce, {"acc": acc}

    def _na(*a, **k):
        raise NotImplementedError("CNN has no serving path")

    return Model(cfg, init, loss, forward, _na, _na, _na, module)
