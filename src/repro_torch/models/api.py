"""Model façade, the port of ``repro.models.api``: one interface over all
families.

``build_model(cfg, window=0, impl="einsum")`` returns a ``Model`` with plain
functions:
    init(rng, device=None) -> (params, specs)   drawn from ``rng``, a
                                                ``core.prng.Key`` (the
                                                reference's values), onto its
                                                device (or onto ``device``;
                                                ``"meta"`` allocates nothing)
    loss(params, batch, rng=None) -> (loss, metrics)
    forward(params, batch) -> logits
    prefill(params, batch, max_len=None) -> (logits, caches)
    decode(params, tokens, caches) -> (logits, caches)
    init_caches(B, S_cache, dtype=None, device=None) -> caches

``params`` is a nested dict of tensors with the reference's names, nesting
and logical-axis ``specs``.  ``decode`` writes into ``caches`` in place and
returns them with their host ``pos`` advanced (``models.transformer``).

The CNN's ``loss`` and ``forward`` run its module through
``torch.func.functional_call``, so they vectorise with ``torch.func.vmap``,
and ``forward`` runs its convolutions in IEEE float32 (``cnn.fp32_convs``);
a caller that differentiates it scopes its backward the same way (the FL
round does).  The CNN has no serving path (``prefill``, ``decode``,
``init_caches`` raise).

``input_specs(cfg, shape)`` gives ``meta`` tensors standing in for every
model input of a shape (the reference's ``jax.ShapeDtypeStruct``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.func import functional_call

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import resolve_device

from . import cnn as cnn_mod
from . import sharding
from . import encdec as encdec_mod
from . import transformer as tr

__all__ = ["Model", "build_model", "input_specs", "cross_entropy"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token CE in fp32. logits (..., V), labels (...) int."""
    logits = logits.to(torch.float32)
    logz, ll = _ce_terms(logits, labels)
    nll = logz - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor):
    """``(logsumexp(logits), logits[..., labels])`` over the last (vocab)
    dimension.  On a DTensor both are computed on each rank's shard, as
    Megatron's vocab-parallel loss does, so no rank gathers the logits:
    where the vocab is split, each rank takes its slice's max, sum of
    exponentials and the labels its slice holds, and the ranks combine them
    (a max and two sums); where it is whole (one rank), the plain ops run
    on the local tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(logits, DTensor):
        return torch.logsumexp(logits, dim=-1), torch.gather(logits, -1, labels[..., None].long())[..., 0]
    from torch.distributed.tensor import Partial, Replicate

    mesh, last = logits.device_mesh, logits.dim() - 1
    if any(p.is_partial() for p in logits.placements):
        logits = logits.redistribute(mesh, [Replicate() if p.is_partial() else p for p in logits.placements])
    rows = [Replicate() if p.is_shard(last) else p for p in logits.placements]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    lab = labels.redistribute(mesh, rows).to_local().long()
    local = logits.to_local()
    start, length = sharding.shard_range(logits, last)
    if length == logits.shape[-1]:  # the whole vocab on every rank
        logz = torch.logsumexp(local, dim=-1)
        ll = torch.gather(local, -1, lab[..., None])[..., 0]
        return (DTensor.from_local(logz, mesh, rows, run_check=False),
                DTensor.from_local(ll, mesh, rows, run_check=False))

    def combined(t, op):
        part = [Partial(op) if p.is_shard(last) else p for p in logits.placements]
        return DTensor.from_local(t, mesh, part, run_check=False).redistribute(mesh, rows)

    m = combined(local.detach().amax(dim=-1), "max").to_local()
    sumexp = combined(torch.exp(local - m[..., None]).sum(dim=-1), "sum")
    logz = torch.log(sumexp) + DTensor.from_local(m, mesh, rows, run_check=False)
    inside = (lab >= start) & (lab < start + length)
    got = torch.gather(local, -1, torch.where(inside, lab - start, 0)[..., None])[..., 0]
    got = torch.where(inside, got, torch.zeros((), dtype=got.dtype, device=got.device))
    return logz, combined(got, "sum")


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable
    loss: Callable
    forward: Callable
    prefill: Callable
    decode: Callable
    init_caches: Callable
    module: Optional[torch.nn.Module]


def build_model(cfg: ModelConfig, window: int = 0, impl: str = "einsum") -> Model:
    if cfg.family == "cnn":
        return _build_cnn(cfg)
    if cfg.family == "encdec":
        return _build_encdec(cfg, window)
    return _build_lm(cfg, window, impl)


def _build_lm(cfg, window, impl):
    def init(rng, device=None):
        return tr.model_init(rng, cfg, device)

    def loss(params, batch, rng=None):
        logits, _, (aux, mtp_logits) = tr.forward(params, cfg, batch, "train", window, impl)
        labels = batch["labels"]
        if cfg.family == "vlm":
            # image positions carry no LM loss
            logits = logits[:, cfg.n_patches:]
        ce = cross_entropy(logits[:, :-1], labels[:, 1:])
        total = ce + cfg.router_aux_coef * aux
        metrics = {"ce": ce, "aux": aux}
        if mtp_logits is not None:
            tl = mtp_logits[:, cfg.n_patches:] if cfg.family == "vlm" else mtp_logits
            # mtp_logits[:, t] predicts labels[t+2] (length S-1 vs labels S)
            mtp_ce = cross_entropy(tl[:, :-1], labels[:, 2:])
            total = total + 0.1 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        return total, metrics

    def forward(params, batch):
        return tr.forward(params, cfg, batch, "train", window, impl)[0]

    def prefill(params, batch, max_len=None):
        logits, caches, _ = tr.forward(params, cfg, batch, "prefill", window, impl)
        S = batch["tokens"].shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
        margin = (max_len - S) if max_len else 64
        return logits, tr.pad_caches(caches, margin, window)

    def decode(params, tokens, caches):
        return tr.decode_step(params, cfg, tokens, caches, window)

    def init_caches(B, S_cache, dtype=None, device=None):
        return tr.init_caches(cfg, B, S_cache, window, dtype or tr.torch_dtype(cfg.dtype), resolve_device(device))

    return Model(cfg, init, loss, forward, prefill, decode, init_caches, None)


def _build_encdec(cfg, window):
    def init(rng, device=None):
        return encdec_mod.encdec_init(rng, cfg, device)

    def loss(params, batch, rng=None):
        logits, _, _ = encdec_mod.encdec_forward(params, cfg, batch, "train", window)
        return cross_entropy(logits[:, :-1], batch["labels"][:, 1:]), {}

    def forward(params, batch):
        return encdec_mod.encdec_forward(params, cfg, batch, "train", window)[0]

    def prefill(params, batch, max_len=None):
        logits, caches, _ = encdec_mod.encdec_forward(params, cfg, batch, "prefill", window)
        S = batch["tokens"].shape[1]
        margin = (max_len - S) if max_len else 64
        if margin > 0 and window == 0:
            caches["self"] = tr.pad_caches({"self": caches["self"]}, margin)["self"]
        return logits, caches

    def decode(params, tokens, caches):
        return encdec_mod.encdec_decode_step(params, cfg, tokens, caches, window)

    def init_caches(B, S_cache, dtype=None, device=None):
        return encdec_mod.encdec_init_caches(cfg, B, S_cache, window, dtype or tr.torch_dtype(cfg.dtype),
                                             resolve_device(device))

    return Model(cfg, init, loss, forward, prefill, decode, init_caches, None)


def _build_cnn(cfg):
    module = cnn_mod.PaperCNN(cfg)

    def init(rng):
        return cnn_mod.cnn_init(rng, cfg)

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


# ------------------------------------------------------------ input specs --


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape, window: int = 0) -> Dict[str, Any]:
    """``meta`` tensors standing in for every model input of this shape.

    For train/prefill: the token batch (+frontend stubs).  For decode: one
    new token per sequence plus the KV/state caches sized to ``seq_len``.
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family == "cnn":
        s = cnn_mod.CNN_SHAPES[cfg.name.replace("-smoke", "")]
        return {"x": _spec((B, *s["img"]), torch.float32), "y": _spec((B,), i32)}
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _spec((B, S), i32)}
        if shape.kind == "train":
            batch["labels"] = _spec((B, S), i32)
        if cfg.family == "vlm":
            P = cfg.n_patches
            batch["tokens"] = _spec((B, S - P), i32)
            if shape.kind == "train":
                batch["labels"] = _spec((B, S - P), i32)
            batch["patch_embeds"] = _spec((B, P, cfg.d_patch), torch.bfloat16)
            batch["positions"] = _spec((3, B, S), i32)
        if cfg.family == "encdec":
            batch["frames"] = _spec((B, cfg.enc_len, cfg.d_model), torch.bfloat16)
        return batch
    # decode: one token + caches pre-filled to S
    caches = build_model(cfg, window=window).init_caches(B, S, device="meta")
    return {"tokens": _spec((B, 1), i32), "caches": caches}
