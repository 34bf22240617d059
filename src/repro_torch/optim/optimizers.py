"""Optimizers from scratch: SGD (+momentum) and AdamW, the port of
``repro.optim.optimizers``.

Plain functions over parameter trees (nested dicts of tensors, mapped leaf
by leaf with ``torch.utils._pytree`` as the JAX package maps them with
``jax.tree.map``; ``leafwise`` slices the largest leaves), with the JAX
package's contract:

    opt = sgd(lr=1e-2, momentum=0.9)
    state = opt.init(params)
    params, state = opt.update(params, grads, state, step)

``lr`` may be a float or a schedule ``step -> float32 0-d tensor``.  State
lives in the parameters' dtype unless ``fp32_state=True`` (AdamW; the FL
paper's SGD runs fp32 anyway).  The operations, their order and their
dtypes are those of the JAX package, one elementwise op at a time, so a
stacked ``(k, ...)`` cohort of parameters updates as k separate calls would.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Union

import torch
from torch.utils import _pytree as pytree

__all__ = ["Optimizer", "sgd", "adamw", "leafwise"]

Schedule = Union[float, Callable]
_f32 = torch.float32


# an elementwise map over a leaf of more elements than this runs a slice at a time
SLICE_ELEMENTS = 1 << 26


def leafwise(fn, *trees, lead: int = 0):
    """``tree_map(fn, *trees)`` for an elementwise ``fn``.  Eager PyTorch
    makes every float32 intermediate of a leaf in full where XLA fuses them,
    and a zoo model's stacked leaves hold billions of elements (gemma-2b's
    18 MLPs, 1.2e9 a client), so a leaf whose broadcast shape holds more than
    ``SLICE_ELEMENTS`` is mapped a slice of its largest trailing axis at a
    time into one output.  Each element sees the same operations either way,
    so the values are the same.  Leaves have one shape, but a leaf may lack
    leading axes of another (a global model against a ``(k, ...)`` cohort
    stack); the first ``lead`` axes are never sliced (``fn`` broadcasts a
    per-row factor along them).

    DTensor leaves (parameters on a mesh, ``models.sharding``) map over
    their local shards: each is first laid out as the leaf of most
    dimensions (a gradient's partial sum reduced, a global leaf's shards
    aligned with a stack's), and the output is a DTensor of that layout."""
    return pytree.tree_map(lambda *leaves: _mapped(fn, leaves, lead), *trees)


def _mapped(fn, leaves, lead):
    from torch.distributed.tensor import DTensor

    dts = [t for t in leaves if isinstance(t, DTensor)]
    if not dts:
        return _sliced(fn, leaves, lead)
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.sharding import contiguous_strides

    ref = max(dts, key=lambda t: t.dim())
    mesh, nd = ref.device_mesh, ref.dim()
    target = [Replicate() if p.is_partial() else p for p in ref.placements]
    locals_ = []
    for t in leaves:
        if isinstance(t, DTensor):
            shift = nd - t.dim()
            want = [Shard(p.dim - shift) if p.is_shard() else p for p in target]
            if any(p.is_shard() and p.dim < shift for p in target):
                raise ValueError(f"a leaf of {t.dim()} dims cannot follow a layout {target} of {nd} dims")
            if tuple(t.placements) != tuple(want):
                t = t.redistribute(mesh, want)
            t = t.to_local()
        locals_.append(t)
    out = _sliced(fn, locals_, lead)
    shape = torch.broadcast_shapes(*(t.shape for t in leaves))
    return DTensor.from_local(out, mesh, target, run_check=False, shape=shape, stride=contiguous_strides(shape))


def _sliced(fn, leaves, lead):
    shape = torch.broadcast_shapes(*(t.shape for t in leaves))
    n = math.prod(shape)
    nd = min(t.dim() for t in leaves)
    if n <= SLICE_ELEMENTS or nd == 0:
        return fn(*leaves)
    ax = max(range(max(len(shape) - nd, lead), len(shape)), key=lambda d: shape[d])  # an axis every leaf holds
    size = shape[ax]
    step = max(1, size * SLICE_ELEMENTS // n)
    out = None
    for start in range(0, size, step):
        width = min(step, size - start)
        part = fn(*(t.narrow(t.dim() - len(shape) + ax, start, width) for t in leaves))
        if out is None:
            out = torch.empty(shape, dtype=part.dtype, device=part.device)
        out.narrow(ax, start, width).copy_(part)
    return out


def _lr_at(lr: Schedule, step):
    return lr(step) if callable(lr) else lr


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def sgd(lr: Schedule = 1e-2, momentum: float = 0.0, nesterov: bool = False, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return leafwise(torch.zeros_like, params)

    def update(params, grads, state, step=0):
        lr_t = _lr_at(lr, step)
        if weight_decay:
            grads = leafwise(lambda g, p: g + weight_decay * p.to(g.dtype), grads, params)
        if momentum == 0.0:
            return leafwise(lambda p, g: (p - lr_t * g.to(_f32)).to(p.dtype), params, grads), ()
        new_state = leafwise(lambda m, g: momentum * m + g.to(m.dtype), state, grads)
        eff = leafwise(lambda m, g: g.to(m.dtype) + momentum * m, new_state, grads) if nesterov else new_state
        new_params = leafwise(lambda p, m: (p - lr_t * m.to(_f32)).to(p.dtype), params, eff)
        return new_params, new_state

    return Optimizer(init, update)


class AdamWState(NamedTuple):
    mu: dict
    nu: dict


def adamw(
    lr: Schedule = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    fp32_state: bool = True,
) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=_f32 if fp32_state else p.dtype, device=p.device)
        return AdamWState(leafwise(z, params), leafwise(z, params))

    def update(params, grads, state, step=0):
        lr_t = _lr_at(lr, step)
        t = torch.tensor(float(step), dtype=_f32) + 1.0
        c1 = 1.0 - b1**t
        c2 = 1.0 - b2**t
        mu = leafwise(lambda m, g: b1 * m + (1 - b1) * g.to(m.dtype), state.mu, grads)
        nu = leafwise(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(v.dtype)), state.nu, grads)

        def upd(p, m, v):
            mh = m / c1.to(m.device)
            vh = v / c2.to(v.device)
            step_ = lr_t * (mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(mh.dtype))
            return (p.to(_f32) - step_).to(p.dtype)

        return leafwise(upd, params, mu, nu), AdamWState(mu, nu)

    return Optimizer(init, update)
