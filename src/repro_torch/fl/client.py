"""Local update operators o1 (paper P1): FedAvg SGD and FedProx, the port
of ``repro.fl.client``.

``make_local_update`` builds a function that trains the whole cohort

    local_train(global_params, batches, step_mask) -> (cohort_params, stats)

over pre-gathered mini-batches (``batches[name]: (k, n_steps, B, ...)``,
``step_mask: (k, n_steps)``): ``n_steps`` steps of the optimizer, a Python
loop, each step's gradients for the k clients at once with ``torch.func``
(``vmap`` of ``grad_and_value`` of the model's loss).  Every client starts
from the same global parameters, so the first step maps over the batches
only (``in_dims=None`` for the parameters); the clients' parameters and
optimizer state are ``(k, ...)`` stacks from then on.  A masked step
(heterogeneous epoch counts, paper §VI-A) blends ``keep * new + (1 - keep)
* old`` for parameters and optimizer state, as the JAX package does, which
leaves both as they were.  FedProx adds ``gamma/2 * ||theta -
theta_global||^2`` to every step's loss (Li et al.).  Parameters are any
tree of tensors: the CNN's flat dict or a zoo model's nested one.  Neither
loss draws noise, so no key is handed on (the JAX package passes one the
losses ignore).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.func import grad_and_value, vmap

from repro_torch.optim import leafwise

__all__ = ["make_local_update", "prox_penalty"]

_f32 = torch.float32


def _jax_leaves(tree) -> list:
    """A parameter tree's leaves in ``jax.tree.leaves`` order (a dict's keys
    sorted, at every level)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _jax_leaves(tree[key])]
    return [tree]


def prox_penalty(params, global_params) -> torch.Tensor:
    """``||params - global_params||^2`` over every leaf in float32, the
    leaves' sums added one at a time in ``jax.tree.reduce``'s order."""
    sq = [torch.sum(torch.square(a.to(_f32) - b.to(_f32)))
          for a, b in zip(_jax_leaves(params), _jax_leaves(global_params))]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    return total


def _blend(keep, new, old):
    """``keep * new + (1 - keep) * old`` leaf by leaf, ``keep`` a ``(k,)``
    row broadcast over each leaf's trailing axes (``old`` unstacked at the
    first step)."""

    def one(n, o):
        kk = keep.reshape(keep.shape + (1,) * (n.dim() - 1))
        return (kk * n.to(_f32) + (1 - kk) * o.to(_f32)).to(o.dtype)

    return leafwise(one, new, old, lead=1)  # keep's row runs along the leading axis


def make_local_update(model, opt, update_kind: str = "fedavg", prox_coef: float = 0.5) -> Callable:
    def loss_fn(params, batch, global_params):
        loss, _ = model.loss(params, batch)
        if update_kind == "fedprox":
            loss = loss + 0.5 * prox_coef * prox_penalty(params, global_params)
        return loss

    grad_fn = grad_and_value(loss_fn)
    shared = vmap(grad_fn, in_dims=(None, 0, None))  # step 0: every client holds the global parameters
    stacked = vmap(grad_fn, in_dims=(0, 0, None))

    def local_train(global_params, batches: Dict[str, torch.Tensor], step_mask: torch.Tensor):
        params, opt_state = global_params, opt.init(global_params)
        losses = []
        for i in range(step_mask.shape[1]):
            batch = {name: b[:, i] for name, b in batches.items()}
            grads, loss = (shared if i == 0 else stacked)(params, batch, global_params)
            new_params, new_opt = opt.update(params, grads, opt_state, i)
            del grads  # each stack is freed as soon as it is spent: a zoo model's are gigabytes
            # masked step: heterogeneous local epochs — skipped steps are no-ops
            keep = step_mask[:, i].to(_f32)
            params = _blend(keep, new_params, params)
            del new_params
            opt_state = _blend(keep, new_opt, opt_state)
            del new_opt
            losses.append(loss * keep)
        n_eff = torch.clamp(torch.sum(step_mask, dim=1), min=1.0)
        return params, {"local_loss": torch.sum(torch.stack(losses, dim=1), dim=1) / n_eff}

    return local_train
