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
from torch.utils import _pytree as pytree

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


def make_local_update(model, opt, update_kind: str = "fedavg", prox_coef: float = 0.5,
                      per_client: bool = False) -> Callable:
    """``local_train(global_params, batches, step_mask) -> (cohort_params,
    stats)``.  ``per_client=True`` trains the clients one after another with
    plain autograd and stacks their results, the same steps in the same
    order; the cohort round takes it for DTensor parameters (a mesh's
    ``model`` axis), which ``torch.func.vmap`` does not map over."""

    def loss_fn(params, batch, global_params):
        loss, _ = model.loss(params, batch)
        if update_kind == "fedprox":
            loss = loss + 0.5 * prox_coef * prox_penalty(params, global_params)
        return loss

    if per_client:
        return _per_client(loss_fn, opt)
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


def _whole(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _per_client(loss_fn, opt) -> Callable:
    def one(global_params, batches, mask):
        """One client: ``mask`` its ``(n_steps,)`` row."""
        params, opt_state = global_params, opt.init(global_params)
        losses = []
        for i in range(mask.shape[0]):
            batch = {name: b[i] for name, b in batches.items()}
            leaves, spec = pytree.tree_flatten(params)
            with torch.enable_grad():
                diff = [t.detach().requires_grad_() for t in leaves]
                loss = loss_fn(pytree.tree_unflatten(diff, spec), batch, global_params)
                grads = pytree.tree_unflatten(list(torch.autograd.grad(loss, diff)), spec)
            loss = _whole(loss.detach())
            new_params, new_opt = opt.update(params, grads, opt_state, i)
            del grads
            keep = mask[i].to(_f32)
            blend = lambda n, o: (keep * n.to(_f32) + (1 - keep) * o.to(_f32)).to(o.dtype)  # noqa: E731
            params = leafwise(blend, new_params, params)
            opt_state = leafwise(blend, new_opt, opt_state)
            del new_params, new_opt
            losses.append(loss * keep)
        return params, torch.stack(losses)

    def local_train(global_params, batches: Dict[str, torch.Tensor], step_mask: torch.Tensor):
        outs = [one(global_params, {name: b[c] for name, b in batches.items()}, step_mask[c])
                for c in range(step_mask.shape[0])]
        cohort = pytree.tree_map(lambda *leaves: torch.stack(leaves), *(o[0] for o in outs))
        losses = torch.stack([o[1] for o in outs])
        n_eff = torch.clamp(torch.sum(step_mask, dim=1), min=1.0)
        return cohort, {"local_loss": torch.sum(losses, dim=1) / n_eff}

    return local_train
