"""Rematerialisation of a layer body, the port of the reference's
``jax.checkpoint`` around each layer of a stack.

``remat(body, *args)`` returns ``body(*args)``, a tuple of tensors.  Where a
gradient is being taken through it (grad mode on and some input requires
one), the body runs as one ``torch.autograd.Function`` that keeps only its
inputs (the residual stream and the layer's parameter views) and none of
its activations; its backward runs the body again under ``torch.func.vjp``.
Elsewhere (``torch.no_grad()``, prefill, decode) it is the plain call.

The function works under plain autograd (``torch.autograd.grad``), under
``torch.func.grad`` and under ``vmap`` of it (``generate_vmap_rule``), which
the FL cohort's local update takes; it is differentiable once (its backward
records no graph).  ``torch.utils.checkpoint`` cannot serve
here: its saved-tensor hooks are refused inside ``torch.func`` transforms.

Every tensor the body reads must be in ``args`` (nested dicts of tensors
are flattened; a ``None`` passes as it is): a tensor it closes over gets no
gradient, and under ``vmap`` of ``torch.func.grad`` one made outside the
body cannot be read inside it at all.  Integer and boolean inputs (positions,
masks) get no gradient.
The recomputation runs the same operations on the same inputs, so the
gradients equal the plain body's bit for bit on the CPU.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import vjp
from torch.utils import _pytree as pytree

__all__ = ["remat"]


class _Remat(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(flat_body, *leaves):
        return flat_body(*leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.flat_body = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        diff = [i for i, t in enumerate(saved) if t.is_floating_point()]
        if _on_mesh(saved):
            return (None, *_autograd_backward(ctx.flat_body, saved, diff, grads))

        def of_floats(*floats):  # the body as a function of its floating inputs
            full = list(saved)
            for i, t in zip(diff, floats):
                full[i] = t
            return ctx.flat_body(*full)

        _, pullback = vjp(of_floats, *(saved[i] for i in diff))
        out = [None] * len(saved)
        for i, g in zip(diff, pullback(grads)):
            # detached: ``torch.func.grad`` differentiates with
            # ``create_graph=True``, and a graph of this backward would keep
            # the layer's recomputed activations alive until the gradients
            # die; the grad mode stays the caller's, so ATen takes the same
            # paths (a matmul folds its batch axes by it) as without remat
            out[i] = g.detach()
        return (None, *out)


def _on_mesh(saved) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in saved)


def _autograd_backward(flat_body, saved, diff, grads):
    """The backward on a mesh (DTensor inputs, which ``torch.func.vjp`` does
    not take): the body again under autograd, differentiated with
    ``torch.autograd.grad`` (the cohort's ``vmap`` never reaches here: it
    maps plain tensors)."""
    with torch.enable_grad():
        inputs = [saved[i].detach().requires_grad_() for i in diff]
        full = list(saved)
        for i, t in zip(diff, inputs):
            full[i] = t
        outs = flat_body(*full)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
    got = torch.autograd.grad([o for o, _ in pairs], inputs, [g for _, g in pairs], allow_unused=True)
    out = [None] * len(saved)
    for i, g in zip(diff, got):
        out[i] = g
    return out


def remat(body: Callable[..., Tuple[torch.Tensor, ...]], *args) -> Tuple[torch.Tensor, ...]:
    """``body(*args)``, its activations recomputed in the backward when a
    gradient flows through it.  ``body`` returns a tuple of tensors."""
    leaves, spec = pytree.tree_flatten(args)
    is_tensor = [isinstance(t, torch.Tensor) for t in leaves]
    tensors = [t for t, is_t in zip(leaves, is_tensor) if is_t]
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return body(*args)

    def flat_body(*flat):
        it = iter(flat)  # the tensors in order; other leaves (None) as given
        full = [next(it) if is_t else leaf for leaf, is_t in zip(leaves, is_tensor)]
        return tuple(body(*pytree.tree_unflatten(full, spec)))

    return _Remat.apply(flat_body, *tensors)
