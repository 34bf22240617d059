"""Aggregation operators o2 under the deadline mechanism (paper P1, Alg. 1
l.9-10), the port of ``repro.fl.aggregation``.

The paper's volatility constraint substitutes the *global* model for every
client that failed or was not selected:

    theta_{t+1} = sum_i w_i * [mask_i * theta_i + (1-mask_i) * theta_t]
               = theta_t + sum_i w_i * mask_i * (theta_i - theta_t)

so every scheme works in delta form over the cohort only:

* ``mean``           — w_i = 1/K (Alg. 1's plain average).
* ``fedavg``         — w_i = q_i / q (data-size weighted, paper P1).
* ``epoch_weighted`` — w_i ∝ (q_i/q) / E_i (Ruan et al. [11]).
* ``unbiased``       — w_i = q_i / (q * p_i) (inverse propensity, Chen et
  al. [19]).

``aggregate_async`` takes per-client completion lags (``0`` on time, ``l >=
1`` late, negative dead), applies the on-time deltas now and returns the
late-but-alive ones as ``(S, ...)`` deferred contributions already scaled by
``alpha**lag``.  ``staleness=0`` with lags ``0 / -1`` is ``aggregate``.
Parameters are trees of tensors (nested dicts, mapped leaf by leaf as the
JAX package's ``jax.tree.map``); cohort leaves carry a leading ``(k,)``
axis.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

__all__ = ["aggregate", "aggregate_async", "staleness_weights"]

_f32 = torch.float32


def _scheme_weights(scheme: str, data_sizes, total_data, K: int, k: int, epochs=None, sel_probs=None):
    """The (k,) base cohort weights w_i of each aggregation scheme."""
    if scheme == "mean":
        return torch.full((k,), 1.0 / K, dtype=_f32, device=data_sizes.device)
    if scheme == "fedavg":
        return data_sizes / torch.clamp(total_data, min=1e-9)
    if scheme == "epoch_weighted":
        base = data_sizes / torch.clamp(total_data, min=1e-9)
        inv = 1.0 / torch.clamp(epochs.to(_f32), min=1.0)
        # renormalise so the cohort's total weight is preserved
        return base.sum() * (base * inv) / torch.clamp((base * inv).sum(), min=1e-9)
    if scheme == "unbiased":
        return data_sizes / torch.clamp(total_data, min=1e-9) / torch.clamp(sel_probs, 1e-3, 1.0)
    raise ValueError(scheme)


def staleness_weights(lag: torch.Tensor, alpha: float, staleness: int) -> torch.Tensor:
    """Decay credit ``alpha**lag`` for ``0 <= lag <= staleness``, else 0."""
    lagf = torch.clamp(lag.to(_f32), min=0.0)
    ok = (lag >= 0) & (lag <= staleness)
    return torch.where(ok, torch.pow(torch.full((), alpha, dtype=_f32, device=lag.device), lagf),
                       torch.zeros((), dtype=_f32, device=lag.device))


def _delta(g, c):
    return c.to(_f32) - g.to(_f32)[None]


def aggregate(global_params, cohort_params, success, data_sizes, total_data, K: int, scheme: str = "fedavg",
              epochs=None, sel_probs=None, rows=None, psum=None):
    """``global + sum_i w_i * success_i * (cohort_i - global)`` leaf by leaf;
    ``success`` (k,) {0,1}, ``data_sizes`` (k,) q_i, ``total_data`` q.

    On a data axis (``fl.make_cohort_round(spmd_axes=...)``) each rank holds
    the cohort's ``rows`` (a slice of the k clients): the weights are the
    whole cohort's, each rank sums its rows' contributions and ``psum``
    adds them over the ranks in place."""
    k = success.shape[0]
    w = _scheme_weights(scheme, data_sizes, total_data, K, k, epochs, sel_probs)
    w = w * success  # failed clients contribute the global model (zero delta)
    if rows is not None:
        w = w[rows]

    def upd(g, c):
        contrib = torch.tensordot(w, _delta(g, c), dims=([0], [0]))
        if psum is not None:
            psum(contrib)
        return (g.to(_f32) + contrib).to(g.dtype)

    return pytree.tree_map(upd, global_params, cohort_params)


def aggregate_async(global_params, cohort_params, lag, data_sizes, total_data, K: int, scheme: str = "fedavg", *,
                    alpha: float = 0.5, staleness: int = 0, epochs=None, sel_probs=None, rows=None, psum=None):
    """Staleness-aware aggregation: ``(new_params, late_deltas)``.

    On-time clients (``lag == 0``) are aggregated now at their full scheme
    weight, as ``aggregate``.  A late-but-alive client (``1 <= lag <=
    staleness``) contributes ``alpha**lag * w_i * (theta_i - theta_t)``,
    returned in ``late_deltas``: leaves with a leading ``(staleness,)`` axis,
    slice ``s`` the summed contribution that lands ``s+1`` rounds from now.
    Dead lags and lags beyond ``staleness`` are dropped.  ``rows`` and
    ``psum`` split the cohort over a data axis, as in ``aggregate``.
    """
    k = lag.shape[0]
    w = _scheme_weights(scheme, data_sizes, total_data, K, k, epochs, sel_probs)
    s_idx = torch.arange(staleness + 1, dtype=lag.dtype, device=lag.device)
    arrive = (lag[None, :] == s_idx[:, None]).to(_f32)  # (S+1, k) one-hot by lag
    decay = torch.pow(torch.full((), alpha, dtype=_f32, device=lag.device), s_idx.to(_f32))
    A = arrive * decay[:, None] * w[None, :]  # (S+1, k) credit matrix
    if rows is not None:
        A = A[:, rows]

    def part(g, c):
        out = torch.tensordot(A, _delta(g, c), dims=([1], [0]))
        if psum is not None:
            psum(out)
        return out

    parts = pytree.tree_map(part, global_params, cohort_params)
    new_params = pytree.tree_map(lambda g, part: (g.to(_f32) + part[0]).to(g.dtype), global_params, parts)
    return new_params, pytree.tree_map(lambda part: part[1:], parts)
