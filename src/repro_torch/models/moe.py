"""Mixture-of-Experts FFN, the port of ``repro.models.moe``: top-k routing,
capacity-based dispatch/combine (GShard/Switch pattern), shared experts and
a load-balance auxiliary loss.  Router compute is float32.

Routing equals the reference's exactly: the top-k is a stable descending
sort of the router's probabilities, so a tie goes to the lowest expert
index, as ``lax.top_k`` orders it (``torch.topk`` promises no order among
ties), and the capacity is ``max(1, int(N * k / E * cf))`` in Python, as the
reference computes it.

Both dispatches vectorise with ``torch.func.vmap`` (the FL cohort's local
update maps them over clients): one-hots are comparisons with an
``arange``, and every scatter writes out of place into a new buffer.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .layers import ParamBuilder, gated_act, plain_act

__all__ = ["moe_init", "moe_apply", "moe_apply_einsum", "moe_apply_scatter", "route"]


def moe_init(pb: ParamBuilder, cfg):
    d, E, dff = cfg.d_model, cfg.n_experts, cfg.d_expert
    gated = cfg.act in ("silu", "geglu")
    pb.p("router", (d, E), ("embed", "experts"), fan_in=d)
    if gated:
        pb.p("w_in", (E, d, 2, dff), ("experts", "embed", None, "expert_mlp"), fan_in=d)
    else:
        pb.p("w_in", (E, d, dff), ("experts", "embed", "expert_mlp"), fan_in=d)
    pb.p("w_out", (E, dff, d), ("experts", "expert_mlp", "embed"), fan_in=dff)
    if cfg.n_shared_experts:
        ds = cfg.n_shared_experts * dff
        if gated:
            pb.p("w_in_shared", (d, 2, ds), ("embed", None, "mlp"), fan_in=d)
        else:
            pb.p("w_in_shared", (d, ds), ("embed", "mlp"), fan_in=d)
        pb.p("w_out_shared", (ds, d), ("mlp", "embed"), fan_in=ds)


def _expert_ffn(p, x, act):
    """x: (E, C, d) -> (E, C, d), batched over experts."""
    if act in ("silu", "geglu"):
        h = torch.einsum("ecd,edgf->ecgf", x, p["w_in"])
        h = gated_act(h[..., 0, :], act) * h[..., 1, :]
    else:
        h = plain_act(torch.einsum("ecd,edf->ecf", x, p["w_in"]), act)
    return torch.einsum("ecf,efd->ecd", h, p["w_out"])


def _shared_ffn(p, x, act):
    if act in ("silu", "geglu"):
        h = torch.einsum("nd,dgf->ngf", x, p["w_in_shared"])
        h = gated_act(h[..., 0, :], act) * h[..., 1, :]
    else:
        h = plain_act(torch.einsum("nd,df->nf", x, p["w_in_shared"]), act)
    return torch.einsum("nf,fd->nd", h, p["w_out_shared"])


def moe_apply(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatches to the einsum (small-scale) or scatter (large-scale) impl."""
    if getattr(cfg, "moe_impl", "einsum") == "scatter":
        return moe_apply_scatter(p, x, cfg)
    return moe_apply_einsum(p, x, cfg)


def route(p, xf: torch.Tensor, cfg):
    """``(gate_vals (N, k), expert_idx (N, k), one_hot (N, k, E), aux)`` of
    the router over ``xf`` (N, d): float32 softmax, the top-k with ties to
    the lowest index, gates renormalised (deepseek-style), the choices one-hot
    in float32 and the load-balance loss (Switch eq. 4 generalised to top-k)."""
    E, k = cfg.n_experts, cfg.moe_top_k
    logits = torch.einsum("nd,de->ne", xf.to(torch.float32), p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)  # (N, E)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(0)  # (E,) mean router prob
    one_hot_k = (expert_idx[..., None] == torch.arange(E, device=xf.device)).to(torch.float32)  # (N,k,E)
    ce = one_hot_k.sum(1).mean(0) / k  # fraction of tokens per expert
    aux = E * torch.sum(me * ce)
    return gate_vals, expert_idx, one_hot_k, aux


def capacity(N: int, cfg) -> int:
    return max(1, int(N * cfg.moe_top_k / cfg.n_experts * cfg.capacity_factor))


def moe_apply_einsum(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d). Returns (y, aux_loss).

    Capacity-based top-k dispatch: tokens beyond an expert's capacity are
    dropped for that expert (their residual passes through).  The (N, E, C)
    one-hot dispatch tensor limits this to small N*E*C; production scale
    uses ``moe_apply_scatter``.
    """
    B, S, d = x.shape
    E = cfg.n_experts
    N = B * S
    xf = x.reshape(N, d)
    gate_vals, expert_idx, one_hot_k, aux = route(p, xf, cfg)

    C = capacity(N, cfg)
    # position of each (token, choice) within its expert's queue
    flat_choice = one_hot_k.reshape(-1, E)
    pos_in_expert = (torch.cumsum(flat_choice, dim=0) - flat_choice).reshape(one_hot_k.shape)
    pos = torch.einsum("nke,nke->nk", pos_in_expert, one_hot_k)  # (N,k)
    keep = pos < C
    gate_vals = gate_vals * keep.to(gate_vals.dtype)

    # a dropped choice (pos >= C) matches no slot
    pos_oh = (pos[..., None] == torch.arange(C, device=x.device)).to(x.dtype)  # (N,k,C)
    oh = one_hot_k.to(x.dtype)
    disp = torch.einsum("nke,nkc->nec", oh, pos_oh)  # (N,E,C)
    comb = torch.einsum("nk,nke,nkc->nec", gate_vals.to(x.dtype), oh, pos_oh)

    xe = torch.einsum("nec,nd->ecd", disp, xf)  # (E, C, d)
    ye = _expert_ffn(p, xe, cfg.act)
    y = torch.einsum("nec,ecd->nd", comb, ye)  # (N, d)

    if cfg.n_shared_experts:
        y = y + _shared_ffn(p, xf, cfg.act)
    return y.reshape(B, S, d), aux.to(torch.float32)


def moe_apply_scatter(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Production-scale MoE dispatch via scatter/gather (no (N,E,C) one-hot).

    Each (token, choice) takes slot = expert*C + position-in-expert; tokens
    are added into the per-expert buffers, the expert FFNs run batched, and
    results gather back.  Over-capacity tokens drop (GShard semantics).
    """
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    N = B * S
    xf = x.reshape(N, d)
    gate_vals, expert_idx, _, aux = route(p, xf, cfg)

    flat_e = expert_idx.reshape(-1)  # (N*k,)
    flat_g = gate_vals.reshape(-1)
    # position-in-expert via a stable sort
    sorted_e, order = torch.sort(flat_e, stable=True)
    # a bincount (torch.bincount would wait for the device to size its output)
    counts = torch.zeros(E, dtype=flat_e.dtype, device=x.device).scatter_add(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts  # (E,)
    pos_sorted = torch.arange(flat_e.shape[0], device=x.device) - starts[sorted_e]
    pos = torch.empty_like(flat_e).scatter(0, order, pos_sorted)
    C = capacity(N, cfg)
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, E * C)  # E*C = trash slot

    tok = torch.arange(N * k, device=x.device) // k
    src = xf[tok] * keep[:, None].to(xf.dtype)  # (N*k, d)
    # every kept slot is written once and only the trash row E*C takes many
    # writes, so the sum is deterministic on the card too
    xe = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device).index_add(0, slot, src)
    xe = xe[: E * C].reshape(E, C, d)
    ye = _expert_ffn(p, xe, cfg.act)
    ye_flat = torch.cat([ye.reshape(E * C, d), torch.zeros((1, d), dtype=ye.dtype, device=ye.device)], 0)
    back = ye_flat[slot] * flat_g[:, None].to(ye.dtype)  # (N*k, d)
    y = back.reshape(N, k, d).sum(1)

    if cfg.n_shared_experts:
        y = y + _shared_ffn(p, xf, cfg.act)
    return y.reshape(B, S, d), aux.to(torch.float32)
