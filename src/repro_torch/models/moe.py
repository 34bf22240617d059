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

On a mesh (a DTensor ``x``) both run GShard's layout, the one the JAX
package's ``shard`` sites ask of the compiler (``_MeshShare``): each rank
routes its own rows of the batch, with the whole batch's capacities and
queue positions, into the experts its shard holds; the ``shard`` sites lay
the dispatched buffers out over ``experts`` and ``embed``, so under
``silo_rules`` the expert FFNs split over the data axes too.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .layers import ParamBuilder, gated_act, mlp_apply, plain_act
from .sharding import einsum, shard

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
        h = einsum("ecd,edgf->ecgf", x, p["w_in"])
        h = gated_act(h[..., 0, :], act) * h[..., 1, :]
    else:
        h = plain_act(einsum("ecd,edf->ecf", x, p["w_in"]), act)
    return einsum("ecf,efd->ecd", h, p["w_out"])


def _shared_ffn(p, x, act):
    if act in ("silu", "geglu"):
        h = einsum("nd,dgf->ngf", x, p["w_in_shared"])
        h = gated_act(h[..., 0, :], act) * h[..., 1, :]
    else:
        h = plain_act(einsum("nd,df->nf", x, p["w_in_shared"]), act)
    return einsum("nf,fd->nd", h, p["w_out_shared"])


def moe_apply(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatches to the einsum (small-scale) or scatter (large-scale) impl."""
    if getattr(cfg, "moe_impl", "einsum") == "scatter":
        return moe_apply_scatter(p, x, cfg)
    return moe_apply_einsum(p, x, cfg)


class _MeshShare:
    """What an MoE layer computes on this rank of a mesh, for a DTensor
    ``x`` (``_on_mesh``).  Its rows: ``x``'s shard along the batch axes
    (``rows``); its experts: ``w_in``'s shard along the ``experts`` axes
    (``ex``), ``[e0, e0 + ne)``.  The routing runs on the rows alone, the
    load-balance statistics and each expert's queue position summed over
    the ranks' rows in the batch's order, so capacities, positions and drops
    are the whole batch's, as on one device.  The dispatched buffers are a
    partial sum over ``rows`` (each rank fills its rows' slots) that the
    ``shard`` sites reduce and lay out; the combined outputs a partial sum
    over ``ex``.  Axes in neither repeat the same work."""

    def __init__(self, p, x, cfg):
        from torch.distributed.tensor import Partial, Replicate, Shard

        from .sharding import replicated, shard_range

        mesh = x.device_mesh
        if not all(pl.is_shard(0) or pl.is_replicate() for pl in x.placements):
            x = x.redistribute(mesh, [pl if pl.is_shard(0) else Replicate() for pl in x.placements])
        rows = [j for j, pl in enumerate(x.placements) if pl.is_shard(0)]
        ex = [j for j, pl in enumerate(p["w_in"].placements) if pl.is_shard(0)]
        if set(rows) & set(ex):
            raise ValueError(f"the MoE's batch and experts share mesh axes {sorted(set(rows) & set(ex))}")
        dims = range(mesh.ndim)
        self.mesh, self.rows, self.ex, self.cfg = mesh, rows, ex, cfg
        self.shape = tuple(x.shape)
        self.N = x.shape[0] * x.shape[1]
        self.n_ex = math.prod(mesh.size(j) for j in ex)
        self.x_pl = [Shard(0) if j in rows else Replicate() for j in dims]
        self.x = x
        # a placement a mesh dimension: rows sharded, the experts' share of a sum partial, else replicated
        self.y_pl = [Shard(0) if j in rows else Partial() if j in ex else Replicate() for j in dims]
        xl = x.to_local(grad_placements=self.y_pl)
        self.xf = xl.reshape(xl.shape[0] * x.shape[1], x.shape[2])
        # the router's gradient sums this rank's rows and its experts' share
        self.router = {"router": replicated(p["router"]).to_local(
            grad_placements=[Partial() if j in rows or j in ex else Replicate() for j in dims])}
        self.e0, self.ne = shard_range(p["w_in"], 0)

    def total(self, t):
        """The sum over the ranks' rows of ``t``, this rank's rows' sum."""
        from torch.distributed.tensor import DTensor, Partial, Replicate

        mesh = self.mesh
        if not self.rows:
            return t
        part = [Partial() if j in self.rows else Replicate() for j in range(mesh.ndim)]
        return DTensor.from_local(t, mesh, part, run_check=False).redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local()

    def offset(self, counts):
        """Where this rank's choices start in each expert's queue: the
        ``counts`` (a choice count an expert) of the ranks whose rows come
        before its own in the batch."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh = self.mesh
        if not self.rows:
            return torch.zeros_like(counts)
        n = math.prod(mesh.size(j) for j in self.rows)
        pl = [Shard(0) if j in self.rows else Replicate() for j in range(mesh.ndim)]
        every = DTensor.from_local(counts[None], mesh, pl, run_check=False, shape=(n,) + tuple(counts.shape),
                                   stride=(counts.numel(), 1)).full_tensor()
        coord, r = mesh.get_coordinate(), 0
        for j in self.rows:  # the batch's order: the first mesh dimension the major
            r = r * mesh.size(j) + coord[j]
        return every[:r].sum(0)

    def dispatched(self, xe):
        """The rank's ``(ne, C, d)`` buffers of its rows as the ``(E, C,
        d)`` DTensor of the whole batch: a partial sum over the rows."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        from .sharding import contiguous_strides

        pl = [Partial() if j in self.rows else Shard(0) if j in self.ex else Replicate()
              for j in range(self.mesh.ndim)]
        shape = (self.cfg.n_experts,) + tuple(xe.shape[1:])
        return DTensor.from_local(xe, self.mesh, pl, run_check=False, shape=shape, stride=contiguous_strides(shape))

    def local(self, ye):
        """The rank's experts' outputs, whole along ``d``, as a local
        tensor: its rows' share of their gradient."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        dims = range(self.mesh.ndim)
        want = [Shard(0) if j in self.ex else Replicate() for j in dims]
        if tuple(ye.placements) != tuple(want):
            ye = ye.redistribute(self.mesh, want)
        return ye.to_local(grad_placements=[Shard(0) if j in self.ex else Partial() if j in self.rows
                                            else Replicate() for j in dims])

    def output(self, p, y, aux):
        """``(y, aux)`` as DTensors: ``y`` (the rank's rows' combined
        outputs, plus the shared experts, a dense MLP) laid out as ``x``,
        ``aux`` replicated."""
        from torch.distributed.tensor import DTensor, Partial, Replicate

        from .sharding import contiguous_strides, replicated

        mesh, (B, S, d) = self.mesh, self.shape
        y = DTensor.from_local(y.reshape(-1, S, d), mesh, self.y_pl, run_check=False, shape=self.shape,
                               stride=contiguous_strides(self.shape))
        if self.cfg.n_shared_experts:
            sh = mlp_apply({"w_in": p["w_in_shared"], "w_out": p["w_out_shared"]}, self.x, self.cfg.act)
            y = y + sh if tuple(sh.placements) == tuple(y.placements) else \
                y.redistribute(mesh, self.x_pl) + sh.redistribute(mesh, self.x_pl)
        # every rank's balance loss is the whole batch's: each adds its share
        # (n_ex a power of two: exact), so that its gradient joins the
        # router's partial sum over the experts at the right weight
        aux = replicated(DTensor.from_local(aux / self.n_ex, mesh, [Partial() if j in self.ex else Replicate()
                                                                    for j in range(mesh.ndim)], run_check=False))
        return y.redistribute(mesh, self.x_pl), aux.to(torch.float32)


def _on_mesh(p, x, cfg):
    """``_MeshShare`` of a DTensor ``x``; ``None`` on one device."""
    from torch.distributed.tensor import DTensor

    return _MeshShare(p, x, cfg) if isinstance(x, DTensor) else None


def route(p, xf: torch.Tensor, cfg, m=None):
    """``(gate_vals (N, k), expert_idx (N, k), one_hot (N, k, E), aux)`` of
    the router over ``xf`` (N, d): float32 softmax, the top-k with ties to
    the lowest index, gates renormalised (deepseek-style), the choices one-hot
    in float32 and the load-balance loss (Switch eq. 4 generalised to top-k;
    on a mesh ``m``, of the whole batch)."""
    E, k = cfg.n_experts, cfg.moe_top_k
    logits = einsum("nd,de->ne", xf.to(torch.float32), p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)  # (N, E)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    one_hot_k = (expert_idx[..., None] == torch.arange(E, device=xf.device)).to(torch.float32)  # (N,k,E)
    if m is None:
        me = probs.mean(0)  # (E,) mean router prob
        ce = one_hot_k.sum(1).mean(0) / k  # fraction of tokens per expert
    else:
        me = m.total(probs.sum(0)) / m.N
        ce = m.total(one_hot_k.sum((0, 1))) / m.N / k
    aux = E * torch.sum(me * ce)
    return gate_vals, expert_idx, one_hot_k, aux


def capacity(N: int, cfg) -> int:
    return max(1, int(N * cfg.moe_top_k / cfg.n_experts * cfg.capacity_factor))


def _einsum_dispatch(gate_vals, one_hot_k, C: int, dtype, m=None):
    """The (N, E, C) dispatch and combine tensors of the top-k choices: each
    (token, choice) at its position in its expert's queue, a choice past
    the capacity dropped (on a mesh ``m``: the rank's rows and experts, the
    positions the whole batch's)."""
    E = one_hot_k.shape[-1]
    flat_choice = one_hot_k.reshape(-1, E)
    pos_in_expert = (torch.cumsum(flat_choice, dim=0) - flat_choice).reshape(one_hot_k.shape)
    if m is not None:
        pos_in_expert = pos_in_expert + m.offset(flat_choice.sum(0).to(torch.int64)).to(pos_in_expert.dtype)
    pos = einsum("nke,nke->nk", pos_in_expert, one_hot_k)  # (N,k)
    keep = pos < C
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    # a dropped choice (pos >= C) matches no slot
    pos_oh = (pos[..., None] == torch.arange(C, device=one_hot_k.device)).to(dtype)  # (N,k,C)
    oh = one_hot_k.to(dtype) if m is None else one_hot_k[..., m.e0:m.e0 + m.ne].to(dtype)
    disp = einsum("nke,nkc->nec", oh, pos_oh)  # (N,E,C)
    comb = einsum("nk,nke,nkc->nec", gate_vals.to(dtype), oh, pos_oh)
    return disp, comb


def _scatter_slots(expert_idx, gate_vals, C: int, cfg, m=None):
    """``(slot, keep, flat_g)`` of each (token, choice): its row ``expert *
    C + position`` in the experts' buffers (``E * C``, the trash row, past
    the capacity), whether it is kept, and its gate.  On a mesh ``m`` the
    buffers are the rank's experts' (``ne * C`` rows; another rank's
    expert, the trash row) and the positions the whole batch's."""
    E = cfg.n_experts
    flat_e = expert_idx.reshape(-1)  # (N*k,)
    flat_g = gate_vals.reshape(-1)
    # position-in-expert via a stable sort
    sorted_e, order = torch.sort(flat_e, stable=True)
    # a bincount (torch.bincount would wait for the device to size its output)
    counts = torch.zeros(E, dtype=flat_e.dtype, device=flat_e.device).scatter_add(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts  # (E,)
    pos_sorted = torch.arange(flat_e.shape[0], device=flat_e.device) - starts[sorted_e]
    pos = torch.empty_like(flat_e).scatter(0, order, pos_sorted)
    if m is None:
        keep = pos < C
        return torch.where(keep, flat_e * C + pos, E * C), keep, flat_g  # E*C = trash slot
    pos = pos + m.offset(counts)[flat_e]
    keep = pos < C
    mine = (flat_e >= m.e0) & (flat_e < m.e0 + m.ne)
    return torch.where(keep & mine, (flat_e - m.e0) * C + pos, m.ne * C), keep, flat_g


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
    m = _on_mesh(p, x, cfg)
    xf = x.reshape(N, d) if m is None else m.xf
    gate_vals, expert_idx, one_hot_k, aux = route(p if m is None else m.router, xf, cfg, m)

    C = capacity(N, cfg)
    disp, comb = _einsum_dispatch(gate_vals, one_hot_k, C, x.dtype, m)

    xe = einsum("nec,nd->ecd", disp, xf)  # (E, C, d)
    xe = shard(xe if m is None else m.dispatched(xe), "experts", None, "embed")
    ye = _expert_ffn(p, xe, cfg.act)
    ye = shard(ye, "experts", None, "embed")
    y = einsum("nec,ecd->nd", comb, ye if m is None else m.local(ye))  # (N, d)

    if m is not None:
        return m.output(p, y, aux)
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
    m = _on_mesh(p, x, cfg)
    xf = x.reshape(N, d) if m is None else m.xf
    gate_vals, expert_idx, _, aux = route(p if m is None else m.router, xf, cfg, m)
    C = capacity(N, cfg)
    slot, keep, flat_g = _scatter_slots(expert_idx, gate_vals, C, cfg, m)
    ne, n = (E, N) if m is None else (m.ne, xf.shape[0])

    tok = torch.arange(n * k, device=xf.device) // k
    src = xf[tok] * keep[:, None].to(xf.dtype)  # (N*k, d)
    # every kept slot is written once and only the trash row E*C takes many
    # writes, so the sum is deterministic on the card too
    xe = torch.zeros((ne * C + 1, d), dtype=xf.dtype, device=xf.device).index_add(0, slot, src)
    xe = xe[: ne * C].reshape(ne, C, d)
    xe = shard(xe if m is None else m.dispatched(xe), "experts", None, "embed")
    ye = _expert_ffn(p, xe, cfg.act)
    ye = shard(ye, "experts", None, "embed")
    ye = ye if m is None else m.local(ye)
    ye_flat = torch.cat([ye.reshape(ne * C, d), torch.zeros((1, d), dtype=ye.dtype, device=ye.device)], 0)
    back = ye_flat[slot] * flat_g[:, None].to(ye.dtype)  # (N*k, d)
    y = back.reshape(n, k, d).sum(1)

    if m is not None:
        return m.output(p, y, aux)
    if cfg.n_shared_experts:
        y = y + _shared_ffn(p, xf, cfg.act)
    return y.reshape(B, S, d), aux.to(torch.float32)
