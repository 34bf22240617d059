"""Logical-axis sharding rules for the model stack, the port of
``repro.models.sharding``.

Model code annotates tensors with *logical* axis names via ``shard(x,
...)``; a rules table (installed with ``use_rules``) maps logical names to
mesh axes.  Outside a rules context, and on a plain tensor, the annotations
are no-ops, so the same model code runs on one device and on a mesh.

On a mesh the port runs one process a device under ``torch.distributed``
(``launch.mesh.make_mesh``): parameters are DTensors placed by the rules
(``distribute_params``), and ``shard`` redistributes a DTensor activation to
the placements its logical axes map to, where JAX's
``with_sharding_constraint`` asks the compiler for the same layout.  A
partial sum (a contraction over a sharded axis, the vocab-sharded embedding
lookup) is reduced first, so no annotated tensor leaves one behind.  Inside
``use_rules`` the tensors the model makes itself (positions, masks, RoPE
tables) join a DTensor as replicated (``implicit_replication``).

Two base rule-sets, as in the JAX package:

* ``cohort_rules`` — tensor-parallel over ``model``; the cohort's client
  axis splits over the data axes (``fl.make_cohort_round(spmd_axes=...)``);
  per-client params otherwise replicated over ``data``.
* ``silo_rules``   — FSDP over (``pod``,``data``) + tensor-parallel over
  ``model``: batch and the ``embed`` dimension of every weight shard over the
  fsdp axes, head/mlp/vocab/expert dimensions over ``model``.

A spec (``logical_to_spec``) is a tuple with one entry a tensor dimension:
``None``, a mesh axis name, or a tuple of names (JAX's ``PartitionSpec``
entries).  ``placements`` maps it to one DTensor placement a mesh
dimension.  Where a dimension does not divide by its mesh axes, JAX refuses
the layout and DTensor shards it unevenly (``torch.chunk``'s split: the
first ranks hold ``ceil(n / m)`` rows, the last fewer or none).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

__all__ = [
    "use_rules",
    "shard",
    "logical_to_spec",
    "cohort_rules",
    "silo_rules",
    "current_rules",
    "placements",
    "local_shape",
    "distribute_params",
    "is_axes",
    "write_slot",
    "shard_range",
    "einsum",
    "splits_evenly",
    "contiguous_strides",
    "on_rows",
    "lookup",
    "replicated",
]

_state = threading.local()


def current_rules() -> Optional[Dict[str, object]]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[Dict[str, object]]):
    """Install ``rules`` for the block.  With rules, plain tensors that meet
    a DTensor inside it are taken as replicated on its mesh."""
    prev = current_rules()
    _state.rules = rules
    try:
        if rules is None:
            yield
        else:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
    finally:
        _state.rules = prev


def logical_to_spec(axes: Sequence[Optional[str]], rules: Optional[Dict[str, object]] = None) -> Tuple:
    """The spec of a tensor whose dimensions carry the logical ``axes``:
    one entry a dimension, ``None``, a mesh axis name or a tuple of names.
    A mesh axis appears at most once; a later duplicate is dropped (e.g.
    ``(experts, mlp)`` both mapped to ``model``)."""
    rules = rules if rules is not None else current_rules()
    if rules is None:
        return (None,) * len(axes)
    out = []
    used = set()
    for a in axes:
        m = rules.get(a) if a is not None else None
        if m is None:
            out.append(None)
            continue
        ms = (m,) if isinstance(m, str) else tuple(m)
        ms = tuple(x for x in ms if x not in used)
        used.update(ms)
        out.append(ms[0] if len(ms) == 1 else (ms if ms else None))
    return tuple(out)


def contiguous_strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (computed, not
    allocated: a DTensor's global metadata)."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Sequence, mesh) -> list:
    """One DTensor placement a dimension of ``mesh``: ``Shard(d)`` where
    the spec's dimension ``d`` names the mesh axis, else ``Replicate()``.
    A dimension over several mesh axes shards over each, the first named
    the major, which must be the mesh's order.  Spec axes that ``mesh``
    lacks (a sub-mesh) are left out."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        present = [a for a in _entry_axes(entry) if a in names]
        if [names.index(a) for a in present] != sorted(names.index(a) for a in present):
            raise ValueError(f"spec entry {entry} orders its mesh axes against the mesh's {names}")
        for a in present:
            out[names.index(a)] = Shard(d)
    return out


def _chunk(n: int, m: int, i: int) -> Tuple[int, int]:
    """(start, length) of part ``i`` of ``n`` rows split ``m`` ways as
    ``torch.chunk`` splits them (DTensor's uneven sharding)."""
    size = -(-n // m) if m else n
    start = min(i * size, n)
    return start, max(0, min(size, n - start))


def _local_slices(shape, spec, mesh, coord) -> list:
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    slices = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        start, length = 0, n
        for a in _entry_axes(entry):  # major axis first: each splits the part before it
            if a not in names:
                continue
            s, length = _chunk(length, int(sizes[a]), int(coord[names.index(a)]))
            start += s
        slices.append((start, length))
    return slices


def local_shape(shape, spec, mesh, coord=None) -> Tuple[int, ...]:
    """The shape of the shard at mesh coordinate ``coord`` (this rank's by
    default) of a tensor of ``shape`` laid out by ``spec``."""
    coord = mesh.get_coordinate() if coord is None else coord
    return tuple(length for _, length in _local_slices(shape, spec, mesh, coord))


def is_axes(x) -> bool:
    """A spec-tree leaf: a tuple of logical axis names (``None`` allowed)."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def _distribute(t: torch.Tensor, spec, mesh):
    from torch.distributed.tensor import DTensor

    local = t
    for d, (start, length) in enumerate(_local_slices(t.shape, spec, mesh, mesh.get_coordinate())):
        if length != t.shape[d]:
            local = local.narrow(d, start, length)
    if local is not t:
        local = local.contiguous()
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False, shape=t.shape,
                              stride=t.stride())


def distribute_params(params, specs, mesh, rules):
    """``params`` as DTensors on ``mesh``, each leaf placed by its logical
    axes in ``specs`` under ``rules`` (the JAX package's
    ``NamedSharding(mesh, logical_to_spec(axes, rules))`` a leaf).  Every
    rank holds the same full tree (drawn from one seed) and keeps its own
    slices of it: nothing is sent.  ``specs`` mirrors ``params``; a leaf's
    axes may be shorter than the tensor (a cache's host ``pos``), and then
    it is replicated."""
    flat_specs = pytree.tree_flatten(specs, is_leaf=is_axes)[0]
    leaves, treedef = pytree.tree_flatten(params)
    if len(flat_specs) != len(leaves):
        raise ValueError(f"{len(leaves)} parameters but {len(flat_specs)} specs")
    out = []
    for t, axes in zip(leaves, flat_specs):
        if not isinstance(t, torch.Tensor):
            out.append(t)
            continue
        spec = logical_to_spec(axes, rules) if len(axes) == t.dim() else (None,) * t.dim()
        out.append(_distribute(t, spec, mesh))
    return pytree.tree_unflatten(out, treedef)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Apply a logical sharding constraint: without rules, or on a plain
    tensor, ``x`` itself; on a DTensor, ``x`` redistributed to the
    placements the axes map to on its mesh (a partial sum reduced first).
    A redistribution that fails raises."""
    rules = current_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    assert len(axes) == x.ndim, (axes, x.shape)
    mesh = x.device_mesh
    target = placements(logical_to_spec(axes, rules), mesh)
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p for p in x.placements])
    if tuple(x.placements) == tuple(target):
        return x
    return x.redistribute(mesh, target)


def write_slot(buf: torch.Tensor, slot: int, value: torch.Tensor) -> None:
    """``buf[:, slot] = value``: a decode step's write into a cache buffer
    ``(B, n_slots, ...)``, in place.  On a DTensor cache the value is laid
    out as the buffer without its slot dimension, and the ranks whose shard
    holds the slot write it there (the others hold other slots)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(buf, DTensor):
        buf[:, slot] = value
        return
    mesh = buf.device_mesh
    target = [Shard(p.dim - (p.dim > 1)) if p.is_shard() and p.dim != 1 else Replicate() for p in buf.placements]
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if any(p.is_partial() for p in value.placements):
        value = value.redistribute(mesh, [Replicate() if p.is_partial() else p for p in value.placements])
    local = value.redistribute(mesh, target).to_local()
    start, length = shard_range(buf, 1)
    if start <= slot < start + length:
        with torch.no_grad():  # a cache write, never differentiated
            buf.to_local()[:, slot - start] = local


def shard_range(x, dim: int) -> Tuple[int, int]:
    """``(start, length)``: the rows of dimension ``dim`` of the DTensor
    ``x`` that this rank's shard holds."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    start, length = 0, x.shape[dim]
    for j, p in enumerate(x.placements):  # mesh dimensions in order: the major split first
        if p.is_shard(dim):
            s, length = _chunk(length, mesh.size(j), coord[j])
            start += s
    return start, length


def _letters(eq: str, ops) -> Tuple[list, str]:
    """The operands' and the output's subscripts of ``eq``, an ellipsis
    spelled out in capitals."""
    lhs, out = eq.replace(" ", "").split("->")
    ins = lhs.split(",")
    ell = ""
    for sub, o in zip(ins, ops):
        if "..." in sub:
            ell = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"[: o.dim() - (len(sub) - 3)]
    return [sub.replace("...", ell) for sub in ins], out.replace("...", ell)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *ops)``; on DTensors, one local ``torch.einsum``
    on each rank's shards.  Per mesh dimension one subscript among those the
    operands are sharded on is chosen: operands that hold it are laid out
    along it, the others replicated; the output is sharded along it, or a
    partial sum where it is contracted; a subscript that does not split
    evenly is not chosen, and a dimension of one rank replicates everything.
    The choice moves the fewest bytes:
    an operand sharded otherwise is re-laid out (all-gathered or
    all-to-all'ed), and a partial output is reduced later; ties go to the
    first operand's subscript.  DTensor's own einsum folds axes into
    ``bmm`` views that its older releases refuse on sharded axes, and this
    computes the same products on the same shards (one rank: the plain
    einsum)."""
    from torch.distributed.tensor import DTensor

    dts = [o for o in ops if isinstance(o, DTensor)]
    if not dts:
        return torch.einsum(eq, *ops)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = dts[0].device_mesh
    ops = [o if isinstance(o, DTensor) else DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim, run_check=False)
           for o in ops]
    ops = [o.redistribute(mesh, [Replicate() if p.is_partial() else p for p in o.placements])
           if any(p.is_partial() for p in o.placements) else o for o in ops]
    ins, out = _letters(eq, ops)
    sizes = {}
    for sub, o in zip(ins, ops):
        sizes.update(zip(sub, o.shape))
    nbytes = [o.numel() * o.element_size() for o in ops]
    out_bytes = math.prod(sizes[c] for c in out) * ops[0].element_size()

    def cost(j, c):
        moved = sum(n for sub, o, n in zip(ins, ops, nbytes)
                    if o.placements[j].is_shard() and sub[o.placements[j].dim] != c)
        return moved + (0 if c in out else out_bytes)

    want = [[Replicate()] * mesh.ndim for _ in ops]
    grads = [[Replicate()] * mesh.ndim for _ in ops]
    res = [Replicate()] * mesh.ndim
    for j in range(mesh.ndim):
        # a subscript that splits evenly over this mesh dimension (of one rank, none: all replicated)
        cands = [sub[o.placements[j].dim] for sub, o in zip(ins, ops) if o.placements[j].is_shard()]
        cands = [c for c in cands if mesh.size(j) > 1 and sizes[c] % mesh.size(j) == 0]
        if not cands:
            continue
        chosen = min(dict.fromkeys(cands), key=lambda c: cost(j, c))
        for i, sub in enumerate(ins):
            if chosen in sub:
                want[i][j] = grads[i][j] = Shard(sub.index(chosen))
            else:  # replicated here, and its gradient sums this rank's slice of `chosen`
                grads[i][j] = Partial()
        res[j] = Shard(out.index(chosen)) if chosen in out else Partial()
    locals_ = []
    for o, w, g in zip(ops, want, grads):
        if tuple(o.placements) != tuple(w):
            o = o.redistribute(mesh, w)
        locals_.append(o.to_local(grad_placements=g))
    shape = tuple(sizes[c] for c in out)
    return DTensor.from_local(torch.einsum(eq, *locals_), mesh, res, run_check=False, shape=shape,
                              stride=contiguous_strides(shape))


def on_rows(fn, x, *args):
    """``fn(x, *args)``: a function of a batch's rows.  On a mesh, where
    ``x`` is a DTensor laid out along its first (batch) dimension at most,
    the other tensors of ``args`` are made whole on every rank and ``fn``
    runs on the local tensors: each rank's rows alone, with the same
    operations as one device runs.  Its tensor outputs are DTensors laid
    out as ``x``, along their first dimension (``None`` passes)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(x, DTensor):
        return fn(x, *args)
    mesh = x.device_mesh
    if any(p.is_partial() or (p.is_shard() and p.dim != 0) for p in x.placements):
        raise ValueError(f"on_rows takes a tensor laid out along its rows only, not {x.placements}")
    rows = tuple(x.placements)
    # a whole parameter's gradient from this rank's rows is a partial sum over the rows' axes
    summed = [Partial() if p.is_shard() else Replicate() for p in rows]

    def local(t, along_rows):
        if not isinstance(t, DTensor):
            return t
        want = rows if along_rows else [Replicate()] * mesh.ndim
        if tuple(t.placements) != tuple(want):
            t = t.redistribute(mesh, want)
        return t.to_local() if along_rows else t.to_local(grad_placements=summed)

    # the first arguments that share x's rows (its caches) follow them; parameters are whole
    locals_ = [x.to_local()] + [local(a, isinstance(a, DTensor) and a.dim() > 0 and a.shape[0] == x.shape[0]
                                      and any(p.is_shard(0) for p in a.placements)) for a in args]
    outs = fn(*locals_)

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        shape = (x.shape[0],) + tuple(t.shape[1:])
        return DTensor.from_local(t, mesh, rows, run_check=False, shape=shape, stride=contiguous_strides(shape))

    return tuple(wrap(t) for t in outs)


def replicated(t):
    """``t`` whole on every rank (a DTensor all-gathered, a partial sum
    reduced); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    want = [Replicate()] * t.device_mesh.ndim
    return t if tuple(t.placements) == tuple(want) else t.redistribute(t.device_mesh, want)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: rows of an embedding table.  On a mesh, per mesh
    dimension: a table split along its rows (the vocab) has each rank look
    up the ids its slice holds, the rest zero, and the ranks' lookups are a
    partial sum; a table split along its columns keeps them split unless
    the ids are split there too (then the columns are gathered, as FSDP
    gathers a weight); the ids' own layout carries over.  Each rank indexes
    its local shard, so no sharding rule of DTensor's is needed."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not (isinstance(table, DTensor) or isinstance(ids, DTensor)):
        return table[ids]
    mesh = (table if isinstance(table, DTensor) else ids).device_mesh
    if not isinstance(table, DTensor):
        table = DTensor.from_local(table, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    ids = replicated(ids) if any(p.is_partial() for p in ids.placements) else ids
    k = ids.dim()
    t_want, i_want, grads, out = [], [], [], []
    for j in range(mesh.ndim):
        tp, ip = table.placements[j], ids.placements[j]
        if tp.is_shard(0):  # vocab rows split: every rank looks up every id in its slice
            t_want.append(tp), i_want.append(Replicate()), grads.append(tp), out.append(Partial())
        elif tp.is_shard(1) and not ip.is_shard():
            t_want.append(tp), i_want.append(ip), grads.append(tp), out.append(Shard(k))
        else:  # the table whole here; the output follows the ids, the table's gradient sums their rows
            t_want.append(Replicate()), i_want.append(ip)
            grads.append(Partial() if ip.is_shard() else Replicate())
            out.append(ip)
    if tuple(table.placements) != tuple(t_want):
        table = table.redistribute(mesh, t_want)
    if tuple(ids.placements) != tuple(i_want):
        ids = ids.redistribute(mesh, i_want)
    start, length = shard_range(table, 0)
    local_ids = ids.to_local().long()
    local = table.to_local(grad_placements=grads)
    if length == table.shape[0]:
        rows = local[local_ids]
    else:
        inside = (local_ids >= start) & (local_ids < start + length)
        rows = local[torch.where(inside, local_ids - start, 0)]
        rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    shape = tuple(ids.shape) + (table.shape[1],)
    return DTensor.from_local(rows, mesh, out, run_check=False, shape=shape, stride=contiguous_strides(shape))


def splits_evenly(x: torch.Tensor, dim: int, n: int) -> bool:
    """Whether dimension ``dim`` of ``x`` can be split into ``n`` major
    groups with its shards inside them: always for a plain tensor; for a
    DTensor, where ``n`` divides by the number of shards along ``dim``."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return True
    m = math.prod(x.device_mesh.size(j) for j, p in enumerate(x.placements) if p.is_shard(dim))
    return n % m == 0


def _divisible(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def cohort_rules(cfg, mesh_axis_sizes: Dict[str, int]) -> Dict[str, object]:
    """Tensor-parallel rules; the client axis splits over the data axes."""
    m = mesh_axis_sizes.get("model", 1)
    fsdp = tuple(a for a in ("pod", "data") if a in mesh_axis_sizes)
    return {
        "batch": fsdp,  # serving batch; during cohort training batch is per-client (unsharded)
        "client": fsdp,
        "seq": None,
        "cache_seq": None,
        "embed": None,
        "mlp_embed": None,  # d-dim of MLP weights (default: follows "embed")
        "act_embed": None,  # embed dim of *activations*
        "q_heads": "model" if _divisible(max(cfg.n_heads, 1), m) else None,
        "kv_heads": "model" if _divisible(max(cfg.n_kv_heads, 1), m) else None,
        "head_dim": None,
        "mlp": "model",
        "vocab": "model" if _divisible(cfg.vocab, m) else None,
        "experts": "model" if cfg.n_experts and _divisible(cfg.n_experts, m) else None,
        "expert_mlp": None,
        "lora": None,
        "ssm_inner": "model" if (cfg.ssm_expand * cfg.d_model) % (m * max(cfg.ssm_headdim, 1)) == 0 else None,
        "ssm_state": None,
        "layers": None,
        "patch": None,
        "enc_seq": None,
    }


def silo_rules(cfg, mesh_axis_sizes: Dict[str, int]) -> Dict[str, object]:
    """FSDP + TP rules for huge archs (one client occupies the whole mesh)."""
    fsdp = tuple(a for a in ("pod", "data") if a in mesh_axis_sizes)
    fsize = 1
    for a in fsdp:
        fsize *= mesh_axis_sizes[a]
    r = cohort_rules(cfg, mesh_axis_sizes)
    r.update(
        {
            "batch": fsdp,
            "embed": fsdp if _divisible(cfg.d_model, fsize) else None,
            "mlp_embed": fsdp if _divisible(cfg.d_model, fsize) else None,
            "expert_mlp": None,
        }
    )
    return r
