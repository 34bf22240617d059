"""The dry run: a deployment's per-device memory, FLOPs and collectives on
the production mesh, planned in one process, the port of
``repro.launch.dryrun``.

For every (architecture x input shape x mesh) this builds the step the
JAX package builds (the silo train step with its microbatches, the cohort
round over the data axes, prefill, decode) on a ``DeviceMesh`` of the
production shape over a ``"fake"`` process group, this process its rank 0:
parameters, optimizer state, batches and caches are ``meta`` tensors (shapes
and dtypes, no storage) placed as DTensors by the logical rules, so nothing
is allocated and no collective moves a byte; the E3CS selection over 1024
virtual clients runs on the host on real tensors.  The step then runs eagerly
under ``metrics.ProgramCounter``, which counts what rank 0 runs, in place
of XLA's analyses: FLOPs (``cost_analysis``), peak live bytes by category
(``memory_analysis``), bytes accessed, and the collectives' result bytes
(``hlo.collective_bytes``).  Eager PyTorch runs every layer and chunk, so
the counts cover the whole program (no ``corrected_metrics``).  The record
goes to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``; a failure
is recorded as ``status: "fail"`` with its error.

The roofline's rates are an H100's data-sheet peaks (``RATES``), not a
measurement: a step's compute, memory and collective times are its
per-device FLOPs, bytes accessed and collective bytes over them.

Usage (CPU, no card)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

``REPRO_DRYRUN_MESH=4x2`` (or ``2x2x2``) replaces the production mesh by a
small one (the tests); ``REPRO_DRYRUN_DEVICES``, when set, must equal the
mesh's size: the fake group has one rank a device.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ASSIGNED, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig

from .comms import count_ops
from .mesh import PRODUCTION_MESH, axis_sizes, make_mesh, make_production_mesh
from .metrics import ProgramCounter, attention_analytic, model_flops

__all__ = ["RATES", "MICRO", "WINDOW_LONG", "SKIPS", "serve_rules", "build_train_program", "build_serve_program",
           "run_program", "run_one", "main"]

# data-sheet peaks of one H100 SXM (80GB HBM3, 700 W): the roofline's rates
RATES = {
    "card": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700,
    "source": "data-sheet peaks, not measured",
    "peak_flops_bf16_dense": 989e12,  # FLOP/s
    "hbm_bytes_per_s": 3.35e12,
    # one 400 Gb/s NIC a card: the slowest hop of a 256-card mesh, which spans nodes
    "link_bytes_per_s": 50e9,
    "nvlink_bytes_per_s_each_way": 450e9,  # within a node of eight; recorded, not used in the bound
}

# grad-accumulation microbatch counts for silo-mapped archs (memory planning)
MICRO = {"llama3-405b": 8, "deepseek-v3-671b": 8, "qwen2-vl-72b": 4, "qwen3-moe-30b-a3b": 2}
WINDOW_LONG = 8192  # sliding window for attention-family long_500k serving

SKIPS = {
    ("whisper-base", "long_500k"): (
        "enc-dec with a 448-token-class decoder; a 500k text self-attention cache is architecturally meaningless"
    ),
}

_f32 = torch.float32


def serve_rules(cfg, sizes, kind: str):
    from repro_torch.models.sharding import cohort_rules, silo_rules

    base = silo_rules(cfg, sizes) if cfg.fl_mapping == "silo" else cohort_rules(cfg, sizes)
    if kind == "decode" and (base.get("kv_heads") is None or cfg.attn == "mla"):
        # kv heads can't shard over `model` -> shard the cache sequence instead
        base["cache_seq"] = "model"
        base["kv_heads"] = None
    return base


def _batch_axis(name: str) -> int:
    return 1 if name == "positions" else 0


# -------------------------------------------------------------- tensors --


def random_fill(shape, dtype, device, vocab):
    """A tensor of ``shape`` on ``device``: token ids below ``vocab``, else
    small normal draws (a program run for real)."""
    if not dtype.is_floating_point:
        return torch.randint(0, vocab, shape, dtype=dtype, device=device)
    return (torch.randn(shape, device=device) * 0.02).to(dtype)


def meta_fill(shape, dtype, device, vocab):
    """A ``meta`` tensor of ``shape``: shapes and dtypes, no storage (the
    plan's tensors)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _placed(shape, dtype, spec, mesh, fill):
    """A DTensor of global ``shape`` laid out by ``spec`` on ``mesh``; this
    rank's shard made by ``fill(local_shape, dtype)``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import contiguous_strides, local_shape, placements

    local = fill(local_shape(shape, spec, mesh), dtype)
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False, shape=tuple(shape),
                              stride=contiguous_strides(shape))


def _params(model, mesh, rules, fill):
    from repro_torch.models.sharding import is_axes, logical_to_spec

    shapes, specs = model.init(None, device="meta")
    flat_axes = pytree.tree_flatten(specs, is_leaf=is_axes)[0]
    leaves, tree = pytree.tree_flatten(shapes)
    return pytree.tree_unflatten(
        [_placed(t.shape, t.dtype, logical_to_spec(a, rules), mesh, fill) for t, a in zip(leaves, flat_axes)], tree)


def _batch(specs, rules, mesh, fill, lead=()):
    """The model inputs, the batch dimension of each over ``rules["batch"]``."""
    out = {}
    for name, s in specs.items():
        spec = [None] * (len(lead) + s.dim())
        spec[len(lead) + _batch_axis(name)] = rules.get("batch")
        out[name] = _placed(tuple(lead) + tuple(s.shape), s.dtype, tuple(spec), mesh, fill)
    return out


def _micro(v, axis: int, i: int, n: int):
    """Microbatch ``i`` of ``n`` of a batch DTensor: each rank takes that
    part of its own rows (JAX slices the global batch; on a batch sharded
    over the fsdp axes both give every device ``1 / n`` of its rows)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import contiguous_strides

    if n == 1:
        return v
    loc = v.to_local()
    m = loc.shape[axis] // n
    shape = list(v.shape)
    shape[axis] //= n
    return DTensor.from_local(loc.narrow(axis, i * m, m), v.device_mesh, v.placements, run_check=False,
                              shape=tuple(shape), stride=contiguous_strides(shape))


# ------------------------------------------------------------------ train --


def build_train_program(cfg: ModelConfig, shape: InputShape, mesh, fill=random_fill):
    """``(step, args, rules, held)``: the training step of ``cfg``'s FL
    mapping at ``shape`` on ``mesh``, its arguments (``fill`` makes each
    rank's shards) and the trees held before it, by memory category."""
    from repro_torch.models import build_model, input_specs
    from repro_torch.models.sharding import cohort_rules, silo_rules
    from repro_torch.optim import leafwise, sgd

    sizes = axis_sizes(mesh)
    fsdp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n_fsdp = math.prod(sizes[a] for a in fsdp_axes)
    model = build_model(cfg, impl="einsum")
    dev = torch.device("meta") if fill is meta_fill else torch.device(mesh.device_type)
    make = lambda s, dt: fill(s, dt, dev, cfg.vocab)  # noqa: E731

    if cfg.fl_mapping == "silo":
        rules = silo_rules(cfg, sizes)
        n_micro = MICRO.get(cfg.name, 1)
        opt = sgd(1e-2, 0.9)

        def train_step(params, opt_state, batch):
            acc = leafwise(lambda p: torch.zeros_like(p, dtype=_f32), params)
            losses = []
            for i in range(n_micro):  # JAX scans the microbatches
                sl = {k: _micro(v, _batch_axis(k), i, n_micro) for k, v in batch.items()}
                leaves, spec = pytree.tree_flatten(params)
                with torch.enable_grad():
                    diff = [t.detach().requires_grad_() for t in leaves]
                    loss, _ = model.loss(pytree.tree_unflatten(diff, spec), sl)
                    grads = pytree.tree_unflatten(list(torch.autograd.grad(loss, diff)), spec)
                acc = leafwise(lambda a, g: a + g.to(a.dtype), acc, grads)
                del grads
                losses.append(loss.detach())
            grads = leafwise(lambda g, p: (g / n_micro).to(p.dtype), acc, params)
            del acc
            new_params, new_opt = opt.update(params, grads, opt_state, 0)
            return new_params, new_opt, torch.stack(losses).mean()

        params = _params(model, mesh, rules, make)
        opt_state = pytree.tree_map(lambda p: torch.zeros_like(p), params)  # momentum mirrors params
        batch = _batch(input_specs(cfg, shape), rules, mesh, make)
        held = {"parameters": params, "optimizer": opt_state, "inputs": batch}
        return train_step, (params, opt_state, batch), rules, held

    # ---- cohort mapping: the full paper round in one program ----
    from repro_torch.configs import FLConfig
    from repro_torch.core.volatility import BernoulliVolatility
    from repro_torch.fl import init_server_state, make_cohort_round, make_select_fn
    from repro_torch.fl.round import RoundNoise

    rules = cohort_rules(cfg, sizes)
    rules["batch"] = None  # per-client batch lives inside a (pod,data) slice
    n_clients = n_fsdp  # one client per (pod, data) slice
    B_cl = max(1, shape.global_batch // n_clients)
    K_virtual = 1024
    k_sel = n_clients
    fl = FLConfig(K=K_virtual, k=k_sel, lr=1e-2, momentum=0.9, scheme="e3cs", eta=0.5, aggregation="fedavg")
    spmd = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    sigma = 0.5 * k_sel / K_virtual

    def quota(t):
        return torch.tensor(sigma, dtype=_f32, device=t.device)

    vol = BernoulliVolatility(torch.full((K_virtual,), 0.7, device=dev))
    _, round_fn = make_cohort_round(model, fl, quota, vol, None, spmd)
    # the selection reads K_virtual = 1024 weights: it runs on the host, on
    # real tensors (a plan's fake or meta tensors hold no values to rank)
    cpu = torch.device("cpu")
    select = make_select_fn(fl, quota)
    sel_state = init_server_state(None, K_virtual, None, device=cpu)

    def round_step(state, batches, g, u):
        idx, p, capped, sig = select(sel_state, RoundNoise(g=g))
        ones = torch.ones(k_sel, device=dev)
        return round_fn(state, idx.to(dev), p.to(dev), capped.to(dev), sig.to(dev), batches,
                        torch.ones((k_sel, 1), device=dev), ones, torch.tensor(float(K_virtual), device=dev), ones,
                        (u,))

    params = _params(model, mesh, rules, make)
    state = init_server_state(params, K_virtual, vol.init_state(), device=dev)
    base = input_specs(cfg, shape)
    batches = {}
    for name, s in base.items():
        per_client = (B_cl,) + tuple(s.shape[1:]) if _batch_axis(name) == 0 else \
            tuple(s.shape[:1]) + (B_cl,) + tuple(s.shape[2:])
        batches[name] = make((k_sel, 1) + per_client, s.dtype)  # every rank takes its client's rows
    g = -torch.log(-torch.log(torch.rand(K_virtual, generator=torch.Generator().manual_seed(0))))
    u = make((K_virtual,), _f32)
    held = {"parameters": params, "inputs": batches}
    return round_step, (state, batches, g, u), rules, held


# ------------------------------------------------------------------ serve --


def _cache_axes(cfg, cshapes):
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.transformer import cache_specs

    if cfg.family == "encdec":
        ax = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
        return {"self": attn_mod.KVCache(ax, ax, ("layers",)),
                "cross": (("layers", "batch", "enc_seq", "kv_heads", "head_dim"),) * 2}
    return cache_specs(cfg)


def build_serve_program(cfg: ModelConfig, shape: InputShape, mesh, fill=random_fill):
    """``(step, args, rules, held)`` of prefill or one decode step."""
    from repro_torch.models import build_model, input_specs
    from repro_torch.models.sharding import is_axes, logical_to_spec

    sizes = axis_sizes(mesh)
    kind = shape.kind
    window = WINDOW_LONG if (shape.name == "long_500k" and cfg.family != "ssm") else 0
    impl = "chunked" if (kind == "prefill" and shape.seq_len >= 8192) else "einsum"
    model = build_model(cfg, window=window, impl=impl)
    rules = serve_rules(cfg, sizes, kind)
    if shape.global_batch < 8:
        rules["batch"] = None  # batch=1 long-context decode: replicate batch
    dev = torch.device("meta") if fill is meta_fill else torch.device(mesh.device_type)
    make = lambda s, dt: fill(s, dt, dev, cfg.vocab)  # noqa: E731
    params = _params(model, mesh, rules, make)

    if kind == "prefill":
        batch = _batch(input_specs(cfg, shape, window=window), rules, mesh, make)

        def prefill_step(params, batch):
            logits, caches = model.prefill(params, batch, max_len=shape.seq_len)
            return logits[:, -1:], caches

        return prefill_step, (params, batch), rules, {"parameters": params, "inputs": batch}

    # ---- decode ----
    cshapes = model.init_caches(shape.global_batch, shape.seq_len, device="meta")
    leaves, tree = pytree.tree_flatten(cshapes)
    flat_axes = pytree.tree_flatten(_cache_axes(cfg, cshapes), is_leaf=is_axes)[0]
    assert len(leaves) == len(flat_axes), (len(leaves), len(flat_axes))
    zeros = lambda s, dt: torch.zeros(s, dtype=dt, device=dev)  # noqa: E731
    placed = []
    for t, a in zip(leaves, flat_axes):
        if not isinstance(t, torch.Tensor):
            placed.append(t)  # a cache's host pos
            continue
        spec = logical_to_spec(a, rules) if len(a) == t.dim() else (None,) * t.dim()
        placed.append(_placed(t.shape, t.dtype, spec, mesh, zeros))
    caches = pytree.tree_unflatten(placed, tree)
    caches = _set_pos(caches, shape.seq_len - 1)  # a cache filled to the shape's context
    tokens = _placed((shape.global_batch, 1), torch.int32, (rules.get("batch"), None), mesh, make)

    def decode_step(params, tokens, caches):
        return model.decode(params, tokens, caches)

    return decode_step, (params, tokens, caches), rules, {"parameters": params, "inputs": (tokens, caches)}


def _set_pos(caches, pos: int):
    """Every cache's host ``pos`` set to ``pos`` (a ring buffer's too)."""
    if isinstance(caches, dict):
        return {k: _set_pos(v, pos) for k, v in caches.items()}
    if hasattr(caches, "_fields") and "pos" in caches._fields:
        return caches._replace(pos=pos)
    return caches


# -------------------------------------------------------------------- run --


def run_program(step, args, rules, held, train: bool) -> Dict:
    """Run ``step(*args)`` once under ``ProgramCounter`` and ``rules``:
    the counter's summary, and the output."""
    from repro_torch.models.sharding import use_rules

    counter = ProgramCounter()
    for category, tree in held.items():
        counter.register(tree, category)
    with counter, use_rules(rules), torch.set_grad_enabled(train):
        out = step(*args)
    summary = counter.summary()
    summary["ops"] = count_ops(counter.ops)
    return summary, out


def _fake_group(n: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _mesh(mesh_kind: str):
    """The plan's mesh on a fresh ``"fake"`` group of one rank a device:
    the production mesh of ``mesh_kind``, or ``REPRO_DRYRUN_MESH``'s shape
    (e.g. ``4x2`` or ``2x2x2``, the tests') over the last of ``("pod",
    "data", "model")``."""
    override = os.environ.get("REPRO_DRYRUN_MESH")
    dims = tuple(int(x) for x in override.split("x")) if override else PRODUCTION_MESH[mesh_kind][0]
    n = math.prod(dims)
    want = os.environ.get("REPRO_DRYRUN_DEVICES")
    if want and int(want) != n:
        raise ValueError(f"REPRO_DRYRUN_DEVICES={want} but the mesh {dims} has {n} devices")
    _fake_group(n)
    if override:
        return make_mesh(dims, ("pod", "data", "model")[-len(dims):], device="cpu")
    return make_production_mesh(multi_pod=mesh_kind == "multi", device="cpu")


def run_one(arch: str, shape_name: str, mesh_kind: str, out_dir: str, skip_existing: bool = True) -> Dict:
    """Plan one (arch, shape, mesh) and write its record."""
    import torch.distributed as dist

    outfile = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    if skip_existing and os.path.exists(outfile):
        with open(outfile) as f:
            rec = json.load(f)
            if rec.get("status") in ("ok", "skipped"):
                return rec
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "ok", "writer": "repro_torch"}
    if (arch, shape_name) in SKIPS:
        rec.update(status="skipped", reason=SKIPS[(arch, shape_name)])
        _write(outfile, rec)
        return rec
    t0 = time.time()
    try:
        mesh = _mesh(mesh_kind)
        dims, n = tuple(mesh.mesh.shape), mesh.size()
        build = build_train_program if shape.kind == "train" else build_serve_program
        step, args, rules, held = build(cfg, shape, mesh, fill=meta_fill)
        t_build = time.time() - t0
        summary, _ = run_program(step, args, rules, held, train=shape.kind == "train")
        t_run = time.time() - t0 - t_build
        flops = summary["flops"]
        coll = summary["collectives"]
        terms = {
            "compute_s": flops / RATES["peak_flops_bf16_dense"],
            "memory_s": summary["bytes_accessed"] / RATES["hbm_bytes_per_s"],
            "collective_s": coll["total"] / RATES["link_bytes_per_s"],
        }
        terms["bottleneck"] = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k]).replace("_s", "")
        mf = model_flops(cfg, shape)
        memory = {k: int(v) for k, v in summary["peak_by_category"].items()}
        memory.update(peak_bytes=int(summary["peak_bytes"]), held_at_start=int(summary["held_at_start"]))
        rec.update(
            mesh_shape=list(dims),
            n_chips=n,
            build_s=round(t_build, 1),
            run_s=round(t_run, 1),
            memory=memory,
            flops_per_dev=flops,
            bytes_accessed_per_dev=summary["bytes_accessed"],
            bytes_accessed_note="each eager operation's input and output bytes, unfused: not comparable "
                                "with XLA's fused 'bytes accessed'",
            collectives=coll,
            ops=summary["ops"],
            n_ops=summary["n_ops"],
            roofline=terms,
            rates=RATES,
            model_flops=mf,
            useful_flops_ratio=(mf / (flops * n)) if flops else None,
            per_device_hbm_gb=round(summary["peak_bytes"] / 1e9, 3),
        )
        if shape.kind == "prefill" and shape.seq_len >= 8192:
            rec["attn_analytic"] = attention_analytic(cfg, shape, n)  # closed form beside the count
    except Exception as e:  # noqa: BLE001 -- every failure is recorded, never hidden
        frames = "".join(traceback.format_list([f for f in traceback.extract_tb(e.__traceback__)
                                                 if "repro_torch" in f.filename]))
        rec.update(status="fail", error=f"{type(e).__name__}: {e}", traceback=frames[-4000:])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    rec["elapsed_s"] = round(time.time() - t0, 1)
    _write(outfile, rec)
    return rec


def _write(path, rec):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--no-skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                rec = run_one(arch, shape, mk, args.out, skip_existing=not args.no_skip_existing)
                status = rec["status"]
                if status == "ok":
                    r = rec["roofline"]
                    extra = (
                        f"compute {r['compute_s']:.3e}s mem {r['memory_s']:.3e}s coll {r['collective_s']:.3e}s"
                        f" | {r['bottleneck']} | hbm/dev {rec['per_device_hbm_gb']}GB | run {rec['run_s']}s"
                    )
                elif status == "fail":
                    extra = rec["error"][:200]
                else:
                    extra = rec.get("reason", "")[:80]
                print(f"[{status:7s}] {arch:22s} {shape:12s} {mk:6s} {extra}", flush=True)


if __name__ == "__main__":
    main()
