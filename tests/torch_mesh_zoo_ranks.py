"""The port's side of ``tests/test_torch_mesh_zoo.py``: what each spawned
gloo rank runs (``test_torch_mesh.spawn_groups``).  It imports no JAX: the
test hands every rank numpy inputs (JAX's parameters, batches and draws)
and holds what the ranks return against the JAX package.

Each function takes the rank's ``HostMesh`` (unused), the mesh's shape and
its inputs, builds the named ``DeviceMesh`` over the group, places the
parameters by the logical rules and returns numpy arrays, every DTensor
gathered whole (``full_tensor``)."""
import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

from repro_torch.configs import FLConfig, get_config, smoke_variant
from repro_torch.convert import lm_params_from_jax
from repro_torch.core.selection import make_quota_schedule
from repro_torch.core.volatility import BernoulliVolatility
from repro_torch.fl import init_server_state, make_cohort_round, make_silo_steps
from repro_torch.fl.round import RoundNoise
from repro_torch.launch import axis_sizes, make_mesh
from repro_torch.launch.dryrun import serve_rules
from repro_torch.models import build_model
from repro_torch.models.sharding import cohort_rules, distribute_params, silo_rules, use_rules

RULES = {"cohort": cohort_rules, "silo": silo_rules}


def axes_of(dims):
    return ("pod", "data", "model")[-len(dims):]


def smoke_cfg(arch):
    """The smoke config the test builds in JAX (the MoE dropless, as
    ``torch_zoo_common.configs``)."""
    cfg = smoke_variant(get_config(arch))
    return dataclasses.replace(cfg, capacity_factor=64.0) if cfg.family == "moe" else cfg


def whole(t):
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().float().numpy()


def flat(prefix, tree):
    """``{prefix/<key path>: numpy}`` of a tensor tree."""
    return {prefix + pytree.keystr(path): whole(t) for path, t in pytree.tree_leaves_with_path(tree)}


def _specs(model):
    return model.init(None, device="meta")[1]


def zoo_rank(_host, dims, archs, inputs, rule_names=("cohort", "silo"), steps=3):
    """Per arch and rule set: the loss and its gradients (every leaf), then
    a prefill and ``steps`` greedy decode steps under the serving rules,
    all on DTensor parameters."""
    mesh = make_mesh(dims, axes_of(dims), device="cpu")
    sizes = axis_sizes(mesh)
    out = {}
    for arch in archs:
        cfg = smoke_cfg(arch)
        model = build_model(cfg)
        specs = _specs(model)
        p = lm_params_from_jax(inputs[arch]["params"], "cpu")
        batch = {k: torch.from_numpy(np.array(v)) for k, v in inputs[arch]["batch"].items()}
        for rname in rule_names:
            rules = RULES[rname](cfg, sizes)
            dp = distribute_params(p, specs, mesh, rules)
            leaves, spec = pytree.tree_flatten(dp)
            diff = [t.detach().requires_grad_() for t in leaves]
            with use_rules(rules):
                loss, _ = model.loss(pytree.tree_unflatten(diff, spec), batch)
                grads = torch.autograd.grad(loss, diff)
            out[f"{arch}/{rname}/loss"] = whole(loss)
            out.update(flat(f"{arch}/{rname}/grads", pytree.tree_unflatten(list(grads), spec)))
        pbatch = {k: v for k, v in batch.items() if k != "labels"}
        with torch.no_grad():
            rules = serve_rules(cfg, sizes, "prefill")
            with use_rules(rules):
                logits, caches = model.prefill(distribute_params(p, specs, mesh, rules), pbatch)
            out[f"{arch}/prefill"] = whole(logits)
            rules = serve_rules(cfg, sizes, "decode")
            dp = distribute_params(p, specs, mesh, rules)
            tok = torch.argmax(whole_t(logits)[:, -1:], -1).to(torch.int32)
            toks = []
            for _ in range(steps):
                with use_rules(rules):
                    ld, caches = model.decode(dp, tok, caches)
                tok = torch.argmax(whole_t(ld)[:, -1:], -1).to(torch.int32)
                toks.append(tok.numpy())
            out[f"{arch}/tokens"] = np.stack(toks)
    return out


def whole_t(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def cohort_round_rank(_host, dims, arch, fl_kw, inputs, spmd_axes="data"):
    """``make_cohort_round(spmd_axes=...)`` over the smoke LM, given JAX's
    rounds: per round the selection's Gumbel row, the volatility row and the
    cohort's token blocks.  Returns the cohort, mask, log-weights, loss and
    the parameters after each round."""
    mesh = make_mesh(dims, axes_of(dims), device="cpu")
    cfg = smoke_cfg(arch)
    model = build_model(cfg)
    rules = cohort_rules(cfg, axis_sizes(mesh))
    fl = FLConfig(**fl_kw)
    rho = torch.from_numpy(inputs["rho"])
    vol = BernoulliVolatility(rho)
    select, round_fn = make_cohort_round(model, fl, make_quota_schedule("inc", fl.k, fl.K, fl.rounds, device="cpu"),
                                         vol, rho, spmd_axes)
    p = distribute_params(lm_params_from_jax(inputs["params"], "cpu"), _specs(model), mesh, rules)
    st = init_server_state(p, fl.K, vol.init_state(), device="cpu")
    out = {}
    for t, r in enumerate(inputs["rounds"]):
        idx, pr, capped, sigma = select(st, RoundNoise(g=torch.from_numpy(r["g"])))
        tok = torch.from_numpy(r["tokens"])
        n = tok.shape[1]
        with use_rules(rules):
            st, met = round_fn(st, idx, pr, capped, sigma, {"tokens": tok, "labels": tok}, torch.ones(fl.k, n),
                               torch.ones(fl.k), torch.tensor(float(fl.K)), torch.ones(fl.k),
                               (torch.from_numpy(r["u"]),))
        out[f"{t}/idx"] = idx.numpy()
        out[f"{t}/sel_counts"] = st.sel_counts.numpy()
        out[f"{t}/logw"] = st.e3cs.logw.numpy()
        out[f"{t}/loss"] = np.asarray(float(met["mean_local_loss"]))
        out[f"{t}/n_success"] = np.asarray(float(met["n_success"]))
        out.update(flat(f"{t}/params", st.params))
    return out


def silo_rank(_host, dims, arch, fl_kw, inputs):
    """``make_silo_steps`` under ``silo_rules`` (FSDP over the data axes,
    TP over ``model``): each client's local steps from the global
    parameters, the float32 accumulation of the weighted deltas and the
    update.  Returns the losses, each client's parameters and the update."""
    mesh = make_mesh(dims, axes_of(dims), device="cpu")
    cfg = smoke_cfg(arch)
    model = build_model(cfg)
    rules = silo_rules(cfg, axis_sizes(mesh))
    local, init, accum, apply = make_silo_steps(model, FLConfig(**fl_kw))
    p = distribute_params(lm_params_from_jax(inputs["params"], "cpu"), _specs(model), mesh, rules)
    acc = pytree.tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32), p)
    out = {}
    with use_rules(rules):
        for c, (w, batches) in enumerate(zip(inputs["weights"], inputs["batches"])):
            q, s = p, init(p)
            for i, b in enumerate(batches):
                q, s, loss = local(q, s, {k: torch.from_numpy(v) for k, v in b.items()}, i)
                out[f"{c}/{i}/loss"] = whole(loss)
            out.update(flat(f"{c}/params", q))
            acc = accum(acc, q, p, w)
        out.update(flat("new", apply(p, acc)))
    return out


def moe_rank(_host, dims, arch, cases, inputs):
    """The MoE layer alone at a capacity that drops choices, on DTensor
    parameters and a batch laid out along the data axes: per case
    (``{name: config overrides}``) and rule set, its output, balance loss
    and the gradients of ``sum(y * r) + aux`` for ``x`` and every
    parameter."""
    from repro_torch.models.layers import ParamBuilder
    from repro_torch.models.moe import moe_apply, moe_init

    mesh = make_mesh(dims, axes_of(dims), device="cpu")
    sizes = axis_sizes(mesh)
    params = {k: torch.from_numpy(v) for k, v in inputs["params"].items()}
    x, r = torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["r"])
    out = {}
    for case, over in cases.items():
        cfg = dataclasses.replace(smoke_variant(get_config(arch)), **over)
        pb = ParamBuilder(None, device="meta")
        moe_init(pb, cfg)
        names = sorted(params)
        for rname in ("cohort", "silo"):
            rules = RULES[rname](cfg, sizes)
            placed = distribute_params({"x": x, **params}, {"x": ("batch", None, "act_embed"), **pb.specs},
                                       mesh, rules)
            diff = [placed[k].detach().requires_grad_() for k in ["x"] + names]
            with use_rules(rules):
                y, aux = moe_apply(dict(zip(names, diff[1:])), diff[0], cfg)
                grads = torch.autograd.grad((y * r).sum() + aux, diff)
            out[f"{case}/{rname}/y"] = whole(y)
            out[f"{case}/{rname}/aux"] = whole(aux)
            out.update({f"{case}/{rname}/grad/{k}": whole(g) for k, g in zip(["x"] + names, grads)})
    return out


def start_groups(jobs):
    """``test_torch_mesh.spawn_groups`` in two halves: start every job's
    ranks now (the caller computes JAX's side meanwhile) and return the
    handles for ``join_groups``."""
    import multiprocessing
    import os

    from test_torch_mesh import _rank_main

    ctx = multiprocessing.get_context("spawn")
    groups = []
    for fn, D, out_dir, *args in jobs:
        os.makedirs(out_dir, exist_ok=True)
        procs = [ctx.Process(target=_rank_main, args=(fn, r, D, str(out_dir), tuple(args))) for r in range(D)]
        for p in procs:
            p.start()
        groups.append((procs, out_dir))
    return groups


def join_groups(groups, timeout):
    """Each job's ranks' returned arrays, in rank order (raises with the
    ranks' tracebacks if any failed)."""
    import os

    from test_torch_mesh import load_ranks

    for procs, _ in groups:
        for p in procs:
            p.join(timeout)
    results = []
    for procs, out_dir in groups:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errs = [open(os.path.join(out_dir, f)).read() for f in sorted(os.listdir(out_dir)) if f.endswith(".err")]
        assert all(p.exitcode == 0 for p in procs) and not errs, (
            f"ranks exited {[p.exitcode for p in procs]}:\n" + "\n".join(errs))
        results.append(load_ranks(out_dir, len(procs)))
    return results


def pow_d_server_rank(_host, D, fl_kw, inputs_path):
    """``FLServer(spmd_axes="data", scheme="pow_d")`` over the EMNIST CNN on
    a ``(data,) = (D,)`` mesh, its parameters replicated DTensors, given
    JAX's initial parameters, data and draws (``inputs_path``: a pickle,
    so that starting a rank sends no megabytes through its pipe).  Returns
    each round's cohort and the final counts, successes, loss cache and
    parameters."""
    import pickle
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.convert import cnn_params_from_jax, cnn_params_to_numpy
    from repro_torch.data import ClientStore
    from repro_torch.fl import FLServer

    mesh = make_mesh((D,), ("data",), device="cpu")
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    fl = FLConfig(**fl_kw)
    srv = FLServer(build_model(get_config("emnist-cnn")), fl, ClientStore(inputs["data"], inputs["idxs"]),
                   spmd_axes="data", device="cpu")
    params = {n: distribute_tensor(t, mesh, [Replicate()]) for n, t in
              cnn_params_from_jax(inputs["params"], "cpu").items()}
    cohorts = []
    select = srv._select
    srv._select = lambda s, n: (lambda out: (cohorts.append(out[0].numpy()), out)[1])(select(s, n))
    noise = [(RoundNoise(perm=torch.from_numpy(r["perm"]).long(), u=(torch.from_numpy(r["u"]),)),
              torch.from_numpy(r["cand"]).long()) for r in inputs["rounds"]]
    st, _ = srv.run(srv.init_state(params=params), noise=noise)
    out = {"cohorts": np.stack(cohorts), "sel_counts": st.sel_counts.numpy(), "cep": st.cep.numpy(),
           "loss_cache": st.loss_cache.numpy()}
    params = cnn_params_to_numpy({n: whole_t(t) for n, t in st.params.items()})
    out.update({f"params/{n}": v for n, v in params.items()})
    return out
