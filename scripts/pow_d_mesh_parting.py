"""Where pow-d's FL server on a one-rank mesh and the unsharded server part.

``python scripts/pow_d_mesh_parting.py`` on a card (``--device cpu --small``
rehearses it at a small size).  EMNIST at ``FLConfig``'s Table I, pow-d,
the servers' own draws (the JAX package's key schedule), as chip_smoke's
``[fl-pow-d-mesh]`` phase runs them.  Each part runs under cuDNN's default
algorithms (``mode=default``) and under ``deterministic=True``
(``mode=deterministic``); TF32 is off in both (``fp32_convs``).  Prints
``[pow-d-parting]`` lines:

* ``what=rounds``: for each of ``--rounds`` rounds, three servers run one
  round (``run(state, rounds=1)``) from the first unsharded server's state:
  the mesh server against it (``pair=mesh-plain``) and a second unsharded
  server against it (``pair=plain-plain``).  Per pair: selections equal,
  the loss cache's largest relative gap over the round's cohort (their
  local losses, written by the round's training) and over the other
  entries, and the parameters' largest absolute gap.
* ``what=steps``: round 0's cohort's local update (``make_local_update``,
  vmapped, as the round runs it) twice on the same inputs, stopped after
  ``n`` steps for growing ``n``: the first ``n`` whose parameters differ,
  and the step-0 gradients of the two calls equal or not.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def log(tag, **kw):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def rel_gap(a, b, sel):
    if not sel.any():
        return 0.0
    return float((np.abs(a[sel] - b[sel]) / np.maximum(np.abs(a[sel]), 1e-30)).max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--small", action="store_true", help="K=20, k=4, 40 samples a client (a CPU rehearsal)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from torch.func import grad_and_value, vmap
    from torch.utils import _pytree as pytree

    from repro_torch.configs import FLConfig
    from repro_torch.fl import FLServer
    from repro_torch.fl.client import make_local_update
    from repro_torch.launch import make_mesh
    from repro_torch.launch.train import build_task
    from repro_torch.models.cnn import fp32_convs
    from repro_torch.optim import sgd

    dev = torch.device(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels._build import load_library

        load_library()
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(), rank=0, world_size=1)
    small = dict(K=20, k=4, pow_d=8, samples_per_client=40, batch_size=10) if args.small else {}
    fl = FLConfig(scheme="pow_d", rounds=args.rounds, **small)
    mesh = make_mesh((1,), ("data",), device=dev)

    def place(state):
        return state._replace(params={n: distribute_tensor(t, mesh, [Replicate()]) for n, t in state.params.items()})

    def whole(state):
        return {n: v.full_tensor() if isinstance(v, DTensor) else v for n, v in state.params.items()}

    try:
        for mode in ("default", "deterministic"):
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=mode == "deterministic"):
                servers = {}
                for name in ("plain", "mesh", "plain2"):
                    model, store, _ = build_task("emnist", fl, device=dev)
                    servers[name] = FLServer(model, fl, store, spmd_axes="data" if name == "mesh" else None,
                                             device=dev)
                params0, _ = model.init(torch.Generator(device=dev).manual_seed(fl.seed))
                state = servers["plain"].init_state(params=params0)
                cohort0 = None
                for t in range(args.rounds):
                    got = {n: s.run(place(state) if n == "mesh" else state, rounds=1)[0] for n, s in servers.items()}
                    a = got["plain"]
                    trained = (a.sel_counts != state.sel_counts).cpu().numpy()
                    if cohort0 is None:
                        cohort0 = np.flatnonzero(trained)
                    ca = a.loss_cache.cpu().numpy()
                    wa = whole(a)
                    for name in ("mesh", "plain2"):
                        b = got[name]
                        cb = b.loss_cache.cpu().numpy()
                        wb = whole(b)
                        log("pow-d-parting", what="rounds", mode=mode, pair=f"{name.rstrip('2')}-plain", round=t,
                            sel_equal=torch.equal(a.sel_counts, b.sel_counts),
                            trained_max_rel=f"{rel_gap(ca, cb, trained):.3g}",
                            others_max_rel=f"{rel_gap(ca, cb, ~trained):.3g}",
                            trained_equal=bool((ca[trained] == cb[trained]).all()),
                            params_max_abs=f"{max(float((wa[n] - wb[n]).abs().max()) for n in wa):.3g}",
                            params_equal=all(torch.equal(wa[n], wb[n]) for n in wa))
                    state = a

                srv = servers["plain"]
                xb, yb, mask = srv.store.round_batches(cohort0, srv.epochs, fl.batch_size, srv.n_steps)
                x, y, step_mask = (torch.from_numpy(np.ascontiguousarray(v)).to(dev) for v in (xb, yb, mask))
                local = make_local_update(model, sgd(fl.lr, fl.momentum), fl.local_update, fl.prox_coef)
                N = step_mask.shape[1]
                cuts = sorted({n for n in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, N) if n <= N})
                first, gaps = None, {}
                with fp32_convs():
                    g = []
                    for _ in range(2):
                        loss_fn = lambda p, b: model.loss(p, b)[0]  # noqa: E731
                        grads, _ = vmap(grad_and_value(loss_fn), in_dims=(None, 0))(
                            params0, {"x": x[:, 0], "y": y[:, 0]})
                        g.append(grads)
                    grads_equal = all(torch.equal(g[0][n], g[1][n]) for n in g[0])
                    grad_gap = max(float((g[0][n] - g[1][n]).abs().max()) for n in g[0])
                    for n in cuts:
                        outs = [local(params0, {"x": x[:, :n], "y": y[:, :n]}, step_mask[:, :n]) for _ in range(2)]
                        pa, pb = (pytree.tree_leaves(o[0]) for o in outs)
                        gap = max(float((u - v).abs().max()) for u, v in zip(pa, pb))
                        gaps[n] = f"{gap:.3g}"
                        if first is None and gap > 0:
                            first = n
                log("pow-d-parting", what="steps", mode=mode, clients=len(cohort0), n_steps=N,
                    step0_grads_equal=grads_equal, step0_grad_max_abs=f"{grad_gap:.3g}",
                    first_step_parted=first, params_max_abs_by_steps=json.dumps(gaps))
                del servers, srv, model
    finally:
        dist.destroy_process_group()
    if dev.type == "cuda":
        os.system("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")


if __name__ == "__main__":
    main()
