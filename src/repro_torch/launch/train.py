"""FL training launcher (the port of ``repro.launch.train``): trains the
paper's CNN global model across K volatile clients with the configured
selection scheme, end to end, on synthetic data of the dataset's shape::

    python -m repro_torch.launch.train --task emnist --scheme e3cs --quota inc \\
        --rounds 120 --out results/train/e3cs_inc.json

``--device`` is ``cuda`` by default; ``--device cpu`` runs on the CPU.
``--ckpt`` writes the final parameters and E3CS state through
``repro_torch.checkpoint.save``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.checkpoint import save
from repro_torch.configs import FLConfig, get_config
from repro_torch.core.prng import PRNGKey
from repro_torch.data import ClientStore, make_image_dataset, partition_iid, partition_primary_label
from repro_torch.device import resolve_device
from repro_torch.fl import FLServer
from repro_torch.models import build_model, cross_entropy

__all__ = ["TASKS", "build_task", "main"]

TASKS = {
    "emnist": dict(cfg="emnist-cnn", classes=26, img=(28, 28, 1)),
    "cifar": dict(cfg="cifar-cnn", classes=10, img=(32, 32, 3)),
}


def build_task(task: str, fl: FLConfig, device=None):
    """``(model, store, eval_fn)`` of a task: the JAX package's synthetic
    data and partition from ``fl.seed`` (the same arrays), the model, and
    ``eval_fn(params) -> (acc, loss)`` on 2000 test images on ``device``
    (``None``: CUDA, which raises without it)."""
    device = resolve_device(device)
    t = TASKS[task]
    cfg = get_config(t["cfg"])
    data = make_image_dataset(t["classes"], t["img"], n_train=fl.K * fl.samples_per_client // 2, n_test=4000,
                              seed=fl.seed)
    part = partition_primary_label if fl.non_iid else partition_iid
    idxs = part(data["y"], fl.K, fl.samples_per_client, seed=fl.seed)
    store = ClientStore(data, idxs, seed=fl.seed)
    model = build_model(cfg)
    x, y = store.eval_batch(2000)
    x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)

    def eval_fn(params):
        with torch.no_grad():
            logits = model.forward(params, {"x": x, "y": y})
        acc = float(torch.mean((torch.argmax(logits, -1) == y).to(torch.float32)))
        return acc, float(cross_entropy(logits, y))

    return model, store, eval_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--task", default="emnist", choices=list(TASKS))
    ap.add_argument("--scheme", default="e3cs")
    ap.add_argument("--quota", default="const")
    ap.add_argument("--quota-frac", type=float, default=0.5)
    ap.add_argument("--local-update", default="fedavg", choices=["fedavg", "fedprox"])
    ap.add_argument("--sampler", default="plackett_luce")
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--K", type=int, default=100)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--spc", type=int, default=80, help="samples per client")
    ap.add_argument("--batch", type=int, default=40)
    ap.add_argument("--epochs", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--volatility", default="bernoulli")
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    fl = FLConfig(
        K=args.K,
        k=args.k,
        rounds=args.rounds,
        scheme=args.scheme,
        quota=args.quota,
        quota_frac=args.quota_frac,
        sampler=args.sampler,
        local_update=args.local_update,
        local_epochs=tuple(args.epochs),
        batch_size=args.batch,
        samples_per_client=args.spc,
        non_iid=not args.iid,
        volatility=args.volatility,
        seed=args.seed,
    )
    model, store, eval_fn = build_task(args.task, fl, device=args.device)
    srv = FLServer(model, fl, store, eval_fn, device=args.device)
    state = srv.init_state(PRNGKey(fl.seed, srv.device))
    t0 = time.time()
    state, hist = srv.run(state, eval_every=args.eval_every)
    out = {
        "config": dataclasses.asdict(fl),
        "task": args.task,
        "device": str(srv.device),
        "history": hist,
        "cep": float(state.cep),
        "sel_counts": state.sel_counts.cpu().numpy().tolist(),
        "wall_s": round(time.time() - t0, 1),
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f)
    if args.ckpt:
        save(args.ckpt, {"params": state.params, "e3cs": state.e3cs}, step=args.rounds)
    print(json.dumps({k: out[k] for k in ("cep", "wall_s")} | {"final_acc": hist["acc"][-1] if hist["acc"] else None}))
    return out


if __name__ == "__main__":
    main()
