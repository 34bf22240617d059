"""Federated *language-model* training with E3CS on the PyTorch/CUDA port
(``examples/fl_lm.py``'s run): each selected client owns a shard of a
heterogeneous token stream (a distinct bigram-mixture dialect) and runs
local SGD on a reduced StableLM-family decoder; the masked deadline
aggregation and the exponential-weight update are ``make_cohort_round``'s.

    PYTHONPATH=src python examples/torch_fl_lm.py --rounds 25               # on the card
    PYTHONPATH=src python examples/torch_fl_lm.py --rounds 5 --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import FLConfig, get_config, smoke_variant
from repro_torch.core import prng
from repro_torch.core.selection import make_quota_schedule
from repro_torch.core.volatility import BernoulliVolatility, paper_success_rates
from repro_torch.data import lm_client_batches, make_lm_dataset
from repro_torch.device import resolve_device
from repro_torch.engine import RoundProgram
from repro_torch.fl.round import init_server_state, make_cohort_round
from repro_torch.models import build_model


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--K", type=int, default=32)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--scheme", default="e3cs")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_variant(get_config("stablelm-1.6b"))
    model = build_model(cfg)
    fl = FLConfig(K=args.K, k=args.k, rounds=args.rounds, scheme=args.scheme, lr=5e-3)
    quota = make_quota_schedule("inc", fl.k, fl.K, fl.rounds, device=dev)
    rho = torch.as_tensor(paper_success_rates(fl.K), device=dev)
    vol = BernoulliVolatility(rho)
    select, round_fn = make_cohort_round(model, fl, quota, vol, rho)
    # the reference's keys: PRNGKey(1) carried on the device, split three
    # ways a round; the selection draws from k1 and the volatility row from
    # split(fold_in(k2, 1))[0], as the round function draws it
    program = RoundProgram.from_config(fl, device=dev)
    gen = program.generator(prng.PRNGKey(1, dev))

    stream = make_lm_dataset(cfg.vocab, 200_000, n_chains=args.K, seed=0)
    params, _ = model.init(prng.PRNGKey(0, dev))
    state = init_server_state(params, fl.K, vol.init_state(), dev)
    n_steps = 2
    ones = torch.ones(fl.k, device=dev)
    losses = []
    for t in range(fl.rounds):
        noise = program.draw_noise(gen, vol_path=(2, 1, (0, 2)))
        idx, p, capped, sigma = select(state, noise)
        blocks = lm_client_batches(stream, fl.K, idx.cpu().numpy(), n_steps, args.batch, args.seq, seed=t)
        tokens = torch.from_numpy(np.ascontiguousarray(blocks[..., :-1])).to(dev)
        state, metrics = round_fn(state, idx, p, capped, sigma, {"tokens": tokens, "labels": tokens},
                                  torch.ones(fl.k, n_steps, device=dev), ones,
                                  torch.tensor(float(fl.K), device=dev), ones, noise.u)
        losses.append(float(metrics["mean_local_loss"]))
        if t % 5 == 0 or t == fl.rounds - 1:
            print(f"round {t:3d}  local_loss={losses[-1]:.3f}  "
                  f"effective={int(metrics['n_success'])}/{fl.k}  CEP={int(metrics['cep'])}")
    counts = state.sel_counts.cpu().numpy().reshape(4, -1).sum(1).astype(int).tolist()
    print("selections by volatility class:", counts)
    return {"losses": losses, "class_counts": counts, "cep": float(state.cep), "rounds": int(state.t)}


if __name__ == "__main__":
    main()
