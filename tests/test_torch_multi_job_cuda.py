"""The multi-job engine on the card: the captured batched step equals J
independent ``job_step`` calls (the exact top-k kernel a row at k_max =
2000, the stable sort at 20,000), a captured step serves a config that
``slot_admit`` made, and ``run_service_compiled``'s captured horizon equals
its eager tick loop, bit for bit.

This file imports no JAX, so it runs where the card is:
``PYTHONPATH=src python -m pytest -q tests/test_torch_multi_job_cuda.py``.
Without a card every test skips (the batched step is held against JAX and
against its rows on the CPU in ``test_torch_multi_job.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as kn
from repro_torch.core.selection.sampling import gumbel_from_uniform
from repro_torch.engine import MultiJobConfig, make_multi_job, multi_job_init, pack_jobs, slot_admit
from repro_torch.engine.multi_job import job_generator
from repro_torch.launch import select_serve

LOGW_ATOL, P_ATOL = 1e-5, 1e-6  # the JAX package's batched-vs-single tolerances
TICKS, SEED = 3, 4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the batched step is captured as a CUDA graph")
    return torch.device("cuda")


def _fleet(K_max, dev):
    Ks, ks, fracs, etas = select_serve._heterogeneous_fleet(8, K_max, np.random.default_rng(SEED))
    return pack_jobs(Ks, ks, fracs, etas, K_max=K_max, device=dev)


@pytest.mark.parametrize("K_max", [100_000, 1_000_000])
def test_batched_step_equals_per_row_job_steps(cuda, K_max):
    cfg, k_max = _fleet(K_max, cuda)
    job_step, batched = make_multi_job(k_max)
    state = multi_job_init(cfg)
    J = cfg.active.shape[0]
    gens = [job_generator(SEED, j, cuda) for j in range(J)]
    xgen = torch.Generator(device=cuda).manual_seed(SEED)
    single = [(state.logw[j].clone(), state.t[j].clone()) for j in range(J)]
    for t in range(TICKS):
        gs = gumbel_from_uniform(torch.stack([torch.rand(K_max, generator=g, device=cuda) for g in gens]))
        xs = (torch.rand((J, K_max), generator=xgen, device=cuda) < 0.6).float()
        state, out = batched(cfg, state, gs, xs)
        for j in range(J):
            row = MultiJobConfig(*(v[j] for v in cfg))
            lw, tt, o = job_step(row, single[j][0], single[j][1], gs[j], xs[j])
            single[j] = (lw, tt)
            assert torch.equal(o["idx"], out["idx"][j]) and torch.equal(o["mask"], out["mask"][j]), (t, j)
            assert float((lw - state.logw[j]).abs().max()) <= LOGW_ATOL
            assert float((o["p"] - out["p"][j]).abs().max()) <= P_ATOL
    assert batched.graphs, "the batched step was not captured"
    per_replay = next(iter(batched.graphs.values()))[3]
    assert per_replay == ({"gumbel_topk": J} if k_max <= 2048 else {})


def test_captured_step_serves_an_admitted_slot(cuda):
    cfg, k_max = _fleet(100_000, cuda)
    _, batched = make_multi_job(k_max)
    J, K_max = cfg.active.shape
    gs = gumbel_from_uniform(torch.rand((J, K_max), generator=torch.Generator(device=cuda).manual_seed(1),
                                        device=cuda))
    xs = torch.ones((J, K_max), device=cuda)
    batched(cfg, multi_job_init(cfg), gs, xs)
    new = slot_admit(cfg, 3, 30_000, 600, 0.5, 0.4)
    kn.reset_launch_counts()
    state, out = batched(new, multi_job_init(new), gs, xs)
    assert len(batched.graphs) == 1, "a new config is data: no second capture"
    sel = out["idx"][3][out["idx"][3] >= 0]
    assert sel.numel() == 600 and int(sel.max()) < 30_000 and sel.unique().numel() == 600
    assert float(out["p"][3, 30_000:].abs().sum()) == 0.0 and float(state.logw[3, 30_000:].abs().sum()) == 0.0
    assert kn.launch_counts()["gumbel_topk"] == J


@pytest.mark.parametrize("staleness", [0, 2])
def test_service_horizon_captured_equals_eager_ticks(cuda, staleness):
    captured, _, ks = select_serve._service_horizon(8, 100_000, SEED, staleness, 0.5, 0.7, 0.5, 48, 8192, cuda)
    eager, _, _ = select_serve._service_horizon(8, 100_000, SEED, staleness, 0.5, 0.7, 0.5, 48, 8192, cuda)
    got = captured.run(TICKS)
    assert captured.graph is not None
    captured.reset()
    again = captured.run(TICKS)
    want = eager.run(TICKS, eager=True)
    for a, b, c in zip(got, again, want):
        for x, y, z in zip(*(torch.utils._pytree.tree_leaves(v) for v in (a, b, c))):
            assert torch.equal(x, z) and torch.equal(y, z)
    assert (got[2] <= torch.tensor(ks, device=cuda)).all()
