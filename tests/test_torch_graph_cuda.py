"""The captured horizon on the card: ``RoundProgram.build_runner`` replays a
CUDA graph of the round step, and every replayed horizon equals the eager
loop of ``build_step`` + ``draw_noise`` bit for bit (outputs, state, rings,
generator state), dense and on a one-rank NCCL mesh, at K = 10^5 and the
ragged K = 1,000,003.

This file imports no JAX, so it runs where the card is:
``PYTHONPATH=src python -m pytest -q tests/test_torch_graph_cuda.py``.
Without a card every test skips (the plumbing around the graph, the static
buffers, is held on the CPU in ``test_torch_round_program.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch import kernels as kn
from repro_torch.configs import FLConfig
from repro_torch.engine import RoundProgram
from repro_torch.engine.sharded import N_ITERS
from repro_torch.launch import make_host_mesh
from repro_torch.obs import ROUND_TAPS, SketchSpec
from repro_torch.obs.sketches import lag_bins, sketch_carry0

KS = (100_000, 1_000_003)
k, T, SEED = 256, 6, 9


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the round step is captured as a CUDA graph")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mesh(cuda):
    """A one-rank NCCL mesh: the mesh's collectives captured in the graph."""
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_host_mesh(1)
    finally:
        dist.destroy_process_group()


def _fl(K, staleness=0):
    return FLConfig(K=K, k=k, rounds=T, scheme="e3cs", quota_frac=0.5, allocator="bisect",
                    staleness_rounds=staleness)


def _packed(K, override, device):
    rng = np.random.default_rng(3)
    if override == "packed":
        rows = np.packbits(rng.random((T, K)) < 0.6, axis=1, bitorder="little")
    else:
        codes = rng.choice(np.arange(4, dtype=np.uint8), (T, K), p=[0.5, 0.15, 0.1, 0.25])
        pad = (-K) % 4
        codes = np.pad(codes, ((0, 0), (0, pad)))
        rows = np.bitwise_or.reduce(codes.reshape(T, -1, 4) << np.array([0, 2, 4, 6], np.uint8), axis=2)
    return torch.from_numpy(rows).to(device)


def _eager(pm, carry, seed, xs=None, taps=False, n=T):
    """The hand loop: ``build_step`` + ``draw_noise`` from the seed's
    generator.  Returns ``(carry, stacked outputs, generator state)``."""
    step, _ = pm.build_step(taps=taps)
    gen = pm.generator(seed)
    outs = []
    for t in range(n):
        carry, out = step(carry, None if xs is None else xs[t], pm.draw_noise(gen))
        outs.append(out)
    stacked = [torch.stack(c) if torch.is_tensor(c[0]) else {n_: torch.stack([r[n_] for r in c]) for n_ in c[0]}
               for c in zip(*outs)]
    return carry, stacked, gen.get_state()


def _assert_same(got, want):
    a, b = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), f"leaf {i} differs"
        else:
            assert x == y, f"leaf {i} differs"


def _rings(pm):
    return () if pm.staleness is None else (pm.init_rings(),)


CASES = {
    "sync-fused": (0, dict(fused=True)),
    "async-late-fused": (2, dict(fused=True, feedback="late_credit")),
    "async-staged": (2, dict(fused=False)),
    "packed-staged": (0, dict(fused=False, override="packed")),
    "packed_lags-fused": (2, dict(fused=True, override="packed_lags")),
}


def _program(K, case, dev, mesh=None, **extra):
    S, opts = CASES[case]
    return RoundProgram.from_config(_fl(K, S), device=dev, mesh=mesh, **opts, **extra)


def _xs(pm, dev):
    return None if pm.override == "none" else pm.local_rows(_packed(pm.fl.K, pm.override, dev))


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("case", list(CASES))
def test_captured_horizon_equals_eager_loop(cuda, K, case):
    pm = _program(K, case, cuda)
    xs = _xs(pm, cuda)
    run, s0 = pm.build_runner(outputs="full", carry_key=True)
    rings = _rings(pm)
    first = run(s0, SEED, *rings, xs)
    assert run.horizon.graph is not None
    again = run(s0, SEED, *rings, xs)
    carry, outs, gstate = _eager(pm, (s0, *(tuple(r.clone() for r in rr) for rr in rings)), SEED, xs)
    want = (carry[0], gstate, *carry[1:], *outs)
    _assert_same(first, want)
    _assert_same(again, want)
    assert all(float(r.abs().sum()) == 0 for rr in rings for r in rr), "the runner changed the caller's rings"


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("case", ["sync-fused", "async-staged", "async-late-fused"])
def test_captured_mesh_horizon_equals_eager_loop(cuda, mesh, K, case):
    pm = _program(K, case, cuda, mesh=mesh, block=4)
    run, s0 = pm.build_runner(outputs="full", carry_key=True)
    rings = _rings(pm)
    got = run(s0, SEED, *rings)
    carry, outs, gstate = _eager(pm, (s0, *(tuple(r.clone() for r in rr) for rr in rings)), SEED)
    _assert_same(got, (carry[0], gstate, *carry[1:], *outs))


def test_two_runners_live_at_once(cuda, mesh):
    dense = _program(KS[0], "sync-fused", cuda)
    sharded = _program(KS[0], "async-late-fused", cuda, mesh=mesh, block=4)
    run_d, s0_d = dense.build_runner(outputs="full", carry_key=True)
    run_m, s0_m = sharded.build_runner(outputs="full", carry_key=True)
    rings = sharded.init_rings()
    got_d1, got_m1 = run_d(s0_d, 1), run_m(s0_m, 2, rings)
    got_d2, got_m2 = run_d(s0_d, 1), run_m(s0_m, 2, rings)
    cd, od, gd = _eager(dense, (s0_d,), 1)
    cm, om, gm = _eager(sharded, (s0_m, tuple(r.clone() for r in rings)), 2)
    for got in (got_d1, got_d2):
        _assert_same(got, (cd[0], gd, *od))
    for got in (got_m1, got_m2):
        _assert_same(got, (cm[0], gm, cm[1], *om))


def test_second_run_from_another_state(cuda):
    pm = _program(KS[0], "async-late-fused", cuda)
    run, s0 = pm.build_runner(outputs="full", carry_key=True)
    st1, key1, rings1, *_ = run(s0, SEED, pm.init_rings())
    st2, key2, rings2, *outs2 = run(st1, key1, rings1)  # a replay from the state the first call returned
    carry, outs, _ = _eager(pm, (s0, pm.init_rings()), SEED, n=T)
    step, _ = pm.build_step()
    gen = pm.generator(key1)
    ref, more = (st1, tuple(r.clone() for r in rings1)), []
    for _ in range(T):
        ref, out = step(ref, None, pm.draw_noise(gen))
        more.append(out)
    _assert_same((st2, key2, rings2, *outs2), (ref[0], gen.get_state(), ref[1], *(torch.stack(c) for c in zip(*more))))
    _assert_same((st1, rings1), (carry[0], carry[1]))


@pytest.mark.parametrize("taps", [False, True], ids=["plain", "taps"])
def test_chunked_carry_key_equals_one_shot(cuda, taps):
    pm = RoundProgram.from_config(dataclasses.replace(_fl(KS[0], 2), rounds=2 * T), fused=True, device=cuda,
                                  feedback="late_credit")
    one, s0 = pm.build_runner(outputs="full", carry_key=True, taps=taps)
    half, _ = pm.build_runner(outputs="full", carry_key=True, scan_length=T, taps=taps)
    tapc = (ROUND_TAPS.init_counters(cuda),) if taps else ()
    rings0 = pm.init_rings()
    st, _, _, *rest = one(s0, SEED, rings0, *tapc)
    st1, key, rings, *r1 = half(s0, SEED, rings0, *tapc)
    st2, _, _, *r2 = half(st1, key, rings, *r1[: len(tapc)])
    n_tap = len(tapc)
    outs, o1, o2 = rest[n_tap:], r1[n_tap:], r2[n_tap:]
    for a, b1, b2 in zip(outs, o1, o2):
        if isinstance(a, dict):
            for name in a:
                assert torch.equal(a[name], torch.cat([b1[name], b2[name]])), name
        else:
            assert torch.equal(a, torch.cat([b1, b2]))
    if taps:
        _assert_same(rest[0], r2[0])
    assert torch.equal(st.e3cs.logw, st2.e3cs.logw) and torch.equal(st.sel_counts, st2.sel_counts)


@pytest.mark.parametrize("case,mesh_run", [("sync-fused", False), ("packed-staged", False), ("sync-fused", True),
                                           ("async-staged", True)])
def test_launch_counts_count_replays(cuda, mesh, case, mesh_run):
    pm = _program(KS[0], case, cuda, mesh=mesh if mesh_run else None, block=4)
    xs = _xs(pm, cuda)
    run, s0 = pm.build_runner(outputs="lean")
    run(s0, SEED, xs)  # the capture: its launches are taken back, the warm-up's ran
    per = dict(run.horizon.per_replay)
    kn.reset_launch_counts()
    run(s0, SEED, xs)
    want = {}
    if pm.fused:
        want.update({"round_select.from_w": 1, "round_tail": 1})
    if pm.override == "packed" and not pm.fused:
        want["unpack_bits"] = 1
    if mesh_run:
        want["bisect_block_sums"] = -(-N_ITERS // 4)
    assert per == want
    assert {n: c for n, c in kn.launch_counts().items() if c} == {n: T * c for n, c in want.items()}


@pytest.mark.parametrize("mesh_run", [False, True], ids=["dense", "mesh"])
def test_taps_and_sketches_in_the_graph(cuda, mesh, mesh_run):
    spec = SketchSpec(window=2, n_regions=3)
    pm = RoundProgram.from_config(_fl(KS[0], 2), fused=True, device=cuda, mesh=mesh if mesh_run else None, block=1)
    run, s0 = pm.build_runner(outputs="full", taps=True, sketch=spec)
    plain, _ = pm.build_runner(outputs="full")
    st, *outs, payload = run(s0, SEED)
    st_plain, *outs_plain = plain(s0, SEED)
    _assert_same((st, *outs), (st_plain, *outs_plain))  # taps never touch the round
    sk_runner, _ = pm.build_runner(outputs="full", taps=True, sketch=spec)
    step = pm._step(False, True, spec)
    gen = pm.generator(SEED)
    carry = (s0, pm.init_rings(), ROUND_TAPS.init_counters(cuda), sketch_carry0(pm.K_loc, lag_bins(2), cuda))
    rows, sks = [], []
    for _ in range(T):
        carry, out = step(carry, None, pm.draw_noise(gen))
        rows.append(out[-2])
        sks.append(out[-1])
    series = {n: torch.stack([r[n] for r in rows]) for n in rows[0]}
    sketches = {n: torch.stack([r[n] for r in sks])[spec.window - 1 :: spec.window] for n in sks[0]}
    _assert_same(payload, {"series": series, "counters": carry[2], "sketches": sketches})
    _assert_same(sk_runner(s0, SEED)[-1], payload)
    assert torch.all(payload["series"]["selected"] == k)
    assert torch.all(payload["sketches"]["count_hist"].sum(1) == pm.fl.K)


SCHEME_CASES = [
    ("random", "plackett_luce", "bernoulli", False),
    ("fedcs", "plackett_luce", "bernoulli", False),
    ("pow_d", "plackett_luce", "bernoulli", False),
    ("ucb", "plackett_luce", "bernoulli", False),
    ("e3cs", "systematic", "bernoulli", False),
    ("e3cs", "plackett_luce", "markov", True),
    ("e3cs", "plackett_luce", "deadline", True),
    ("e3cs", "plackett_luce", "diurnal", True),
    ("e3cs", "plackett_luce", "regional_outage", True),
    ("e3cs", "plackett_luce", "flash_crowd", False),
]


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("scheme,sampler,volatility,fused", SCHEME_CASES,
                         ids=[f"{s}-{sm}-{v}" for s, sm, v, _ in SCHEME_CASES])
def test_every_scheme_and_scenario_captures_as_the_eager_loop(cuda, K, scheme, sampler, volatility, fused):
    """Permutations and uniforms drawn into static buffers, the exact top-k
    kernel of FedCS, UCB and the systematic sampler, and a scenario model's
    state (a flash crowd of ``2 * T`` rounds, its window inside the horizon)
    replay as the eager loop, bit for bit."""
    fl = FLConfig(K=K, k=k, rounds=2 * T, scheme=scheme, sampler=sampler, quota_frac=0.5, allocator="bisect",
                  volatility=volatility, pow_d=4 * k)
    pm = RoundProgram.from_config(fl, fused=fused, device=cuda)
    run, s0 = pm.build_runner(outputs="full", carry_key=True, scan_length=T)
    first, again = run(s0, SEED), run(s0, SEED)
    carry, outs, gstate = _eager(pm, (s0,), SEED)
    for got in (first, again):
        _assert_same(got, (carry[0], gstate, *outs))
    assert torch.all(outs[0].sum(1) == k)
    topk = scheme in ("fedcs", "ucb") or sampler == "systematic"
    assert run.horizon.per_replay.get("gumbel_topk", 0) == int(topk)


@pytest.mark.parametrize("n", [1_000, 1_000_003])
def test_systematic_cumsum_is_the_same_bits_every_call(cuda, n):
    """The blocked cumulative sum behind the systematic sampler: the same
    bits over 50 calls and a graph replay (PyTorch's 1-D CUDA cumsum is a
    single-pass scan whose partial sums combine in a varying order), within
    float32 rounding of the float64 sum."""
    from repro_torch.core.selection.sampling import _cumsum

    x = torch.rand(n, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    first = _cumsum(x)
    assert all(torch.equal(_cumsum(x), first) for _ in range(50))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _cumsum(x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)
    ref = torch.cumsum(x.double(), 0)
    # the worst case of the two-level sum: a rounding per add in a row (1024)
    # and per row of the prefix, each at most an ulp of the total
    ulp = 2.0 ** (np.floor(np.log2(float(ref[-1]))) - 23)
    assert float((first.double() - ref).abs().max()) <= (1024 + -(-n // 1024)) * ulp


MESH_CASES = [
    ("random", "bernoulli", False, 0),
    ("fedcs", "bernoulli", False, 0),
    ("pow_d", "bernoulli", False, 0),
    ("ucb", "bernoulli", False, 2),
    ("e3cs", "diurnal", True, 0),
    ("e3cs", "regional_outage", True, 0),
    ("e3cs", "flash_crowd", True, 0),
    ("e3cs", "flash_crowd", False, 2),
]


def _mesh_program(K, scheme, volatility, fused, S, dev, mesh=None, block=1):
    fl = FLConfig(K=K, k=k, rounds=2 * T, scheme=scheme, quota_frac=0.5, allocator="bisect", volatility=volatility,
                  pow_d=4 * k, staleness_rounds=S)
    return RoundProgram.from_config(fl, fused=fused, device=dev, mesh=mesh, block=block)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("scheme,volatility,fused,S", MESH_CASES, ids=[f"{s}-{v}-S{S}" for s, v, _, S in MESH_CASES])
def test_every_scheme_and_scenario_captures_on_the_mesh(cuda, mesh, K, scheme, volatility, fused, S):
    """The baselines (replicated selection, UCB's replicated state, pow-d's
    gathered loss cache) and the scenario models (a regional outage's chain
    from the shared stream) on the one-rank NCCL mesh: the captured horizon
    (``block=4``) replays as the eager loop, and at ``block=1`` the mesh
    equals the dense runner bit for bit."""
    pm = _mesh_program(K, scheme, volatility, fused, S, cuda, mesh=mesh, block=4)
    run, s0 = pm.build_runner(outputs="full", carry_key=True, scan_length=T)
    rings = _rings(pm)
    first, again = run(s0, SEED, *rings), run(s0, SEED, *rings)
    carry, outs, gstate = _eager(pm, (s0, *(tuple(r.clone() for r in rr) for rr in rings)), SEED)
    for got in (first, again):
        _assert_same(got, (carry[0], gstate, *carry[1:], *outs))
    assert torch.all(outs[0].sum(1) == k)
    runs = []
    for m in (None, mesh):
        run1, s1 = _mesh_program(K, scheme, volatility, fused, S, cuda, mesh=m).build_runner(outputs="full")
        runs.append(run1(s1, SEED))
    _assert_same(runs[1], runs[0])
