"""The port's K-sharded round on the CPU, over gloo process groups, without
JAX: a one-rank mesh in this process, and D = 2 and 4 ranks in spawned
processes (one process per rank, a ``FileStore`` under ``tmp_path``).

* a one-rank mesh with ``block=1`` equals the dense ``allocator="bisect"``
  runner bit for bit, and ``block=4`` selects the same cohorts;
* a chunked ``carry_key`` mesh horizon equals a one-shot one, also where
  both noise streams are drawn (a baseline's K-wide rows and a regional
  outage's chain row from the shared stream), and every rank holds the same
  shared-stream state after each chunk;
* at D > 1: the collectives, the distributed top-k (exact, ties included),
  the sharded allocator against the dense one, and the runner's invariants
  (k distinct clients a round, ``sum(p) = k``, fused == staged cohorts).

``run_cases`` and ``run_mesh_cases`` are also the port's side of
``test_torch_sharded.py`` and ``test_torch_sharded_baselines.py``, which
hold the mesh round against the JAX package; they live here so that the
spawned ranks import no JAX.
"""
import time

_T_MODULE = time.time()  # a spawned rank's clock: its start-up up to here is the spawn itself

import dataclasses  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import os  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

_T_TORCH = time.time()

from repro_torch.configs import FLConfig
from repro_torch.convert import gather_state, shard_arrays, state_from_jax
from repro_torch.core.selection import top_k
from repro_torch.core.volatility import CompletionLag, make_volatility, paper_success_rates
from repro_torch.engine import RoundNoise, RoundProgram
from repro_torch.core.selection import perturbed_scores
from repro_torch.engine import distributed_topk, plackett_luce_shmap, prob_alloc_shmap
from repro_torch.engine.sharded import _shard_topk_merge, masked_prob_alloc
from repro_torch.launch import make_host_mesh
from repro_torch.launch.mesh import EXCHANGE_MAX
from repro_torch.scenarios import make_scenario

_T_REPRO = time.time()
SPAWN_TIMEOUT = 120  # seconds for a group of spawned ranks to finish
ALLOC_RTOL = 1e-6  # a psum adds the ranks' tiled float32 sums in another order than one tiled sum


# ---------------------------------------------------------------------------
# spawned ranks
# ---------------------------------------------------------------------------


_CLOCK: dict = {}  # a spawned rank's case clock: its times file, the last lap and the laps so far


def _record(name: str, secs: float) -> None:
    _CLOCK["laps"][name] = secs
    with open(_CLOCK["path"], "a") as f:
        f.write(json.dumps({"case": name, "s": round(secs, 3)}) + "\n")


def lap(name: str) -> None:
    """In a spawned rank: the seconds since the rank's last lap, under
    ``name``.  Each lap is appended to ``rank<r>.times`` at once, so that a
    rank killed at the join limit shows how far it got, and the laps go into
    the rank's npz as ``time/<name>``.  Elsewhere (the test process) a
    no-op."""
    if not _CLOCK:
        return
    now = time.time()
    _record(name, now - _CLOCK["last"])
    _CLOCK["last"] = now


def _rank_main(fn, rank, D, out_dir, args, t_spawn=None):
    # fd 2 into rank<r>.stderr, and a fatal signal's Python stacks there: an
    # abort below Python (at teardown, say) raises nothing to write a .err
    fd = os.open(os.path.join(out_dir, f"rank{rank}.stderr"), os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 2)
    os.close(fd)
    faulthandler.enable(all_threads=True)
    torch.set_num_threads(1)
    # the start-up's parts: the spawn (a new interpreter, up to this module's
    # first line), import torch, import repro_torch, the case's own module
    # (unpickling ``fn``), then init_process_group
    _CLOCK.update(path=os.path.join(out_dir, f"rank{rank}.times"), laps={}, last=time.time())
    if t_spawn is not None:
        _record("spawn", _T_MODULE - t_spawn)
    _record("import torch", _T_TORCH - _T_MODULE)
    _record("import repro_torch", _T_REPRO - _T_TORCH)
    _record("import the case's module", _CLOCK["last"] - _T_REPRO)
    try:
        store = dist.FileStore(os.path.join(out_dir, "store"), D)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=D)
        lap("init_process_group")
        out = fn(make_host_mesh(D, device="cpu"), *args)
        out.update({f"time/{n}": np.array(s) for n, s in _CLOCK["laps"].items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _death(out_dir, rank, tail=4000):
    """What a rank that exited non-zero left: whether it had written its
    results (then it died at teardown, after its work) and the end of its
    stderr."""
    wrote = os.path.exists(os.path.join(out_dir, f"rank{rank}.npz"))
    path = os.path.join(out_dir, f"rank{rank}.stderr")
    err = open(path, errors="replace").read()[-tail:] if os.path.exists(path) else "(no stderr file)"
    when = "after writing its results (at teardown)" if wrote else "before writing its results"
    return f"rank {rank} died {when}; the end of its stderr:\n{err}"


def rank_times(out_dir, rank) -> str:
    """A spawned rank's seconds a case as far as it got (``lap``), one line."""
    path = os.path.join(out_dir, f"rank{rank}.times")
    if not os.path.exists(path):
        return f"rank {rank}: no times"
    laps = [json.loads(line) for line in open(path)]
    return f"rank {rank} ({sum(r['s'] for r in laps):.1f} s): " + ", ".join(f"{r['case']} {r['s']}" for r in laps)


def spawn_groups(jobs):
    """Run each job ``(fn, D, out_dir, *args)`` as ``fn(mesh, *args)`` on
    ``D`` spawned gloo ranks, all groups at once; returns, per job, the dicts
    of numpy arrays its ranks return, in rank order."""
    ctx = multiprocessing.get_context("spawn")
    groups = []
    for fn, D, out_dir, *args in jobs:
        os.makedirs(out_dir, exist_ok=True)
        t_spawn = time.time()
        procs = [ctx.Process(target=_rank_main, args=(fn, r, D, str(out_dir), tuple(args), t_spawn))
                 for r in range(D)]
        for p in procs:
            p.start()
        groups.append((procs, out_dir))
    for procs, _ in groups:
        for p in procs:
            p.join(SPAWN_TIMEOUT)
    results = []
    for procs, out_dir in groups:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errs = [open(os.path.join(out_dir, f)).read() for f in sorted(os.listdir(out_dir)) if f.endswith(".err")]
        died = [_death(out_dir, r) for r, p in enumerate(procs) if p.exitcode != 0]
        assert not died and not errs, (
            f"ranks exited {[p.exitcode for p in procs]} ({SPAWN_TIMEOUT} s to join; -9: killed at the limit); "
            "seconds a case:\n" + "\n".join([rank_times(out_dir, r) for r in range(len(procs))] + errs + died)
        )
        results.append(load_ranks(out_dir, len(procs)))
    return results


def load_ranks(out_dir, D):
    """The ``D`` ranks' returned arrays, in rank order, without their
    seconds a case (``time/<case>``, which the harness reports)."""
    return [{k: v for k, v in np.load(os.path.join(out_dir, f"rank{r}.npz")).items() if not k.startswith("time/")}
            for r in range(D)]


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo mesh in this process."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_host_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the port's side of the parity cases (test_torch_sharded.py)
# ---------------------------------------------------------------------------


def port_program(spec, mesh, fused):
    K, S = spec["K"], spec["staleness"]
    rho = paper_success_rates(K)
    vol = make_volatility("bernoulli", rho, device="cpu")
    if S is not None:
        vol = CompletionLag(vol, max_lag=S)
    fl = FLConfig(K=K, k=spec["k"], rounds=spec["T"], scheme="e3cs", quota_frac=0.5, allocator="bisect")
    return RoundProgram(
        fl=fl, vol=vol, rho=rho, override=spec["override"], staleness=S, alpha=0.5, feedback=spec["feedback"],
        mesh=mesh, block=spec["block"], fused=fused, device="cpu",
    )


def run_cases(mesh, specs, npz_path):
    """Each case's round step on this rank, fed its slab of the case's Gumbel
    rows (``<name>/gumbel``: ``(T, D, Ks)``) and trace rows (``<name>/xs``),
    fused and staged.  Returns this rank's output slabs and, gathered, the
    final ``K_pad``-wide state.  A case with ``resume`` starts from the
    ``K_pad``-wide state ``<name>/state/<field>``."""
    inputs = np.load(npz_path)
    out = {}
    for spec in specs:
        name = spec["name"]
        for fused in (True, False):
            tag = f"{name}/{'fused' if fused else 'staged'}"
            pm = port_program(spec, mesh, fused)
            step, state = pm.build_step()
            rings = pm.init_rings()
            if spec.get("resume"):
                prefix = f"{name}/state/"
                arrays = {n[len(prefix):]: inputs[n] for n in inputs.files if n.startswith(prefix)}
                state, rings = state_from_jax(shard_arrays(arrays, mesh.rank, mesh.size), device="cpu")
            carry = (state,) if pm.staleness is None else (state, rings)
            rows = pm.local_rows(inputs[f"{name}/xs"])
            gumbel = inputs[f"{name}/gumbel"]
            outs = []
            for t in range(spec["T"]):
                noise = RoundNoise(g=torch.from_numpy(np.ascontiguousarray(gumbel[t, mesh.rank])))
                carry, o = step(carry, rows[t], noise)
                outs.append(o)
            for field, col in zip(("mask", "x", "p", "sigma", "arrived"), zip(*outs)):
                out[f"{tag}/{field}"] = torch.stack(col).numpy()
            for field, a in gather_state(carry[0], carry[1] if len(carry) > 1 else (), mesh).items():
                out[f"{tag}/state/{field}"] = a
    return out


def mesh_case_program(spec, mesh, fused):
    """The port's program of a ``test_torch_sharded_baselines`` case: any
    scheme, over Bernoulli volatility (a dense trace's outcomes) or a
    registry scenario's model, sync or async."""
    K, S, T = spec["K"], spec["staleness"], spec["T"]
    if spec["scenario"] is None:
        rho = paper_success_rates(K)
        vol = make_volatility("bernoulli", rho, device="cpu")
    else:
        vol, rho = make_scenario(spec["scenario"], K, T, spec["seed"], device="cpu")
    if S is not None:
        vol = CompletionLag(vol, max_lag=S)
    fl = FLConfig(K=K, k=spec["k"], rounds=T, scheme=spec["scheme"], quota_frac=0.5, allocator="bisect",
                  pow_d=spec["pow_d"])
    return RoundProgram(fl=fl, vol=vol, rho=rho, override=spec["override"], staleness=S, alpha=0.5, mesh=mesh,
                        fused=fused, device="cpu")


def _rank_noise(inputs, name, t, d):
    """Round ``t``'s noise of rank ``d``: the npz holds ``<name>/g`` and
    ``<name>/u<i>`` as ``(T, D, n)`` per-rank rows, ``<name>/perm`` and
    ``<name>/v`` as ``(T, K)`` rows every rank takes whole."""
    noise = {}
    if f"{name}/g" in inputs.files:
        noise["g"] = torch.from_numpy(np.ascontiguousarray(inputs[f"{name}/g"][t, d]))
    if f"{name}/perm" in inputs.files:
        noise["perm"] = torch.from_numpy(inputs[f"{name}/perm"][t]).long()
    if f"{name}/v" in inputs.files:
        noise["v"] = torch.from_numpy(inputs[f"{name}/v"][t])
    n_u = sum(1 for f in inputs.files if f.startswith(f"{name}/u"))
    noise["u"] = tuple(torch.from_numpy(np.ascontiguousarray(inputs[f"{name}/u{i}"][t, d])) for i in range(n_u))
    return RoundNoise(**noise)


def run_mesh_cases(mesh, specs, npz_path):
    """Each case's round step on this rank, fed its noise (``_rank_noise``)
    and, for a dense trace, its slab of ``<name>/xs``; E3CS fused and
    staged, a baseline staged.  Returns this rank's output slabs and the
    final state gathered (``gather_state``).  A case with ``runner`` also
    runs the mesh runner from its own streams and returns its final model
    state (``<name>/runner/vol_state``)."""
    inputs = np.load(npz_path)
    out = {}
    for spec in specs:
        name = spec["name"]
        for fused in (True, False) if spec["scheme"] == "e3cs" else (False,):
            tag = f"{name}/{'fused' if fused else 'staged'}"
            pm = mesh_case_program(spec, mesh, fused)
            step, state = pm.build_step()
            carry = (state,) if pm.staleness is None else (state, pm.init_rings())
            rows = pm.local_rows(inputs[f"{name}/xs"]) if spec["override"] == "dense" else None
            outs = []
            for t in range(spec["T"]):
                carry, o = step(carry, None if rows is None else rows[t], _rank_noise(inputs, name, t, mesh.rank))
                outs.append(o)
            for field, col in zip(("mask", "x", "p", "sigma", "arrived"), zip(*outs)):
                out[f"{tag}/{field}"] = torch.stack(col).numpy()
            for field, a in gather_state(carry[0], carry[1] if len(carry) > 1 else (), mesh).items():
                if isinstance(a, tuple):
                    out.update({f"{tag}/state/{field}{i}": v for i, v in enumerate(a)})
                else:
                    out[f"{tag}/state/{field}"] = a
        if spec.get("runner"):
            run, s0 = mesh_case_program(spec, mesh, False).build_runner()
            vs = run(s0, spec["seed"])[0].vol_state
            out[f"{name}/runner/vol_state"] = vs.numpy()
    return out


def surface_inputs(D):
    """The inputs of ``test_torch_sharded_baselines``'s public-surface test:
    1001 weights, scores with ties within and across ranks, an allocation,
    and each rank's Gumbel slab."""
    rng = np.random.default_rng(21)
    K = 1001
    Ks = -(-K // D)
    w = rng.gamma(0.3, 1.0, K).astype(np.float32)
    scores = np.round(rng.normal(size=K), 1).astype(np.float32)
    p = rng.uniform(0.01, 1.0, K).astype(np.float32)
    g_rows = rng.gumbel(size=(D, Ks)).astype(np.float32)
    return w, scores, p, g_rows


def surface_on_rank(mesh, D):
    """``prob_alloc_shmap``, ``distributed_topk`` and ``plackett_luce_shmap``
    on this rank, at k = 40."""
    w, scores, p, g_rows = surface_inputs(D)
    pt, ct = prob_alloc_shmap(torch.from_numpy(w), 40, 0.01, mesh)
    return {"p": pt.numpy(), "capped": ct.numpy(),
            "topk": distributed_topk(torch.from_numpy(scores), 40, mesh).numpy(),
            "pl": plackett_luce_shmap(torch.from_numpy(g_rows[mesh.rank]), torch.from_numpy(p), 40, mesh).numpy()}


def sharded_baselines_rank(mesh, specs, npz_path):
    """Everything ``test_torch_sharded_baselines`` reads from one rank: its
    ``run_mesh_cases`` and, under ``surface/``, its ``surface_on_rank``."""
    out = run_mesh_cases(mesh, specs, npz_path)
    out.update({f"surface/{n}": v for n, v in surface_on_rank(mesh, mesh.size).items()})
    return out


# ---------------------------------------------------------------------------
# one rank, in this process
# ---------------------------------------------------------------------------

K, k, T = 256, 16, 20


def _fl(staleness=0, K=K):
    return FLConfig(K=K, k=k, rounds=T, scheme="e3cs", quota_frac=0.5, allocator="bisect",
                    staleness_rounds=staleness)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
@pytest.mark.parametrize("staleness,feedback", [(0, "deadline"), (2, "late_credit")], ids=["sync", "async_late"])
def test_mesh1_block1_equals_dense(mesh1, staleness, feedback, fused):
    runs = []
    for mesh in (None, mesh1):
        pm = RoundProgram.from_config(_fl(staleness), mesh=mesh, fused=fused, feedback=feedback, device="cpu")
        run, s0 = pm.build_runner(outputs="full")
        runs.append(run(s0, 11))
    (sd, *od), (sm, *om) = runs
    for a, b in zip(od, om):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(sd.e3cs.logw, sm.e3cs.logw, rtol=0, atol=0)
    torch.testing.assert_close(sd.sel_counts, sm.sel_counts, rtol=0, atol=0)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_mesh1_block4_selects_like_block1(mesh1, fused):
    """Dyadic blocks reach the same bracket as halvings, up to roundoff in
    the grid points: the same cohorts, ``p`` within ``P_RTOL``."""
    P_RTOL = 1e-5
    outs = [
        RoundProgram.from_config(_fl(), mesh=mesh1, fused=fused, block=b, device="cpu").build_runner()[0]
        for b in (1, 4)
    ]
    s0 = RoundProgram.from_config(_fl(), mesh=mesh1, device="cpu").build_step()[1]
    (_, m1, _, p1, _), (_, m4, _, p4, _) = (run(s0, 4) for run in outs)
    torch.testing.assert_close(m1, m4, rtol=0, atol=0)
    torch.testing.assert_close(p1, p4, rtol=P_RTOL, atol=0)


def _chunked_vs_one_shot(mesh, staleness, block):
    """Two carry_key chunks against one horizon: ``(one-shot outs, chunked
    outs, one-shot logw, chunked logw)`` as numpy."""
    feedback = "deadline" if staleness == 0 else "late_credit"
    pm = RoundProgram.from_config(_fl(staleness), mesh=mesh, fused=True, feedback=feedback, block=block,
                                  device="cpu")
    one, s0 = pm.build_runner(outputs="full", carry_key=True)
    half, _ = pm.build_runner(outputs="full", carry_key=True, scan_length=T // 2)
    if staleness == 0:
        st, _, *outs = one(s0, 5)
        st1, key, *o1 = half(s0, 5)
        st2, _, *o2 = half(st1, key)
    else:
        rings0 = pm.init_rings()
        st, _, _, *outs = one(s0, 5, rings0)
        st1, key, rings, *o1 = half(s0, 5, rings0)
        st2, _, _, *o2 = half(st1, key, rings)
    chunked = [torch.cat([a, b]).numpy() for a, b in zip(o1, o2)]
    return [o.numpy() for o in outs], chunked, st.e3cs.logw.numpy(), st2.e3cs.logw.numpy()


# carry_key cases that draw from the shared stream: (scheme, scenario or None
# for Bernoulli volatility)
STREAM_CASES = {"random": ("random", None), "fedcs": ("fedcs", None),
                "e3cs-regional_outage": ("e3cs", "regional_outage")}


def _streams_chunked_vs_one_shot(mesh, scheme, scenario):
    """A ``carry_key`` runner's two chunks against one shot, on a case that
    draws from both streams.  ``one/*`` and ``two/*`` are the one-shot's and
    the chunks' outputs, final state and final (own, shared) stream states;
    ``after1/*`` the stream states after the first chunk."""
    if scenario is None:
        rho = paper_success_rates(K)
        vol = make_volatility("bernoulli", rho, device="cpu")
    else:
        vol, rho = make_scenario(scenario, K, T, 3, device="cpu")
    fl = FLConfig(K=K, k=k, rounds=T, scheme=scheme, quota_frac=0.5, allocator="bisect")
    pm = RoundProgram(fl=fl, vol=vol, rho=rho, mesh=mesh, fused=scheme == "e3cs", device="cpu")
    one, s0 = pm.build_runner(outputs="full", carry_key=True)
    half, _ = pm.build_runner(outputs="full", carry_key=True, scan_length=T // 2)
    st, key, *outs = one(s0, 5)
    st1, key1, *o1 = half(s0, 5)
    st2, key2, *o2 = half(st1, key1)
    out = {}
    for i, (a, b1, b2) in enumerate(zip(outs, o1, o2)):
        out[f"one/out{i}"], out[f"two/out{i}"] = a.numpy(), torch.cat([b1, b2]).numpy()
    for i, (a, b) in enumerate(zip(pytree.tree_leaves(st), pytree.tree_leaves(st2))):
        out[f"one/state{i}"], out[f"two/state{i}"] = np.asarray(a), np.asarray(b)
    out["one/vol_state"], out["two/vol_state"] = (np.asarray(v) for v in (st.vol_state, st2.vol_state))
    for tag, (own, shared) in (("one", key), ("two", key2), ("after1", key1)):
        out[f"{tag}/own"], out[f"{tag}/shared"] = own.numpy(), shared.numpy()
    return out


@pytest.mark.parametrize("staleness", [0, 2], ids=["sync", "async"])
def test_mesh1_carry_key_chunks_equal_one_shot(mesh1, staleness):
    outs, chunked, logw, logw2 = _chunked_vs_one_shot(mesh1, staleness, block=4)
    for a, b in zip(outs, chunked):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(logw, logw2)


def test_mesh_packed_rows_are_cut_per_rank(mesh1):
    pm = RoundProgram.from_config(_fl(K=250), mesh=mesh1, override="packed", device="cpu")
    assert pm.K_loc == 256 and pm.local_rows(np.ones((3, 32), np.uint8)).shape == (3, 32)
    with pytest.raises(ValueError, match="shard width"):
        RoundProgram.from_config(dataclasses.replace(_fl(), k=300), mesh=mesh1, device="cpu")


def test_make_host_mesh_wants_a_group_of_its_size(mesh1):
    with pytest.raises(ValueError, match="whole process group"):
        make_host_mesh(2, device="cpu")


def test_make_host_mesh_wants_a_started_group(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="started process group"):
        make_host_mesh(1, device="cpu")


# ---------------------------------------------------------------------------
# D > 1, in spawned ranks
# ---------------------------------------------------------------------------


def _topk_inputs():
    """90 scores rounded to one decimal (many ties), and a Plackett-Luce
    draw's Gumbel row and allocation, each padded to 96 clients."""
    rng = np.random.default_rng(17)
    scores = np.round(rng.normal(size=90), 1).astype(np.float32)
    return scores, rng.gumbel(size=96).astype(np.float32), rng.uniform(0.05, 1.0, 96).astype(np.float32)


def _alloc_weights():
    return np.random.default_rng(18).gamma(0.3, 1.0, 1000).astype(np.float32)


def mesh_suite(mesh):
    """Everything the D > 1 tests below read, computed on one rank."""
    d, D = mesh.rank, mesh.size
    out = {
        "psum": mesh.psum(torch.tensor([float(d), 1.0])).numpy(),
        "pmax": mesh.pmax(torch.tensor(float(-d))).numpy(),
        "gather": mesh.all_gather(torch.arange(3, dtype=torch.int32) + 10 * d).numpy(),
    }
    # the small collectives' one all_to_all round against gloo's own ring, bit
    # for bit: values of many scales, so that another order of the sum shows
    same = []
    for m in (1, 2, 3, 4, 15, 16, 17, 100, EXCHANGE_MAX):
        for dtype in (torch.float32, torch.float64, torch.int64):
            g = torch.Generator().manual_seed(1000 * d + m)
            if dtype.is_floating_point:
                x = (torch.randn(m, generator=g, dtype=torch.float64)
                     * 10.0 ** torch.randint(-6, 6, (m,), generator=g)).to(dtype)
            else:
                x = torch.randint(-10**6, 10**6, (m,), generator=g)
            want, gathered = x.clone(), x.new_empty(D * m)
            dist.all_reduce(want)
            dist.all_gather_into_tensor(gathered, x)
            same.append(torch.equal(mesh.psum(x).view(torch.uint8), want.view(torch.uint8))
                        and torch.equal(mesh.all_gather(x).view(torch.uint8), gathered.view(torch.uint8)))
    out["exchange_same"] = np.array(same)
    # distributed top-k: 90 scores with ties, padded with -inf to 96
    scores, g, p = _topk_inputs()
    Kp = 96
    full = np.concatenate([scores, np.full(Kp - 90, -np.inf, np.float32)])
    Ks = Kp // D
    loc = torch.from_numpy(full[d * Ks:(d + 1) * Ks])
    out["topk"] = _shard_topk_merge(loc, 12, mesh).numpy()
    # a Plackett-Luce draw: log p perturbed by the rank's Gumbel slab, padding at -inf
    pl_scores = perturbed_scores(torch.from_numpy(g[d * Ks:(d + 1) * Ks]), torch.from_numpy(p[d * Ks:(d + 1) * Ks]))
    pl_scores = torch.where(torch.arange(d * Ks, (d + 1) * Ks) < 90, pl_scores, torch.tensor(float("-inf")))
    out["pl"] = _shard_topk_merge(pl_scores, 12, mesh).numpy()
    # the sharded allocator over a ragged population
    w = _alloc_weights()
    Kp = D * -(-1000 // D)
    Ks = Kp // D
    wp = np.concatenate([w, np.zeros(Kp - 1000, np.float32)])
    act = (np.arange(Kp) < 1000).astype(np.float32)
    for block in (1, 4):
        pl, cl = masked_prob_alloc(torch.from_numpy(wp[d * Ks:(d + 1) * Ks]), 100, 0.025, mesh=mesh,
                                   active=torch.from_numpy(act[d * Ks:(d + 1) * Ks]), block=block)
        out[f"alloc{block}/p"], out[f"alloc{block}/capped"] = pl.numpy(), cl.numpy()
    # runners: fused and staged, sync and async, block 4
    for staleness in (0, 2):
        for fused in (True, False):
            fb = "deadline" if staleness == 0 else "late_credit"
            pm = RoundProgram.from_config(_fl(staleness, K=250), mesh=mesh, fused=fused, feedback=fb, block=4,
                                          device="cpu")
            run, s0 = pm.build_runner(outputs="full")
            st, masks, _, ps, sigmas, *_ = run(s0, 9)
            tag = f"run{staleness}/{'fused' if fused else 'staged'}"
            out[f"{tag}/mask"], out[f"{tag}/p"], out[f"{tag}/sigma"] = masks.numpy(), ps.numpy(), sigmas.numpy()
            out[f"{tag}/logw"] = st.e3cs.logw.numpy()
    for case, (scheme, scenario) in STREAM_CASES.items():
        out.update({f"streams/{case}/{n}": v for n, v in _streams_chunked_vs_one_shot(mesh, scheme, scenario).items()})
    if D == 2:
        for staleness in (0, 2):
            outs, chunked, logw, logw2 = _chunked_vs_one_shot(mesh, staleness, block=1)
            for i, (a, b) in enumerate(zip(outs, chunked)):
                out[f"chunk{staleness}/one/{i}"], out[f"chunk{staleness}/two/{i}"] = a, b
            out[f"chunk{staleness}/one/logw"], out[f"chunk{staleness}/two/logw"] = logw, logw2
    return out


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    Ds = (2, 4)
    return dict(zip(Ds, spawn_groups([(mesh_suite, D, tmp_path_factory.mktemp(f"mesh{D}")) for D in Ds])))


@pytest.mark.parametrize("D", [2, 4])
def test_collectives(suite, D):
    for d, r in enumerate(suite[D]):
        np.testing.assert_array_equal(r["psum"], [sum(range(D)), D])
        assert float(r["pmax"]) == 0.0
        np.testing.assert_array_equal(r["gather"], np.concatenate([np.arange(3) + 10 * j for j in range(D)]))


@pytest.mark.parametrize("D", [2, 4])
def test_small_collectives_equal_gloos_own_bit_for_bit(suite, D):
    """``psum`` and ``all_gather`` of up to ``EXCHANGE_MAX`` host elements go
    through one ``all_to_all`` round and add in the ring's order: every
    rank's results equal ``all_reduce``'s and ``all_gather_into_tensor``'s."""
    for r in suite[D]:
        assert r["exchange_same"].size == 27 and r["exchange_same"].all()


@pytest.mark.parametrize("D", [2, 4])
def test_distributed_topk_is_exact_with_ties(suite, D):
    scores, g, p = _topk_inputs()
    want = top_k(torch.from_numpy(scores), 12)[1].numpy()
    want_pl = top_k(torch.log(torch.from_numpy(p[:90])) + torch.from_numpy(g[:90]), 12)[1].numpy()
    for r in suite[D]:
        np.testing.assert_array_equal(r["topk"], want)
        np.testing.assert_array_equal(r["pl"], want_pl)


@pytest.mark.parametrize("block", [1, 4])
@pytest.mark.parametrize("D", [2, 4])
def test_sharded_allocator_matches_dense(suite, D, block):
    w = torch.from_numpy(_alloc_weights())
    p_want, c_want = masked_prob_alloc(w, 100, 0.025, block=block)
    p = np.concatenate([r[f"alloc{block}/p"] for r in suite[D]])[:1000]
    capped = np.concatenate([r[f"alloc{block}/capped"] for r in suite[D]])
    np.testing.assert_allclose(p, p_want.numpy(), rtol=ALLOC_RTOL, atol=0)
    np.testing.assert_array_equal(capped[:1000], c_want.numpy())
    assert not capped[1000:].any() and not np.concatenate([r[f"alloc{block}/p"] for r in suite[D]])[1000:].any()


@pytest.mark.parametrize("staleness", [0, 2], ids=["sync", "async"])
@pytest.mark.parametrize("D", [2, 4])
def test_mesh_runner_invariants(suite, D, staleness):
    ranks = suite[D]
    for fused in ("fused", "staged"):
        tag = f"run{staleness}/{fused}"
        masks = np.concatenate([r[f"{tag}/mask"] for r in ranks], axis=1)
        ps = np.concatenate([r[f"{tag}/p"] for r in ranks], axis=1)
        sig = ranks[0][f"{tag}/sigma"]
        assert (masks.sum(1) == k).all() and not masks[:, 250:].any()
        np.testing.assert_allclose(ps.sum(1), k, rtol=1e-4)
        assert (ps[:, :250] >= sig[:, None]).all() and (ps <= 1.0).all() and not ps[:, 250:].any()
        logw = np.concatenate([r[f"{tag}/logw"] for r in ranks])
        assert np.isfinite(logw).all() and logw.max() == 0.0 and not logw[250:].any()
    for r in ranks:
        np.testing.assert_array_equal(r[f"run{staleness}/fused/mask"], r[f"run{staleness}/staged/mask"])


@pytest.mark.parametrize("staleness", [0, 2], ids=["sync", "async"])
def test_mesh2_carry_key_chunks_equal_one_shot(suite, staleness):
    for r in suite[2]:
        names = sorted(n for n in r if n.startswith(f"chunk{staleness}/one/"))
        assert names
        for n in names:
            np.testing.assert_array_equal(r[n], r[n.replace("/one/", "/two/")])


@pytest.mark.parametrize("case", list(STREAM_CASES))
@pytest.mark.parametrize("D", [2, 4])
def test_mesh_carry_key_resumes_both_streams(suite, D, case):
    """Two ``carry_key`` chunks equal one shot on every rank where the shared
    stream is drawn; after each chunk every rank holds the same shared state
    (and a regional outage the same region row) and its own own state; the
    ranks' mask slabs make one cohort of k a round."""
    ranks = [{n[len(f"streams/{case}/"):]: v for n, v in r.items() if n.startswith(f"streams/{case}/")}
             for r in suite[D]]
    for r in ranks:
        names = [n for n in r if n.startswith("one/")]
        assert len(names) > 4
        for n in names:
            np.testing.assert_array_equal(r[n], r["two/" + n[4:]], err_msg=n)
    for n in ("after1/shared", "two/shared", "two/vol_state"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[n], ranks[0][n], err_msg=n)
    own = [r["after1/own"].tobytes() for r in ranks]
    assert len(set(own)) == D and ranks[0]["after1/shared"].tobytes() not in own
    masks = np.concatenate([r["one/out0"] for r in ranks], axis=1)
    assert masks.shape == (T, K) and (masks.sum(1) == k).all()
