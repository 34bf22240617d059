"""The port's K-sharded round on the CPU, over gloo process groups, without
JAX: a one-rank mesh in this process, and D = 2 and 4 ranks in spawned
processes (one process per rank, a ``FileStore`` under ``tmp_path``).

* a one-rank mesh with ``block=1`` equals the dense ``allocator="bisect"``
  runner bit for bit, and ``block=4`` selects the same cohorts;
* a chunked ``carry_key`` mesh horizon equals a one-shot one;
* at D > 1: the collectives, the distributed top-k (exact, ties included),
  the sharded allocator against the dense one, and the runner's invariants
  (k distinct clients a round, ``sum(p) = k``, fused == staged cohorts).

``run_cases`` is also the port's side of ``test_torch_sharded.py``, which
holds the mesh round against the JAX package; it lives here so that the
spawned ranks import no JAX.
"""
import dataclasses
import multiprocessing
import os
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import FLConfig
from repro_torch.convert import gather_state, shard_arrays, state_from_jax
from repro_torch.core.selection import top_k
from repro_torch.core.volatility import CompletionLag, make_volatility, paper_success_rates
from repro_torch.engine import RoundNoise, RoundProgram
from repro_torch.core.selection import perturbed_scores
from repro_torch.engine.sharded import _shard_topk_merge, masked_prob_alloc
from repro_torch.launch import make_host_mesh

SPAWN_TIMEOUT = 120  # seconds for a group of spawned ranks to finish
ALLOC_RTOL = 1e-6  # a psum adds the ranks' tiled float32 sums in another order than one tiled sum


# ---------------------------------------------------------------------------
# spawned ranks
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, D, out_dir, args):
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(out_dir, "store"), D)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=D)
        out = fn(make_host_mesh(D, device="cpu"), *args)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_groups(jobs):
    """Run each job ``(fn, D, out_dir, *args)`` as ``fn(mesh, *args)`` on
    ``D`` spawned gloo ranks, all groups at once; returns, per job, the dicts
    of numpy arrays its ranks return, in rank order."""
    ctx = multiprocessing.get_context("spawn")
    groups = []
    for fn, D, out_dir, *args in jobs:
        os.makedirs(out_dir, exist_ok=True)
        procs = [ctx.Process(target=_rank_main, args=(fn, r, D, str(out_dir), tuple(args))) for r in range(D)]
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
        assert all(p.exitcode == 0 for p in procs) and not errs, (
            f"ranks exited {[p.exitcode for p in procs]}:\n" + "\n".join(errs)
        )
        results.append([dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(len(procs))])
    return results


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
    vol = make_volatility("bernoulli", rho)
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
