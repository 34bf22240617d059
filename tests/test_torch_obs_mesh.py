"""The round taps and the client-axis sketch stream of the port's runners on
the CPU, without JAX: dense, on a one-rank gloo mesh in this process, and on
D = 2 and 4 spawned gloo ranks (``test_torch_mesh.spawn_groups``).

* taps never touch the round: a taps-on horizon's state and outputs equal
  the taps-off ones bit for bit;
* the sketch stream equals ``sketch_from_dense`` of the run's own full
  outputs, and the gauge series equal the sums of those outputs;
* a one-rank mesh with ``block=1`` emits the dense runner's taps and
  sketch stream bit for bit;
* at D > 1 (each rank draws its own noise) every rank holds the same merged
  stream, equal to ``sketch_from_dense`` of the gathered outputs;
* ``carry_key`` chunks of taps equal one shot.

``test_torch_obs.py`` holds the same streams against the JAX package's.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import FLConfig
from repro_torch.engine import RoundProgram
from repro_torch.launch import make_host_mesh
from repro_torch.obs import ROUND_TAPS, SKETCH_FIELDS, SketchSpec, sketch_from_dense
from repro_torch.obs.sketches import lag_bins, region_ids
from test_torch_mesh import spawn_groups

K, k, T, SEED = 1001, 16, 12, 4
SPEC = dict(window=3, count_bins=8, prob_bins=10, n_regions=4)


def _fl(staleness=None, K_=K):
    return FLConfig(K=K_, k=k, rounds=T, scheme="e3cs", quota_frac=0.5, allocator="bisect",
                    staleness_rounds=staleness or 0)


def _program(staleness=None, mesh=None, fused=True, **kw):
    feedback = "late_credit" if staleness else "deadline"
    return RoundProgram.from_config(_fl(staleness), mesh=mesh, fused=fused, feedback=feedback, device="cpu", **kw)


def dense_stream(spec: SketchSpec, masks, xs, ps, lags, staleness):
    """The sketch stream a horizon's full outputs imply: one
    ``sketch_from_dense`` row at every ``window``-th round."""
    masks, xs, ps = (np.asarray(a, np.float64) for a in (masks, xs, ps))
    n_rounds, n = masks.shape
    L = lag_bins(staleness)
    if lags is None:
        codes = (1 - xs).astype(np.int64)
    else:
        lags = np.asarray(lags)
        codes = np.where(lags < 0, L - 1, np.clip(lags, 0, L - 2))
    counts = np.cumsum(masks, axis=0)
    cum = np.cumsum(masks * xs, axis=0)
    lag_hist = np.zeros(L)
    region = region_ids(spec, n)
    rows = []
    for i in range(n_rounds):
        lag_hist = lag_hist + np.bincount(codes[i], weights=masks[i], minlength=L)[:L]
        if (i + 1) % spec.window == 0:
            rows.append(sketch_from_dense(spec, counts[i], ps[i], cum[i], lag_hist, region))
    return {f: np.stack([r[f] for r in rows]) for f in SKETCH_FIELDS}


def _numpy(tree):
    return {n: v.numpy() for n, v in tree.items()}


def _split(outs, staleness):
    """``(masks, xs, ps, lags, arrived)`` of a full horizon's outputs."""
    if staleness is None:
        masks, xs, ps, _ = outs
        return masks, xs, ps, None, None
    masks, lags, ps, _, arrived = outs
    return masks, (lags == 0).float(), ps, lags, arrived


def _assert_equal_trees(a, b):
    assert set(a) == set(b)
    for n in a:
        np.testing.assert_array_equal(np.asarray(a[n]), np.asarray(b[n]), err_msg=n)


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo mesh in this process."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_host_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
@pytest.mark.parametrize("staleness", [None, 2], ids=["sync", "async"])
def test_taps_leave_the_round_alone(staleness, fused):
    pm = _program(staleness, fused=fused)
    plain, s0 = pm.build_runner(outputs="full")
    tapped, _ = pm.build_runner(outputs="full", taps=True, sketch=SketchSpec(**SPEC))
    st, *outs = plain(s0, SEED)
    st_t, *outs_t, payload = tapped(s0, SEED)
    for a, b in zip((st.e3cs.logw, st.sel_counts, st.loss_cache, st.cep, st.t, *outs),
                    (st_t.e3cs.logw, st_t.sel_counts, st_t.loss_cache, st_t.cep, st_t.t, *outs_t)):
        assert torch.equal(a, b)
    assert set(payload) == {"series", "counters", "sketches"}


@pytest.mark.parametrize("staleness", [None, 2], ids=["sync", "async"])
def test_sketch_stream_and_series_follow_the_outputs(staleness):
    spec = SketchSpec(**SPEC)
    pm = _program(staleness)
    run, s0 = pm.build_runner(outputs="full", taps=True, sketch=spec)
    _, *outs, payload = run(s0, SEED)
    masks, xs, ps, lags, arrived = _split(outs, staleness)
    _assert_equal_trees(_numpy(payload["sketches"]), dense_stream(spec, masks, xs, ps, lags, staleness))
    series = payload["series"]
    assert torch.equal(series["selected"], masks.sum(1)) and torch.all(series["selected"] == k)
    assert torch.equal(series["on_time"], (masks * xs).sum(1))
    assert torch.equal(series["stale"], torch.zeros(T) if arrived is None else arrived.sum(1))
    assert torch.equal(series["sigma"], outs[3])
    counters = payload["counters"]
    assert float(counters["rounds"]) == T and float(counters["cum_selected"]) == T * k
    assert float(counters["cum_credit"]) == float((series["on_time"] + series["stale"]).sum())


@pytest.mark.parametrize("outputs", ["full", "lean"])
@pytest.mark.parametrize("staleness", [None, 2], ids=["sync", "async"])
def test_one_rank_mesh_emits_the_dense_taps_and_sketches(mesh1, staleness, outputs):
    """The runners that replace the old NotImplementedError of
    ``build_runner(taps=True)``: dense and on a one-rank gloo mesh."""
    spec = SketchSpec(**SPEC)
    dense = _program(staleness)
    sharded = _program(staleness, mesh=mesh1, block=1)
    run_d, s0 = dense.build_runner(outputs=outputs, taps=True, sketch=spec)
    run_m, s0_m = sharded.build_runner(outputs=outputs, taps=True, sketch=spec)
    *outs_d, pay_d = run_d(s0, SEED)
    *outs_m, pay_m = run_m(s0_m, SEED)
    for a, b in zip(outs_d[1:], outs_m[1:]):
        assert torch.equal(a, b)
    for part in ("series", "counters", "sketches"):
        _assert_equal_trees(_numpy(pay_d[part]), _numpy(pay_m[part]))
    taps_only, _ = sharded.build_runner(outputs=outputs, taps=True)
    *_, pay_t = taps_only(s0_m, SEED)
    assert set(pay_t) == {"series", "counters"}
    _assert_equal_trees(_numpy(pay_t["series"]), _numpy(pay_d["series"]))


@pytest.mark.parametrize("mesh_run", [False, True], ids=["dense", "mesh1"])
@pytest.mark.parametrize("staleness", [None, 2], ids=["sync", "async"])
def test_carry_key_taps_chunks_equal_one_shot(mesh1, staleness, mesh_run):
    pm = _program(staleness, mesh=mesh1 if mesh_run else None, block=4)
    one, s0 = pm.build_runner(outputs="lean", carry_key=True, taps=True)
    chunk, _ = pm.build_runner(outputs="lean", carry_key=True, taps=True, scan_length=T // 3)
    rings = () if staleness is None else (pm.init_rings(),)
    st, _, *rest = one(s0, SEED, *rings, ROUND_TAPS.init_counters("cpu"))
    tapc_one, row_one = rest[len(rings)], rest[-1]
    carry, key, rows = (s0, *rings, ROUND_TAPS.init_counters("cpu")), SEED, []
    for _ in range(3):
        st_c, key, *rest_c = chunk(carry[0], key, *carry[1:])
        carry = (st_c, *rest_c[: len(rings) + 1])
        rows.append(rest_c[-1])
    for n in ROUND_TAPS.gauge_names():
        assert torch.equal(row_one[n], torch.cat([r[n] for r in rows])), n
    _assert_equal_trees(_numpy(tapc_one), _numpy(carry[-1]))
    assert torch.equal(st.sel_counts, carry[0].sel_counts)


def test_sketch_needs_taps_and_one_shot():
    pm = _program()
    with pytest.raises(ValueError, match="taps=True"):
        pm.build_runner(sketch=SketchSpec(window=4))
    with pytest.raises(ValueError, match="one-shot"):
        pm.build_runner(taps=True, carry_key=True, sketch=SketchSpec(window=4))


def _rank_horizon(mesh, staleness):
    """One rank's full horizon with taps and sketches on (spawned ranks)."""
    pm = _program(staleness, mesh=mesh, block=4)
    run, s0 = pm.build_runner(outputs="full", taps=True, sketch=SketchSpec(**SPEC))
    _, *outs, payload = run(s0, SEED)
    masks, xs, ps, lags, arrived = _split(outs, staleness)
    out = {"masks": masks, "xs": xs, "ps": ps, "sigmas": outs[3]}
    if staleness is not None:
        out.update(lags=lags, arrived=arrived)
    out = {n: v.numpy() for n, v in out.items()}
    for part in ("series", "counters", "sketches"):
        out.update({f"{part}/{n}": v.numpy() for n, v in payload[part].items()})
    return out


@pytest.mark.parametrize("staleness", [None, 2], ids=["sync", "async"])
def test_spawned_ranks_hold_one_merged_stream(tmp_path, staleness):
    jobs = [(_rank_horizon, D, tmp_path / f"d{D}", staleness) for D in (2, 4)]
    spec = SketchSpec(**SPEC)
    for D, ranks in zip((2, 4), spawn_groups(jobs)):
        shared = [n for n in ranks[0] if n.split("/")[0] in ("series", "counters", "sketches")]
        for r in ranks[1:]:
            for n in shared:
                np.testing.assert_array_equal(r[n], ranks[0][n], err_msg=f"D={D} {n}")

        def gathered(name):
            return np.concatenate([r[name] for r in ranks], axis=1)[:, :K]

        masks, xs, ps = gathered("masks"), gathered("xs"), gathered("ps")
        lags = None if staleness is None else gathered("lags")
        want = dense_stream(spec, masks, xs, ps, lags, staleness)
        _assert_equal_trees({f: ranks[0][f"sketches/{f}"] for f in SKETCH_FIELDS}, want)
        assert (masks.sum(1) == k).all()
        np.testing.assert_array_equal(ranks[0]["series/selected"], masks.sum(1))
        np.testing.assert_array_equal(ranks[0]["series/on_time"], (masks * xs).sum(1))
        stale = np.zeros(T, np.float32) if staleness is None else gathered("arrived").sum(1)
        np.testing.assert_array_equal(ranks[0]["series/stale"], stale)
        np.testing.assert_array_equal(ranks[0]["series/sigma"], ranks[0]["sigmas"])
        assert ranks[0]["counters/cum_selected"] == T * k
