"""The port's autotune harness, as ``tests/test_autotune.py`` holds the JAX
package's: cache round-trip, corrupt-cache degradation, sweep determinism
with an injected timer, cross-process pickup, and ``tile=None`` resolving
through the cache in the ops.  Every sweep here runs on the CPU
(``device="cpu"``), where the wrappers take their plain versions."""
import json

import numpy as np
import pytest
import torch

from repro_torch.kernels import autotune
from repro_torch.kernels import ops as ops_mod
from repro_torch.kernels._build import UnsupportedLaunch


@pytest.fixture(autouse=True)
def _isolated_cache(monkeypatch, tmp_path):
    # every test gets its own cache dir and a cleared memo/cold-set
    monkeypatch.setenv("REPRO_AUTOTUNE_DIR", str(tmp_path))
    autotune._cache_memo = (None, None, None)
    autotune.reset_cold()
    yield tmp_path
    autotune._cache_memo = (None, None, None)
    autotune.reset_cold()


def _cache_file(tmp_path):
    return tmp_path / f"{autotune.CACHE_NAME}.json"


def test_bucketing_and_key_shape():
    assert autotune._bucket(1) == 1024
    assert autotune._bucket(1024) == 1024
    assert autotune._bucket(1025) == 2048
    assert autotune._bucket(1_000_000) == 2**20
    assert autotune.cache_key("gumbel_topk", 1_000_000, backend="cpu") == "gumbel_topk|K1048576|float32|cpu"
    assert autotune.cache_key("gumbel_topk", 1_000_000, backend="cuda") == "gumbel_topk|K1048576|float32|cuda"


def test_cache_round_trip(tmp_path):
    cache = {
        "gumbel_topk|K1048576|float32|cuda": {"tile": 16384},
        "bisect_tiles|K1048576|float32|cuda": {"tile": 4096, "block": 2},
    }
    path = autotune.save_cache(cache, str(_cache_file(tmp_path)))
    assert autotune.load_cache(path) == cache
    # sorted keys + trailing newline: byte-stable output
    text = _cache_file(tmp_path).read_text()
    assert text.endswith("\n")
    assert list(json.loads(text)) == sorted(cache)


@pytest.mark.parametrize("garbage", ["{not json", '["a", "list"]', '{"key": 7}'])
def test_corrupt_cache_degrades_to_defaults(tmp_path, garbage):
    _cache_file(tmp_path).write_text(garbage)
    with pytest.warns(UserWarning, match="corrupt autotune cache"):
        assert autotune.load_cache() == {}
    # best_config never crashes on a corrupt cache: defaults, recorded cold
    with pytest.warns(UserWarning):
        cfg = autotune.best_config("gumbel_topk", 4096)
    assert cfg == autotune.DEFAULTS["gumbel_topk"]
    assert autotune.cache_key("gumbel_topk", 4096) in autotune.cold_keys()


def test_best_config_merges_hit_over_defaults(tmp_path):
    key = autotune.cache_key("bisect_tiles", 4096)
    autotune.save_cache({key: {"tile": 2048}})  # partial entry: no "block"
    cfg = autotune.best_config("bisect_tiles", 4096)
    assert cfg["tile"] == 2048
    assert cfg["block"] == autotune.DEFAULTS["bisect_tiles"]["block"]  # default survives
    assert autotune.cold_keys() == []


def test_external_write_picked_up_by_mtime_memo(tmp_path):
    # a lookup before any cache exists: defaults + cold
    assert autotune.best_config("gumbel_topk", 4096) == autotune.DEFAULTS["gumbel_topk"]
    assert autotune.cold_keys()
    # another process writes the cache (same effect: file appears / mtime moves)
    autotune.save_cache({autotune.cache_key("gumbel_topk", 4096): {"tile": 16384}})
    autotune.reset_cold()
    assert autotune.best_config("gumbel_topk", 4096)["tile"] == 16384
    assert autotune.cold_keys() == []


def test_sweep_deterministic_with_injected_timer():
    # timer keyed on the candidate: argmin must win
    def timer(fn, iters, warmup, blocking):
        timer.calls += 1
        return timer.plan[timer.calls - 1]

    timer.calls = 0
    timer.plan = [50.0, 10.0, 30.0]
    best, table = autotune.sweep(
        "gumbel_topk", 4096, candidates={"tile": [2048, 4096, 8192]}, timer=timer, device="cpu"
    )
    assert best == {"tile": 4096}
    assert table == {'{"tile": 2048}': 50.0, '{"tile": 4096}': 10.0, '{"tile": 8192}': 30.0}


def test_sweep_tie_breaks_to_earlier_candidate():
    best, _ = autotune.sweep(
        "gumbel_topk", 4096,
        candidates={"tile": [2048, 4096, 8192]},
        timer=lambda fn, iters, warmup, blocking: 42.0,
        device="cpu",
    )
    assert best == {"tile": 2048}  # strict <: constant timings keep the first


def test_sweep_records_unsupported_candidates_as_skipped():
    """A candidate the kernel cannot take is not timed and never wins; the
    table says it was skipped.  round_fused's select kernel has a fixed
    step: any other tile is refused by the builder."""
    def timer(fn, iters, warmup, blocking):
        timer.calls += 1
        return 5.0

    timer.calls = 0
    best, table = autotune.sweep("round_fused", 4096, candidates={"tile": [2048, 4096]}, timer=timer, device="cpu")
    assert best == {"tile": 4096} and timer.calls == 1
    assert table['{"tile": 2048}'].startswith("skipped:") and table['{"tile": 4096}'] == 5.0
    with pytest.raises(UnsupportedLaunch, match="no candidate"):
        autotune.sweep("round_fused", 4096, candidates={"tile": [2048]}, timer=timer, device="cpu")


def test_autotune_merges_and_persists(tmp_path):
    # pre-existing entry for another kernel must survive the merge
    keep_key = autotune.cache_key("e3cs_tiles", 4096, backend="cpu")
    autotune.save_cache({keep_key: {"tile": 16384}})
    out = autotune.autotune(
        ["gumbel_topk"], [4096], timer=lambda fn, iters, warmup, blocking: 1.0, device="cpu"
    )
    cache = autotune.load_cache(out["path"])
    assert keep_key in cache
    assert autotune.cache_key("gumbel_topk", 4096, backend="cpu") in cache
    # the fresh write is immediately visible through best_config (memo reset)
    assert autotune.best_config("gumbel_topk", 4096, backend="cpu")["tile"] == cache[
        autotune.cache_key("gumbel_topk", 4096, backend="cpu")
    ]["tile"]


def test_sweep_smoke_real_timer():
    # a real (non-injected) sweep at K=1e4 on the CPU: exercises the
    # benchmark builders end to end through the port's wrappers
    for kernel in sorted(autotune.CANDIDATES):
        cands = {ax: vals[:2] for ax, vals in autotune.CANDIDATES[kernel].items()}
        best, table = autotune.sweep(kernel, 10_000, candidates=cands, iters=1, warmup=1, device="cpu")
        assert best[next(iter(cands))] in cands[next(iter(cands))]
        n = 1
        for vals in cands.values():
            n *= len(vals)
        assert len(table) == n
        assert all(us > 0 for us in table.values())


def test_ops_consult_autotune_cache(monkeypatch, tmp_path):
    """tile=None must resolve through the on-disk autotune cache and reach
    the kernel call; an uncached size gets the defaults, recorded cold."""
    key = autotune.cache_key("gumbel_topk", 263, backend="cpu")
    ekey = autotune.cache_key("e3cs_tiles", 263, backend="cpu")
    _cache_file(tmp_path).write_text(json.dumps({key: {"tile": 4096}, ekey: {"tile": 48}}))

    seen = []

    def spy(name, real):
        def call(*args, tile=8192, **kw):
            seen.append((name, tile))
            return real(*args, tile=tile, **kw)
        monkeypatch.setattr(ops_mod, name, call)

    for name in ("gumbel_topk_kernel_call", "fused_gumbel_topk_kernel_call", "e3cs_update_kernel_call"):
        spy(name, getattr(ops_mod, name))
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.gamma(1.0, 1.0, 263).astype(np.float32))
    g = torch.from_numpy(rng.gumbel(size=263).astype(np.float32))
    ops_mod.gumbel_topk_sample(g, p, 5)  # tile=None -> cache
    ops_mod.fused_gumbel_topk_sample(torch.rand(263), p, 5)  # shares the gumbel_topk entry
    z = torch.zeros(263)
    ops_mod.e3cs_update_tiled(z, p, z, z, z, 0.1)
    assert seen == [("gumbel_topk_kernel_call", 4096), ("fused_gumbel_topk_kernel_call", 4096),
                    ("e3cs_update_kernel_call", 48)]
    assert autotune.cold_keys() == []
    # a size outside the cached bucket falls back to the defaults, recorded cold
    bigp = torch.from_numpy(rng.gamma(1.0, 1.0, 3001).astype(np.float32))
    ops_mod.gumbel_topk_sample(torch.zeros(3001), bigp, 5)
    assert seen[-1] == ("gumbel_topk_kernel_call", autotune.DEFAULTS["gumbel_topk"]["tile"])
    assert autotune.cache_key("gumbel_topk", 3001, backend="cpu") in autotune.cold_keys()
    # an explicit tile bypasses the cache
    ops_mod.gumbel_topk_sample(g, p, 5, tile=2048)
    assert seen[-1] == ("gumbel_topk_kernel_call", 2048)


def test_default_cache_is_the_ports_own(tmp_path):
    """A sweep writes the port's file, never the JAX package's
    ``autotune.json`` in the same directory."""
    out = autotune.autotune(["e3cs_tiles"], [4096], timer=lambda fn, iters, warmup, blocking: 1.0, device="cpu")
    assert out["path"] == str(_cache_file(tmp_path))
    assert not (tmp_path / "autotune.json").exists()


def test_autotune_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.autotune(["gumbel_topk"], [4096], timer=lambda fn, iters, warmup, blocking: 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.time_fn(lambda: None)
