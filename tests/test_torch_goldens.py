"""The repo's frozen record of the engine, ``tests/golden/round_program_goldens.npz``
(48 arrays written by ``tests/golden/gen_goldens.py`` in JAX's original,
non-partitionable threefry mode), reproduced by the port under
``core.prng.threefry_partitionable(False)``, bit for bit, on the CPU.

Every array is held exactly: masks, counts, lags, successes, on-time and
stale credit, the packed lag trace, and ``cep`` (a float32 sum of the same
float32 credits in the same round order).  The cells run in
``gen_goldens.py``'s order with its arguments (``torch_goldens_ranks``);
the three D = 8 cells run on 8 spawned gloo ranks in one group.  Three
cells (sync E3CS, async E3CS, the packed-lag replay) are also held against
the live JAX package under ``jax.threefry_partitionable(False)``.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest

import torch_goldens_ranks as R
from test_torch_mesh import spawn_groups

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDENS = np.load(os.path.join(GOLDEN_DIR, "round_program_goldens.npz"))
D1_CELLS = [name for name, _ in R.CELLS if name != "d8"]


def _assert_arrays(got: dict, names):
    assert sorted(got) == sorted(names)
    for n in names:
        want = GOLDENS[n]
        assert got[n].shape == want.shape and got[n].dtype == want.dtype, (n, got[n].shape, got[n].dtype)
        np.testing.assert_array_equal(got[n], want, err_msg=n)


def test_cells_are_gen_goldens_in_its_order():
    spec = importlib.util.spec_from_file_location("gen_goldens", os.path.join(GOLDEN_DIR, "gen_goldens.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert (gen.K, gen.k, gen.T, gen.SEED, gen.FRAC) == (R.K, R.k, R.T, R.SEED, R.FRAC)
    assert (gen.SYNC_SCHEMES, gen.ASYNC_SCHEMES) == (R.SYNC_SCHEMES, R.ASYNC_SCHEMES)
    np.testing.assert_array_equal(gen.dense_xs(), R.dense_xs())
    assert [n for _, names in R.CELLS for n in names] == list(GOLDENS.files)


@pytest.mark.parametrize("cell", D1_CELLS)
def test_d1_cell_reproduces_the_goldens(cell, tmp_path):
    _assert_arrays(R.port_cell(cell, tmp_path), dict(R.CELLS)[cell])


@pytest.fixture(scope="module")
def d8_ranks(tmp_path_factory):
    return spawn_groups([(R.d8_cells, 8, tmp_path_factory.mktemp("d8"))])[0]


@pytest.mark.parametrize("scheme", ["e3cs", "random", "packed"])
def test_d8_cell_on_eight_gloo_ranks(d8_ranks, scheme):
    names = [n for n in dict(R.CELLS)["d8"] if n.startswith(f"sync_d8_{scheme}_")]
    for out in d8_ranks:  # every rank returns the whole horizon
        _assert_arrays({n: out[n] for n in names}, names)


# -- the live JAX package under the flag ---------------------------------------

def _jax_cell(cell):
    import jax.numpy as jnp

    from repro.core.volatility import CompletionLag, make_volatility, paper_success_rates
    from repro.engine.scan_sim import async_selection_sim, scan_selection_sim
    from repro.scenarios.replay import ReplayLag, pack_trace, record_lag_trace

    rho = paper_success_rates(R.K)

    def lag_model():
        return CompletionLag(make_volatility("bernoulli", rho), p_late=0.7, lag_decay=0.5, max_lag=2)

    def run_async(model):
        return async_selection_sim("e3cs", staleness=2, alpha=0.5, lag_model=model, rho=rho, **R.KW)

    with jax.threefry_partitionable(False):
        if cell == "sync_e3cs":
            out = scan_selection_sim("e3cs", **R.KW)
            return {"sync_d1_e3cs_masks": pack_trace(out["masks"]), "sync_d1_e3cs_counts": out["counts"]}
        if cell == "async_e3cs":
            out = run_async(lag_model())
            return {"async_d1_e3cs_masks": pack_trace(out["masks"]), "async_d1_e3cs_lags": out["lags"].astype(np.int8),
                    "async_d1_e3cs_counts": out["counts"], "async_d1_e3cs_cep": np.float32(out["cep"]),
                    "async_d1_e3cs_on_time": out["on_time"], "async_d1_e3cs_stale": out["stale"]}
        lags = record_lag_trace(lag_model(), R.T, seed=R.SEED)
        out = run_async(ReplayLag(jnp.asarray(lags), R.K))
        return {"async_d1_replay_masks": pack_trace(out["masks"]), "async_d1_replay_counts": out["counts"],
                "async_d1_replay_cep": np.float32(out["cep"])}


@pytest.mark.parametrize("cell", ["sync_e3cs", "async_e3cs", "async_replay"])
def test_port_equals_live_jax_under_the_flag(cell, tmp_path):
    assert jax.config.jax_threefry_partitionable  # the file runs in jax 0.9's default mode
    want = {n: np.asarray(v) for n, v in _jax_cell(cell).items()}
    assert jax.config.jax_threefry_partitionable  # and the flag is restored for the worker's next file
    got = R.port_cell(cell, tmp_path)
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n].astype(got[n].dtype), err_msg=n)
    _assert_arrays(got, dict(R.CELLS)[cell])


def test_partitionable_default_leaves_the_goldens(tmp_path):
    """The port's default mode is jax 0.9's: the same call does not give
    the goldens there, and the cached runner of one mode never serves the
    other."""
    got = R.port_cell("sync_e3cs", tmp_path)  # original mode, as the goldens
    from repro_torch.engine.scan_sim import scan_selection_sim
    from repro_torch.scenarios.replay import pack_trace

    default = pack_trace(scan_selection_sim("e3cs", device="cpu", **R.KW)["masks"])
    assert not np.array_equal(default, GOLDENS["sync_d1_e3cs_masks"])
    np.testing.assert_array_equal(got["sync_d1_e3cs_masks"], GOLDENS["sync_d1_e3cs_masks"])
    np.testing.assert_array_equal(R.port_cell("sync_e3cs", tmp_path)["sync_d1_e3cs_masks"],
                                  GOLDENS["sync_d1_e3cs_masks"])
