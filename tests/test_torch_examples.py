"""The five examples of the port (``examples/torch_*.py``) on the CPU at a
tiny size: each runs its JAX counterpart's steps through ``main(argv)``
with ``--device cpu`` and gives results of the right shape; none imports
the JAX package or JAX; where the JAX example computes a value from the
same inputs without noise (Theorem 1's eta and bound), the two are equal.
"""
import ast
import importlib.util
import math
import os

import numpy as np
import pytest

from repro.core.selection import theorem1_bound as jtheorem1_bound
from repro.core.selection import theorem1_eta as jtheorem1_eta

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
NAMES = ("quickstart", "scenarios_demo", "serve_demo", "paper_repro", "fl_lm")


def _example(name):
    path = os.path.join(EXAMPLES, f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NAMES)
def test_the_example_imports_only_the_port(name):
    with open(os.path.join(EXAMPLES, f"torch_{name}.py")) as f:
        tree = ast.parse(f.read())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    roots = {m.split(".")[0] for m in mods}
    assert "repro_torch" in roots and not roots & {"repro", "jax", "jaxlib", "flax"}, sorted(roots)
    assert callable(_example(name).main)


def test_quickstart():
    out = _example("quickstart").main(["--K", "400", "--k", "20", "--rounds", "12", "--device", "cpu"])
    assert 0 < out["cep"] <= 12 * 20 and sum(out["class_counts"]) == 12 * 20
    assert out["sigmas"][0] == 0.0 and out["taps"]["selected"] == 20.0


def test_scenarios_demo():
    out = _example("scenarios_demo").main(["--K", "64", "--k", "8", "--T", "16", "--T-multi", "8", "--device",
                                           "cpu"])
    assert len(out["grid"]) == 12 and len(out["multi_job"]) == 4
    assert out["packed_same_as_dense"] and out["dense_bytes"] == 32 * out["packed_bytes"]
    assert 0 < out["cep"] <= 16 * 8


def test_serve_demo():
    out = _example("serve_demo").main(["--rounds", "6", "--device", "cpu"])
    assert out["restored_step"] == 2 * 3 and sorted(out["cohorts"]) == [0, 1]
    assert [len(c) for c in out["cohorts"][0]] == [24] * 6 and [len(c) for c in out["cohorts"][1]] == [8] * 6
    assert out["stats"]["ticks"] == 6 and out["stats"]["errors"] == 0


def test_paper_repro_phase1_and_theorem1_equal_jax():
    ex = _example("paper_repro")
    out = ex.phase1(T=40, device="cpu", theorem_T=60)
    assert [r[0] for r in out["rows"]] == [n for n, _ in ex.SCHEMES] and sorted(out["order"]) == sorted(
        n for n, _ in ex.SCHEMES)
    assert all(0 < r[1] <= 40 * 20 and 0 < r[2] <= 1 and sum(r[3]) == 40 * 20 for r in out["rows"])
    sigmas = np.zeros(60)
    assert out["eta"] == jtheorem1_eta(50, 10, sigmas)
    assert out["bound"] == jtheorem1_bound(50, 10, sigmas, out["eta"]) and math.isfinite(out["regret"])


def test_paper_repro_phase2_trains_the_four_schemes():
    res = _example("paper_repro").phase2(rounds=2, device="cpu", K=8, k=2, samples_per_client=20)
    assert list(res) == ["E3CS-0", "E3CS-inc", "FedCS", "Random"]
    for v in res.values():
        assert len(v["acc"]) >= 1 and all(0.0 <= a <= 1.0 for a in v["acc"]) and 0 <= v["cep"] <= 2 * 2


def test_fl_lm():
    out = _example("fl_lm").main(["--rounds", "2", "--K", "8", "--k", "2", "--seq", "16", "--batch", "2",
                                  "--device", "cpu"])
    assert out["rounds"] == 2 and len(out["losses"]) == 2 and all(math.isfinite(v) for v in out["losses"])
    assert sum(out["class_counts"]) == 2 * 2 and 0 <= out["cep"] <= 4
