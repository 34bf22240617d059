"""The port's dry run (``repro_torch.launch.dryrun``) on the JAX package's
four ``tests/test_dryrun.py`` cells, each in a subprocess with a ``"fake"``
process group of 8 ranks (``REPRO_DRYRUN_DEVICES=8``, ``REPRO_DRYRUN_MESH``),
and its closed forms against JAX's.

JAX's own dry-run records cannot be the reference here: three of its four
tests fail under jax 0.9 (sharding-API errors in ``repro.launch.dryrun``),
so each cell is held to what JAX's test asserts of its own record (status,
a positive compute term, collectives present, the mesh's shape, the SSM's
small per-device memory, the whisper skip).  ``attention_analytic`` and the
useful-FLOPs count are pure functions of a config and are held to JAX's
exactly.
"""
import json
import os
import subprocess
import sys
import tempfile

import pytest

from repro.configs import INPUT_SHAPES as JINPUT_SHAPES, get_config as jget_config
from repro.launch.metrics import attention_analytic as jattention_analytic
from repro_torch.configs import ASSIGNED, INPUT_SHAPES, get_config
from repro_torch.launch.metrics import attention_analytic, model_flops

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _run(arch, shape, mesh_dims="4x2", timeout=240):
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, PYTHONPATH=SRC, REPRO_DRYRUN_DEVICES="8", REPRO_DRYRUN_MESH=mesh_dims)
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--mesh",
             "multi" if mesh_dims.count("x") == 2 else "single", "--out", out],
            env=env, capture_output=True, text=True, timeout=timeout,
        )
        files = [f for f in os.listdir(out) if f.endswith(".json")]
        assert files, r.stdout + r.stderr
        with open(os.path.join(out, files[0])) as f:
            return json.load(f)


def _no_tpu_rates(rec):
    rates = rec["rates"]
    assert rates["card"] == "NVIDIA H100 80GB HBM3" and rates["power_limit_w"] == 700
    assert rates["peak_flops_bf16_dense"] == 989e12 and rates["hbm_bytes_per_s"] == 3.35e12
    assert rates["link_bytes_per_s"] == 50e9


def test_dryrun_dense_train_single():
    rec = _run("stablelm-1.6b", "train_4k", "4x2")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["roofline"]["compute_s"] > 0
    assert rec["collectives"]["total"] > 0  # the cohort's aggregation and the model axis's collectives
    assert rec["flops_per_dev"] > 0 and rec["per_device_hbm_gb"] > 0
    _no_tpu_rates(rec)


def test_dryrun_dense_train_multipod():
    rec = _run("stablelm-1.6b", "train_4k", "2x2x2")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh_shape"] == [2, 2, 2]


def test_dryrun_ssm_decode():
    rec = _run("mamba2-130m", "long_500k", "4x2")
    assert rec["status"] == "ok", rec.get("error")
    # O(1) state decode: per-device HBM must be tiny even at 500k context
    assert rec["per_device_hbm_gb"] < 4.0


def test_dryrun_whisper_skip_long():
    rec = _run("whisper-base", "long_500k", "4x2")
    assert rec["status"] == "skipped"


@pytest.mark.parametrize("window", [0, 8192])
@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_attention_analytic_equals_jax(arch, shape, window):
    got = attention_analytic(get_config(arch), INPUT_SHAPES[shape], 256, window)
    want = jattention_analytic(jget_config(arch), JINPUT_SHAPES[shape], 256, window)
    assert got == {k: float(v) for k, v in want.items()}


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_equal_jax(arch, shape):
    jcfg, js = jget_config(arch), JINPUT_SHAPES[shape]
    tokens = js.global_batch * (js.seq_len if js.kind != "decode" else 1)
    want = (6 if js.kind == "train" else 2) * jcfg.n_active_params() * tokens  # repro.launch.dryrun.run_one
    assert model_flops(get_config(arch), INPUT_SHAPES[shape]) == float(want)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_equals_jax(multi_pod, monkeypatch):
    """The dry run's production mesh (``make_production_mesh`` on a fake
    group of 256 or 512 ranks, in a subprocess) has the shape and axis
    names JAX's ``make_production_mesh`` asks ``jax.make_mesh`` for."""
    import jax

    from repro.launch import mesh as jmesh

    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes: (list(shape), list(axes)))
    want = jmesh.make_production_mesh(multi_pod=multi_pod)
    code = ("import json, torch.distributed as dist; from repro_torch.launch import dryrun; "
            f"m = dryrun._mesh({'multi' if multi_pod else 'single'!r}); "
            "print(json.dumps([list(m.mesh.shape), list(m.mesh_dim_names)])); dist.destroy_process_group()")
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_DRYRUN")}
    r = subprocess.run([sys.executable, "-c", code], env=dict(env, PYTHONPATH=SRC), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == list(want)
