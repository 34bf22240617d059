"""The port stands alone: ``import repro_torch`` loads no JAX, no file of the
port (nor ``chip_smoke.py``) imports ``jax`` or ``repro``, its ``FLConfig``
is the JAX package's field for field, and its entry points refuse to carry
on silently without CUDA."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import FLConfig as JFLConfig
from repro_torch.configs import FLConfig
from repro_torch.convert import state_from_jax
from repro_torch.core.volatility import make_volatility, paper_success_rates
from repro_torch.engine import RoundProgram
from repro_torch.kernels import fused_round_tail, unpack_bits
from repro_torch.launch import HostMesh, make_host_mesh

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, repro_torch, repro_torch.engine, repro_torch.kernels, repro_torch.convert, repro_torch.fl, "
        "repro_torch.launch.mesh, repro_torch.kernels.bisect_tiles, repro_torch.engine.sharded; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'repro' "
        "or m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_repro(path):
    bad = {m for m in _imported_roots(path) if m in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_flconfig_matches_jax_field_for_field():
    jf = {f.name: (f.type, f.default) for f in dataclasses.fields(JFLConfig)}
    pf = {f.name: (f.type, f.default) for f in dataclasses.fields(FLConfig)}
    assert pf == jf
    assert dataclasses.asdict(FLConfig()) == dataclasses.asdict(JFLConfig())


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _program_args():
    fl = FLConfig(K=64, k=8, rounds=4)
    return fl, make_volatility("bernoulli", paper_success_rates(64)), paper_success_rates(64)


def test_entry_points_raise_without_cuda(no_cuda):
    fl, vol, rho = _program_args()
    with pytest.raises(RuntimeError, match="CUDA"):
        RoundProgram.from_config(fl)
    with pytest.raises(RuntimeError, match="CUDA"):
        RoundProgram(fl=fl, vol=vol, rho=rho)
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_jax({})
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh(1)


def test_entry_points_run_on_cpu_when_asked(no_cuda):
    fl, vol, rho = _program_args()
    pm = RoundProgram(fl=fl, vol=vol, rho=rho, device="cpu", fused=True)
    step, state0 = pm.build_step()
    assert state0.e3cs.logw.device.type == "cpu"
    run, state0 = RoundProgram.from_config(fl, device="cpu").build_runner(outputs="lean")
    state, successes, sigmas = run(state0, 0)
    assert successes.shape == (4,) and int(state.t) == 4


def test_mesh_program_takes_the_mesh_device(no_cuda):
    fl, vol, rho = _program_args()
    mesh = HostMesh(size=1, rank=0, device=torch.device("cpu"))
    assert RoundProgram(fl=fl, vol=vol, rho=rho, mesh=mesh).device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        RoundProgram(fl=fl, vol=vol, rho=rho, mesh=mesh, device="cuda")


def test_wrappers_refuse_a_device_with_no_kernel():
    with pytest.raises(RuntimeError, match="meta"):
        unpack_bits(torch.empty(2, dtype=torch.uint8, device="meta"), 16)
    z = torch.zeros(8, device="meta")
    with pytest.raises(RuntimeError, match="meta"):
        fused_round_tail(z, z, z, z.bool(), z, z, kind="x", residual=1.0, eta=0.5, K_glob=8)


@pytest.mark.parametrize("what", ["mesh", "taps", "scheme", "sampler", "scenario"])
def test_unported_paths_raise_with_their_roadmap_item(what):
    fl, vol, rho = _program_args()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what == "mesh":  # the mesh is ported; its taps are not
            mesh = HostMesh(size=1, rank=0, device=torch.device("cpu"))
            RoundProgram.from_config(fl, mesh=mesh, device="cpu").build_runner(taps=True)
        elif what == "taps":
            RoundProgram.from_config(fl, device="cpu").build_runner(taps=True)
        elif what == "scheme":
            RoundProgram(fl=dataclasses.replace(fl, scheme="random"), vol=vol, rho=rho, device="cpu")
        elif what == "sampler":
            RoundProgram(fl=dataclasses.replace(fl, sampler="systematic"), vol=vol, rho=rho, device="cpu")
        else:
            RoundProgram.from_config(dataclasses.replace(fl, volatility="diurnal"), device="cpu")


def test_state_from_jax_names_missing_arrays():
    with pytest.raises(KeyError, match="logw"):
        state_from_jax({"t": np.int32(0)}, device="cpu")
