"""The port stands alone: ``import repro_torch`` loads no JAX, no file of the
port (nor ``chip_smoke.py``) imports ``jax``, ``repro``, ``msgpack`` or
``zstandard`` (the serving stack and its checkpoints import on a machine
without them; ``zstandard`` only where its ImportError is caught, to read a
JAX zstd checkpoint), its ``FLConfig`` is the JAX package's field for field, and
its entry points refuse to carry on silently without CUDA."""
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
from repro_torch.core.selection import e3cs_init, make_quota_schedule, ucb_init
from repro_torch.fl.round import init_server_state
from repro_torch.obs import ROUND_TAPS
from repro_torch.obs.sketches import sketch_carry0
from repro_torch import scenarios
from repro_torch.core.sim import selection_sim
from repro_torch.engine import RoundProgram, async_selection_sim, scan_selection_sim
from repro_torch.fl import build_volatility
from repro_torch.kernels import fused_round_tail, unpack_bits
from repro_torch.launch import HostMesh, make_host_mesh
from repro_torch.serve import ShardedEngine, SlotEngine, engine_from_meta

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, repro_torch, repro_torch.engine, repro_torch.kernels, repro_torch.convert, repro_torch.fl, "
        "repro_torch.launch.mesh, repro_torch.kernels.bisect_tiles, repro_torch.engine.sharded, "
        "repro_torch.kernels.ops, repro_torch.kernels.autotune, repro_torch.obs.paths, repro_torch.scenarios, "
        "repro_torch.engine.scan_sim, repro_torch.core.sim, repro_torch.core.fairness, "
        "repro_torch.core.selection.regret, repro_torch.engine.multi_job, repro_torch.launch.select_serve, "
        "repro_torch.serve, repro_torch.checkpoint, repro_torch.optim, repro_torch.data, repro_torch.models, "
        "repro_torch.fl.client, repro_torch.fl.aggregation, repro_torch.launch.train, repro_torch.configs, "
        "repro_torch.models.attention, repro_torch.models.mla, repro_torch.models.moe, repro_torch.models.ssm, "
        "repro_torch.models.transformer, repro_torch.models.encdec, repro_torch.models.api, "
        "repro_torch.launch.serve, repro_torch.models.sharding, repro_torch.launch.dryrun, "
        "repro_torch.launch.metrics, repro_torch.launch.comms; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'msgpack', 'zstandard')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_serving_imports_without_msgpack_or_zstandard():
    """The card's machine has neither package: with both made unimportable,
    the serving stack and its checkpoints still import and round-trip."""
    code = (
        "import sys, tempfile, os\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('msgpack', 'zstandard', 'jax', 'repro'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch, repro_torch.serve, repro_torch.launch.select_serve\n"
        "from repro_torch.checkpoint import save, restore\n"
        "p = os.path.join(tempfile.mkdtemp(), 'c.ckpt')\n"
        "t = {'a': torch.arange(3)}\n"
        "assert torch.equal(restore(save(p, t), t)['a'], t['a'])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


OPTIONAL = ("zstandard",)  # may be imported where an ImportError is caught (a JAX zstd checkpoint's reader)


def _guarded(tree):
    """The import nodes inside a ``try`` whose handlers catch ImportError."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and any(
                isinstance(h.type, ast.Name) and h.type.id in ("ImportError", "ModuleNotFoundError")
                for h in node.handlers):
            out.update(id(n) for stmt in node.body for n in ast.walk(stmt))
    return out


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    guarded = _guarded(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                root = alias.name.split(".")[0]
                if not (root in OPTIONAL and id(node) in guarded):
                    yield root
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_repro(path):
    bad = {m for m in _imported_roots(path) if m in ("jax", "jaxlib", "repro", "msgpack", "zstandard")}
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
    return fl, make_volatility("bernoulli", paper_success_rates(64), device="cpu"), paper_success_rates(64)


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


SLICE_ENTRY_POINTS = {
    "build_volatility": lambda: build_volatility(FLConfig(K=64, k=8, rounds=4), 64),
    "scan_selection_sim": lambda: scan_selection_sim("e3cs", K=64, k=8, T=2),
    "async_selection_sim": lambda: async_selection_sim("e3cs", K=64, k=8, T=2),
    "selection_sim": lambda: selection_sim("e3cs", K=64, k=8, T=2),
    "make_scenario": lambda: scenarios.make_scenario("diurnal", 64, 4),
    "record_trace": lambda: scenarios.record_trace(make_volatility("bernoulli", paper_success_rates(64), device="cpu"), 2),
    "evaluate_cell": lambda: scenarios.evaluate_cell("e3cs", "markov", K=64, k=8, T=2),
    "run_replay": lambda: scenarios.run_replay("ucb", "markov", K=64, k=8, T=2),
    "SlotEngine": lambda: SlotEngine(K_max=64),
    "ShardedEngine": lambda: ShardedEngine(D=1),
    "engine_from_meta": lambda: engine_from_meta(SlotEngine(K_max=64, device="cpu").meta()),
}


def _fl_task():
    from repro_torch.configs import FLConfig
    from repro_torch.launch.train import build_task

    fl = FLConfig(K=8, k=2, rounds=2, samples_per_client=20)
    return fl, build_task("emnist", fl, device="cpu")


def _fl_server():
    from repro_torch.fl import FLServer

    fl, (model, store, eval_fn) = _fl_task()
    return FLServer(model, fl, store, eval_fn)


def _train_main():
    from repro_torch.launch.train import main

    return main(["--rounds", "1", "--K", "8", "--k", "2", "--spc", "20"])


def _cnn_params():
    from repro_torch.convert import cnn_params_from_jax

    return cnn_params_from_jax({"b1": np.zeros(3, np.float32)})


def _build_task():
    from repro_torch.configs import FLConfig
    from repro_torch.launch.train import build_task

    return build_task("emnist", FLConfig(K=8, k=2, rounds=2, samples_per_client=20))


def _serve_main():
    from repro_torch.launch.serve import main

    return main(["--arch", "gemma-2b", "--smoke", "--gen", "1"])


def _zoo_init_caches():
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import build_model

    return build_model(smoke_variant(get_config("gemma-2b"))).init_caches(1, 4)


def _lm_params():
    from repro_torch.convert import lm_params_from_jax

    return lm_params_from_jax({"tok_emb": np.zeros((3, 2), np.float32)})


def _caches():
    from repro_torch.convert import caches_from_jax

    return caches_from_jax({"x": np.zeros(2, np.float32)})


FL_ENTRY_POINTS = {"FLServer": _fl_server, "train.main": _train_main, "cnn_params_from_jax": _cnn_params,
                   "build_task": _build_task, "serve.main": _serve_main, "init_caches": _zoo_init_caches,
                   "lm_params_from_jax": _lm_params, "caches_from_jax": _caches}


@pytest.mark.parametrize("name", list(FL_ENTRY_POINTS))
def test_fl_entry_points_raise_without_cuda(no_cuda, name):
    """The training stack's ``device=None`` entry points mean CUDA (the
    command line's ``--device`` defaults to it): without one they raise."""
    with pytest.raises(RuntimeError, match="CUDA"):
        FL_ENTRY_POINTS[name]()


def test_zoo_runs_on_the_generators_device(no_cuda):
    """A zoo model's ``init`` draws onto its generator's device (a CUDA
    generator needs CUDA), and the serving CLI runs on the CPU when asked."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch.serve import main
    from repro_torch.models import build_model

    params, _ = build_model(smoke_variant(get_config("mamba2-130m"))).init(torch.Generator())
    assert all(t.device.type == "cpu" for t in torch.utils._pytree.tree_leaves(params))
    assert main(["--arch", "mamba2-130m", "--smoke", "--gen", "1", "--device", "cpu"])["generated_shape"] == [4, 2]


def test_fl_server_runs_on_cpu_when_asked(no_cuda):
    from repro_torch.fl import FLServer

    fl, (model, store, eval_fn) = _fl_task()
    srv = FLServer(model, fl, store, eval_fn, device="cpu")
    state = srv.init_state(0)
    assert srv.device.type == "cpu" and state.params["conv1"].device.type == "cpu"


@pytest.mark.parametrize("name", list(SLICE_ENTRY_POINTS))
def test_scenario_entry_points_raise_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA"):
        SLICE_ENTRY_POINTS[name]()


CONSTRUCTORS = {
    "make_volatility": lambda: make_volatility("bernoulli", paper_success_rates(64)),
    "e3cs_init": lambda: e3cs_init(64),
    "ucb_init": lambda: ucb_init(64),
    "init_server_state": lambda: init_server_state({}, 64, None),
    "make_quota_schedule": lambda: make_quota_schedule("const", 8, 64, 4, 0.5),
    "init_counters": lambda: ROUND_TAPS.init_counters(),
    "sketch_carry0": lambda: sketch_carry0(64, 2),
}


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructors_raise_without_cuda(no_cuda, name):
    """A public constructor given no device means CUDA, as the entry points
    do: it raises without one instead of building its tensors on the CPU."""
    with pytest.raises(RuntimeError, match="CUDA"):
        CONSTRUCTORS[name]()


@pytest.mark.parametrize("name", ["bernoulli", "diurnal"])
def test_build_volatility_lands_on_the_device_asked(no_cuda, name):
    """A builtin and a scenario name land on the same device: the CPU when
    asked (without a device both raise, ``SLICE_ENTRY_POINTS``)."""
    vol, rho = build_volatility(FLConfig(K=64, k=8, rounds=4, volatility=name), 64, device="cpu")
    assert rho.device.type == "cpu" and vol.rho.device.type == "cpu" and vol.init_state().device.type == "cpu"


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


@pytest.mark.parametrize("what", ["scheme", "sampler", "scenario"])
def test_unported_paths_raise_with_their_roadmap_item(what):
    """The paths a mesh once refused (ROADMAP A9 rest): a baseline scheme
    and a scenario model now run on a one-rank mesh and equal the dense
    ``allocator="bisect"`` run bit for bit; the systematic sampler is
    refused with a ``ValueError``, as JAX's sharded runner refuses it."""
    import torch.distributed as dist

    from repro.engine.round_program import RoundProgram as JRoundProgram
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh

    fl, vol, rho = _program_args()
    fl = dataclasses.replace(fl, allocator="bisect")
    mesh = HostMesh(size=1, rank=0, device=torch.device("cpu"))
    if what == "sampler":
        with pytest.raises(ValueError, match="plackett_luce sampler"):
            RoundProgram(fl=dataclasses.replace(fl, sampler="systematic"), vol=vol, rho=rho, mesh=mesh)
        jfl = dataclasses.replace(JFLConfig(K=64, k=8, rounds=4, allocator="bisect"), sampler="systematic")
        jpm = JRoundProgram(fl=jfl, vol=vol, rho=rho, mesh=jmake_host_mesh(1))
        with pytest.raises(ValueError, match="plackett_luce sampler"):
            jpm.build_runner()
        return
    cfg = dataclasses.replace(fl, scheme="random") if what == "scheme" else dataclasses.replace(fl, volatility="diurnal")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        runs = []
        for m in (None, mesh):
            run, s0 = RoundProgram.from_config(cfg, mesh=m, device="cpu").build_runner()
            runs.append(run(s0, 3))
    finally:
        dist.destroy_process_group()
    for a, b in zip(*(torch.utils._pytree.tree_leaves(r) for r in runs)):
        assert torch.equal(a, b)


def test_state_from_jax_names_missing_arrays():
    with pytest.raises(KeyError, match="logw"):
        state_from_jax({"t": np.int32(0)}, device="cpu")


def test_zoo_training_names_import_without_jax():
    """``make_silo_steps`` and the remat helper load without JAX, and the
    port's ``fl`` exports every public name of the JAX package's ``fl``."""
    code = (
        "import sys\n"
        "from repro_torch.fl import make_silo_steps\n"
        "from repro_torch.fl.round import make_silo_steps as m2\n"
        "from repro_torch.models.remat import remat\n"
        "assert make_silo_steps is m2 and callable(remat)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    import types

    import repro.fl as jfl
    import repro_torch.fl as pfl

    jax_names = {n for n, v in vars(jfl).items() if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    assert jax_names == set(pfl.__all__)
    assert all(hasattr(pfl, n) for n in pfl.__all__)


def test_mesh_entry_points_raise_without_cuda(no_cuda):
    """``make_mesh`` and ``make_production_mesh`` default to CUDA and raise
    without it, before any process group is asked for."""
    from repro_torch.launch import make_mesh, make_production_mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_production_mesh()


def test_mesh_names_are_exported():
    """The port's ``launch`` exports JAX's mesh names, and ``models``
    exports ``sharding``, as the JAX package does."""
    import repro_torch.launch as launch
    import repro_torch.models as models
    from repro.launch import mesh as jmesh

    assert set(jmesh.__all__) <= set(launch.__all__)
    assert models.sharding.__name__ == "repro_torch.models.sharding"
