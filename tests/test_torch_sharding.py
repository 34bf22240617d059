"""The port's logical sharding rules (``repro_torch.models.sharding``) and
meshes against the JAX package's.

* ``cohort_rules``, ``silo_rules``, the dry run's ``serve_rules`` and
  ``logical_to_spec`` equal JAX's exactly, for every leaf of the ten
  archs' full-config parameter and cache specs, at axis sizes (16, 16),
  (2, 16, 16), (4, 2) and (2, 2, 2).  All pure functions.
* Each leaf's shard shape equals JAX's ``NamedSharding(mesh,
  spec).shard_shape`` on conftest's 8 host devices at (4, 2) and (2, 2, 2).
  The port's side runs in a subprocess with a ``"fake"`` process group of 8
  ranks (one process holds all coordinates' shapes).  Where a dimension does
  not divide by its mesh axes, JAX refuses the layout (``ValueError``) and
  DTensor shards it unevenly as ``torch.chunk`` does: the test holds the
  port to ``ceil(n / m)`` rows on the first ranks and the rest, possibly
  none, on the last.
* ``shard`` is a no-op without rules and on a plain tensor, and
  ``placements`` maps a spec to DTensor placements (a dimension over two
  mesh axes: ``Shard`` on both, the first the major).
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from torch.utils import _pytree as pytree

from repro.configs import ASSIGNED as JASSIGNED, get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import sharding as jsharding
from repro.models.transformer import cache_specs as jcache_specs
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.launch.dryrun import _cache_axes, serve_rules
from repro_torch.models import build_model, sharding
from repro_torch.models.transformer import cache_specs

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SIZES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
         "4x2": {"data": 4, "model": 2}, "2x2x2": {"pod": 2, "data": 2, "model": 2}}
HOST_MESHES = ["4x2", "2x2x2"]


def _jax_serve_rules():
    """JAX's ``serve_rules``: ``repro.launch.dryrun`` sets ``XLA_FLAGS`` when
    it is imported, so the import leaves this process's environment as it was."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import serve_rules as jserve
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jserve


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def _jax_param_specs(arch):
    model = jbuild_model(jget_config(arch))
    captured = {}

    def f(r):
        params, specs = model.init(r)
        captured["specs"] = specs
        return params

    shapes = jax.eval_shape(f, jax.random.PRNGKey(0))
    return shapes, captured["specs"]


@pytest.fixture(scope="module")
def trees():
    """Per arch: JAX's and the port's parameter leaves as (key path, shape,
    logical axes), and both packages' cache specs."""
    out = {}
    for arch in ASSIGNED:
        jshapes, jspecs = _jax_param_specs(arch)
        jleaves = jax.tree_util.tree_leaves_with_path(jspecs, is_leaf=_is_axes)
        jshape_leaves = jax.tree_util.tree_leaves(jshapes)
        shapes, specs = build_model(get_config(arch)).init(None, device="meta")
        leaves = pytree.tree_leaves_with_path(specs, is_leaf=_is_axes)
        out[arch] = {
            "jax": [(jax.tree_util.keystr(p), tuple(s.shape), a) for (p, a), s in zip(jleaves, jshape_leaves)],
            "port": [(pytree.keystr(p), tuple(s.shape), a)
                     for (p, a), s in zip(leaves, pytree.tree_leaves(shapes))],
        }
    return out


def test_the_assigned_archs_are_the_same():
    assert list(ASSIGNED) == list(JASSIGNED)


@pytest.mark.parametrize("mesh", sorted(SIZES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_rules_equal_jax(arch, mesh):
    cfg, jcfg, sizes = get_config(arch), jget_config(arch), SIZES[mesh]
    assert sharding.cohort_rules(cfg, sizes) == jsharding.cohort_rules(jcfg, sizes)
    assert sharding.silo_rules(cfg, sizes) == jsharding.silo_rules(jcfg, sizes)
    jserve = _jax_serve_rules()
    for kind in ("prefill", "decode"):
        assert serve_rules(cfg, sizes, kind) == jserve(jcfg, sizes, kind)


def _rule_sets(arch, sizes):
    cfg = get_config(arch)
    return {"cohort": sharding.cohort_rules(cfg, sizes), "silo": sharding.silo_rules(cfg, sizes),
            "serve-decode": serve_rules(cfg, sizes, "decode")}


@pytest.mark.parametrize("mesh", sorted(SIZES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_every_parameter_spec_equals_jax(trees, arch, mesh):
    t = trees[arch]
    assert {k: (s, a) for k, s, a in t["port"]} == {k: (s, a) for k, s, a in t["jax"]}
    for name, rules in _rule_sets(arch, SIZES[mesh]).items():
        for key, _, axes in t["port"]:
            want = tuple(jsharding.logical_to_spec(axes, rules))
            assert sharding.logical_to_spec(axes, rules) == want, (name, key)


@pytest.mark.parametrize("mesh", sorted(SIZES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_every_cache_spec_equals_jax(arch, mesh):
    cfg, jcfg = get_config(arch), jget_config(arch)
    if cfg.family == "encdec":  # both dry runs spell the enc-dec's axes out (JAX's build_serve_program)
        ports = pytree.tree_leaves(_cache_axes(cfg, None), is_leaf=_is_axes)
        assert ports == [("layers", "batch", "cache_seq", "kv_heads", "head_dim")] * 2 + [("layers",)] + \
            [("layers", "batch", "enc_seq", "kv_heads", "head_dim")] * 2
    else:
        ports = pytree.tree_leaves(cache_specs(cfg), is_leaf=_is_axes)
        assert ports == jax.tree_util.tree_leaves(jcache_specs(jcfg), is_leaf=_is_axes)
    rules = serve_rules(cfg, SIZES[mesh], "decode")
    for axes in ports:
        assert sharding.logical_to_spec(axes, rules) == tuple(jsharding.logical_to_spec(axes, rules))


_PORT_SHAPES = textwrap.dedent("""
    import json, sys, itertools
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils import _pytree as pytree
    from repro_torch.configs import ASSIGNED, get_config
    from repro_torch.launch import make_mesh
    from repro_torch.launch.dryrun import serve_rules
    from repro_torch.models import build_model
    from repro_torch.models.sharding import cohort_rules, is_axes, local_shape, logical_to_spec, silo_rules
    out = {}
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    for name in sys.argv[1:]:
        dims = tuple(int(x) for x in name.split("x"))
        mesh = make_mesh(dims, ("pod", "data", "model")[-len(dims):], device="cpu")
        sizes = dict(zip(mesh.mesh_dim_names, dims))
        for arch in ASSIGNED:
            cfg = get_config(arch)
            shapes, specs = build_model(cfg).init(None, device="meta")
            leaves = pytree.tree_leaves_with_path(specs, is_leaf=is_axes)
            for rname, rules in (("cohort", cohort_rules(cfg, sizes)), ("silo", silo_rules(cfg, sizes)),
                                 ("serve-decode", serve_rules(cfg, sizes, "decode"))):
                for (path, axes), t in zip(leaves, pytree.tree_leaves(shapes)):
                    spec = logical_to_spec(axes, rules)
                    out["|".join((name, arch, rname, pytree.keystr(path)))] = [
                        local_shape(t.shape, spec, mesh, c) for c in itertools.product(*(range(n) for n in dims))]
    dist.destroy_process_group()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def port_shapes():
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _PORT_SHAPES, *HOST_MESHES], env=env, capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh", HOST_MESHES)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_shard_shapes_equal_jax_on_the_host_devices(trees, port_shapes, arch, mesh):
    """Where JAX lays a leaf out, every rank's shard has JAX's shard shape;
    where JAX refuses (a dimension that does not divide), the port splits it
    as ``torch.chunk`` does."""
    dims = tuple(int(x) for x in mesh.split("x"))
    names = ("pod", "data", "model")[-len(dims):]
    jmesh = jax.make_mesh(dims, names, devices=jax.devices()[: math.prod(dims)])
    for rname, rules in _rule_sets(arch, SIZES[mesh]).items():
        for key, shape, axes in trees[arch]["port"]:
            spec = sharding.logical_to_spec(axes, rules)
            got = [tuple(s) for s in port_shapes["|".join((mesh, arch, rname, key))]]
            try:
                want = NamedSharding(jmesh, P(*spec)).shard_shape(shape)
            except ValueError:  # JAX refuses; DTensor chunks
                m = [math.prod(dict(zip(names, dims))[a] for a in ((e,) if isinstance(e, str) else e))
                     if e is not None else 1 for e in spec]
                assert got[0] == tuple(-(-n // k) for n, k in zip(shape, m)), (rname, key)
                assert len(got) == math.prod(dims)
                continue
            assert all(g == tuple(want) for g in got), (rname, key, got, want)


def test_shard_is_a_no_op_without_rules_and_on_plain_tensors():
    x = torch.randn(2, 3, 4)
    assert sharding.shard(x, "batch", "seq", "act_embed") is x
    with sharding.use_rules({"batch": "data", "seq": None, "act_embed": None}):
        assert sharding.shard(x, "batch", "seq", "act_embed") is x
        assert sharding.current_rules() == {"batch": "data", "seq": None, "act_embed": None}
    assert sharding.current_rules() is None
    assert sharding.logical_to_spec(("batch", "seq")) == (None, None)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert sharding.placements((("pod", "data"), None, "model"), Mesh()) == [Shard(0), Shard(0), Shard(2)]
    assert sharding.placements((None, "data"), Mesh()) == [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError):
        sharding.placements((("data", "pod"),), Mesh())
    # a spec axis the (sub-)mesh lacks is left out
    Mesh.mesh_dim_names = ("model",)
    assert sharding.placements(("data", "model"), Mesh()) == [Shard(1)]
