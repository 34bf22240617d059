"""The model zoo's configs and parameter trees at full size, and its layers
and attention in the port against the JAX package's functions at smoke size
(MLA, MoE, SSM, enc-dec: ``test_torch_zoo_modules.py``).

* configs: every field, ``smoke_variant``, ``n_params`` / ``n_active_params``,
  ``INPUT_SHAPES`` and ``ASSIGNED`` equal JAX's;
* shapes without memory: each full config's parameter tree on the ``meta``
  device equals ``jax.eval_shape`` of JAX's ``init`` in names, shapes, dtypes
  and logical-axis specs, and ``input_specs`` / ``cache_specs`` equal JAX's;
* the parameter builder's stacks and the conversion of JAX's trees;
* modules, on the same inputs from a numpy seed and JAX's parameters
  (converted): norms, the four MLP activations, RoPE / M-RoPE / sinusoidal
  positions, attention (einsum and chunked, window 0 and 16, decode, cross).

Float32 tolerance: ``F32_TOL`` (rtol = atol = 1e-4; the packages sum the same
products in other orders, seen gaps are below 5e-5).  Routing, masks, tokens
and cache positions are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import ASSIGNED as JASSIGNED, INPUT_SHAPES as JINPUT_SHAPES
from repro.models import api as japi, attention as jattn, layers as jlayers, transformer as jtr
from repro_torch.configs import ASSIGNED, INPUT_SHAPES, get_config, smoke_variant
from repro_torch.convert import caches_from_jax, lm_params_from_jax, lm_params_to_numpy
from repro_torch.models import attention, input_specs, layers, transformer
from repro_torch.models.api import build_model
from torch_zoo_common import F32_TOL, assert_caches_close, close, configs, jbuild_model, jget_config, jparams
from torch_zoo_common import jsmoke_variant, np_normal, tt


# ----------------------------------------------------------------- configs --


@pytest.mark.parametrize("arch", ASSIGNED)
def test_config_equals_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(smoke_variant(cfg)) == dataclasses.asdict(jsmoke_variant(jcfg))
    assert cfg.n_params() == jcfg.n_params() and cfg.n_active_params() == jcfg.n_active_params()
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim


def test_registry_lists_equal_jax():
    assert ASSIGNED == JASSIGNED
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JINPUT_SHAPES.items()}


def _named(tree):
    """``{"['a']['b']": leaf}`` of a nested dict (JAX's ``keystr`` form)."""
    return {"".join(f"['{k.key}']" for k in path): v for path, v in pytree.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_tree_on_meta_equals_eval_shape(arch):
    """The full config's tree, made on ``meta`` (no memory), against
    ``jax.eval_shape`` of JAX's ``init``: names, shapes, dtypes and specs."""
    cfg = get_config(arch)
    box = {}

    def jinit(key):
        params, box["specs"] = jbuild_model(jget_config(arch)).init(key)
        return params

    shapes = jax.eval_shape(jinit, jax.random.PRNGKey(0))
    params, specs = build_model(cfg).init(torch.Generator(), device="meta")
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)) for k, v in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in _named(params).items()}
    assert got == want
    assert specs == box["specs"]
    assert all(v.device.type == "meta" for v in _named(params).values())


def _leaves(tree):
    """Tensors / shape-dtype stand-ins of an input or cache tree, with each
    cache's ``pos`` (JAX: an array of zeros; the port: the int 0) taken out."""
    if isinstance(tree, dict):
        return {k: _leaves(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        pos = tree.pos
        assert (pos == 0) if isinstance(pos, int) else tuple(pos.shape) in ((), (tree[0].shape[0],))
        return tuple(_leaves(v) for v in tree[:-1])
    if isinstance(tree, tuple):
        return tuple(_leaves(v) for v in tree)
    return tuple(tree.shape), str(tree.dtype).split(".")[-1]


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_specs_equal_jax(arch, shape):
    got = input_specs(get_config(arch), INPUT_SHAPES[shape])
    want = japi.input_specs(jget_config(arch), JINPUT_SHAPES[shape])
    assert _leaves(got) == _leaves(want)
    assert all(v.device.type == "meta" for v in pytree.tree_leaves(got) if isinstance(v, torch.Tensor))


@pytest.mark.parametrize("arch", [a for a in ASSIGNED if get_config(a).family != "encdec"])
def test_segments_and_cache_specs_equal_jax(arch):
    """The decoder stack's segments and cache axes (the enc-dec stack has
    neither, in both packages)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert transformer.segments_of(cfg) == jtr.segments_of(jcfg)
    got, want = transformer.cache_specs(cfg), jtr.cache_specs(jcfg)
    assert got.keys() == want.keys()
    for k in got:
        assert type(got[k]).__name__ == type(want[k]).__name__ and tuple(got[k]) == tuple(want[k])


def test_param_builder_stacks_layers_and_experts():
    """``stack=n`` gives ``(n, ...)`` leaves with ``"layers"`` first; each
    layer (and each expert block) is its own draw; zeros/ones stack too."""
    pb = layers.ParamBuilder(torch.Generator().manual_seed(0))
    st = pb.child("seg", stack=3)
    w = st.p("w", (4, 200, 300), ("experts", "embed", "mlp"), fan_in=200)
    o = st.p("o", (5,), ("embed",), init="ones")
    assert w.shape == (3, 4, 200, 300) and o.shape == (3, 5) and torch.equal(o, torch.ones(3, 5))
    assert pb.specs == {"seg": {"w": ("layers", "experts", "embed", "mlp"), "o": ("layers", "embed")}}
    blocks = w.reshape(12, -1)
    assert not any(torch.equal(blocks[i], blocks[j]) for i in range(12) for j in range(i))
    assert abs(float(w.std()) * np.sqrt(200) - 1) < 0.01
    meta = layers.ParamBuilder(torch.Generator(), torch.bfloat16, device="meta").child("s", stack=2)
    m = meta.p("w", (7, 9), ("a", "b"))
    assert m.device.type == "meta" and m.dtype == torch.bfloat16 and m.shape == (2, 7, 9)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_lm_params_round_trip(dtype):
    """JAX's tree crosses bit for bit (bf16 through its bits) and comes back."""
    jcfg, _ = configs("gemma-2b", dtype=jnp.dtype(dtype).name)
    jp, _ = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    ported = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    back = _named(lm_params_to_numpy(ported))
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert back.keys() == want.keys()
    for k, v in want.items():
        assert _named(ported)[k].dtype == getattr(torch, jnp.dtype(dtype).name)
        assert back[k].dtype == np.float32 and np.array_equal(back[k], v.astype(np.float32)), k


def test_caches_from_jax_refuses_unequal_positions():
    c = jattn.KVCache(np.zeros((2, 1, 3, 1, 4), np.float32), np.zeros((2, 1, 3, 1, 4), np.float32),
                      np.array([3, 4], np.int32))
    with pytest.raises(ValueError, match="different positions"):
        caches_from_jax({"seg0": c}, "cpu")
    assert caches_from_jax({"seg0": c._replace(pos=np.array([3, 3], np.int32))}, "cpu")["seg0"].pos == 3


# ------------------------------------------------------------------ layers --


@pytest.mark.parametrize("kind", ["rmsnorm", "rmsnorm_plus_one", "layernorm"])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_norms_equal_jax(kind, dtype):
    x, w, b = np_normal((2, 5, 64), 1, 3.0), np_normal((64,), 2), np_normal((64,), 3)
    jxv = jnp.asarray(x, dtype)
    tx = lm_params_from_jax({"x": np.asarray(jxv)}, "cpu")["x"]
    if kind == "layernorm":
        ref, got = jlayers.layernorm(jxv, jnp.asarray(w), jnp.asarray(b)), layers.layernorm(tx, tt(w), tt(b))
    else:
        po = kind.endswith("plus_one")
        ref, got = jlayers.rmsnorm(jxv, jnp.asarray(w), 1e-5, po), layers.rmsnorm(tx, tt(w), 1e-5, po)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    # bf16: both round the same float32 value once
    close(got, np.asarray(ref).astype(np.float32), **(F32_TOL if dtype == np.float32 else dict(rtol=0, atol=0)))


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu", "sqrelu"])
def test_mlp_equals_jax(act):
    pb = jlayers.ParamBuilder(jax.random.PRNGKey(1), jnp.float32)
    jlayers.mlp_init(pb, 64, 96, act)
    p = lm_params_from_jax(jax.tree.map(np.asarray, pb.params), "cpu")
    x = np_normal((2, 7, 64), 4)
    close(layers.mlp_apply(p, tt(x), act), jlayers.mlp_apply(pb.params, jnp.asarray(x), act))


def test_rope_equals_jax():
    x = np_normal((2, 9, 3, 16), 5)
    pos = np.random.default_rng(6).integers(0, 5000, (2, 9)).astype(np.int32)
    close(layers.apply_rope(tt(x), tt(pos), 500000.0), jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))


def test_mrope_equals_jax():
    x = np_normal((2, 9, 3, 64), 7)
    pos3 = np.random.default_rng(8).integers(0, 100, (3, 2, 9)).astype(np.int32)
    got = layers.apply_mrope(tt(x), tt(pos3), 1e6, (8, 12, 12))
    close(got, jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, (8, 12, 12)))


def test_sinusoidal_positions_equal_jax():
    close(layers.sinusoidal_positions(1500, 512), jlayers.sinusoidal_positions(1500, 512))


def test_vlm_positions_equal_jax():
    jcfg, cfg = configs("qwen2-vl-72b")
    got = transformer.vlm_positions(cfg, 2, 40)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtr.vlm_positions(jcfg, 2, 40)))


# --------------------------------------------------------------- attention --


def _attn_setup(arch="gemma-2b", S=32, seed=0, **over):
    jcfg, cfg = configs(arch, **over)
    jp, p = jparams(jattn.attn_init, jcfg, seed=seed)
    x = np_normal((2, S, jcfg.d_model), 10 + seed)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (2, S))
    return jcfg, cfg, jp, p, x, pos


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("impl", ["einsum", "chunked"])
def test_attn_apply_equals_jax(impl, window):
    jcfg, cfg, jp, p, x, pos = _attn_setup("llama3-405b")
    jy, jc = jattn.attn_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), "prefill", window, impl)
    y, c = attention.attn_apply(p, tt(x), cfg, tt(pos), "prefill", window, impl)
    close(y, jy)
    assert_caches_close(caches_from_jax(jc, "cpu"), c, **F32_TOL)


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("window", [0, 16])
def test_chunked_sdpa_blocks_equal_jax(window, softcap):
    """Several q and kv chunks (16 of 64), so the running-softmax carry crosses
    blocks and whole blocks are masked."""
    q, k, v = np_normal((2, 64, 4, 16), 11), np_normal((2, 64, 2, 16), 12), np_normal((2, 64, 2, 16), 13)
    ref = jattn._chunked_sdpa(*map(jnp.asarray, (q, k, v)), True, window, softcap, chunk_q=16, chunk_k=16)
    got = attention._chunked_sdpa(tt(q), tt(k), tt(v), True, window, softcap, chunk_q=16, chunk_k=16)
    close(got, ref)
    dense = attention._sdpa(tt(q), tt(k), tt(v), attention._causal_mask(64, 64, 0, window)[None, None], softcap)
    close(got, dense.numpy())


def test_causal_mask_equals_jax():
    for window in (0, 5):
        np.testing.assert_array_equal(attention._causal_mask(12, 20, 8, window).numpy(),
                                      np.asarray(jattn._causal_mask(12, 20, 8, window)))


@pytest.mark.parametrize("window", [0, 16])
def test_attn_decode_equals_jax(window):
    """Five steps from JAX's prefill cache (S = 20: the window's ring wraps),
    with softcap on; the port's cache written in place equals JAX's new one."""
    jcfg, cfg, jp, p, x, pos = _attn_setup("gemma-2b", S=20, attn_logit_softcap=50.0)
    _, jc = jattn.attn_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), "prefill", window)
    if window == 0:  # room for the steps, as prefill's margin gives
        jc = jattn.KVCache(*(jnp.pad(a, ((0, 0), (0, 8), (0, 0), (0, 0))) for a in jc[:2]), jc.pos)
    c = caches_from_jax(jc, "cpu")
    for step in range(5):
        xs = np_normal((2, 1, jcfg.d_model), 30 + step)
        jy, jc = jattn.attn_decode(jp, jnp.asarray(xs), jcfg, jc, window)
        y, c = attention.attn_decode(p, tt(xs), cfg, c, window)
        close(y, jy)
        assert_caches_close(caches_from_jax(jc, "cpu"), c, **F32_TOL)


def test_cross_attention_equals_jax():
    jcfg, cfg, jp, p, x, pos = _attn_setup("whisper-base", S=8)
    k, v = np_normal((2, 24, jcfg.n_kv_heads, 64), 14), np_normal((2, 24, jcfg.n_kv_heads, 64), 15)
    jy, _ = jattn.attn_apply(jp, jnp.asarray(x), jcfg, None, cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    y, _ = attention.attn_apply(p, tt(x), cfg, None, cross_kv=(tt(k), tt(v)))
    close(y, jy)
    jy, _ = jattn.attn_decode(jp, jnp.asarray(x[:, :1]), jcfg, None, cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    y, _ = attention.attn_decode(p, tt(x[:, :1]), cfg, None, cross_kv=(tt(k), tt(v)))
    close(y, jy)
