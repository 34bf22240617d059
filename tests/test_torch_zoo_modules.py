"""The model zoo's MLA, MoE, SSM and enc-dec modules in the port against
the JAX package's functions at smoke size, on the same inputs from a numpy
seed and JAX's parameters (converted): MLA (absorbed or not, chunked with
several blocks, five decode steps), MoE (einsum and scatter, the routing's
experts equal exactly, tied router probabilities going to the lowest index,
capacity drops), the chunked SSD (several chunks, a padded tail, a carried
state) and its recurrent decode, the enc-dec encoder and decode step; then
the reference's sliding-window caveat, and decode past the cache.

Float32 tolerance: ``F32_TOL`` (rtol = atol = 1e-4; the packages sum the same
products in other orders, seen gaps are below 5e-5).  Routing, tokens and
cache positions are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as japi, encdec as jencdec, layers as jlayers, mla as jmla, moe as jmoe, ssm as jssm
from repro_torch.convert import caches_from_jax, lm_params_from_jax
from repro_torch.models import encdec, mla, moe, ssm
from repro_torch.models.api import build_model
from torch_zoo_common import F32_TOL, assert_caches_close, clone, close, configs, jbuild_model, jparams, jx
from torch_zoo_common import np_batch, np_normal, tc, tt


# --------------------------------------------------------------------- MLA --


def _mla_setup(S=24, **over):
    jcfg, cfg = configs("deepseek-v3-671b", **over)
    jp, p = jparams(jmla.mla_init, jcfg)
    x = np_normal((2, S, jcfg.d_model), 20)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (2, S))
    return jcfg, cfg, jp, p, x, pos


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("impl", ["einsum", "chunked"])
def test_mla_apply_equals_jax(absorb, impl):
    jcfg, cfg, jp, p, x, pos = _mla_setup(mla_absorb=absorb)
    jy, jc = jax.jit(jmla.mla_apply, static_argnums=(2, 4, 5, 6))(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), "prefill", 0,
                                                                   impl)
    y, c = mla.mla_apply(p, tt(x), cfg, tt(pos), "prefill", 0, impl)
    close(y, jy)
    assert_caches_close(caches_from_jax(jc, "cpu"), c, **F32_TOL)


@pytest.mark.parametrize("window", [0, 16])
def test_mla_attend_chunked_blocks_equal_jax(window):
    jcfg, cfg, jp, p, x, pos = _mla_setup(S=64)
    jl = jax.jit(jmla._latents, static_argnums=2)(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    lat = mla._latents(p, tt(x), cfg, tt(pos))
    for a, b in zip(lat, jl):
        close(a, b)
    ref = jax.jit(jmla._mla_attend_chunked, static_argnums=(5, 6, 7, 8))(jp, *jl, jcfg, window, 16, 16)
    close(mla._mla_attend_chunked(p, *lat, cfg, window, chunk_q=16, chunk_k=16), ref)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("absorb", [False, True])
def test_mla_decode_equals_jax(absorb, window):
    jcfg, cfg, jp, p, x, pos = _mla_setup(S=20, mla_absorb=absorb)
    _, jc = jax.jit(jmla.mla_apply, static_argnums=(2, 4, 5))(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), "prefill", window)
    if window == 0:
        jc = jmla.MLACache(*(jnp.pad(a, ((0, 0), (0, 8), (0, 0))) for a in jc[:2]), jc.pos)
    c = caches_from_jax(jc, "cpu")
    jdecode = jax.jit(jmla.mla_decode, static_argnums=(2, 4))
    for step in range(5):
        xs = np_normal((2, 1, jcfg.d_model), 40 + step)
        jy, jc = jdecode(jp, jnp.asarray(xs), jcfg, jc, window)
        y, c = mla.mla_decode(p, tt(xs), cfg, c, window)
        close(y, jy)
        assert_caches_close(caches_from_jax(jc, "cpu"), c, **F32_TOL)


# --------------------------------------------------------------------- MoE --


def _moe_setup(arch="qwen3-moe-30b-a3b", tie=False, **over):
    jcfg, cfg = configs(arch, **over)
    pb = jlayers.ParamBuilder(jax.random.PRNGKey(0), jnp.float32)
    jmoe.moe_init(pb, jcfg)
    jp = jax.tree.map(np.asarray, pb.params)
    if tie:  # experts 1 and 3 share a router column, 0 and 2 another: ties in every row
        r = np.array(jp["router"])
        r[:, 3], r[:, 2] = r[:, 1], r[:, 0]
        jp["router"] = r
    p = lm_params_from_jax(jp, "cpu")
    x = np_normal((2, 16, jcfg.d_model), 21)
    return jcfg, cfg, jax.tree.map(jnp.asarray, jp), p, x


def _jroute(jp, x, jcfg):
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, x.shape[-1])) @ jp["router"], axis=-1)
    return jax.lax.top_k(probs, jcfg.moe_top_k)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v3-671b"])
def test_moe_equals_jax(arch, impl, tie):
    """Output and aux within ``F32_TOL``; routing (the top-k's experts) equal
    exactly, with tied router probabilities in every row when ``tie``."""
    jcfg, cfg, jp, p, x = _moe_setup(arch, tie, moe_impl=impl)
    jy, jaux = (jmoe.moe_apply_scatter if impl == "scatter" else jmoe.moe_apply_einsum)(jp, jnp.asarray(x), jcfg)
    y, aux = (moe.moe_apply_scatter if impl == "scatter" else moe.moe_apply_einsum)(p, tt(x), cfg)
    close(y, jy)
    close(aux, jaux)
    _, jidx = _jroute(jp, x, jcfg)
    _, idx, _, _ = moe.route(p, tt(x).reshape(-1, x.shape[-1]), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    if tie:  # the ties are real, and lax.top_k puts the lower index first
        probs = torch.softmax(tt(x).reshape(-1, x.shape[-1]) @ p["router"], -1)
        assert torch.equal(probs[:, 1], probs[:, 3]) and torch.equal(probs[:, 0], probs[:, 2])
        assert bool((idx[:, 0] < idx[:, 1]).all())


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_moe_capacity_drops_equal_jax(impl):
    """capacity_factor 0.5: tokens over an expert's capacity drop, as JAX
    drops them (the same capacity, computed in Python)."""
    jcfg, cfg, jp, p, x = _moe_setup(capacity_factor=0.5, moe_impl=impl)
    assert moe.capacity(32, cfg) == max(1, int(32 * jcfg.moe_top_k / jcfg.n_experts * 0.5))
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_apply(p, tt(x), cfg)
    close(y, jy)
    close(aux, jaux)


# --------------------------------------------------------------------- SSM --


@pytest.mark.parametrize("S,chunk,init", [(64, 16, False), (40, 16, False), (64, 64, True)])
def test_ssd_chunked_equals_jax(S, chunk, init):
    """Several chunks, a padded tail (40 of 48) and a carried initial state."""
    rng = np.random.default_rng(S + chunk)
    b, H, P, G, N = 2, 4, 8, 2, 8
    args = (rng.normal(size=(b, S, H, P)), rng.uniform(0.01, 0.3, (b, S, H)), -rng.uniform(0.5, 1, (H,)),
            rng.normal(size=(b, S, G, N)), rng.normal(size=(b, S, G, N)))
    args = [a.astype(np.float32) for a in args]
    s0 = rng.normal(size=(b, H, N, P)).astype(np.float32) if init else None
    jy, jf = jax.jit(jssm.ssd_chunked, static_argnums=(5, 7))(*map(jnp.asarray, args), chunk,
                                                             None if s0 is None else jnp.asarray(s0), True)
    y, f = ssm.ssd_chunked(*map(tt, args), chunk, None if s0 is None else tt(s0), True)
    close(y, jy)
    close(f, jf)


def test_ssm_decode_equals_jax():
    """Five recurrent steps from JAX's prefill cache (S = 21, not a multiple
    of the chunk): the conv ring and the state written in place."""
    jcfg, cfg = configs("mamba2-130m")
    jp, p = jparams(jssm.ssm_init, jcfg)
    jp = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(np_normal(a.shape, 50)), jp)  # nonzero A_log, dt_bias, conv_b
    p = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np_normal((2, 21, jcfg.d_model), 51)
    jy, jc = jax.jit(jssm.ssm_apply, static_argnums=(2, 3))(jp, jnp.asarray(x), jcfg, "prefill")
    y, c = ssm.ssm_apply(p, tt(x), cfg, "prefill")
    close(y, jy)
    assert_caches_close(caches_from_jax(jc, "cpu"), c, **F32_TOL)
    jdecode = jax.jit(jssm.ssm_decode, static_argnums=2)
    for step in range(5):
        xs = np_normal((2, 1, jcfg.d_model), 60 + step)
        jy, jc = jdecode(jp, jnp.asarray(xs), jcfg, jc)
        y, c = ssm.ssm_decode(p, tt(xs), cfg, c)
        close(y, jy)
        assert_caches_close(caches_from_jax(jc, "cpu"), c, **F32_TOL)


# ------------------------------------------------------------------ encdec --


def _encdec_setup():
    jcfg, cfg = configs("whisper-base")
    jp, _ = jencdec.encdec_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_encdec_encode_equals_jax():
    jcfg, cfg, jp, p = _encdec_setup()
    frames = np_normal((2, jcfg.enc_len, jcfg.d_model), 70)
    close(encdec.encdec_encode(p, cfg, tt(frames)),
          jax.jit(jencdec.encdec_encode, static_argnums=1)(jp, jcfg, jnp.asarray(frames)))


def test_encdec_decode_step_equals_jax():
    jcfg, cfg, jp, p = _encdec_setup()
    batch = np_batch(jcfg, with_labels=False)
    _, jc = jax.jit(japi.build_model(jcfg).prefill)(jp, jx(batch))
    c = caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    tok = np.array([[3], [7]], np.int32)
    jdecode = jax.jit(jencdec.encdec_decode_step, static_argnums=1)
    for _ in range(3):
        jl, jc = jdecode(jp, jcfg, jnp.asarray(tok), jc)
        lg, c = encdec.encdec_decode_step(p, cfg, tt(tok), c)
        close(lg, jl)
        assert_caches_close(caches_from_jax(jax.tree.map(np.asarray, jc), "cpu"), c, **F32_TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)


# --------------------------------------------- the reference's caveats --


@pytest.mark.parametrize("S", [32, 20])
def test_sliding_window_decode_equals_jax(S):
    """Window 16 on the smoke gemma: the port's decode after prefill equals
    JAX's at S = 32 and at S = 20.  The reference's caveat: its prefill keeps
    the last 16 keys at slots 0..15 and decode then writes slot S % 16, which
    evicts the wrong key unless S is a multiple of the window; against the
    windowed forward, decode agrees at S = 32 and misses by O(1) at S = 20
    (1.50 seen), in both packages alike."""
    jcfg, cfg = configs("gemma-2b", sliding_window=16)
    jm, m = jbuild_model(jcfg, window=16), build_model(cfg, window=16)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    p = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = np_batch(jcfg, with_labels=False, S=S)
    jlp, jc = jax.jit(jm.prefill)(jp, jx(batch))
    lp, c = m.prefill(p, tc(batch))
    close(lp, jlp)
    tok = jnp.argmax(jlp[:, -1:], -1).astype(jnp.int32)
    jld, _ = jax.jit(jm.decode)(jp, tok, jc)
    ld, _ = m.decode(p, tt(tok), c)
    close(ld, jld)
    full = np.concatenate([batch["tokens"], np.asarray(tok)], 1)
    gap = float(np.max(np.abs(np.asarray(jld[:, 0]) - np.asarray(jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(full)})[:, -1]))))
    port_gap = float((ld[:, 0] - m.forward(p, {"tokens": tt(full)})[:, -1]).abs().max())
    if S % 16 == 0:
        assert gap < 2e-3 and port_gap < 2e-3
    else:
        assert gap > 0.1 and port_gap > 0.1


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v3-671b", "whisper-base"])
def test_decode_past_the_cache_raises(arch):
    """A cache without a window holds ``max_len`` tokens: the next decode
    raises ``ValueError`` (JAX drops that write silently), and nothing is
    written."""
    _, cfg = configs(arch)
    m = build_model(cfg)
    p, _ = m.init(torch.Generator().manual_seed(0))
    batch = tc(np_batch(cfg, with_labels=False, S=8))
    _, c = m.prefill(p, batch, max_len=9)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    _, c = m.decode(p, tok, c)
    before = clone(c)
    with pytest.raises(ValueError, match="past the cache"):
        m.decode(p, tok, c)
    assert_caches_close(before, c, rtol=0, atol=0)
