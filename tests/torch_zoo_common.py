"""Shared drivers of the model zoo tests (``tests/test_torch_zoo*.py``): the
same smoke-size inputs, made from a numpy seed, through the JAX package's
model and the port's, with the port's parameters converted from JAX's."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config, smoke_variant as jsmoke_variant
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models.transformer import vlm_positions as jvlm_positions
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import caches_from_jax, lm_params_from_jax
from repro_torch.models import build_model

B, S = 2, 32
DECODE_STEPS = 3
# float32 end to end: the two packages sum the same products in other orders
# (XLA's dots against ATen's); the largest gap seen over the ten smoke archs
# is 1.5e-5 on the logits and 4.7e-5 on a cache leaf (zamba2's SSM state)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bfloat16 end to end: every op rounds to 8 significant bits (a step of 2^-8
# relative), and XLA fuses ops (one rounding) where ATen runs them apart (one
# each), so the gap grows to a few steps at the logits' scale (|logits| < 4):
# 0.054 on the logits and 0.0625 on a cache leaf seen for the gemma and
# qwen3-moe smokes; the bound is twice that
BF16_TOL = dict(rtol=0.03, atol=0.125)


def configs(arch, dtype=None, **over):
    """The JAX and port smoke configs of ``arch`` (MoE at JAX's dropless
    ``capacity_factor=64``, as its consistency test runs it)."""
    jcfg, cfg = jsmoke_variant(jget_config(arch)), smoke_variant(get_config(arch))
    if jcfg.family == "moe":
        over.setdefault("capacity_factor", 64.0)
    if dtype is not None:
        over.update(dtype=dtype, param_dtype=dtype)
    return dataclasses.replace(jcfg, **over), dataclasses.replace(cfg, **over)


def np_batch(cfg, with_labels=True, seed=0, S=S):
    """The inputs of ``tests/test_models.py``'s ``_batch`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": tok}
    if with_labels:
        batch["labels"] = tok
    if cfg.family == "vlm":
        P = cfg.n_patches
        batch["tokens"] = tok[:, : S - P]
        if with_labels:
            batch["labels"] = tok[:, : S - P]
        batch["patch_embeds"] = rng.normal(size=(B, P, cfg.d_patch)).astype(np.float32)
        batch["positions"] = np.asarray(jvlm_positions(cfg, B, S))
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return batch


def jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tc(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float32) if np.asarray(a).dtype.name == "bfloat16"
                        else np.asarray(a), tree)


def clone(tree):
    """A copy of a port cache tree (its decode writes in place)."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        leaves = [clone(v) for v in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(leaves)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def run_both(jcfg, cfg, window=0, steps=DECODE_STEPS, seed=0):
    """Everything the end-to-end tests compare, from both packages: the loss
    and its metrics, forward logits, prefill logits and caches, and
    ``steps`` greedy decode steps (the port decodes JAX's tokens)."""
    jm, m = jbuild_model(jcfg, window=window), build_model(cfg, window=window)
    jp, _ = jm.init(jax.random.PRNGKey(seed))
    p = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = np_batch(jcfg)
    out = {"jax": {}, "port": {}}
    jl, jmet = jax.jit(jm.loss)(jp, jx(batch))
    l, met = m.loss(p, tc(batch))
    out["jax"]["loss"], out["port"]["loss"] = (float(jl), {k: float(v) for k, v in jmet.items()}), \
        (float(l), {k: float(v) for k, v in met.items()})
    out["jax"]["forward"] = to_np(jax.jit(jm.forward)(jp, jx(batch)))
    out["port"]["forward"] = m.forward(p, tc(batch)).float().numpy()
    pbatch = {k: v for k, v in batch.items() if k != "labels"}
    jlp, jc = jax.jit(jm.prefill)(jp, jx(pbatch))
    lp, c = m.prefill(p, tc(pbatch))
    out["jax"]["prefill"], out["port"]["prefill"] = to_np(jlp), lp.float().numpy()
    out["jax"]["caches"] = caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    out["port"]["caches"] = clone(c)  # decode writes into c
    jdecode = jax.jit(jm.decode)
    tok = jnp.argmax(jlp[:, -1:], -1).astype(jnp.int32)
    jtoks, toks, jlogs, logs = [], [], [], []
    for _ in range(steps):
        ptok = torch.from_numpy(np.array(tok))
        jld, jc = jdecode(jp, tok, jc)
        ld, c = m.decode(p, ptok, c)
        jlogs.append(to_np(jld))
        logs.append(ld.float().numpy())
        tok = jnp.argmax(jld[:, -1:], -1).astype(jnp.int32)
        jtoks.append(np.asarray(tok))
        toks.append(torch.argmax(ld[:, -1:], -1).to(torch.int32).numpy())
    out["jax"]["decode"], out["port"]["decode"] = jlogs, logs
    out["jax"]["tokens"], out["port"]["tokens"] = jtoks, toks
    out["jax"]["decoded_caches"] = caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    out["port"]["decoded_caches"] = c
    return out


def assert_caches_close(jc, c, **tol):
    """Same structure, cache types, shapes and dtypes; ``pos`` equal; every
    tensor within ``tol``."""
    if isinstance(jc, dict):
        assert jc.keys() == c.keys()
        for k in jc:
            assert_caches_close(jc[k], c[k], **tol)
        return
    if isinstance(jc, tuple):
        assert type(jc) is type(c) and len(jc) == len(c), (type(jc), type(c))
        if hasattr(jc, "pos"):
            assert jc.pos == c.pos
        for a, b in zip(jc, c):
            if isinstance(a, torch.Tensor):
                assert_caches_close(a, b, **tol)
        return
    assert jc.shape == c.shape and jc.dtype == c.dtype, (jc.shape, c.shape, jc.dtype, c.dtype)
    np.testing.assert_allclose(c.float().numpy(), jc.float().numpy(), **tol)


# every comparison an end-to-end test makes, by name
CHECKS = ("loss", "forward", "prefill", "caches", "decode")


def check(out, what, tol=F32_TOL, tokens=True):
    """One comparison of ``run_both``'s output.  ``tokens=False`` skips the
    greedy tokens' equality (bf16 logits tie or part at the argmax; the
    port decodes JAX's tokens either way)."""
    j, p = out["jax"], out["port"]
    if what == "loss":
        np.testing.assert_allclose(p["loss"][0], j["loss"][0], **tol)
        assert p["loss"][1].keys() == j["loss"][1].keys()
        for k in j["loss"][1]:
            np.testing.assert_allclose(p["loss"][1][k], j["loss"][1][k], **tol, err_msg=k)
    elif what in ("forward", "prefill"):
        np.testing.assert_allclose(p[what], j[what], **tol)
    elif what == "caches":
        assert_caches_close(j["caches"], p["caches"], **tol)
    elif what == "decode":
        for a, b in zip(j["tokens"], p["tokens"]):
            if tokens:
                np.testing.assert_array_equal(b, a)
        for a, b in zip(j["decode"], p["decode"]):
            np.testing.assert_allclose(b, a, **tol)
        assert_caches_close(j["decoded_caches"], p["decoded_caches"], **tol)
    else:
        raise ValueError(what)


def np_normal(shape, seed=0, scale=1.0):
    """Standard normal float32 draws from a numpy seed."""
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def tt(a):
    return torch.from_numpy(np.array(a))


def close(port, ref, **tol):
    """A port tensor against a JAX or numpy reference (``F32_TOL`` unless given)."""
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32), **(tol or F32_TOL))


def jparams(init, cfg, seed=0):
    """A module ``init``'s parameters from JAX's builder, and the port's copy of them."""
    pb = jlayers.ParamBuilder(jax.random.PRNGKey(seed), jnp.float32)
    init(pb, cfg)
    return pb.params, lm_params_from_jax(jax.tree.map(np.asarray, pb.params), "cpu")


# -- training ------------------------------------------------------------------

# float32 gradients: the two packages sum the same products in other orders
# (XLA's dots against ATen's), and a gradient is a sum over every token of
# the batch; the largest gap seen over the ten smoke archs is 4.5e-6 on a
# gradient leaf (zamba2's tied embedding, 0.16 of this bound) and 3.8e-6 on
# the loss after the step.  gemma in bf16 parts by 0.026 on its embedding's
# gradient, within BF16_TOL
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
TRAIN_LR, TRAIN_MOMENTUM = 1e-2, 0.9  # tests/test_models.py's step


@functools.lru_cache(maxsize=None)
def train_both(arch, dtype=None, **over):
    """One training step in both packages, with ``remat=True`` in both
    configs, from JAX's parameters: the loss and its metrics, the gradients,
    the parameters after one ``sgd(TRAIN_LR, TRAIN_MOMENTUM)`` step and the
    loss there.  JAX's side is one jitted program."""
    from torch.func import grad_and_value

    from repro.optim import sgd as jsgd
    from repro_torch.optim import sgd

    jcfg, cfg = configs(arch, dtype, remat=True, **over)
    jm, m = jbuild_model(jcfg), build_model(cfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    p = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = np_batch(jcfg)
    jopt, opt = jsgd(TRAIN_LR, TRAIN_MOMENTUM), sgd(TRAIN_LR, TRAIN_MOMENTUM)

    def jstep(params, b):
        (loss, metrics), grads = jax.value_and_grad(jm.loss, has_aux=True)(params, b)
        new, _ = jopt.update(params, grads, jopt.init(params), 0)
        return loss, metrics, grads, new, jm.loss(new, b)[0]

    out = {"jax": dict(zip(("loss", "metrics", "grads", "new", "loss1"), jax.jit(jstep)(jp, jx(batch))))}
    grads, (loss, metrics) = grad_and_value(m.loss, has_aux=True)(p, tc(batch))
    new, _ = opt.update(p, grads, opt.init(p), 0)
    out["port"] = dict(loss=loss, metrics=metrics, grads=grads, new=new, loss1=m.loss(new, tc(batch))[0])
    return out


def assert_tree_close(got, want, **tol):
    """A port parameter tree against a JAX one, leaf by leaf by path."""
    from torch.utils import _pytree as pytree

    from repro_torch.convert import lm_params_to_numpy

    flat_g = pytree.tree_leaves_with_path(lm_params_to_numpy(got))
    flat_w = dict(pytree.tree_leaves_with_path(to_np(want)))
    assert len(flat_g) == len(flat_w)
    for path, a in flat_g:
        np.testing.assert_allclose(a, flat_w[path], **tol, err_msg=pytree.keystr(path))


def check_train(arch, what, dtype=None, tol=GRAD_TOL):
    """One comparison of ``train_both``: ``"grads"`` (the loss, its metrics
    and every gradient leaf) or ``"sgd"`` (the parameters after the step and
    the loss there)."""
    out = train_both(arch, dtype)
    j, p = out["jax"], out["port"]
    if what == "grads":
        np.testing.assert_allclose(float(p["loss"]), float(j["loss"]), **tol)
        assert p["metrics"].keys() == j["metrics"].keys()
        for k in j["metrics"]:
            np.testing.assert_allclose(float(p["metrics"][k]), float(j["metrics"][k]), **tol, err_msg=k)
        assert_tree_close(p["grads"], j["grads"], **tol)
    elif what == "sgd":
        assert_tree_close(p["new"], j["new"], **tol)
        assert np.isfinite(float(p["loss1"]))
        np.testing.assert_allclose(float(p["loss1"]), float(j["loss1"]), **tol)
    else:
        raise ValueError(what)
