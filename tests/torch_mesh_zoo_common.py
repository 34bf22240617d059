"""The JAX package's side of the mesh tests (``test_torch_mesh_zoo.py``,
``test_torch_mesh_zoo_rest.py``, ``test_torch_mesh_fl.py``): the inputs the
spawned ranks (``torch_mesh_zoo_ranks``, no JAX) replay, JAX's unsharded
references, and the comparisons, with the tolerances
``torch_zoo_common`` states."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro.configs import FLConfig as JFLConfig
from repro.core.selection import make_quota_schedule as jmake_quota_schedule
from repro.core.volatility import BernoulliVolatility as JBernoulli, paper_success_rates
from repro.fl import init_server_state as jinit_server_state, make_cohort_round as jmake_cohort_round
from repro.fl import make_silo_steps as jmake_silo_steps
from repro.models import build_model as jbuild_model
from repro_torch.convert import lm_params_from_jax
from torch_mesh_zoo_ranks import join_groups, start_groups, zoo_rank
from torch_zoo_common import F32_TOL, GRAD_TOL, configs, jx, np_batch, to_np

ARCHS = ["gemma-2b", "qwen3-moe-30b-a3b", "deepseek-v3-671b", "mamba2-130m", "zamba2-7b", "whisper-base",
         "qwen2-vl-72b"]
ARCHS_ATTN = ["gemma-2b", "qwen3-moe-30b-a3b", "deepseek-v3-671b", "qwen2-vl-72b"]  # test_torch_mesh_zoo.py
ARCHS_REST = ["mamba2-130m", "zamba2-7b", "whisper-base"]  # test_torch_mesh_zoo_rest.py
MESHES = {4: (2, 2), 2: (1, 2)}
LOGW_ATOL = 1e-6
STEPS = 3
FL_KW = dict(K=32, k=8, rounds=25, scheme="e3cs", lr=5e-3)
SILO_KW = dict(K=8, k=2, lr=1e-2, momentum=0.9)
TIMEOUT = 240


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _keyed(prefix, jtree):
    """JAX's tree keyed as the ranks key theirs (the port's key paths)."""
    port = lm_params_from_jax(_np_tree(jtree), "cpu")
    return {prefix + pytree.keystr(path): t.float().numpy() for path, t in pytree.tree_leaves_with_path(port)}


def _zoo_inputs(archs):
    inputs, refs = {}, {}
    for arch in archs:
        jcfg, _ = configs(arch)
        jm = jbuild_model(jcfg)
        jp, _ = jm.init(jax.random.PRNGKey(0))
        batch = np_batch(jcfg)
        inputs[arch] = {"params": _np_tree(jp), "batch": batch}
        refs[arch] = (jm, jp, batch)
    return inputs, refs


def _zoo_refs(refs):
    out = {}
    for arch, (jm, jp, batch) in refs.items():
        (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, jx(batch))
        pbatch = {k: v for k, v in batch.items() if k != "labels"}
        logits, caches = jax.jit(jm.prefill)(jp, jx(pbatch))
        tok, toks = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32), []
        for _ in range(STEPS):
            ld, caches = jax.jit(jm.decode)(jp, tok, caches)
            tok = jnp.argmax(ld[:, -1:], -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
        out[arch] = {"loss": float(loss), "grads": grads, "prefill": to_np(logits), "tokens": np.stack(toks)}
    return out


def _cohort_inputs():
    """Two rounds of ``make_cohort_round`` over the gemma smoke in JAX, and
    the draws and data the ranks replay them from."""
    from test_torch_fl_lm import _token_batches, _vol_rows

    jcfg, _ = configs("gemma-2b")
    jm = jbuild_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    jfl = JFLConfig(**FL_KW)
    rho = paper_success_rates(jfl.K)
    jvol = JBernoulli(jnp.asarray(rho))
    jselect, jround = jmake_cohort_round(jm, jfl, jmake_quota_schedule("inc", jfl.k, jfl.K, jfl.rounds), jvol,
                                         jnp.asarray(rho))
    jselect, jround = jax.jit(jselect), jax.jit(jround)
    js = jinit_server_state(jp, jfl.K, jvol.init_state())
    key = jax.random.PRNGKey(1)
    rounds, refs = [], []
    for t in range(2):
        key, k1, k2 = jax.random.split(key, 3)
        jidx, jpr, jcapped, jsigma = jselect(js, k1)
        tok = _token_batches(jcfg.vocab, jfl.k, 2, 2, 16, seed=t)["tokens"]
        js, jmet = jround(js, jidx, jpr, jcapped, jsigma, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)},
                          jnp.ones((jfl.k, 2), jnp.float32), jnp.full((jfl.k,), 1.0), jnp.float32(jfl.K),
                          jnp.ones((jfl.k,)), k2)
        rounds.append({"g": np.asarray(jax.random.gumbel(k1, (jfl.K,), jnp.float32)),
                       "u": _vol_rows(jfl, k2)[0].numpy(), "tokens": tok})
        refs.append({"idx": np.asarray(jidx), "sel_counts": np.asarray(js.sel_counts),
                     "logw": np.asarray(js.e3cs.logw), "loss": float(jmet["mean_local_loss"]),
                     "n_success": float(jmet["n_success"]), "params": js.params})
    return {"params": _np_tree(jp), "rho": np.asarray(rho, np.float32), "rounds": rounds}, refs


def _silo_inputs():
    from test_torch_fl_lm import _token_batches

    jcfg, _ = configs("qwen3-moe-30b-a3b")
    jm = jbuild_model(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    jlocal, jinit, jaccum, japply = jmake_silo_steps(jm, JFLConfig(**SILO_KW))
    jstep, jaccum = jax.jit(jlocal), jax.jit(jaccum)
    jacc = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), jp)
    weights, batches, refs = (0.25, 0.75), [], {"losses": [], "params": []}
    for c, w in enumerate(weights):
        b = _token_batches(jcfg.vocab, 2, 1, 2, 16, seed=10 + c)
        steps = [{k: np.ascontiguousarray(v[i, 0]) for k, v in b.items()} for i in range(2)]
        batches.append(steps)
        jq, js = jp, jinit(jp)
        for i, s in enumerate(steps):
            jq, js, jl = jstep(jq, js, {k: jnp.asarray(v) for k, v in s.items()}, i, jax.random.PRNGKey(i))
            refs["losses"].append(float(jl))
        refs["params"].append(jq)
        jacc = jaccum(jacc, jq, jp, w)
    refs["new"] = jax.jit(japply)(jp, jacc)
    return {"params": _np_tree(jp), "weights": weights, "batches": batches}, refs


def _same_on_every_rank(ranks):
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        for k in r:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def zoo_runs(base, archs):
    """The zoo job on each mesh of ``MESHES`` for ``archs``, started first,
    and JAX's references, computed meanwhile."""
    zoo_in, zoo_jax = _zoo_inputs(archs)
    groups = start_groups([(zoo_rank, D, base / f"zoo{D}", MESHES[D], archs, zoo_in) for D in MESHES])
    ref = _zoo_refs(zoo_jax)
    return {"zoo": dict(zip(MESHES, join_groups(groups, TIMEOUT))), "zoo_ref": ref}


def check_loss_and_grads(runs, D, arch, rules):
    got, ref = runs["zoo"][D][0], runs["zoo_ref"][arch]
    np.testing.assert_allclose(got[f"{arch}/{rules}/loss"], ref["loss"], **GRAD_TOL)
    want = _keyed(f"{arch}/{rules}/grads", ref["grads"])
    assert {k for k in got if k.startswith(f"{arch}/{rules}/grads")} == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **GRAD_TOL, err_msg=k)


def check_prefill_and_decode(runs, D, arch):
    got, ref = runs["zoo"][D][0], runs["zoo_ref"][arch]
    np.testing.assert_allclose(got[f"{arch}/prefill"], ref["prefill"], **F32_TOL)
    np.testing.assert_array_equal(got[f"{arch}/tokens"], ref["tokens"])
