"""The serving driver (``repro_torch.launch.serve``) against the JAX
package's ``repro.launch.serve`` at smoke size: the same JSON keys, and the
same generated tokens from the same parameters and prompts (JAX's, converted)
— greedy token for token, and sampled given JAX's Gumbel rows
(``jax.random.categorical`` is ``argmax(logits / T + gumbel(key))``).  JAX's
loop is driven here as its ``main`` drives it, and checked against the
``sample_tokens`` its ``main`` prints.  Tokens are compared exactly."""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, smoke_variant as jsmoke_variant
from repro.launch import serve as jserve
from repro.models import build_model as jbuild_model
from repro.models.transformer import vlm_positions as jvlm_positions
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import prng
from repro_torch.launch import serve
from repro_torch.models import build_model

B, S, GEN, SEED = 2, 16, 11, 3
KEYS = ["arch", "prefill_s", "decode_tok_per_s", "generated_shape", "sample_tokens"]


def _jax_main(capsys, monkeypatch, arch, temperature):
    argv = ["serve", "--arch", arch, "--smoke", "--batch", str(B), "--prompt-len", str(S), "--gen", str(GEN),
            "--temperature", str(temperature), "--seed", str(SEED)]
    monkeypatch.setattr(sys, "argv", argv)
    capsys.readouterr()
    jserve.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _jax_run(arch, temperature):
    """JAX's parameters, prompt batch, generated tokens and Gumbel rows, as
    ``repro.launch.serve.main`` makes them."""
    cfg = jsmoke_variant(jget_config(arch))
    model = jbuild_model(cfg)
    rng = jax.random.PRNGKey(SEED)
    params, _ = model.init(rng)
    batch = {"tokens": jax.random.randint(jax.random.fold_in(rng, 1), (B, S), 0, cfg.vocab, jnp.int32)}
    if cfg.family == "vlm":
        P = cfg.n_patches
        batch["patch_embeds"] = jax.random.normal(jax.random.fold_in(rng, 2), (B, P, cfg.d_patch), jnp.float32)
        batch["positions"] = jvlm_positions(cfg, B, S + P)
    if cfg.family == "encdec":
        batch["frames"] = jax.random.normal(jax.random.fold_in(rng, 3), (B, cfg.enc_len, cfg.d_model), jnp.float32)
    logits, caches = jax.jit(model.prefill)(params, batch)
    decode = jax.jit(model.decode)
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    outs, gumbels = [tok], []
    key = jax.random.fold_in(rng, 7)
    for i in range(GEN):
        logits_i, caches = decode(params, tok, caches)
        key = jax.random.fold_in(key, i)
        if temperature > 0:
            scaled = logits_i[:, -1] / temperature
            gumbels.append(np.asarray(jax.random.gumbel(key, scaled.shape, scaled.dtype)))
            tok = jax.random.categorical(key, scaled)[:, None].astype(jnp.int32)
            assert np.array_equal(np.asarray(tok[:, 0]), np.argmax(np.asarray(scaled) + gumbels[-1], -1))
        else:
            tok = jnp.argmax(logits_i[:, -1:], -1).astype(jnp.int32)
        outs.append(tok)
    return params, batch, np.concatenate([np.asarray(t) for t in outs], 1), gumbels


@pytest.mark.parametrize("arch,temperature", [("gemma-2b", 0.0), ("qwen2-vl-72b", 0.0), ("zamba2-7b", 0.0),
                                              ("whisper-base", 0.0), ("gemma-2b", 0.8),
                                              ("qwen3-moe-30b-a3b", 0.8)])
def test_generation_equals_jax(capsys, monkeypatch, arch, temperature):
    printed = _jax_main(capsys, monkeypatch, arch, temperature)
    jparams, jbatch, jtokens, gumbels = _jax_run(arch, temperature)
    assert printed["generated_shape"] == list(jtokens.shape) and printed["sample_tokens"] == jtokens[0, :12].tolist()
    model = build_model(smoke_variant(get_config(arch)))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    out = serve.generate(model, params, batch, GEN, temperature, gumbel=gumbels if temperature > 0 else None)
    assert out.tokens.dtype == torch.int32
    np.testing.assert_array_equal(out.tokens.numpy(), jtokens)


def test_main_prints_jax_keys(capsys, monkeypatch):
    printed = _jax_main(capsys, monkeypatch, "mamba2-130m", 0.8)
    out = serve.main(["--arch", "mamba2-130m", "--smoke", "--batch", str(B), "--prompt-len", str(S), "--gen",
                      str(GEN), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == list(printed) == KEYS and line == out
    assert line["arch"] == printed["arch"] and line["generated_shape"] == [B, GEN + 1]
    assert all(0 <= t < smoke_variant(get_config("mamba2-130m")).vocab for t in line["sample_tokens"])


def test_main_is_seeded():
    """Sampling draws from the seed's keys: the same seed generates the same
    tokens, another seed others."""
    args = ["--arch", "gemma-2b", "--smoke", "--batch", str(B), "--prompt-len", str(S), "--gen", str(GEN),
            "--device", "cpu"]
    a, b = serve.main(args), serve.main(args)
    c = serve.main(args + ["--seed", "1"])
    assert a["sample_tokens"] == b["sample_tokens"] != c["sample_tokens"]


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-base", "stablelm-1.6b"])
def test_make_batch_inputs(arch):
    """The prompt batch holds the family's stub inputs at JAX's shapes and
    dtypes, on the key's device."""
    cfg = smoke_variant(get_config(arch))
    batch = serve.make_batch(cfg, B, S, prng.PRNGKey(0, "cpu"))
    assert batch["tokens"].shape == (B, S) and batch["tokens"].dtype == torch.int32
    assert int(batch["tokens"].max()) < cfg.vocab
    if cfg.family == "vlm":
        assert batch["patch_embeds"].shape == (B, cfg.n_patches, cfg.d_patch)
        np.testing.assert_array_equal(batch["positions"].numpy(), np.asarray(jvlm_positions(cfg, B, S + cfg.n_patches)))
    if cfg.family == "encdec":
        assert batch["frames"].shape == (B, cfg.enc_len, cfg.d_model)
    assert set(batch) == {"tokens"} | ({"patch_embeds", "positions"} if cfg.family == "vlm" else set()) | \
        ({"frames"} if cfg.family == "encdec" else set())


def test_generate_sizes_the_cache_for_its_steps():
    """More decode steps than the prefill's default 64 slots of room: the
    caches are sized for them, so nothing decodes past its cache."""
    cfg = smoke_variant(get_config("llama3-405b"))
    model = build_model(cfg)
    key = prng.PRNGKey(0, "cpu")
    params, _ = model.init(key)
    out = serve.generate(model, params, serve.make_batch(cfg, 1, 4, key), 70, 0.0)
    assert out.tokens.shape == (1, 71)
