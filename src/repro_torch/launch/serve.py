"""Serving driver, the port of ``repro.launch.serve``: batched prefill, then
token-by-token decode of a model of the zoo, from random weights drawn from
``--seed``::

    python -m repro_torch.launch.serve --arch gemma-2b --smoke --batch 4 \\
        --prompt-len 64 --gen 32

``--device`` is ``cuda`` by default; ``--device cpu`` runs on the CPU.  It
prints the reference's JSON keys: ``arch``, ``prefill_s``,
``decode_tok_per_s``, ``generated_shape``, ``sample_tokens``.  Each timed
span ends in a device synchronise on the card.

The noise is the reference's, seed for seed (``core.prng``): parameters
from ``PRNGKey(seed)``, the prompt ``randint(fold_in(rng, 1), (B, S), 0,
vocab)``, patch embeddings ``normal(fold_in(rng, 2))`` and encoder frames
``normal(fold_in(rng, 3))`` (``make_batch``).

``generate`` is the loop: the prefill sizes its caches for the ``gen``
decode steps (the reference pads 64 slots and drops writes past them), the
first token is the prefill's greedy choice, then decode step ``i`` samples
``categorical(key_i, logits / T)`` with ``key_i = fold_in(key_{i-1}, i)``
from ``key_{-1} = fold_in(rng, 7)`` (one fused launch a step, the
``(B, vocab)`` noise never written), or picks ``argmax(logits / T + g)``
with ``g = gumbel[i]`` when given; ``T = 0`` is greedy.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple, Optional

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.transformer import vlm_positions

__all__ = ["Generation", "make_batch", "generate", "main"]


class Generation(NamedTuple):
    tokens: torch.Tensor  # (B, gen + 1) int32: the prefill's token, then one a decode step
    prefill_s: float
    decode_s: float


def make_batch(cfg, B: int, S: int, rng: prng.Key):
    """A prompt batch on the key's device, the reference's: ``S`` tokens a
    row from ``randint(fold_in(rng, 1))``, and the family's stub inputs
    (patch embeddings from ``normal(fold_in(rng, 2))`` and M-RoPE positions,
    encoder frames from ``normal(fold_in(rng, 3))``)."""
    dev = rng.device
    batch = {"tokens": prng.randint(prng.fold_in(rng, 1), (B, S), 0, cfg.vocab, torch.int32)}
    if cfg.family == "vlm":
        P = cfg.n_patches
        batch["patch_embeds"] = prng.normal(prng.fold_in(rng, 2), (B, P, cfg.d_patch))
        batch["positions"] = vlm_positions(cfg, B, S + P, dev)
    if cfg.family == "encdec":
        batch["frames"] = prng.normal(prng.fold_in(rng, 3), (B, cfg.enc_len, cfg.d_model))
    return batch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, batch, gen: int, temperature: float, *, rng: Optional[prng.Key] = None,
             gumbel=None) -> Generation:
    """Prefill ``batch``, then ``gen`` decode steps.  ``gumbel[i]`` (B, vocab),
    when given, is step ``i``'s noise; else step ``i`` samples
    ``categorical`` under the chained key from ``fold_in(rng, 7)``."""
    tokens = batch["tokens"]
    dev = tokens.device
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        S = tokens.shape[1] + (model.cfg.n_patches if model.cfg.family == "vlm" else 0)
        logits, caches = model.prefill(params, batch, max_len=S + gen)
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        outs = [tok]
        t0 = time.perf_counter()
        key = prng.fold_in(rng, 7) if gumbel is None and temperature > 0 else None
        for i in range(gen):
            logits_i, caches = model.decode(params, tok, caches)
            if temperature > 0:
                scaled = logits_i[:, -1] / temperature
                if gumbel is not None:
                    g = torch.as_tensor(gumbel[i], device=dev)
                    tok = torch.argmax(scaled + g.to(scaled.dtype), -1)[:, None].to(torch.int32)
                else:
                    # hashed now: the chain stays one fold long
                    key = prng.Key(prng.key_data(prng.fold_in(key, i)), partitionable=key.partitionable)
                    tok = prng.categorical(key, scaled)[:, None]
            else:
                tok = torch.argmax(logits_i[:, -1:], -1).to(torch.int32)
            outs.append(tok)
        _sync(dev)
        decode_s = time.perf_counter() - t0
    return Generation(torch.cat(outs, 1), prefill_s, decode_s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced smoke variant (CPU-friendly)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    model = build_model(cfg, window=args.window)
    rng = prng.PRNGKey(args.seed, device)
    params, _ = model.init(rng)
    batch = make_batch(cfg, args.batch, args.prompt_len, rng)
    out = generate(model, params, batch, args.gen, args.temperature, rng=rng)
    gen = out.tokens.cpu()
    result = {
        "arch": cfg.name,
        "prefill_s": round(out.prefill_s, 6),
        "decode_tok_per_s": round(args.gen * args.batch / out.decode_s, 2),
        "generated_shape": list(gen.shape),
        "sample_tokens": gen[0, :12].tolist(),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
