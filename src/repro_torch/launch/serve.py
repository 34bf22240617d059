"""Serving driver, the port of ``repro.launch.serve``: batched prefill, then
token-by-token decode of a model of the zoo, from random weights drawn from
``--seed``::

    python -m repro_torch.launch.serve --arch gemma-2b --smoke --batch 4 \\
        --prompt-len 64 --gen 32

``--device`` is ``cuda`` by default; ``--device cpu`` runs on the CPU.  It
prints the reference's JSON keys: ``arch``, ``prefill_s``,
``decode_tok_per_s``, ``generated_shape``, ``sample_tokens``.  Each timed
span ends in a device synchronise on the card.

``generate`` is the loop: the prefill sizes its caches for the ``gen``
decode steps (the reference pads 64 slots and drops writes past them), the
first token is the prefill's greedy choice,
then each decode step picks ``argmax(logits / T + g)`` (the reference's
``jax.random.categorical``) with ``g`` a Gumbel row drawn from
``generator``, or taken from ``gumbel`` when given; ``T = 0`` is greedy.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple, Optional

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.transformer import vlm_positions

__all__ = ["Generation", "make_batch", "generate", "main"]


class Generation(NamedTuple):
    tokens: torch.Tensor  # (B, gen + 1) int32: the prefill's token, then one a decode step
    prefill_s: float
    decode_s: float


def make_batch(cfg, B: int, S: int, generator: torch.Generator):
    """A prompt batch on the generator's device: ``S`` random tokens a row,
    and the family's stub inputs (patch embeddings and M-RoPE positions,
    encoder frames)."""
    dev = generator.device
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=generator, device=dev, dtype=torch.int32)}
    if cfg.family == "vlm":
        P = cfg.n_patches
        batch["patch_embeds"] = torch.randn((B, P, cfg.d_patch), generator=generator, device=dev)
        batch["positions"] = vlm_positions(cfg, B, S + P, dev)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, cfg.enc_len, cfg.d_model), generator=generator, device=dev)
    return batch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, batch, gen: int, temperature: float, *, generator: Optional[torch.Generator] = None,
             gumbel=None) -> Generation:
    """Prefill ``batch``, then ``gen`` decode steps.  ``gumbel[i]`` (B, vocab),
    when given, is step ``i``'s noise; else it is drawn from ``generator``."""
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
        for i in range(gen):
            logits_i, caches = model.decode(params, tok, caches)
            if temperature > 0:
                scaled = logits_i[:, -1] / temperature
                if gumbel is not None:
                    g = torch.as_tensor(gumbel[i], device=dev)
                else:
                    g = -torch.empty(scaled.shape, device=dev).exponential_(generator=generator).log()
                tok = torch.argmax(scaled + g.to(scaled.dtype), -1)[:, None].to(torch.int32)
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
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params, _ = model.init(generator)
    batch = make_batch(cfg, args.batch, args.prompt_len, generator)
    out = generate(model, params, batch, args.gen, args.temperature, generator=generator)
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
