"""Time the checkpoint payload raw against zlib on the sharded serving
engine's arrays: the measurement behind ``checkpoint.CODEC``.

    python -m repro_torch.checkpoint.codec_times [--device cpu] [--K 1000000] [--rounds 25]

Two jobs of ``ShardedEngine(D=1, staleness=2, block=4)`` (K clients with k =
K/1000, and half of each) serve ``--rounds`` rounds of lag feedback (the
paper's success rates decide who is on time; a failure is late by one or two
rounds, p = 0.7, or never).  Their ``arrays()`` ("served": most clients never
selected still share one log-weight) and the same tree with every float leaf
redrawn from a normal ("dense": a long-lived server's weights at worst) are
each written and read back raw (``checkpoint.save`` and ``restore``) and
through zlib at levels 1 and 6 (the same payload compressed, written, fsynced
and renamed; read, decompressed and put back on the device).  One line a
case: ``[ckpt-codec] arrays=... codec=... raw_bytes=... file_bytes=...
write_ms=... read_ms=...``.  The command starts its own one-rank process
group (NCCL on the card, gloo with ``--device cpu``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.checkpoint.checkpoint import _leaf_bytes, restore, save
from repro_torch.core.volatility import paper_success_rates
from repro_torch.device import resolve_device


def _zlib_write(path: str, tree, level: int) -> None:
    payload = zlib.compress(b"".join(_leaf_bytes(t) for t in pytree.tree_leaves(tree)), level)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _zlib_read(path: str, like):
    with open(path, "rb") as f:
        raw = zlib.decompress(f.read())
    leaves, spec = pytree.tree_flatten(like)
    out, off = [], 0
    for leaf in leaves:
        n = leaf.numel() * leaf.element_size()
        t = torch.frombuffer(bytearray(raw[off:off + n]), dtype=leaf.dtype) if n else torch.empty(0, dtype=leaf.dtype)
        out.append(t.reshape(leaf.shape).to(leaf.device))
        off += n
    return pytree.tree_unflatten(out, spec)


def served_arrays(dev: torch.device, K: int, rounds: int, seed: int = 0) -> dict:
    """The arrays of a sharded engine that served two jobs ``rounds`` rounds."""
    from repro_torch.serve import JobSpec, ShardedEngine

    eng = ShardedEngine(D=1, staleness=2, block=4, device=dev)
    Ks = (K, K // 2)
    uids = [eng.admit(JobSpec(K=Kj, k=max(1, Kj // 1000), rounds=2 * rounds, seed=seed + i))
            for i, Kj in enumerate(Ks)]
    for t in range(rounds):
        items = []
        for i, (u, Kj) in enumerate(zip(uids, Ks)):
            rng = np.random.default_rng([seed, i, t])
            ok = rng.random(Kj) < paper_success_rates(Kj)
            items.append((u, np.where(ok, 0, np.where(rng.random(Kj) < 0.7, rng.integers(1, 3, Kj), -1))))
        eng.tick(items)
    return eng.arrays()


def time_codecs(dev: torch.device, K: int, rounds: int, seed: int = 0) -> list:
    """One dict a (arrays, codec) case: sizes and write / read ms."""
    served = served_arrays(dev, K, rounds, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dense = pytree.tree_map(
        lambda v: torch.randn(v.shape, generator=gen, device=v.device) if v.is_floating_point() else v, served)
    nbytes = sum(t.numel() * t.element_size() for t in pytree.tree_leaves(served))
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "codec.ckpt")
        for name, tree in (("served", served), ("dense", dense)):
            for codec in ("raw", "zlib:1", "zlib:6"):
                raw = codec == "raw"
                t0 = time.perf_counter()
                if raw:
                    save(path, tree)
                else:
                    _zlib_write(path, tree, int(codec.partition(":")[2]))
                write_ms = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                back = restore(path, like=tree) if raw else _zlib_read(path, tree)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                read_ms = (time.perf_counter() - t0) * 1e3
                if not all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(back), pytree.tree_leaves(tree))):
                    raise AssertionError(f"{name} {codec}: the arrays read back differ from those written")
                rows.append(dict(arrays=name, codec=codec, raw_bytes=nbytes, file_bytes=os.path.getsize(path),
                                 write_ms=write_ms, read_ms=read_ms))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    ap.add_argument("--K", type=int, default=1_000_000, help="the larger job's clients")
    ap.add_argument("--rounds", type=int, default=25, help="rounds served before the arrays are taken")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        for row in time_codecs(dev, args.K, args.rounds, args.seed):
            print("[ckpt-codec] " + " ".join(f"{k}={v:.1f}" if isinstance(v, float) else f"{k}={v}"
                                             for k, v in row.items()), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
