"""Device time of the port's threefry kernel (``repro_torch.kernels.threefry``)
in both counter layouts, timed as ``chip_smoke.py`` times its kernels: 20
calls captured in one CUDA graph, CUDA events around a replay, median of 5.

    python scripts/threefry_times.py [--src DIR] [--label NAME] [--probes] [--out FILE]
    python scripts/threefry_times.py --compare FILE FILE

``--src`` is the ``src`` directory of a checkout (default: this checkout's),
so that two versions of the kernel, each in its own checkout, can be timed in
turns on one card: run the script once for each, in one job.  It builds that
checkout's kernels, prints the card's name and power limit, then:

* ``[threefry-time]``: ``bits``, ``sortkey``, ``uniform``, ``gumbel`` and
  ``normal`` at 10^6 under a key folded twice, ``normal`` at a gemma-2b MLP
  leaf (2048 x 16384 values), in the partitionable and the original layout,
  a key's in-place advance, and the rows (8 x 100000 Gumbel rows) and
  categorical ((4, 256000) bfloat16 and float32 logits, and (1, 8) bfloat16
  for its fixed cost) entries in both layouts;
  ``torch.rand`` at 10^6 as a scale (a different stream, not the same
  function);
* ``[threefry-digest]``: the sha256 of each entry's output at odd sizes (1,
  3, 255, 10^6 + 1), at offsets, in blocks of an original-layout draw and
  for an in-place key, the rows entry at J in {1, 8, 64} and n in {1, 3,
  100000, 100001} (also into rows off 16-byte alignment), and categorical
  at B in {1, 4, 133, 300} and V in {1, 7, 255999, 256000, 262147} and on
  logits with NaN, +-inf and ties (``edge_logits``), each in both dtypes
  and layouts, so that two checkouts' outputs are compared bit for bit
  (``--compare`` reads two ``--out`` files and fails on any difference);
* with ``--probes``, ``[threefry-probe]``: the draw kernel at the rows' and
  categorical's sizes (their hashes over every SM), and the kernels of
  ``scripts/threefry_probes.cu`` (built with the library's flags), each of
  which keeps one part of a draw, ordinary and as a programmatic dependent
  launch: what a draw's time is made of.

``--out`` also writes every line's fields as JSON lines.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from block_sums_times import graph_ms  # noqa: E402

K = 1_000_000
LEAF = 2048 * 16384  # gemma-2b's d_model x d_ff
PATH = (3, 2**33 + 7)  # the folds of chip_smoke's [jax-stream-kernel] key
MODES = ("bits", "sortkey", "uniform", "gumbel", "normal")


def build_probes(torch):
    """``scripts/threefry_probes.cu`` as a library of its own."""
    from repro_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, _nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / "threefry_probes.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib), os.path.join(HERE, "threefry_probes.cu")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    sigs = {"probe_empty": [I, P], "probe_store": [I64, P, I, P],
            "probe_fold": [P, I, I64, I64, I64, P, I, P], "probe_hash": [P, I, I64, I64, I64, I, P, I, P],
            "probe_wide": [P, I, I64, I64, I64, I, I, P, I, P], "probe_normal": [P, I, I64, I64, I64, I, P, I, P],
            "probe_read": [P, I64, P, I, P]}
    for name, argtypes in sigs.items():
        getattr(so, name).argtypes = argtypes
        getattr(so, name).restype = ctypes.c_int

    def call(name, *args):
        err = getattr(so, name)(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    return call


def edge_logits(torch, dtype, V=1000):
    """(6, V) logits whose argmax JAX's rules decide: a row all -inf (index
    0), +inf twice (the lower), NaN twice after +inf (the first NaN), a tie
    of two values too large for the noise to move (the lower), a row of
    zeros but one -0.0 and a row with NaN only at the end."""
    lg = torch.randn((6, V), device="cuda")
    lg[0] = float("-inf")
    lg[1, [5, 3]] = float("inf")
    lg[2, 1], lg[2, [7, 2]] = float("inf"), float("nan")
    lg[3, [9, 4]] = 1e30
    lg[4] = 0.0
    lg[4, 11] = -0.0
    lg[5, V - 1] = float("nan")
    return lg.to(dtype)


def digests(torch, kn):
    """``{case: sha256}`` of the entries' outputs at odd sizes, offsets and
    blocks."""
    from repro_torch.core import prng

    key = prng.PRNGKey(12345, "cuda").data
    out = {}

    def put(name, t):
        torch.cuda.synchronize()
        out[name] = hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()

    for mode in MODES + ("keys",):
        for n in (1, 3, 255, K + 1):
            for offset in (0, 5, 2**32 - 2):
                put(f"{mode}/part/n={n}/offset={offset}", kn.threefry(key, PATH, offset, n, mode))
            for total in (n, 2 * n + 1):
                put(f"{mode}/orig/n={n}/total={total}", kn.threefry(key, PATH, 0, n, mode, total=total))
                put(f"{mode}/orig/n={n}/total={total}/tail",
                    kn.threefry(key, PATH, total - n, n, mode, total=total))
        for lo, hi in ((0, K // 3), (K // 3, 2 * K // 3 + 1), (2 * K // 3 + 1, K + 1)):
            put(f"{mode}/orig/block={lo}..{hi}", kn.threefry(key, PATH, lo, hi - lo, mode, total=K + 1))
    put("uniform/part/[1e-7,1)", kn.threefry(key, PATH, 0, K, "uniform", 1e-7, 1.0))
    put("uniform/orig/[1e-7,1)", kn.threefry(key, PATH, 0, K, "uniform", 1e-7, 1.0, total=K))
    leaf = torch.empty(LEAF, dtype=torch.float32, device="cuda")
    put("normal/part/leaf", kn.threefry(key, (2, 5), 0, LEAF, "normal", out=leaf))
    put("normal/orig/leaf", kn.threefry(key, (2, 5), 0, LEAF, "normal", out=leaf, total=LEAF))
    adv = key.clone()
    for _ in range(3):
        kn.threefry(adv, (), 0, 1, "keys", out=adv.view(1, 2))
    put("keys/in-place", adv)
    # the rows and categorical entries (their outputs stay)
    keys8 = prng.split_data(prng.PRNGKey(4, "cuda"), 8).data
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((4, 256_000), generator=gen, device="cuda") * 3
    for original in (False, True):
        put(f"rows/original={original}", kn.threefry_rows(keys8, (3,), 100_001, original=original))
        for dt in (torch.float32, torch.bfloat16):
            put(f"categorical/{dt}/original={original}",
                kn.threefry_categorical(key, (5,), logits.to(dt), original=original))
    # rows at every J and n of the card tests, into an output whose rows start
    # off 16-byte alignment
    for J in (1, 8, 64):
        keys = prng.split_data(prng.PRNGKey(J, "cuda"), J).data
        for n in (1, 3, 100_000, 100_001):
            out_u = torch.empty(J * n + 1, dtype=torch.float32, device="cuda")[1:].view(J, n)
            for original in (False, True):
                put(f"rows/J={J}/n={n}/original={original}", kn.threefry_rows(keys, (3,), n, original=original))
                put(f"rows/J={J}/n={n}/original={original}/unaligned",
                    kn.threefry_rows(keys, (3,), n, out=out_u, original=original))
    # categorical at every B and V of the card tests, and NaN, +-inf and ties
    for B in (1, 4, 133, 300):
        for V in (1, 7, 255_999, 256_000, 262_147):
            lg = torch.randn((B, V), generator=gen, device="cuda") * 3
            for dt in (torch.float32, torch.bfloat16):
                for original in (False, True):
                    put(f"categorical/B={B}/V={V}/{dt}/original={original}",
                        kn.threefry_categorical(key, (5,), lg.to(dt), original=original))
    for dt in (torch.float32, torch.bfloat16):
        for original in (False, True):
            put(f"categorical/edges/{dt}/original={original}",
                kn.threefry_categorical(key, (5,), edge_logits(torch, dt), original=original))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(HERE, "..", "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--compare", nargs=2, default=None, metavar="FILE")
    args = ap.parse_args(argv)
    if args.compare:
        a, b = ({r["case"]: r["sha256"] for r in map(json.loads, open(f)) if r["line"] == "threefry-digest"}
                for f in args.compare)
        differ = sorted(c for c in a.keys() | b.keys() if a.get(c) != b.get(c))
        print(f"[threefry-compare] cases={len(a)} differ={len(differ)} {differ[:10]}")
        return 1 if differ or not a else 0
    import torch

    if not torch.cuda.is_available():
        print("threefry_times: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch import kernels as kn
    from repro_torch.core import prng

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    records = []

    def emit(line, **fields):
        records.append({"line": line, "src": args.label, **fields})
        print(f"[{line}] src={args.label!r} " + " ".join(f"{k}={v}" for k, v in fields.items()) + f" card={smi!r}",
              flush=True)

    key = prng.PRNGKey(12345, "cuda").data
    out_f = torch.empty(max(K, LEAF), dtype=torch.float32, device="cuda")
    out_b = torch.empty(4 * 256_000, dtype=torch.int32, device="cuda")  # bits at 10^6 and at the categorical's size
    for layout in ("partitionable", "original"):
        for mode, n in [(m, K) for m in MODES] + [("normal", LEAF)]:
            out = (out_b if mode in ("bits", "sortkey") else out_f)[:n]
            total = n if layout == "original" else 0
            ms = graph_ms(torch, lambda: kn.threefry(key, PATH, 0, n, mode, out=out, total=total))
            emit("threefry-time", entry=mode, layout=layout, n=n, ms=f"{ms:.5f}")
    adv = key.clone()
    emit("threefry-time", entry="keys", layout="partitionable", n=1,
         ms=f"{graph_ms(torch, lambda: kn.threefry(adv, (), 0, 1, 'keys', out=adv.view(1, 2))):.5f}")
    keys8 = prng.split_data(prng.PRNGKey(4, "cuda"), 8).data
    out_r = torch.empty((8, 100_000), dtype=torch.float32, device="cuda")
    logits32 = torch.randn((4, 256_000), device="cuda")
    logits = logits32.to(torch.bfloat16)
    tiny = logits[:1, :8].contiguous()  # (1, 8): a launch's fixed cost, its blocks' meeting and the last block's
    for layout in ("partitionable", "original"):
        orig = layout == "original"
        emit("threefry-time", entry="rows", layout=layout, n=8 * 100_000,
             ms=f"{graph_ms(torch, lambda: kn.threefry_rows(keys8, (3,), 100_000, out=out_r, original=orig)):.5f}")
        emit("threefry-time", entry="categorical", layout=layout, n=logits.numel(),
             ms=f"{graph_ms(torch, lambda: kn.threefry_categorical(key, (5,), logits, original=orig)):.5f}")
        emit("threefry-time", entry="categorical.float32", layout=layout, n=logits32.numel(),
             ms=f"{graph_ms(torch, lambda: kn.threefry_categorical(key, (5,), logits32, original=orig)):.5f}")
        emit("threefry-time", entry="categorical.fixed", layout=layout, n=tiny.numel(),
             ms=f"{graph_ms(torch, lambda: kn.threefry_categorical(key, (5,), tiny, original=orig)):.5f}")
    emit("threefry-time", entry="torch.rand", layout="philox", n=K,
         ms=f"{graph_ms(torch, lambda: torch.rand(K, device='cuda', out=out_f[:K])):.5f}")
    for case, sha in digests(torch, kn).items():
        records.append({"line": "threefry-digest", "src": args.label, "case": case, "sha256": sha})
    print(f"[threefry-digest] src={args.label!r} cases={sum(r['line'] == 'threefry-digest' for r in records)}")
    if args.probes:
        # the draw kernel at the rows' and categorical's sizes: the same hashes
        # (and, for rows, the same epilogue and stores) over every SM in one wave
        for layout in ("partitionable", "original"):
            for mode, n in (("gumbel", 8 * 100_000), ("bits", 4 * 256_000), ("gumbel", 4 * 256_000),
                            ("bits", 256_000)):
                total = n if layout == "original" else 0
                out = (out_b if mode == "bits" else out_f)[:n]
                emit("threefry-probe", probe=f"draw-{mode}", layout=layout, n=n,
                     ms=f"{graph_ms(torch, lambda: kn.threefry(key, PATH, 0, n, mode, out=out, total=total)):.5f}")
        call = build_probes(torch)
        kp = key.data_ptr()
        p = out_f.data_ptr()
        folds = (2, 3, 2**33 + 7)
        for pdl in (0, 1):
            emit("threefry-probe", probe="empty", n=0, pdl=pdl, ms=f"{graph_ms(torch, lambda: call('probe_empty', pdl)):.5f}")
            emit("threefry-probe", probe="store", n=K, pdl=pdl,
                 ms=f"{graph_ms(torch, lambda: call('probe_store', K, p, pdl)):.5f}")
            for n_path in (0, 2):
                emit("threefry-probe", probe="fold", n=K, folds=n_path, pdl=pdl,
                     ms=f"{graph_ms(torch, lambda: call('probe_fold', kp, n_path, *folds[1:], K, p, pdl)):.5f}")
                for k32 in (0, 1):
                    emit("threefry-probe", probe="hash32" if k32 else "hash", n=K, folds=n_path, pdl=pdl,
                         ms=f"{graph_ms(torch, lambda: call('probe_hash', kp, n_path, *folds[1:], K, k32, p, pdl)):.5f}")
                for per in (4, 8):
                    for store in (0, 1):
                        emit("threefry-probe", probe="wide", n=K, folds=n_path, per=per, store=store, pdl=pdl,
                             ms=f"{graph_ms(torch, lambda: call('probe_wide', kp, n_path, *folds[1:], K, per, store, p, pdl)):.5f}")
            emit("threefry-probe", probe="read16", n=logits.numel(), pdl=pdl,
                 ms=f"{graph_ms(torch, lambda: call('probe_read', logits.data_ptr(), logits.numel() * 2, p, pdl)):.5f}")
            for part in (0, 1, 2, 3):
                for n in (K, LEAF):
                    emit("threefry-probe", probe=f"normal{part}", n=n, folds=2, pdl=pdl,
                         ms=f"{graph_ms(torch, lambda: call('probe_normal', kp, 2, *folds[1:], n, part, p, pdl)):.5f}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
