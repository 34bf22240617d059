"""Device time of the port's ``bisect_block_sums`` at 3, 15 and 63 caps, timed
as ``chip_smoke.py`` times its kernels: 20 calls at K = 10^6 (float32, tile
8192) captured in one CUDA graph, CUDA events around a replay, median of 5.

    python scripts/block_sums_times.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory of a checkout (default: this checkout's),
so that two versions of the kernel, each in its own checkout, can be timed in
turns on one card: run the script once for each, in one job.  It builds that
checkout's kernels, prints the card's name and power limit, then one
``[block-sums-time]`` line per cap count.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

K, TILE, REPS = 1_000_000, 8192, 20


def graph_ms(torch, fn):
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(REPS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / REPS)
    return float(np.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("block_sums_times: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels.bisect_tiles import bisect_block_sums

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.gamma(1.0, 1.0, K).astype(np.float32)).cuda()
    for n_caps in (3, 15, 63):
        caps = torch.from_numpy(np.sort(rng.uniform(0.0, float(w.max()), n_caps)).astype(np.float32)).cuda()
        ms = graph_ms(torch, lambda: bisect_block_sums(w, caps, tile=TILE))
        print(f"[block-sums-time] src={args.label!r} K={K} n_caps={n_caps} ms={ms:.5f} card={smi!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
