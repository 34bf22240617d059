"""The serve-mesh test file's spawned groups under load on the CPU: where a
D-rank group's seconds go when the host's cores are busy, as they are under
the suite's ``-n 6`` workers.

    python scripts/serve_mesh_load.py [--src DIR] [--busy N] [--runs R] [--label NAME]
    python scripts/serve_mesh_load.py --collectives [--src DIR] [--busy N]

``--src`` is the root of a checkout (default: this one), so that two
checkouts can be timed in turns on one host.  Each of ``--runs`` runs starts
``--busy`` processes that spin (``while True: pass``) and runs
``tests/test_torch_serve_mesh.py`` of that checkout beside them with
pytest (``--basetemp`` a new temporary directory), then stops them.  It
prints one ``[serve-mesh-load]`` line a run (pytest's exit code and
summary, and the seconds of the run) and one ``[serve-mesh-group]`` line a
group: D, the group's seconds (its slowest rank's start-up and cases) and
rank 0's seconds a case, read from the ``rank<r>.times`` files that
``tests/test_torch_mesh.spawn_groups`` has each rank write as it goes
(``lap``); the run's directory is then removed.  A last
``[serve-mesh-total]`` line gives, for each D, the groups' seconds over the
runs.  CPU only; ``JAX_PLATFORMS=cpu``.

``--collectives`` times the collectives themselves instead: a spawned
D = 4 gloo group (as the test harness's) beside the same busy processes,
each rank timing 200 calls of each, and prints one ``[serve-mesh-collective]``
line a collective with rank 0's ms a call: ``all_reduce`` of 1 and 15
float32 elements (15: the allocator's block sums at ``block=4``),
``all_gather_into_tensor`` and ``all_to_all_single`` of 15, and the
checkout's ``HostMesh.psum`` and ``all_gather`` of 15.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def group_times(group_dir):
    """``(D, seconds, rank 0's laps)`` of a spawned group's directory."""
    ranks = sorted(glob.glob(os.path.join(group_dir, "rank*.times")))
    laps = [[json.loads(line) for line in open(p)] for p in ranks]
    secs = max(sum(r["s"] for r in rank) for rank in laps)
    return len(ranks), secs, laps[0]


def _collective_rank(root, rank, D, store, calls, queue):
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.launch import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, D), rank=rank, world_size=D)
    mesh = make_host_mesh(D, device="cpu")
    one, x = torch.zeros(1), torch.zeros(15)
    out, out_a2a = torch.empty(15 * D), torch.empty(15 * D)
    cases = {"all_reduce/1": lambda: dist.all_reduce(one), "all_reduce/15": lambda: dist.all_reduce(x),
             "all_gather_into_tensor/15": lambda: dist.all_gather_into_tensor(out, x),
             "all_to_all_single/15": lambda: dist.all_to_all_single(out_a2a, x.repeat(D)),
             "HostMesh.psum/15": lambda: mesh.psum(x), "HostMesh.all_gather/15": lambda: mesh.all_gather(x)}
    ms = {}
    for name, fn in cases.items():
        for _ in range(10):
            fn()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        ms[name] = (time.perf_counter() - t0) / calls * 1e3
    if rank == 0:
        queue.put(ms)
    dist.destroy_process_group()


def collectives(root, busy, label, D=4, calls=200) -> None:
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    queue, store = ctx.Queue(), os.path.join(tempfile.mkdtemp(prefix="serve_mesh_coll_"), "store")
    spin = [subprocess.Popen([sys.executable, "-c", "while True: pass"]) for _ in range(busy)]
    try:
        procs = [ctx.Process(target=_collective_rank, args=(root, r, D, store, calls, queue)) for r in range(D)]
        for p in procs:
            p.start()
        ms = queue.get(timeout=600)
        for p in procs:
            p.join(60)
    finally:
        for p in spin:
            p.kill()
            p.wait()
        shutil.rmtree(os.path.dirname(store), ignore_errors=True)
    for name, v in ms.items():
        print(f"[serve-mesh-collective] src={label!r} busy={busy} D={D} {name} ms={v:.3f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(HERE, ".."))
    ap.add_argument("--busy", type=int, default=6)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--collectives", action="store_true")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.src)
    if args.collectives:
        collectives(root, args.busy, args.label)
        return 0
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    totals: dict = {}
    for run in range(args.runs):
        base = tempfile.mkdtemp(prefix="serve_mesh_load_")
        busy = [subprocess.Popen([sys.executable, "-c", "while True: pass"]) for _ in range(args.busy)]
        try:
            t0 = time.time()
            done = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                                   f"--basetemp={base}", "tests/test_torch_serve_mesh.py"],
                                  cwd=root, env=env, capture_output=True, text=True)
            secs = time.time() - t0
        finally:
            for p in busy:
                p.kill()
                p.wait()
        summary = ([line for line in done.stdout.splitlines() if " in " in line] or ["(no summary)"])[-1]
        print(f"[serve-mesh-load] src={args.label!r} run={run} busy={args.busy} rc={done.returncode} "
              f"s={secs:.1f} pytest={summary.strip('= ')!r}", flush=True)
        if done.returncode:
            print(done.stdout[-4000:], flush=True)
        for group in sorted(d for d in glob.glob(os.path.join(base, "serve_mesh*")) if not d.endswith("current")):
            D, gsecs, laps = group_times(group)
            totals.setdefault(D, []).append(round(gsecs, 1))
            print(f"[serve-mesh-group] src={args.label!r} run={run} busy={args.busy} D={D} s={gsecs:.1f} rank0="
                  + json.dumps({r["case"]: r["s"] for r in laps}), flush=True)
        shutil.rmtree(base, ignore_errors=True)
    print(f"[serve-mesh-total] src={args.label!r} busy={args.busy} runs={args.runs} "
          + " ".join(f"D{D}_s={v}" for D, v in sorted(totals.items())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
