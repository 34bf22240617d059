"""How often a rank of a D = 4 gloo group of the sharded selection service
aborts at process exit, for one checkout.

    python scripts/serve_mesh_teardown.py [--src DIR] [--kind full|life] [--groups G] [--iters N]

``--src`` is the root of a checkout (default: this one); its ``src`` and
``tests`` are imported, so that two checkouts can be counted in turns on
one host.  Each of ``--iters`` rounds spawns ``--groups`` D = 4 groups at
once (one process a rank, gloo over a ``FileStore``, CPU only) and waits
for them.  A rank runs ``tests/torch_serve_mesh_ranks.py``'s body:
``serve_mesh_rank`` (``--kind full``, the serve-mesh test file's D = 4
group) or one engine's life (``--kind life``: build, admit, one tick,
``stop_followers`` / ``follow``), writes ``rank<r>.done``, destroys the
default group and exits, having written how many threads it has left
(``/proc/self/task``: a gloo group not yet freed keeps its worker threads)
to ``rank<r>.threads``.  Each rank's fd 2 goes to ``rank<r>.stderr``
with ``faulthandler`` on and, where a C compiler is found, a SIGABRT
handler that writes the native backtrace before the Python stacks.
Prints one ``[teardown]`` line a round and a last ``[teardown-total]``
line; a group with a non-zero exit keeps its directory (under
``--out``, default a new temporary directory) and is named in an
``[teardown-abort]`` line with the exit codes and which ranks had written
``.done`` (an abort after a rank's work is one at teardown).
"""
from __future__ import annotations

import argparse
import ctypes
import faulthandler
import gc
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
D = 4

BACKTRACE_C = r"""
#include <execinfo.h>
#include <signal.h>
#include <string.h>
#include <unistd.h>
static struct sigaction prev;
static void on_abrt(int sig, siginfo_t* si, void* uc) {
    void* f[128];
    int n = backtrace(f, 128);
    static const char m[] = "=== native backtrace (SIGABRT) ===\n";
    write(2, m, sizeof(m) - 1);
    backtrace_symbols_fd(f, n, 2);
    sigaction(SIGABRT, &prev, 0);
    raise(sig);
}
void bt_install(void) {
    struct sigaction sa;
    memset(&sa, 0, sizeof(sa));
    sa.sa_sigaction = on_abrt;
    sa.sa_flags = SA_SIGINFO | SA_RESETHAND;
    sigaction(SIGABRT, &sa, &prev);
}
"""


def build_backtrace(out_dir):
    """The SIGABRT handler as a shared library, or None without a compiler."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return None
    src, lib = os.path.join(out_dir, "bt.c"), os.path.join(out_dir, "libbt.so")
    with open(src, "w") as f:
        f.write(BACKTRACE_C)
    done = subprocess.run([cc, "-O1", "-shared", "-fPIC", "-o", lib, src], capture_output=True)
    return lib if done.returncode == 0 else None


def rank_main(root, kind, lib, rank, group_dir):
    fd = os.open(os.path.join(group_dir, f"rank{rank}.stderr"), os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 2)
    os.close(fd)
    faulthandler.enable(all_threads=True)
    if lib is not None:
        ctypes.CDLL(lib).bt_install()  # after faulthandler: it runs first, then hands on
    sys.path[:0] = [os.path.join(root, "src"), os.path.join(root, "tests")]
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.launch import make_host_mesh
    import torch_serve_mesh_ranks as ranks

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(group_dir, "store"), D), rank=rank,
                            world_size=D)
    mesh = make_host_mesh(D, device="cpu")
    if kind == "full":
        ranks.serve_mesh_rank(mesh, os.path.join(group_dir, "work"))
    elif rank == 0:
        from repro_torch.serve import JobSpec, ShardedEngine, stop_followers

        eng = ShardedEngine(device="cpu")
        uid = eng.admit(JobSpec(K=ranks.K_SH, k=ranks.k_SH, seed=3))
        eng.tick([(uid, ranks.lags(np.random.default_rng(3), ranks.K_SH))])
        stop_followers()
    else:
        from repro_torch.serve import follow

        follow(device="cpu")
    open(os.path.join(group_dir, f"rank{rank}.done"), "w").close()
    dist.destroy_process_group()
    del mesh
    gc.collect()
    with open(os.path.join(group_dir, f"rank{rank}.threads"), "w") as f:  # the threads left to the exit
        f.write(str(len(os.listdir("/proc/self/task")) if os.path.isdir("/proc/self/task") else -1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(HERE, ".."))
    ap.add_argument("--kind", choices=("full", "life"), default="full")
    ap.add_argument("--groups", type=int, default=6)
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.src)
    out = args.out or tempfile.mkdtemp(prefix="teardown_")
    os.makedirs(out, exist_ok=True)
    lib = build_backtrace(out)
    ctx = multiprocessing.get_context("spawn")
    groups = aborted = 0
    threads = set()
    t0 = time.time()
    for it in range(args.iters):
        running = []
        for _ in range(args.groups):
            d = tempfile.mkdtemp(dir=out, prefix="group_")
            procs = [ctx.Process(target=rank_main, args=(root, args.kind, lib, r, d)) for r in range(D)]
            for p in procs:
                p.start()
            running.append((procs, d))
        for procs, d in running:
            for p in procs:
                p.join(600)
                if p.exitcode is None:
                    p.kill()
                    p.join()
            codes = [p.exitcode for p in procs]
            groups += 1
            for r in range(D):
                path = os.path.join(d, f"rank{r}.threads")
                if os.path.exists(path):
                    threads.add(int(open(path).read()))
            if any(c != 0 for c in codes):
                aborted += 1
                done = [os.path.exists(os.path.join(d, f"rank{r}.done")) for r in range(D)]
                print(f"[teardown-abort] src={args.label!r} dir={d} codes={codes} done={done}", flush=True)
            else:
                shutil.rmtree(d)
        print(f"[teardown] src={args.label!r} kind={args.kind} round={it} groups={groups} aborted={aborted} "
              f"s={time.time() - t0:.0f}", flush=True)
    print(f"[teardown-total] src={args.label!r} kind={args.kind} groups={groups} aborted={aborted} "
          f"threads_at_exit={sorted(threads)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
