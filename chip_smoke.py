#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device: the card's name and its power limit (``nvidia-smi``);
2. build: compile the CUDA kernels under ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card at the
   main path's shapes (K = 1,000,000 and a ragged 1,000,003, k = 1000; 3, 15
   and 63 bisection caps in float32 and float64; the top-k and update kernels
   at every tile they are swept at), with its time, the plain version's, a
   library call's where one exists, and its least possible time on this
   card (the block sums at each cap count); then the three top-k kernels bit
   for bit on ``ENGINE_CASES``, the inputs that reach every path of their
   radix select; one call of the select, the top-k and the block sums broken
   down into its stream operations (``[kernel-launches]``); and the block
   sums bit for bit across eager calls and a graph replay;
4. main path: ``RoundProgram.from_config`` at K = 1e6, k = 1000, T = 50,
   ``allocator="bisect"``, on the card, dense and on a one-rank NCCL mesh
   (``make_host_mesh(1)``, ``block=4``: the K-sharded round with the
   ``bisect_block_sums`` kernel), fused and staged: sync (lean and full),
   async with S = 2 under deadline and late-credit feedback, the sorted
   allocator, a mesh ``block=1`` run, and the staged replay of packed 1-bit
   and 2-bit rows; each path runs with the launch counts set to 0 just before
   it and read just after;
5. checks: cohorts of k distinct clients every round, counts, allocation
   bounds, re-centred finite weights, fused == staged cohorts, the mesh's
   ``block=1`` run == the dense run bit for bit, ``block=4`` allocations
   within ``BLOCK_P_RTOL`` of ``block=1``, launch counts;
6. profile: a dense and two mesh (``block=4`` and ``block=1``) fused rounds
   under ``torch.profiler``, with the host time of the mesh's collectives;
7. ops: the kernel layer's public ops, the path of the top-k and update
   kernels: ``autotune`` sweeps all four kernel families at K = 1e4, 1e5
   and 1e6 into a fresh cache under ``chiprun_out/autotune/``, then
   ``gumbel_topk_sample``, ``fused_gumbel_topk_sample`` and
   ``e3cs_update_tiled`` run at K = 1e6, k = 1000 with ``tile=None``,
   resolved through that cache; launch counts set to 0 before the phase and
   checked exactly after it, outputs against the plain versions;
8. times: rounds/s and client decisions/s of each run.

Ends with a JSON line of per-kernel numbers and, last, ``{"ok": true,
"device": ...}``.  Without CUDA it exits non-zero before printing a result.
"""
import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

K_MAIN, K_RAGGED, k_MAIN, T_MAIN, T_SHORT = 1_000_000, 1_000_003, 1000, 50, 10
# Every kernel must equal its plain version exactly (both round each float32
# operation once, in the same order; the kernels are built with --fmad=false).
FLOAT_TOL = 0.0
# bisect_block_sums adds each tile's float32 terms in another order than
# torch.sum (a tree per CTA against torch's own): a few units in the last place
BISECT_RTOL = {"float32": 1e-6, "float64": 1e-12}
BLOCK_P_RTOL = 1e-5  # p after 12 dyadic blocks vs 48 halvings: roundoff in the grid points
# ops.e3cs_update_tiled against the core e3cs_update: a step of at most 1
# rounded in another order (scale * xhat against residual * eta * xhat / K),
# added to |logw| < 16 and re-centred: a few float32 ulps at 16 (9.5e-7 each)
UPDATE_ATOL = 4e-6
AUTOTUNE_K, AUTOTUNE_ITERS, AUTOTUNE_WARMUP = (10_000, 100_000, 1_000_000), 5, 1
# the wrapper each autotune family's sweep launches
AUTOTUNE_WRAPPER = {"gumbel_topk": "gumbel_topk", "e3cs_tiles": "e3cs_update", "bisect_tiles": "bisect_block_sums",
                    "round_fused": "round_select.from_w"}
LOGW_TOL = 1e-5  # fused vs staged log-weights after T rounds (expected equal)
PSUM_RTOL = 1e-3  # sum of 1e6 float32 probabilities against k
# data-sheet rates (NVIDIA): HBM bytes/s and float32 (non-tensor) flop/s
CARDS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12), ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12))
TIMED_CALLS = 20
# inputs that reach every path of the radix select (all scores equal: the
# digits reach the index word; fewer than k positive: the -inf fill; one
# binade: the chosen bin overflows the candidate buffer), k = 1, k = 2048 and
# K = k, at K = 1e6 and 1,000,003
ENGINE_CASES = [(case, K, k) for K in (K_MAIN, K_RAGGED)
                for case, k in (("equal", k_MAIN), ("few_positive", k_MAIN), ("binade", k_MAIN), ("gumbel", 1),
                                ("gumbel", 2048))] + [("gumbel", 2048, 2048), ("equal", 2048, 2048)]
# fused runs with no staged partner: every other "-fused" run must have one
UNPAIRED_FUSED_RUNS = ("mesh-block1-sync-full-fused",)


def log(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def card_rates(name):
    for tag, bw, flops in CARDS:
        if tag in name:
            return bw, flops
    raise RuntimeError(f"no data-sheet rates for card {name!r}: add them to CARDS")


def main():
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs only on a CUDA device",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch import kernels as kn
    from repro_torch.engine.sharded import masked_prob_alloc, masked_prob_alloc_scalars
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import build, load_library
    from repro_torch.kernels.autotune import CANDIDATES
    from repro_torch.kernels.gumbel_topk import TOPK_TILES
    from repro_torch.launch import make_host_mesh

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", name=repr(name), count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)
    bw, flops = card_rates(name)

    path, secs = build()
    log("build", seconds=f"{secs:.1f}", library=path.name)
    load_library()

    # -- 3. kernels against their plain versions ---------------------------
    def events_ms(fn, reps=TIMED_CALLS):
        """Per-call time of back-to-back calls, CUDA events around them
        (includes any gaps the host leaves between launches)."""
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def graph_ms(fn, reps=TIMED_CALLS):
        """Device time per call: ``reps`` calls captured in one CUDA graph,
        replayed, CUDA events around the replay (no host gaps)."""
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(reps):
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
            times.append(a.elapsed_time(b) / reps)
        return float(np.median(times))

    def launch_breakdown(kname, fn):
        """One call's stream operations in order, each with its device
        time: the call captured in a CUDA graph, one replay under
        ``torch.profiler``."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            fn()
        graph.replay()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        ops = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        span = (ops[-1].time_range.end - ops[0].time_range.start) / 1e3 if ops else 0.0
        log("kernel-launches", kernel=kname, ops=len(ops), span_ms=f"{span:.4f}", card=repr(smi),
            us=",".join(f"{e.name.split('(')[0].split('<')[0].split('::')[-1][:20]}:{e.time_range.elapsed_us():.1f}"
                        for e in ops))

    def max_err(got, want):
        """Integer and boolean products must be equal; floats within FLOAT_TOL."""
        err = 0.0
        for key in want:
            a, b = got[key], want[key]
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{key}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
            if a.dtype in (torch.bool, torch.int32, torch.uint8):
                if not torch.equal(a, b):
                    raise AssertionError(f"{key}: kernel and plain version differ")
                continue
            # equal values (infinities too) agree; the rest differ by |a - b|
            differ = a != b
            e = float((a - b)[differ].abs().max()) if bool(differ.any()) else 0.0
            if not (e <= FLOAT_TOL):
                raise AssertionError(f"{key}: max |kernel - plain| = {e} > {FLOAT_TOL}")
            err = max(err, e)
        return err

    def bound(nbytes, nops, rate=flops):
        t_bytes, t_ops = nbytes / bw * 1e3, nops / rate * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def check_deterministic(kname, fn):
        """Two eager calls and a CUDA-graph replay of one call must give the
        same bits."""
        a, b = fn(), fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            c = fn()
        c.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise AssertionError(f"{kname}: eager calls and a graph replay differ")
        log("kernel-determinism", kernel=kname, eager_eager_graph="bit-identical")

    rng = np.random.default_rng(0)
    rows = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def nbytes(*ts):
        return sum(x.numel() * x.element_size() for x in ts if x is not None)

    for K in (K_MAIN, K_RAGGED):
        k = k_MAIN
        w = t(rng.gamma(1.0, 1.0, K).astype(np.float32))
        g = t(rng.gumbel(size=K).astype(np.float32))
        sigma = torch.tensor(0.5 * k / K, dtype=torch.float32, device=dev)
        scalars = masked_prob_alloc_scalars(w, k, sigma)
        for with_active in (False, True):
            act = t((rng.random(K) < 0.9).astype(np.float32)) if with_active else None
            wa = w if act is None else w * act
            got = dict(zip(("p", "capped", "vals", "idx"), kn.fused_alloc_select(wa, g, k, sigma=sigma, scalars=scalars, active=act)))
            want = dict(zip(("p", "capped", "vals", "idx"), ref.fused_alloc_select_ref(wa, g, k, sigma=sigma, scalars=scalars, active=act)))
            err_w = max_err(got, want)
            gotp = dict(zip(("vals", "idx"), kn.fused_perturb_select(want["p"], g, k, active=act)))
            wantp = dict(zip(("vals", "idx"), ref.fused_perturb_select_ref(want["p"], g, k, active=act)))
            err_p = max_err(gotp, wantp)
            log("kernel-check", kernel="round_select", K=K, k=k, active=with_active, from_w_err=err_w, from_p_err=err_p)
            if K == K_MAIN and not with_active:
                p_main = want["p"]
                scores = torch.log(torch.clamp(p_main, min=1e-20)) + g
                ms_w = graph_ms(lambda: kn.fused_alloc_select(w, g, k, sigma=sigma, scalars=scalars))
                ms_p = graph_ms(lambda: kn.fused_perturb_select(p_main, g, k))
                lib = graph_ms(lambda: torch.topk(scores, k))
                launch_breakdown("round_select.from_w", lambda: kn.fused_alloc_select(w, g, k, sigma=sigma,
                                                                                      scalars=scalars))
                b_w = bound(nbytes(w, g) + 20 + nbytes(want["p"], want["capped"], want["vals"], want["idx"]), 12 * K)
                b_p = bound(nbytes(p_main, g) + nbytes(want["vals"], want["idx"]), 3 * K)
                rows["round_select.from_w"] = dict(
                    route="cuda", source="src/repro_torch/kernels/csrc/round_select.cu",
                    replaces="src/repro/kernels/round_fused.py:171", max_abs_err=err_w, ms=ms_w,
                    plain_ms=events_ms(lambda: ref.fused_alloc_select_ref(w, g, k, sigma=sigma, scalars=scalars)),
                    bound_ms=b_w[0], bound_by=b_w[1], library_ms=lib)
                rows["round_select.from_p"] = dict(
                    route="cuda", source="src/repro_torch/kernels/csrc/round_select.cu",
                    replaces="src/repro/kernels/round_fused.py:171", max_abs_err=err_p, ms=ms_p,
                    plain_ms=events_ms(lambda: ref.fused_perturb_select_ref(p_main, g, k)),
                    bound_ms=b_p[0], bound_by=b_p[1], library_ms=lib)

        # tail: every kind, S in {0, 2}, late feedback on and off
        p = torch.clamp(w / w.sum() * k, 0.01, 0.97)
        mask = (torch.rand(K, device=dev) < k / K).to(torch.float32)
        capped = torch.rand(K, device=dev) < 0.01
        logw = torch.randn(K, device=dev)
        loss = torch.rand(K, device=dev)
        obs_of = {
            "x": (torch.rand(K, device=dev) < 0.6).to(torch.float32),
            "lag": t(rng.choice(np.array([-1, 0, 1, 2], np.int32), K)),
            "bits": t(rng.integers(0, 256, (K + 7) // 8, dtype=np.uint8)),
            "crumbs": t(rng.integers(0, 256, (K + 3) // 4, dtype=np.uint8)),
        }
        residual = torch.tensor(k - K * 0.5 * k / K, dtype=torch.float32, device=dev)
        for kind in ("x", "bits", "lag", "crumbs"):
            for S, late_fb in ((0, False),) if kind in ("x", "bits") else ((0, False), (2, False), (2, True)):
                credit = torch.rand(S, K, device=dev) if S else None
                fb = torch.randn(S, K, device=dev) * 0.1 if late_fb else None
                kw = dict(kind=kind, residual=residual, eta=0.5, K_glob=K, decay=tuple(0.5 ** (s + 1) for s in range(S)))
                args = (obs_of[kind], mask, p, capped, logw, loss)
                want = ref.round_tail_ref(*args, credit, fb, **kw)
                got = kn.fused_round_tail(*args, None if credit is None else credit.clone(),
                                          None if fb is None else fb.clone(), **kw)
                if set(got) != set(want):
                    raise AssertionError(f"tail products {sorted(got)} vs {sorted(want)}")
                err = max_err(got, want)
                log("kernel-check", kernel="round_tail", K=K, kind=kind, S=S, late_fb=late_fb, max_abs_err=err)
                main_case = {("x", 0, False): "round_tail.sync_x", ("lag", 2, True): "round_tail.async_lag_S2_fb"}
                if K == K_MAIN and (kind, S, late_fb) in main_case:
                    cr, fbr = (None if credit is None else credit.clone()), (None if fb is None else fb.clone())
                    ms = graph_ms(lambda: kn.fused_round_tail(*args, cr, fbr, **kw))
                    out_bytes = nbytes(*(v for key, v in got.items() if key not in ("m", "x") or kind != "x"))
                    b = bound(nbytes(*args, credit, fb, residual) + out_bytes, 12 * K * (1 + 2 * S))
                    rows[main_case[(kind, S, late_fb)]] = dict(
                        route="cuda", source="src/repro_torch/kernels/csrc/round_tail.cu",
                        replaces="src/repro/kernels/round_fused.py:422", max_abs_err=err, ms=ms,
                        plain_ms=events_ms(lambda: ref.round_tail_ref(*args, credit, fb, **kw)),
                        bound_ms=b[0], bound_by=b[1], library_ms=None)

        for kname, per, fn, rfn, line in (
            ("unpack_bits", 8, kn.unpack_bits, ref.unpack_bits_ref, "src/repro/kernels/unpack_bits.py:64"),
            ("unpack_crumbs", 4, kn.unpack_crumbs, ref.unpack_crumbs_ref, "src/repro/kernels/unpack_bits.py:117"),
        ):
            packed = obs_of["bits" if per == 8 else "crumbs"]
            err = max_err({"out": fn(packed, K)}, {"out": rfn(packed, K)})
            log("kernel-check", kernel=kname, K=K, max_abs_err=err)
            if K == K_MAIN:
                out = fn(packed, K)
                b = bound(nbytes(packed, out), 2 * K)
                rows[kname] = dict(route="cuda", source="src/repro_torch/kernels/csrc/unpack_bits.cu", replaces=line,
                                   max_abs_err=err, ms=graph_ms(lambda: fn(packed, K)),
                                   plain_ms=events_ms(lambda: rfn(packed, K)), bound_ms=b[0], bound_by=b[1],
                                   library_ms=None)
        # bisection block sums: 3, 15 and 63 caps drawn inside [0, max w]
        for n_caps, dtype in itertools.product((3, 15, 63), (torch.float32, torch.float64)):
            wd = w.to(dtype)
            caps = t(np.sort(rng.uniform(0.0, float(w.max()), n_caps))).to(dtype)
            got, want = kn.bisect_block_sums(wd, caps), ref.bisect_block_sums_ref(wd, caps)
            rtol = BISECT_RTOL[str(dtype).split(".")[1]]
            rel = float(((got - want).abs() / want.abs()).max())
            err = float((got - want).abs().max())
            if got.dtype != dtype or got.shape != want.shape or not rel <= rtol:
                raise AssertionError(f"bisect_block_sums K={K} caps={n_caps} {dtype}: max relative error {rel} > {rtol}")
            log("kernel-check", kernel="bisect_block_sums", K=K, n_caps=n_caps, dtype=str(dtype), max_abs_err=err,
                max_rel_err=rel, rtol=rtol)
            if K != K_MAIN or dtype != torch.float32:
                continue
            # bound: the bytes, or the instructions the function needs at the
            # issue rate (min and add are not FMAs: half the FMA flop rate).
            # With sorted caps, s_b = sum_{w < c_b} w + c_b * #{w >= c_b}: a
            # binary search of the caps and two adds a client.  The per-cap
            # algorithm's own floor (one FMNMX and one FADD per client and
            # cap) is logged beside it, not taken as the function's.
            b = bound(nbytes(w, caps, got), K * (math.ceil(math.log2(n_caps + 1)) + 2), rate=flops / 2)
            ms = graph_ms(lambda: kn.bisect_block_sums(w, caps))
            log("kernel-caps-time", kernel="bisect_block_sums", K=K, n_caps=n_caps, ms=f"{ms:.4f}",
                bound_ms=f"{b[0]:.4f}", bound_by=b[1], per_cap_issue_floor_ms=f"{2 * K * n_caps / flops * 2e3:.4f}",
                card=repr(smi))
            if n_caps != 15:
                continue
            # one launch a call, and the same bits eager and replayed
            launch_breakdown("bisect_block_sums", lambda: kn.bisect_block_sums(w, caps))
            check_deterministic("bisect_block_sums", lambda: kn.bisect_block_sums(w, caps))
            rows["bisect_block_sums"] = dict(
                route="cuda", source="src/repro_torch/kernels/csrc/bisect_block_sums.cu",
                replaces="src/repro/kernels/bisect_tiles.py:85", max_abs_err=err, ms=ms,
                plain_ms=events_ms(lambda: ref.bisect_block_sums_ref(w, caps)),
                bound_ms=b[0], bound_by=b[1],
                # two PyTorch calls and a (K, n_caps) temporary: no single call computes it
                library_ms=graph_ms(lambda: torch.minimum(w[:, None], caps).sum(0)))
        # top-k of given scores (B6), the fused Gumbel top-k (B7) and the tiled
        # E3CS update (B8) at every tile they are built for; a tenth of p is 0
        pt = rng.gamma(1.0, 1.0, K).astype(np.float32)
        pt[rng.random(K) < 0.1] = 0.0
        pt = t(pt / pt.sum() * k)
        ut = t(rng.random(K).astype(np.float32))
        scores = torch.log(torch.clamp(pt, min=1e-20)) + g
        upd = [t(rng.normal(0, 1, K).astype(np.float32)), torch.clamp(pt, 1e-3, 1.0), (pt > 0.005).float(),
               t((rng.random(K) < 0.6).astype(np.float32)), t((rng.random(K) < 0.05).astype(np.float32))]
        scale = torch.tensor((k - K * 0.3 * k / K) * 0.5 / K, dtype=torch.float32, device=dev)
        topk_ms, upd_ms, upd_cold_ms = {}, {}, {}
        # four copies of the update's inputs, 96 MB in all: rotating over them,
        # each call finds its inputs evicted from the 50 MB L2 (a round's
        # update reads rows that other passes touched since)
        upd_copies = [[r.clone() for r in upd] for _ in range(4)] if K == K_MAIN else None
        for tile in TOPK_TILES:
            err6 = max_err(dict(zip(("vals", "idx"), kn.gumbel_topk_kernel_call(scores, k, tile=tile))),
                           dict(zip(("vals", "idx"), ref.gumbel_topk_kernel_ref(scores, k))))
            err7 = max_err(dict(zip(("vals", "idx"), kn.fused_gumbel_topk_kernel_call(pt, ut, k, tile=tile))),
                           dict(zip(("vals", "idx"), ref.fused_gumbel_topk_kernel_ref(pt, ut, k))))
            log("kernel-check", kernel="gumbel_topk+fused_gumbel_topk", K=K, k=k, tile=tile, max_abs_err=err6,
                fused_max_abs_err=err7)
            if K == K_MAIN:
                topk_ms[tile] = (graph_ms(lambda: kn.gumbel_topk_kernel_call(scores, k, tile=tile)),
                                 graph_ms(lambda: kn.fused_gumbel_topk_kernel_call(pt, ut, k, tile=tile)))
        for tile in CANDIDATES["e3cs_tiles"]["tile"]:
            got = kn.e3cs_update_kernel_call(*upd, scale, tile=tile)
            want = ref.e3cs_update_kernel_ref(*upd, scale, tile=tile)
            err8 = max_err(dict(zip(("new", "tmax"), got)), dict(zip(("new", "tmax"), want)))
            if got[1].shape != (-(-K // tile),):
                raise AssertionError(f"e3cs_update tile={tile}: tmax shape {tuple(got[1].shape)}")
            log("kernel-check", kernel="e3cs_update", K=K, tile=tile, max_abs_err=err8)
            if K == K_MAIN:
                upd_ms[tile] = graph_ms(lambda: kn.e3cs_update_kernel_call(*upd, scale, tile=tile))
                turn = itertools.cycle(upd_copies)
                upd_cold_ms[tile] = graph_ms(lambda: kn.e3cs_update_kernel_call(*next(turn), scale, tile=tile))
        if K == K_MAIN:
            for tile, (ms6, ms7) in topk_ms.items():
                log("kernel-tile-time", kernel="gumbel_topk", tile=tile, ms=f"{ms6:.4f}", card=repr(smi))
                log("kernel-tile-time", kernel="fused_gumbel_topk", tile=tile, ms=f"{ms7:.4f}", card=repr(smi))
            for tile, ms8 in upd_ms.items():
                log("kernel-tile-time", kernel="e3cs_update", tile=tile, ms=f"{ms8:.4f}",
                    l2_cold_ms=f"{upd_cold_ms[tile]:.4f}", card=repr(smi))
            tile_ms = {"gumbel_topk": {tl: v[0] for tl, v in topk_ms.items()},
                       "fused_gumbel_topk": {tl: v[1] for tl, v in topk_ms.items()}, "e3cs_update": upd_ms}
            vals6, idx6 = ref.gumbel_topk_kernel_ref(scores, k)
            b6 = bound(nbytes(scores, vals6, idx6), K)
            rows["gumbel_topk"] = dict(
                route="cuda", source="src/repro_torch/kernels/csrc/gumbel_topk.cu",
                replaces="src/repro/kernels/gumbel_topk.py:89", max_abs_err=err6, ms=topk_ms[8192][0],
                plain_ms=events_ms(lambda: ref.gumbel_topk_kernel_ref(scores, k)),
                bound_ms=b6[0], bound_by=b6[1], library_ms=graph_ms(lambda: torch.topk(scores, k)))
            # no one PyTorch call perturbs and selects: torch.topk of the
            # perturbed scores, made beforehand, is a lower figure (logged)
            pert = ref.fused_gumbel_scores(pt, ut)
            for tile in TOPK_TILES:
                launch_breakdown(f"gumbel_topk@{tile}", lambda: kn.gumbel_topk_kernel_call(scores, k, tile=tile))
            launch_breakdown("fused_gumbel_topk@4096", lambda: kn.fused_gumbel_topk_kernel_call(pt, ut, k, tile=4096))
            log("kernel-library-lower", kernel="fused_gumbel_topk", call="torch.topk(perturbed scores, k)",
                ms=f"{graph_ms(lambda: torch.topk(pert, k)):.4f}", card=repr(smi))
            b7 = bound(nbytes(pt, ut, vals6, idx6), 10 * K)
            rows["fused_gumbel_topk"] = dict(
                route="cuda", source="src/repro_torch/kernels/csrc/gumbel_topk.cu",
                replaces="src/repro/kernels/e3cs_tiles.py:72", max_abs_err=err7, ms=topk_ms[8192][1],
                plain_ms=events_ms(lambda: ref.fused_gumbel_topk_kernel_ref(pt, ut, k)),
                bound_ms=b7[0], bound_by=b7[1], library_ms=None)
            new8, tmax8 = ref.e3cs_update_kernel_ref(*upd, scale, tile=8192)
            b8 = bound(nbytes(*upd, scale, new8, tmax8), 7 * K)
            rows["e3cs_update"] = dict(
                route="cuda", source="src/repro_torch/kernels/csrc/e3cs_update.cu",
                replaces="src/repro/kernels/e3cs_tiles.py:139", max_abs_err=err8, ms=upd_ms[8192],
                plain_ms=events_ms(lambda: ref.e3cs_update_kernel_ref(*upd, scale, tile=8192)),
                bound_ms=b8[0], bound_by=b8[1], library_ms=None)
            del pert, new8, tmax8, upd_copies
    # the radix select on inputs that reach every path of its engine, bit for
    # bit: B3 from_w and from_p with and without active, B6 and B7 at every tile
    for case, K, k in ENGINE_CASES:
        for with_active in (False, True):
            args = engine_select_inputs(case, K, k, with_active, rng, dev)
            got = dict(zip(("p", "capped", "vals", "idx"), kn.fused_alloc_select(*args[:3], **args[3])))
            want = dict(zip(("p", "capped", "vals", "idx"), ref.fused_alloc_select_ref(*args[:3], **args[3])))
            err_w = max_err(got, want)
            act = args[3]["active"]
            err_p = max_err(dict(zip(("vals", "idx"), kn.fused_perturb_select(want["p"], args[1], k, active=act))),
                            dict(zip(("vals", "idx"), ref.fused_perturb_select_ref(want["p"], args[1], k, active=act))))
            log("engine-check", kernel="round_select", case=case, K=K, k=k, active=with_active, from_w_err=err_w,
                from_p_err=err_p)
        pe, ue, se = engine_topk_inputs(case, K, k, rng, dev)
        for tile in TOPK_TILES:
            err6 = max_err(dict(zip(("vals", "idx"), kn.gumbel_topk_kernel_call(se, k, tile=tile))),
                           dict(zip(("vals", "idx"), ref.gumbel_topk_kernel_ref(se, k))))
            err7 = max_err(dict(zip(("vals", "idx"), kn.fused_gumbel_topk_kernel_call(pe, ue, k, tile=tile))),
                           dict(zip(("vals", "idx"), ref.fused_gumbel_topk_kernel_ref(pe, ue, k))))
            log("engine-check", kernel="gumbel_topk+fused_gumbel_topk", case=case, K=K, k=k, tile=tile,
                max_abs_err=err6, fused_max_abs_err=err7)
    # the block allocator where the cap binds (heavy-tailed weights, k = K/10):
    # 12 dyadic blocks through the kernel against 48 plain halvings
    wh = t(rng.gamma(0.3, 1.0, K_MAIN).astype(np.float32))
    kh = K_MAIN // 10
    sig = torch.tensor(0.25 * kh / K_MAIN, dtype=torch.float32, device=dev)
    (p1, c1), (p4, c4) = (masked_prob_alloc(wh, kh, sig, block=b) for b in (1, 4))
    rel = float(((p4 - p1).abs() / p1).max())
    if not (bool(c1.any()) and torch.equal(c1, c4) and rel <= BLOCK_P_RTOL):
        raise AssertionError(f"block=4 allocation vs block=1: max relative p difference {rel}, "
                             f"capped {int(c1.sum())} vs {int(c4.sum())}")
    log("alloc-check", K=K_MAIN, k=kh, capped=int(c1.sum()), block4_vs_block1_p_max_rel=rel, rtol=BLOCK_P_RTOL)
    del wh, p1, c1, p4, c4
    for kname, r in rows.items():
        log("kernel-time", kernel=kname, ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            library_ms=None if r["library_ms"] is None else f"{r['library_ms']:.4f}",
            bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"])
    del w, g, p, mask, capped, logw, loss, obs_of, pt, ut, scores, upd
    torch.cuda.empty_cache()

    # a one-rank NCCL group: the mesh's collectives run on the card, no network
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1)
        runs, launched = main_path(dev, K_MAIN, k_MAIN, T_MAIN, T_SHORT, rng, mesh)
        check_runs(runs)
        profile_round(dev, K_MAIN, k_MAIN, label="dense")
        profile_round(dev, K_MAIN, k_MAIN, label="mesh-block4", mesh=mesh, block=4)
        profile_round(dev, K_MAIN, k_MAIN, label="mesh-block1", mesh=mesh, block=1)
    finally:
        dist.destroy_process_group()

    # -- 7. the ops and the autotuner (this slice's path) -------------------------
    ops_counts, ops_tiles = ops_path(dev, K_MAIN, k_MAIN)
    for n, c in ops_counts.items():
        if c:
            launched.setdefault(n, c)
    # the ops' kernels are reported at the tile the ops resolved through the cache
    for kname, tname in (("gumbel_topk", "gumbel_topk"), ("fused_gumbel_topk", "gumbel_topk"),
                         ("e3cs_update", "e3cs_tiles")):
        rows[kname]["ms"] = tile_ms[kname][ops_tiles[tname]]
        log("kernel-time", kernel=kname, tile=ops_tiles[tname], ms=f"{rows[kname]['ms']:.4f}", card=repr(smi))

    # -- 8. times ---------------------------------------------------------------
    for label, (_, secs, T, cfg) in runs.items():
        log("time", run=label, rounds_per_s=f"{T / secs:.3f}", client_decisions_per_s=f"{T * cfg.K / secs:.6g}",
            card=repr(smi))
    kernels = []
    for kname, r in rows.items():
        wrapper = kname.split(".")[0] if kname.startswith("round_tail") else kname
        launches = launched.get(wrapper, 0)
        if launches == 0:
            raise AssertionError(f"{kname}: no launch on the main path")
        kernels.append({"name": kname, **{k: r[k] for k in ("route", "source", "replaces")}, "launches": launches,
                        **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def engine_select_inputs(case, K, k, with_active, rng, dev):
    """``(w, g, k, kwargs)`` of a from_w select on one of ``ENGINE_CASES``:
    Gumbel-perturbed gamma weights, all scores equal, fewer than k active
    (the -inf fill), or p = 1 and g in one binade [1, 2)."""
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    w = rng.gamma(1.0, 1.0, K)
    g = rng.gumbel(size=K)
    active = (rng.random(K) < 0.9).astype(np.float32) if with_active else None
    if case == "few_positive":
        active = np.zeros(K, np.float32) if with_active else None
        if with_active:
            active[rng.permutation(K)[: k // 2]] = 1.0
    if case in ("equal", "binade"):
        w = np.ones(K)
        g = np.zeros(K) if case == "equal" else rng.uniform(1.0, 2.0, K)
    if active is not None:
        w = w * active
    sigma = 0.3 * k / K
    # binade: residual 2 over denominator 1 clips p to 1, so the scores are g
    residual, cap, denom = (2.0, 1.0, 1.0) if case == "binade" else (k - K * sigma, np.quantile(w, 0.999), w.sum())
    scalars = tuple(torch.tensor(v, dtype=torch.float32, device=dev) for v in (residual, cap, denom))
    scalars += (torch.tensor(True, device=dev),)
    return t(w), t(g), k, dict(sigma=torch.tensor(sigma, dtype=torch.float32, device=dev), scalars=scalars,
                               active=None if active is None else t(active))


def engine_topk_inputs(case, K, k, rng, dev):
    """``(p, u, scores)`` of the top-k kernels on one of ``ENGINE_CASES``."""
    import torch

    p = rng.gamma(1.0, 1.0, K)
    p = p / p.sum() * k
    u = rng.random(K)
    scores = np.log(p) + rng.gumbel(size=K)
    if case == "equal":
        p, u, scores = np.full(K, 0.3), np.full(K, 0.4), np.full(K, 0.5)
    elif case == "few_positive":
        keep = np.zeros(K, bool)
        keep[rng.permutation(K)[: k // 2]] = True
        p, scores = np.where(keep, p, 0.0), np.where(keep, scores, -np.inf)
    elif case == "binade":  # log p + Gumbel(u) and the scores in [1, 2)
        p, u, scores = np.full(K, np.exp(1.5)), rng.uniform(0.2, 0.54, K), rng.uniform(1.0, 2.0, K)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev) for a in (p, u, scores))


def main_path(dev, K, k, T, T_short, rng, mesh):
    """Phase 4: drive the port's entry points at (K, k, T) on ``dev``, dense
    and on the one-rank ``mesh``; each run starts with the launch counts at 0
    and must end with exactly the launches its path makes (none on the CPU,
    where every wrapper takes its plain version).  Returns the runs and the
    first launch count of each wrapper."""
    import dataclasses

    import torch

    from repro_torch import kernels as kn
    from repro_torch.configs import FLConfig
    from repro_torch.engine import RoundProgram
    from repro_torch.engine.sharded import N_ITERS

    on_card = dev.type == "cuda"

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    fl = FLConfig(K=K, k=k, rounds=T, scheme="e3cs", quota_frac=0.5, allocator="bisect",
                  volatility="bernoulli")
    fl_async = dataclasses.replace(fl, staleness_rounds=2)
    fl_sort = dataclasses.replace(fl, allocator="sort")
    packed_bits = np.packbits(rng.random((T_short, K)) < 0.6, axis=1, bitorder="little")
    codes = rng.choice(np.arange(4, dtype=np.uint8), (T_short, K), p=[0.5, 0.15, 0.1, 0.25])
    packed_lags = np.bitwise_or.reduce(codes.reshape(T_short, -1, 4) << np.array([0, 2, 4, 6], np.uint8), axis=2)
    runs = {}
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    launched = {}

    def drive(label, cfg, *, fused, outputs="full", T=T, expect, **opts):
        xs = opts.pop("xs", None)
        pm = RoundProgram.from_config(cfg, fused=fused, device=dev, **opts)
        xs = None if xs is None else pm.local_rows(xs)
        run, s0 = pm.build_runner(outputs=outputs, scan_length=T)
        run(s0, 7, xs)  # warm-up: allocator pools, library handles
        sync()
        kn.reset_launch_counts()
        t0 = time.perf_counter()
        out = run(s0, 7, xs)
        sync()
        secs = time.perf_counter() - t0
        counts = kn.launch_counts()
        want = {n: 0 for n in counts} | (expect if on_card else {})
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, expected {want}")
        for n, c in counts.items():
            if c:
                launched.setdefault(n, c)
        runs[label] = (out, secs, T, cfg)
        log("main-path", run=label, rounds=T, seconds=f"{secs:.4f}", rounds_per_s=f"{T / secs:.2f}",
            client_decisions_per_s=f"{T * cfg.K / secs:.4g}", launches=json.dumps({n: c for n, c in counts.items() if c}))
        return out

    fused_sync = {"round_select.from_w": T, "round_tail": T}
    drive("sync-full-fused", fl, fused=True, expect=fused_sync)
    drive("sync-lean-fused", fl, fused=True, outputs="lean", expect=fused_sync)
    drive("sync-full-staged", fl, fused=False, expect={})
    for fb in ("deadline", "late_credit"):
        drive(f"async-S2-{fb}-fused", fl_async, fused=True, feedback=fb, expect=fused_sync)
        drive(f"async-S2-{fb}-staged", fl_async, fused=False, feedback=fb, expect={})
    drive("sort-fused", fl_sort, fused=True, T=T_short, expect={"round_select.from_p": T_short, "round_tail": T_short})
    drive("sort-staged", fl_sort, fused=False, T=T_short, expect={})
    drive("packed-staged", fl, fused=False, T=T_short, override="packed", xs=t(packed_bits),
          expect={"unpack_bits": T_short})
    drive("packed-fused", fl, fused=True, T=T_short, override="packed", xs=t(packed_bits),
          expect={"round_select.from_w": T_short, "round_tail": T_short})
    drive("packed_lags-staged", fl_async, fused=False, T=T_short, override="packed_lags", xs=t(packed_lags),
          expect={"unpack_crumbs": T_short})
    drive("packed_lags-fused", fl_async, fused=True, T=T_short, override="packed_lags", xs=t(packed_lags),
          expect={"round_select.from_w": T_short, "round_tail": T_short})

    # the K-sharded round on the one-rank mesh: 12 block sums a round at block=4
    n_block = -(-N_ITERS // 4)
    m4 = dict(mesh=mesh, block=4)
    mesh_fused = fused_sync | {"bisect_block_sums": n_block * T}
    mesh_staged = {"bisect_block_sums": n_block * T}
    drive("mesh-sync-full-fused", fl, fused=True, expect=mesh_fused, **m4)
    drive("mesh-sync-lean-fused", fl, fused=True, outputs="lean", expect=mesh_fused, **m4)
    drive("mesh-sync-full-staged", fl, fused=False, expect=mesh_staged, **m4)
    drive("mesh-sync-lean-staged", fl, fused=False, outputs="lean", expect=mesh_staged, **m4)
    for fb in ("deadline", "late_credit"):
        drive(f"mesh-async-S2-{fb}-fused", fl_async, fused=True, feedback=fb, expect=mesh_fused, **m4)
        drive(f"mesh-async-S2-{fb}-staged", fl_async, fused=False, feedback=fb, expect=mesh_staged, **m4)
    drive("mesh-block1-sync-full-fused", fl, fused=True, mesh=mesh, block=1, expect=fused_sync)
    drive("mesh-packed-staged", fl, fused=False, T=T_short, override="packed", xs=t(packed_bits),
          expect={"unpack_bits": T_short, "bisect_block_sums": n_block * T_short}, **m4)

    return runs, launched


def ops_path(dev, K, k, K_list=AUTOTUNE_K):
    """Phase 7: the kernel layer's public ops with their autotuner, on
    ``dev``.  The sweep over ``K_list`` writes a fresh cache under
    ``chiprun_out/autotune/`` (git-ignored; the JAX package's cache is never
    touched), the ops resolve ``tile=None`` through it.  Launch counts start
    at 0 and must end at exactly the sweep's timed calls plus one launch per
    op (none on the CPU, where every wrapper takes its plain version).
    Returns the counts and the tiles the ops resolved."""
    import torch

    from repro_torch import kernels as kn
    from repro_torch.core.selection import E3CSState, e3cs_update
    from repro_torch.core.selection.e3cs import divide, residual_mass
    from repro_torch.core.selection.sampling import gumbel_row, selection_mask, uniform_row
    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.obs.paths import autotune_path

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    os.environ["REPRO_AUTOTUNE_DIR"] = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
                                                    "autotune")
    path = autotune_path(autotune.CACHE_NAME)
    if os.path.exists(path):
        os.remove(path)
    kn.reset_launch_counts()
    autotune.reset_cold()
    t0 = time.perf_counter()
    res = autotune.autotune(K_list=K_list, path=path, iters=AUTOTUNE_ITERS, warmup=AUTOTUNE_WARMUP, device=dev)
    sync()
    sweep_s = time.perf_counter() - t0
    want = {n: 0 for n in kn.launch_counts()}
    for key, table in res["tables"].items():
        timed = sum(1 for v in table.values() if not isinstance(v, str))
        want[AUTOTUNE_WRAPPER[key.split("|")[0]]] += timed * (AUTOTUNE_ITERS + AUTOTUNE_WARMUP)
        log("autotune", key=key, best=json.dumps(res["cache"][key]),
            us_per_call=json.dumps({c: v if isinstance(v, str) else round(v, 3) for c, v in table.items()}))
    log("autotune", seconds=f"{sweep_s:.2f}", cache=os.path.relpath(path),
        device=repr(torch.cuda.get_device_name(dev) if on_card else "cpu"))

    gen = torch.Generator(device=dev).manual_seed(11)
    p = -torch.log(torch.rand(K, generator=gen, device=dev))  # Exp(1) weights
    p = torch.clamp(p / p.sum() * k, 1e-3, 1.0)
    g, u = gumbel_row(gen, K, dev), uniform_row(gen, K, dev)
    logw = torch.randn(K, generator=gen, device=dev)
    sigma = torch.tensor(0.3 * k / K, dtype=torch.float32, device=dev)
    x = (torch.rand(K, generator=gen, device=dev) < 0.6).float()
    capped = p >= 1.0 - 1e-6
    frozen = capped.float()
    eta = 0.5
    scale = divide(residual_mass(k, K, sigma) * eta, K)
    tiles = {name: autotune.best_config(name, K, backend=dev.type)["tile"] for name in ("gumbel_topk", "e3cs_tiles")}
    idx_g = ops.gumbel_topk_sample(g, p, k)
    idx_f = ops.fused_gumbel_topk_sample(u, p, k)
    mask = selection_mask(idx_g, K)
    new = ops.e3cs_update_tiled(logw, p, mask, x, frozen, scale)
    sync()
    counts = kn.launch_counts()
    for n in ("gumbel_topk", "fused_gumbel_topk", "e3cs_update"):
        want[n] += 1
    if not on_card:
        want = {n: 0 for n in want}
    if counts != want:
        raise AssertionError(f"ops phase: launches {counts}, expected {want}")
    if autotune.cold_keys():
        raise AssertionError(f"ops phase: tile=None missed the fresh cache: {autotune.cold_keys()}")
    scores = torch.log(torch.clamp(p, min=1e-20)) + g
    for name, idx, want_idx in (("gumbel_topk_sample", idx_g, ref.gumbel_topk_ref(scores, k)),
                                ("fused_gumbel_topk_sample", idx_f, ref.fused_gumbel_topk_kernel_ref(p, u, k)[1])):
        if not torch.equal(idx, want_idx):
            raise AssertionError(f"{name} differs from its plain version")
        if idx.unique().numel() != k or int(idx.min()) < 0 or int(idx.max()) >= K:
            raise AssertionError(f"{name}: not k distinct clients in range")
    if not torch.equal(new, ref.e3cs_update_tiled_ref(logw, p, mask, x, frozen, scale)):
        raise AssertionError("e3cs_update_tiled differs from its plain version")
    core = e3cs_update(E3CSState(logw=logw, t=torch.zeros((), dtype=torch.int32, device=dev)), p, capped, mask, x,
                       k, sigma, eta)
    d = float((new - core.logw).abs().max())
    if not (bool(torch.isfinite(new).all()) and float(new.max()) == 0.0 and d <= UPDATE_ATOL):
        raise AssertionError(f"e3cs_update_tiled: not finite, not re-centred, or {d} > {UPDATE_ATOL} from e3cs_update")
    log("ops", K=K, k=k, tiles=json.dumps(tiles), cohorts="equal to the plain versions",
        update_vs_core_max_abs_diff=d, atol=UPDATE_ATOL, launches=json.dumps({n: c for n, c in counts.items() if c}))
    return counts, tiles


def check_runs(runs):
    """Phase 5: the checks on every run of the main path."""
    import torch

    for label, (out, _, T, cfg) in runs.items():
        state = out[0]
        if "lean" in label:
            continue
        masks, ps, sigmas = out[1], out[3], out[4]
        if not torch.all(masks.sum(1) == cfg.k):
            raise AssertionError(f"{label}: a round's cohort is not k distinct clients")
        if float(state.sel_counts.sum()) != T * cfg.k:
            raise AssertionError(f"{label}: sum(sel_counts) != T*k")
        if not (torch.all(ps >= sigmas[:, None]) and torch.all(ps <= 1.0)):
            raise AssertionError(f"{label}: p outside [sigma, 1]")
        psum = ps.sum(1, dtype=torch.float64)
        if not torch.allclose(psum, torch.full_like(psum, cfg.k), rtol=PSUM_RTOL):
            raise AssertionError(f"{label}: sum(p) far from k: {psum.min().item()}..{psum.max().item()}")
        logw = state.e3cs.logw
        if not (torch.isfinite(logw).all() and float(logw.max()) == 0.0):
            raise AssertionError(f"{label}: logw not finite or not re-centred to max 0")
    fused_runs = [a for a in runs if a.endswith("-fused") and "lean" not in a and a not in UNPAIRED_FUSED_RUNS]
    for a in fused_runs:
        b = a.replace("-fused", "-staged")
        if b not in runs:
            raise AssertionError(f"{a} has no staged run {b} to compare its cohorts with")
        oa, ob = runs[a][0], runs[b][0]
        if not torch.equal(oa[1], ob[1]):
            raise AssertionError(f"{a} and {b} selected different cohorts")
        d = float((oa[0].e3cs.logw - ob[0].e3cs.logw).abs().max())
        if not d <= LOGW_TOL:
            raise AssertionError(f"{a} vs {b}: max |logw difference| {d} > {LOGW_TOL}")
        log("check", fused=a, staged=b, cohorts="identical", logw_max_abs_diff=d)
    for lean in (label for label in runs if "lean" in label):
        full = runs[lean.replace("lean", "full")][0][0]
        if not torch.equal(runs[lean][0][0].e3cs.logw, full.e3cs.logw):
            raise AssertionError(f"{lean}: lean and full outputs of the same seed ran different rounds")
    # a one-rank mesh with block=1 is the dense round, bit for bit
    dense, mesh1 = runs["sync-full-fused"][0], runs["mesh-block1-sync-full-fused"][0]
    for name, a, b in (("cohorts", dense[1], mesh1[1]), ("x", dense[2], mesh1[2]), ("p", dense[3], mesh1[3]),
                       ("logw", dense[0].e3cs.logw, mesh1[0].e3cs.logw)):
        if not torch.equal(a, b):
            raise AssertionError(f"mesh block=1 differs from the dense run in {name}")
    log("check", mesh_block1="bit-identical to sync-full-fused (cohorts, x, p, logw)")
    # block=4 against block=1: p of every round up to the first differing cohort
    b4 = runs["mesh-sync-full-fused"][0]
    differ = (b4[1] != mesh1[1]).any(dim=1).nonzero()
    n_same = int(differ[0]) if len(differ) else b4[1].shape[0]
    last = min(n_same + 1, b4[1].shape[0])
    rel = float(((b4[3][:last] - mesh1[3][:last]).abs() / mesh1[3][:last]).max())
    if not rel <= BLOCK_P_RTOL:
        raise AssertionError(f"block=4 p differs from block=1 by {rel} relative > {BLOCK_P_RTOL}")
    log("check", block4_vs_block1_p_max_rel=rel, rtol=BLOCK_P_RTOL, identical_cohort_rounds=n_same,
        rounds=b4[1].shape[0])
    log("check", result="all main-path checks passed")


def profile_round(dev, K, k, rounds=5, label="dense", **opts):
    """Where a fused sync round's time goes (``opts``: the mesh and block):
    ``torch.profiler`` over a few rounds after a warm-up: device time by
    kernel, host time and device span by round stage, and the device's busy
    share of the window's wall time (profiler overhead included in the wall
    time)."""
    import torch

    from repro_torch.configs import FLConfig
    from repro_torch.engine import RoundProgram

    fl = FLConfig(K=K, k=k, rounds=T_MAIN, scheme="e3cs", quota_frac=0.5, allocator="bisect")
    pm = RoundProgram.from_config(fl, fused=True, device=dev, **opts)
    run, s0 = pm.build_runner(outputs="lean", scan_length=rounds)
    run(s0, 1)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(s0, 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    # device-side events: kernels and memory ops; the "round.*" ones are the
    # GPU spans of the stage annotations, which cover gaps and other events
    dev_events = [e for e in prof.events() if e.device_type == cuda]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events if not e.name.startswith("round."))
    log("profile", program=label, rounds=rounds, wall_ms=f"{wall_us / 1e3:.3f}", device_busy_ms=f"{busy_us / 1e3:.3f}",
        device_idle_share=f"{1 - busy_us / wall_us:.4f}")
    by_name = {}
    for e in dev_events:
        if not e.name.startswith("round."):
            calls, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    for kname, (calls, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        log("profile-kernel", program=label, name=repr(kname[:90]), calls=calls, device_ms=f"{us / 1e3:.4f}")
    spans = {}
    for e in prof.events():
        if e.name.startswith("round."):
            side = "device_span_ms" if e.device_type == cuda else "host_ms"
            spans.setdefault(e.name, {}).setdefault(side, 0.0)
            spans[e.name][side] += e.time_range.elapsed_us() / 1e3
    for stage_name, v in spans.items():
        log("profile-stage", program=label, stage=stage_name, **{key: f"{ms:.3f}" for key, ms in v.items()})
    # host time of the collectives, by event name (an op and the events it
    # opens are listed apart, so the names' times nest, and do not add up)
    comms = {}
    for e in prof.events():
        low = e.name.lower()
        if e.device_type != cuda and any(s in low for s in ("allreduce", "all_reduce", "allgather", "all_gather")):
            calls, us = comms.get(e.name, (0, 0.0))
            comms[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    for cname, (calls, us) in sorted(comms.items(), key=lambda kv: -kv[1][1]):
        log("profile-comms", program=label, name=repr(cname[:90]), calls=calls, host_ms=f"{us / 1e3:.4f}",
            host_us_per_call=f"{us / calls:.2f}")


if __name__ == "__main__":
    sys.exit(main())
