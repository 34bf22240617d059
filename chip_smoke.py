#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device: the card's name and its power limit (``nvidia-smi``);
2. build: compile the CUDA kernels under ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card at the
   main path's shapes (K = 1,000,000 and a ragged 1,000,003, k = 1000), with
   its time, the plain version's, a library call's where one exists, and its
   least possible time on this card;
4. main path: ``RoundProgram.from_config`` at K = 1e6, k = 1000, T = 50,
   ``allocator="bisect"``, fused, on the card: sync (lean and full), async
   with S = 2 under deadline and late-credit feedback, the sorted allocator,
   and the staged replay of packed 1-bit and 2-bit rows; each path runs with
   the launch counts set to 0 just before it and read just after;
5. checks: cohorts of k distinct clients every round, counts, allocation
   bounds, re-centred finite weights, fused == staged cohorts, launch counts;
6. times: rounds/s and client decisions/s of each run.

Ends with a JSON line of per-kernel numbers and, last, ``{"ok": true,
"device": ...}``.  Without CUDA it exits non-zero before printing a result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

K_MAIN, K_RAGGED, k_MAIN, T_MAIN, T_SHORT = 1_000_000, 1_000_003, 1000, 50, 10
# Every kernel must equal its plain version exactly (both round each float32
# operation once, in the same order; the kernels are built with --fmad=false).
FLOAT_TOL = 0.0
LOGW_TOL = 1e-5  # fused vs staged log-weights after T rounds (expected equal)
PSUM_RTOL = 1e-3  # sum of 1e6 float32 probabilities against k
# data-sheet rates (NVIDIA): HBM bytes/s and float32 (non-tensor) flop/s
CARDS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12), ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12))
TIMED_CALLS = 20


def log(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def card_rates(name):
    for tag, bw, flops in CARDS:
        if tag in name:
            return bw, flops
    raise RuntimeError(f"no data-sheet rates for card {name!r}: add them to CARDS")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs only on a CUDA device",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch import kernels as kn
    from repro_torch.engine.sharded import masked_prob_alloc_scalars
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import build, load_library

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
            e = float((a - b).abs().max()) if a.numel() else 0.0
            if not (e <= FLOAT_TOL):
                raise AssertionError(f"{key}: max |kernel - plain| = {e} > {FLOAT_TOL}")
            err = max(err, e)
        return err

    def bound(nbytes, nops):
        t_bytes, t_ops = nbytes / bw * 1e3, nops / flops * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

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
    for kname, r in rows.items():
        log("kernel-time", kernel=kname, ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            library_ms=None if r["library_ms"] is None else f"{r['library_ms']:.4f}",
            bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"])
    del w, g, p, mask, capped, logw, loss, obs_of
    torch.cuda.empty_cache()

    runs, launched = main_path(dev, K_MAIN, k_MAIN, T_MAIN, T_SHORT, rng)
    check_runs(runs)
    profile_round(dev, K_MAIN, k_MAIN)

    # -- 6. times ---------------------------------------------------------------
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


def main_path(dev, K, k, T, T_short, rng):
    """Phase 4: drive the port's entry points at (K, k, T) on ``dev``; each
    run starts with the launch counts at 0 and must end with exactly the
    launches its path makes (none on the CPU, where every wrapper takes its
    plain version).  Returns the runs and the first launch count of each
    wrapper."""
    import dataclasses

    import torch

    from repro_torch import kernels as kn
    from repro_torch.configs import FLConfig
    from repro_torch.engine import RoundProgram

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

    return runs, launched


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
    for a, b in (("sync-full-fused", "sync-full-staged"), ("async-S2-deadline-fused", "async-S2-deadline-staged"),
                 ("async-S2-late_credit-fused", "async-S2-late_credit-staged"), ("sort-fused", "sort-staged"),
                 ("packed-fused", "packed-staged"), ("packed_lags-fused", "packed_lags-staged")):
        oa, ob = runs[a][0], runs[b][0]
        if not torch.equal(oa[1], ob[1]):
            raise AssertionError(f"{a} and {b} selected different cohorts")
        d = float((oa[0].e3cs.logw - ob[0].e3cs.logw).abs().max())
        if not d <= LOGW_TOL:
            raise AssertionError(f"{a} vs {b}: max |logw difference| {d} > {LOGW_TOL}")
        log("check", fused=a, staged=b, cohorts="identical", logw_max_abs_diff=d)
    lean_state = runs["sync-lean-fused"][0][0]
    if not torch.equal(lean_state.e3cs.logw, runs["sync-full-fused"][0][0].e3cs.logw):
        raise AssertionError("lean and full outputs of the same seed ran different rounds")
    log("check", result="all main-path checks passed")


def profile_round(dev, K, k, rounds=5):
    """Where a fused sync round's time goes: ``torch.profiler`` over a few
    rounds after a warm-up: device time by kernel, host time and device span
    by round stage, and the device's busy share of the window's wall time
    (profiler overhead included in the wall time)."""
    import torch

    from repro_torch.configs import FLConfig
    from repro_torch.engine import RoundProgram

    fl = FLConfig(K=K, k=k, rounds=T_MAIN, scheme="e3cs", quota_frac=0.5, allocator="bisect")
    run, s0 = RoundProgram.from_config(fl, fused=True, device=dev).build_runner(outputs="lean", scan_length=rounds)
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
    log("profile", rounds=rounds, wall_ms=f"{wall_us / 1e3:.3f}", device_busy_ms=f"{busy_us / 1e3:.3f}",
        device_idle_share=f"{1 - busy_us / wall_us:.4f}")
    by_name = {}
    for e in dev_events:
        if not e.name.startswith("round."):
            calls, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    for kname, (calls, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        log("profile-kernel", name=repr(kname[:90]), calls=calls, device_ms=f"{us / 1e3:.4f}")
    spans = {}
    for e in prof.events():
        if e.name.startswith("round."):
            side = "device_span_ms" if e.device_type == cuda else "host_ms"
            spans.setdefault(e.name, {}).setdefault(side, 0.0)
            spans[e.name][side] += e.time_range.elapsed_us() / 1e3
    for stage_name, v in spans.items():
        log("profile-stage", stage=stage_name, **{key: f"{ms:.3f}" for key, ms in v.items()})


if __name__ == "__main__":
    sys.exit(main())
