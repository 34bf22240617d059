"""The selection service's fleet job (the port of ``run_service_sharded`` in
``repro.launch.select_serve``): one fleet-scale selection job with the K
axis sharded over the caller's process group, its whole horizon one runner
of ``RoundProgram`` with the round taps and the client-axis sketches on.

On one card the group is a one-rank NCCL group; the tests run it on gloo::

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    report = run_service_sharded(K=1_000_000, rounds=50, D=1, block=4, fused=True,
                                 reporter=Reporter("serve_sharded"))

The runner's first call (off the clock) captures the round step as a CUDA
graph on the card; the timed horizons replay it.  The request-queue loop
(``run_service``), the compiled multi-job loop (``run_service_compiled``),
the socket server and the command line come with multi-job batching and
serving.
"""
from __future__ import annotations

import time

import torch

from repro_torch.obs import ROUND_TAPS, Reporter, SketchSpec

__all__ = ["run_service_sharded"]


def run_service_sharded(
    K: int = 1_000_000,
    rounds: int = 50,
    D: int | None = None,
    k: int | None = None,
    seed: int = 0,
    block: int = 4,
    reps: int = 3,
    staleness: int = 0,
    alpha: float = 0.5,
    fused: bool = False,
    reporter: Reporter | None = None,
    device=None,
):
    """Steady-state serving of ONE fleet-scale job with the K axis sharded
    over the default process group (``make_host_mesh(D)``); returns the
    throughput report, with the keys of the JAX package's.

    Per-client state, allocation and volatility draw live as ``(K/D,)``
    slabs; the ranks exchange one scalar sum per bisection block plus the
    ``(D*k,)`` top-k candidates a round.  ``staleness=S > 0`` serves async
    rounds (completion lags, the ``(S, K/D)`` credit ring); ``fused=True``
    serves through the fused round kernels.  The runner emits the
    ``ROUND_TAPS`` stream and the merged client-axis sketch stream; with a
    ``reporter`` they become its ``serve_sharded`` and ``fairness`` metric
    streams and the detector pass's alerts.  ``device=None`` is this rank's
    CUDA device; the tests pass ``"cpu"`` with a gloo group.

    One untimed horizon first (on the card it captures the round step),
    then ``reps`` timed horizons, each ending in a device synchronise; the
    rates come from the fastest.
    """
    from repro_torch.configs.base import FLConfig
    from repro_torch.engine.round_program import RoundProgram
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(D, device=device)
    D = mesh.size
    k = k or max(8, K // 1000)
    S = int(staleness)
    fl = FLConfig(
        K=K, k=k, rounds=rounds, scheme="e3cs", quota_frac=0.5, allocator="bisect",
        volatility="bernoulli", staleness_rounds=S, staleness_alpha=alpha,
    )
    program = RoundProgram.from_config(fl, mesh=mesh, block=block, fused=fused)
    sk_spec = SketchSpec(window=max(1, rounds // 5), n_regions=4)
    run, state0 = program.build_runner(outputs="lean", taps=True, sketch=sk_spec)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    run(state0, seed)  # off the clock: on the card, the capture
    sync()
    elapsed = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run(state0, seed)
        sync()
        elapsed.append(time.perf_counter() - t0)
    best = min(elapsed)
    taps = out[-1]
    report = {
        "mode": "compiled_sharded_async" if S else "compiled_sharded",
        "mesh_devices": int(D),
        "K": K,
        "k": k,
        "rounds": rounds,
        "bisect_block": block,
        "fused": bool(fused),
        "rounds_per_s": round(rounds / best, 2),
        "client_decisions_per_s": round(rounds * K / best, 1),
        "round_us": round(best / rounds * 1e6, 1),
        "per_device_state_mb": round(4.0 * K / D / 1e6, 2),  # one (K/D,) float32 vector
        "tap_counters": {n: float(v) for n, v in taps["counters"].items()},
    }
    if S:
        _, on_time, stale, _, _ = out
        report.update({
            "staleness": S,
            "alpha": alpha,
            "on_time_total": float(on_time.sum()),
            "stale_credit_total": float(stale.sum()),
        })
    else:
        report["successes_total"] = float(out[1].sum())
    if reporter is not None:
        series = {n: v.cpu().numpy() for n, v in taps["series"].items()}
        reporter.metrics_stream("serve_sharded", series, window=max(1, rounds // 10), better=ROUND_TAPS.directions())
        # client-axis fairness telemetry and the detector pass: starvation,
        # outage and drift land as ``alert`` events in the serving run log
        sketches = {n: v.cpu().numpy() for n, v in taps["sketches"].items()}
        fair = reporter.fairness_stream("fairness", sketches)
        reporter.alerts(series=series, fairness=fair, expected_selected=k)
    return report
