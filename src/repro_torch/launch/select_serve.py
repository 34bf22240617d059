"""Selection as a service (the port of ``repro.launch.select_serve``):
request queue -> batched engine step -> per-job cohort responses.

* ``run_service``: each FL job posts a tick request carrying last round's
  success bits; the server drains up to J requests from the host queue,
  packs them into one batched multi-job step (``engine.multi_job``) and
  answers every request with its cohort.  Feedback comes from the paper's
  Bernoulli classes, or with ``scenario=<name>`` from a bit-packed trace of
  that ``repro_torch.scenarios`` regime recorded per job and unpacked
  row by row at enqueue time.  Reports ticks/s, client decisions/s and
  request latency percentiles.
* ``run_service_compiled``: the steady state with no host round trip a
  tick: each tick draws the fleet's completion lags, runs the batched step
  and credits late arrivals ``alpha**lag`` from a ``(J, S, K_max)``
  staleness ring, the whole tick one CUDA-graph replay over static buffers
  (JAX compiles one ``lax.scan`` with donated state).  ``staleness=0`` is
  the compiled synchronous loop.
* ``run_service_sharded``: one fleet-scale job with the K axis sharded over
  the caller's process group, its whole horizon one runner of
  ``RoundProgram`` with the round taps and the client-axis sketches on.

The noise is the JAX package's (``core.prng``): job ``j``'s round-``t``
Gumbel row is ``gumbel(fold_in(split(PRNGKey(seed), J)[j], t), (K_max,))``,
all J rows in one launch (``prng.rows``), and ``run_service_compiled``'s
fleet lag rows come from a carried ``PRNGKey(seed + 1)``, split every tick;
``run_service_sharded`` runs its horizon from ``PRNGKey(seed)``.  The same
``seed`` gives the JAX package's cohorts.  Reports go through the port's ``Reporter``
(``results/bench/torch/``).  The command line takes JAX's flags and
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path)::

    python -m repro_torch.launch.select_serve --smoke
    python -m repro_torch.launch.select_serve --smoke --async
    python -m repro_torch.launch.select_serve --smoke --scenario diurnal
    python -m repro_torch.launch.select_serve --smoke --mesh 1

``--mesh D`` runs ``run_service_sharded`` on the caller's process group, or
on a one-rank group it starts when D = 1 and none exists (NCCL on the card,
gloo on the CPU).  ``--serve`` stands up the socket front end
(``repro_torch.serve``, ``run_server``): a ``SlotEngine``, or with ``--mesh
D`` a ``ShardedEngine``; ``--serve --smoke [--chaos SEED]`` drives it with
the built-in loopback client::

    python -m repro_torch.launch.select_serve --serve --smoke
    python -m repro_torch.launch.select_serve --serve --smoke --async --mesh 1 --chaos 3

At D > 1 every rank of the started group runs the command: rank 0 serves
(and runs ``--smoke`` and ``--chaos``), the other ranks follow its engine
(``repro_torch.serve.follow``) until it stops them.
"""
from __future__ import annotations

import argparse
import collections
import functools
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.core import prng
from repro_torch.core.volatility import BernoulliVolatility, BinaryLag, CompletionLag, paper_success_rates
from repro_torch.core.volatility import row_shape
from repro_torch.device import resolve_device
from repro_torch.engine.multi_job import make_multi_job, multi_job_init, pack_jobs, plain_batched_step
from repro_torch.engine.round_program import JaxStream, capture_step, staleness_ring_step
from repro_torch.kernels import add_launch_counts
from repro_torch.obs import ROUND_TAPS, Reporter, SketchSpec, SpanTimer

__all__ = ["run_service", "run_service_compiled", "run_service_sharded", "run_server", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _heterogeneous_fleet(J: int, K_max: int, rng):
    """The service's standard heterogeneous job mix (shared by both paths)."""
    Ks = [int(K_max // (2 ** (j % 3))) for j in range(J)]
    ks = [max(4, Kj // 50) for Kj in Ks]
    fracs = [float(rng.choice([0.0, 0.5, 0.8])) for _ in range(J)]
    etas = [float(rng.choice([0.3, 0.5])) for _ in range(J)]
    return Ks, ks, fracs, etas


def _fleet_rhos(Ks, K_max: int) -> np.ndarray:
    """``(J, K_max)`` paper success rates, each job's population padded with 0."""
    return np.stack([np.pad(paper_success_rates(Kj), (0, K_max - Kj)) for Kj in Ks])


def run_service(
    J: int = 8,
    K_max: int = 4096,
    rounds: int = 30,
    seed: int = 0,
    n_iters: int = 48,
    tile: int = 8192,
    scenario: str | None = None,
    reporter: Reporter | None = None,
    device=None,
):
    """Simulate the service loop; returns the throughput and latency report
    (the JAX package's keys).

    Request latency goes into a bucketed ``LatencyHistogram`` through a
    ``SpanTimer`` (nothing is stored per request); the report's p50/p95/p99
    come from it.  With a ``reporter`` the request, dispatch and feedback
    histograms land in the run log: ``dispatch`` is the batched step (copies
    in, the replay, the wait for the device), ``feedback`` the host's work
    a tick (the rows unpacked, stacked and copied to the device).
    ``device=None`` means CUDA.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    Ks, ks, fracs, etas = _heterogeneous_fleet(J, K_max, rng)
    cfg, k_max = pack_jobs(Ks, ks, fracs, etas, K_max=K_max, device=dev)
    _, batched_step = make_multi_job(k_max, n_iters=n_iters, tile=tile)
    state = multi_job_init(cfg)
    rhos = _fleet_rhos(Ks, K_max)
    base_keys = prng.split_data(prng.PRNGKey(seed, dev), J)

    queue: collections.deque = collections.deque()  # (enqueue time, job id, feedback bits)
    spans = SpanTimer(lo=1e-6, hi=60.0)
    request_hist = spans.get("request")
    n_ticks = 0
    if scenario is None:
        xs_host = (rng.random((rounds, J, K_max)) < rhos[None]).astype(np.float32)

        def feedback(t, j):
            return xs_host[t, j]

    else:
        from repro_torch.scenarios import make_scenario, record_trace, unpack_trace

        # one bit-packed trace a job (jobs get distinct seeds); rows are
        # expanded only at enqueue time, the dense (rounds, J, K_max) trace
        # never exists
        traces = [
            record_trace(make_scenario(scenario, Kj, rounds, seed=seed + j, device=dev)[0], rounds, seed=seed + j,
                         chunk=min(64, rounds), device=dev)
            for j, Kj in enumerate(Ks)
        ]

        def feedback(t, j):
            return np.pad(unpack_trace(traces[j][t], Ks[j]), (0, K_max - Ks[j]))

    # one dispatch off the clock (on the card, the capture), under the keys
    # of round ``rounds``, as in the JAX package; its state is dropped
    xs0 = torch.from_numpy(np.stack([feedback(0, j) for j in range(J)])).to(dev)
    batched_step(cfg, state, prng.rows(base_keys, (rounds,), K_max), xs0)
    _sync(dev)

    t_start = time.perf_counter()
    n_decisions = 0
    for t in range(rounds):
        for j in range(J):
            queue.append((time.perf_counter(), j, feedback(t, j)))
        # drain one full batch of J requests into a single engine dispatch
        batch = [queue.popleft() for _ in range(min(J, len(queue)))]
        with spans.span("feedback"):
            xs = torch.from_numpy(np.stack([b[2] for b in batch])).to(dev)
            gs = prng.rows(base_keys, (t,), K_max)
        with spans.span("dispatch", annotate=True):
            state, out = batched_step(cfg, state, gs, xs)
            _sync(dev)
        t_done = time.perf_counter()
        cohorts = out["idx"].cpu().numpy()  # (J, k_max), -1 padded
        for (t_enq, j, _), cohort in zip(batch, cohorts):
            request_hist.observe(t_done - t_enq)
            n_ticks += 1
            n_decisions += Ks[j]  # one accept/reject decision per live client
            if (cohort >= 0).sum() != ks[j]:
                raise AssertionError(f"job {j}: a cohort of {(cohort >= 0).sum()} clients, not k={ks[j]}")
    elapsed = time.perf_counter() - t_start

    report = {
        "jobs": J,
        "K_max": K_max,
        "rounds": rounds,
        "scenario": scenario or "paper_iid(static)",
        "ticks": n_ticks,
        "ticks_per_s": round(n_ticks / elapsed, 1),
        "client_decisions_per_s": round(n_decisions / elapsed, 1),
        "latency_ms": {
            "p50": round(request_hist.quantile(0.50) * 1e3, 3),
            "p95": round(request_hist.quantile(0.95) * 1e3, 3),
            "p99": round(request_hist.quantile(0.99) * 1e3, 3),
            "max": round(request_hist.max * 1e3, 3),
        },
        "cohort_sizes": ks,
        "populations": Ks,
    }
    if reporter is not None:
        reporter.histogram("request_latency", request_hist)
        reporter.histogram("dispatch_latency", spans.get("dispatch"))
        reporter.histogram("feedback_latency", spans.get("feedback"))
    return report


class _ServiceHorizon:
    """``run_service_compiled``'s ticks over static buffers.

    A tick ``t``: the fleet's lag rows are drawn under ``k_vol`` of the
    carried fleet key, which is then advanced (``key, k_vol =
    split(key)``), and every job's Gumbel row under ``fold_in(base_key_j,
    t)`` in one launch (outside the graph, into static buffers), the keys
    in the threefry mode of the horizon's making; then the
    lag model's ``sample``, the batched step on the on-time bits, and the
    ``(J, S, K_max)`` staleness ring, writing the new state, ring and the
    tick's per-job ``on_time`` and ``stale`` credit back into the buffers.
    On a CUDA device the first ``run`` warms the tick up and captures it as
    a CUDA graph; every tick after replays it (``run(eager=True)`` loops the
    tick eagerly instead, for the check that both give the same bits).
    ``reset`` starts a fresh horizon: zero state and ring, the model's
    initial state, the fleet key back at ``PRNGKey(seed + 1)`` and ``t`` at
    0; a ``run`` after another resumes the horizon.
    """

    def __init__(self, cfg, k_max: int, lag_model, S: int, alpha: float, seed: int, n_iters: int, tile: int):
        J, K_max = cfg.active.shape
        self.cfg, self.lag_model, self.S, self.alpha, self.seed = cfg, lag_model, S, alpha, seed
        self.dev = cfg.active.device
        self.batched = functools.partial(plain_batched_step, k_max=k_max, n_iters=n_iters, tile=tile)
        self.rows = lag_model.draw_rows()
        self.state = multi_job_init(cfg)
        self.pending = torch.zeros((J, S, K_max), dtype=torch.float32, device=self.dev)
        self.vs = pytree.tree_map(lambda v: v.clone(), lag_model.init_state())
        self.raw_vol = [torch.empty(row_shape(n), dtype=torch.float32, device=self.dev) for n, _ in self.rows]
        self.raw_g = torch.empty((J, K_max), dtype=torch.float32, device=self.dev)
        self.base_keys = prng.split_data(prng.PRNGKey(seed, self.dev), J)  # the horizon's mode: the default's
        self.on_time = torch.zeros(J, dtype=torch.float32, device=self.dev)
        self.stale = torch.zeros(J, dtype=torch.float32, device=self.dev)
        self.graph, self.per_replay, self.warmup_s, self.capture_s = None, {}, None, None
        self.reset()

    def reset(self) -> None:
        for buf in (*self.state, self.pending):
            buf.zero_()
        for buf, v in zip(pytree.tree_leaves(self.vs), pytree.tree_leaves(self.lag_model.init_state())):
            buf.copy_(v)
        self.fleet = JaxStream(prng.PRNGKey(self.seed + 1, self.dev, self.base_keys.partitionable), self.dev, num=2)
        self.tick = 0  # the next tick's t: a later run resumes the horizon where the last one stopped

    def _draw(self, t: int) -> None:
        k_vol = self.fleet.round_keys()[1]
        for buf, path, (_, lo) in zip(self.raw_vol, self.lag_model.key_paths(), self.rows):
            prng.uniform(prng.derive(k_vol, path), buf.shape, minval=lo, out=buf)
        self.fleet.advance()
        prng.rows(self.base_keys, (t,), self.raw_g.shape[1], out=self.raw_g)

    def _tick(self) -> None:
        lag, vs = self.lag_model.sample(tuple(self.raw_vol), self.vs)
        x = (lag == 0).to(torch.float32)
        state, out = self.batched(self.cfg, self.state, self.raw_g, x)
        mask = out["mask"]
        arriving, pending = staleness_ring_step(self.pending, mask, lag, self.S, self.alpha)
        self.stale.copy_(torch.sum(arriving, dim=1))
        self.on_time.copy_(torch.sum(mask * x, dim=1))
        for buf, v in zip((*self.state, self.pending, *pytree.tree_leaves(self.vs)),
                          (*state, pending, *pytree.tree_leaves(vs))):
            if v is not buf:
                buf.copy_(v)

    def _capture(self) -> None:
        def warm_up():
            self._draw(0)
            self._tick()

        self.graph, _, self.per_replay, self.warmup_s, self.capture_s = capture_step(self.dev, warm_up, self._tick)
        self.reset()  # the warm-up ran a tick on the buffers

    def run(self, rounds: int, eager: bool = False):
        """``rounds`` ticks from the buffers' state: returns copies of the
        ``(state, pending)`` after them and the ``(rounds, J)`` ``on_time``
        and ``stale`` credit a tick."""
        if self.dev.type == "cuda" and not eager and self.graph is None:
            self._capture()
        J = self.raw_g.shape[0]
        on_time = torch.empty((rounds, J), dtype=torch.float32, device=self.dev)
        stale = torch.empty((rounds, J), dtype=torch.float32, device=self.dev)
        for t in range(rounds):
            self._draw(self.tick)
            self.tick += 1
            if self.graph is not None and not eager:
                self.graph.replay()
                add_launch_counts(self.per_replay)
            else:
                self._tick()
            on_time[t].copy_(self.on_time)
            stale[t].copy_(self.stale)
        state = type(self.state)(*(v.clone() for v in self.state))
        return state, self.pending.clone(), on_time, stale


def _service_horizon(J, K_max, seed, staleness, alpha, p_late, lag_decay, n_iters, tile, device):
    """The standard fleet's ``_ServiceHorizon`` and its ``(Ks, ks)``."""
    S = int(staleness)
    rng = np.random.default_rng(seed)
    Ks, ks, fracs, etas = _heterogeneous_fleet(J, K_max, rng)
    cfg, k_max = pack_jobs(Ks, ks, fracs, etas, K_max=K_max, device=device)
    base = BernoulliVolatility(torch.as_tensor(_fleet_rhos(Ks, K_max), device=device))  # one draw serves a tick
    lag_model = CompletionLag(base, p_late=p_late, lag_decay=lag_decay, max_lag=max(S, 1)) if S else BinaryLag(base)
    return _ServiceHorizon(cfg, k_max, lag_model, S, alpha, seed, n_iters, tile), Ks, ks


def run_service_compiled(
    J: int = 8,
    K_max: int = 4096,
    rounds: int = 30,
    seed: int = 0,
    staleness: int = 2,
    alpha: float = 0.5,
    p_late: float = 0.7,
    lag_decay: float = 0.5,
    n_iters: int = 48,
    tile: int = 8192,
    reps: int = 3,
    reporter: Reporter | None = None,
    device=None,
):
    """Steady-state serving with no host round trip a tick: a batched step
    issues every job's next cohort, a completion-lag draw over the fleet's
    ``(J, K_max)`` Bernoulli classes decides who returns on time, late or
    never, the on-time bits feed the E3CS update, and a ``(J, S, K_max)``
    staleness ring credits late arrivals ``alpha**lag`` ticks later.  The
    tick is one CUDA-graph replay on the card (``_ServiceHorizon``).
    ``staleness=0`` is the synchronous loop.  One horizon off the clock (the
    capture), then ``reps`` fresh timed horizons; the rates come from the
    fastest.  Returns the JAX package's report; there is no host queue, so
    the per-tick cost is the latency.  ``device=None`` means CUDA.
    """
    dev = resolve_device(device)
    S = int(staleness)
    horizon, Ks, ks = _service_horizon(J, K_max, seed, S, alpha, p_late, lag_decay, n_iters, tile, dev)
    horizon.run(rounds)  # off the clock: on the card, the warm-up and the capture
    _sync(dev)
    elapsed = []
    for _ in range(reps):
        horizon.reset()
        _sync(dev)
        t0 = time.perf_counter()
        _, _, on_time, stale = horizon.run(rounds)
        _sync(dev)
        elapsed.append(time.perf_counter() - t0)
    best = min(elapsed)
    n_decisions = rounds * sum(Ks)
    on_time, stale = on_time.cpu().numpy(), stale.cpu().numpy()
    if reporter is not None:
        # the fleet-wide credit a tick (summed over the J jobs) as a windowed
        # stream, and the detector pass over it
        reporter.metrics_stream(
            "serve_async", {"on_time": on_time.sum(1), "stale": stale.sum(1)}, window=max(1, rounds // 10),
            better={"on_time": "higher", "stale": "none"},
        )
        reporter.alerts(series={"on_time": on_time.sum(1)})
    return {
        "mode": "compiled_async" if S else "compiled_sync",
        "jobs": J,
        "K_max": K_max,
        "rounds": rounds,
        "staleness": S,
        "alpha": alpha,
        "ticks": rounds * J,
        "ticks_per_s": round(rounds * J / best, 1),
        "client_decisions_per_s": round(n_decisions / best, 1),
        "tick_us": round(best / (rounds * J) * 1e6, 1),  # per job-tick, = 1e6/ticks_per_s
        "scan_step_us": round(best / rounds * 1e6, 1),  # per tick of all J jobs
        "on_time_total": float(on_time.sum()),
        "stale_credit_total": float(stale.sum()),
        "cohort_sizes": ks,
        "populations": Ks,
    }


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

    run(state0, prng.PRNGKey(seed, mesh.device))  # off the clock: on the card, the capture
    sync()
    elapsed = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run(state0, prng.PRNGKey(seed, mesh.device))
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


def run_server(args, reporter: Reporter, device=None):
    """``--serve``: stand up the socket front end (``repro_torch.serve``)
    instead of a self-driving loop.

    ``--mesh D`` serves K-sharded ``RoundProgram`` jobs (``ShardedEngine`` on
    the process group; at D > 1 rank 0 serves, and on every other rank this
    call follows rank 0's engine and returns None, with ``reporter`` unused);
    otherwise the multi-tenant ``SlotEngine`` handles up to the bucket
    ladder's top in jobs.  Under ``--smoke`` a built-in
    loopback client admits ``--jobs`` tenants, drives ``--rounds`` rounds
    each and shuts the server down; without it the server runs until
    interrupted (clients speak ``repro_torch.serve.protocol``, the JAX
    package's wire contract).

    ``--chaos SEED`` arms a seeded ``FaultPlan`` (engine crashes,
    checkpoint corruption, dropped connections, slow dispatches) against the
    server; the smoke client drives round-tagged ticks with retries and
    rewinds on ``round_desync``, so the horizon completes through the
    injected faults.  ``device=None`` means CUDA.
    """
    import shutil
    import tempfile

    from repro_torch.serve import FaultPlan, SelectionServer, ServeClient, ServeError, ShardedEngine, SlotEngine
    from repro_torch.serve import follow, stop_followers

    dev = resolve_device(device)
    if args.mesh is not None and dist.get_rank() != 0:
        follow(args.mesh, device=dev)
        return None
    S = args.staleness if args.async_mode else 0
    K_max = args.clients or (512 if args.smoke else 4096)
    if args.mesh is not None:
        engine = ShardedEngine(D=args.mesh, staleness=S, alpha=args.alpha, device=dev)
    else:
        engine = SlotEngine(K_max=K_max, staleness=S, alpha=args.alpha, device=dev)
    plan = None
    tmp_ckpt = None
    ckpt_dir, ckpt_every = args.ckpt_dir, args.ckpt_every
    if args.chaos is not None:
        plan = FaultPlan.sample(
            args.chaos, n_steps=args.jobs * args.rounds,
            crashes=1, corruptions=1, drops=2, slow=1, slow_s=0.005,
            first_step=args.jobs + 2,
        )
        # recovery needs restore points: default a checkpoint cadence and dir
        if ckpt_dir is None:
            ckpt_dir = tmp_ckpt = tempfile.mkdtemp(prefix="serve_chaos_")
        ckpt_every = ckpt_every or max(2, args.rounds // 4)
    srv = SelectionServer(
        engine, port=args.port, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
        ckpt_keep=4 if plan else 0, faults=plan,
        restart_backoff=0.01 if plan else 0.05,
    )
    srv.start()
    host, port = srv.address
    print(f"serving {engine.kind} engine (S={S}) on {host}:{port}"
          + (f" under chaos seed {args.chaos}" if plan else ""), flush=True)
    try:
        if args.smoke:
            rng = np.random.default_rng(args.seed)
            K = min(K_max, 256)
            with ServeClient.connect(srv.address, retries=8, seed=args.seed) as c:
                jobs = [c.admit(K=K, k=max(1, K // 16), seed=args.seed + j) for j in range(args.jobs)]
                cursors = {j: 0 for j in jobs}
                while any(t < args.rounds for t in cursors.values()):
                    for j in jobs:
                        t = cursors[j]
                        if t >= args.rounds:
                            continue
                        if S:
                            lag = rng.integers(0, S + 2, K)
                            feed = dict(lags=np.where(lag > S, -1, lag))
                        else:
                            feed = dict(bits=rng.random(K) < 0.7)
                        try:
                            out = c.tick(j, round=t, **feed)
                        except ServeError as e:
                            if e.code == "round_desync":
                                # recovery rolled the job back: replay from there
                                cursors[j] = int(e.response["expected"])
                                continue
                            raise
                        cursors[j] = out["round"] + 1
        else:
            while True:
                time.sleep(1.0)
    except KeyboardInterrupt:
        print("interrupt: draining", flush=True)
    finally:
        srv.close()
        if args.mesh is not None:
            stop_followers()
        srv.attach_report(reporter)
        if tmp_ckpt is not None:
            shutil.rmtree(tmp_ckpt, ignore_errors=True)
    report = {"address": f"{host}:{port}", "engine": engine.kind, "staleness": S}
    if plan is not None:
        fired = plan.fired()
        if srv.stats["ticks"] < args.jobs * args.rounds:
            raise AssertionError(f"chaos run served {srv.stats['ticks']} ticks, not {args.jobs * args.rounds}")
        report.update(
            chaos_seed=args.chaos, fired=fired, restarts=srv.stats["restarts"],
            recovery_s_total=float(sum(srv.recoveries)), replayed=srv.stats["replayed"],
        )
        print(f"chaos survived: fired={fired} restarts={srv.stats['restarts']}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--clients", type=int, default=None,
                    help="K_max: largest job population (default 4096, or 512 under --smoke; "
                         "with --mesh: 1,000,000, or 65,536 under --smoke)")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scenario", type=str, default=None, help="repro_torch.scenarios name to replay as feedback")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="the captured steady-state path with overlapping in-flight rounds")
    ap.add_argument("--staleness", type=int, default=2,
                    help="async buffer depth S (with --async, alone or combined with --mesh; 0 = captured sync)")
    ap.add_argument("--alpha", type=float, default=0.5, help="staleness decay per round of lag")
    ap.add_argument("--fused", action="store_true",
                    help="with --mesh: serve through the fused round kernels (repro_torch.kernels.round_fused)")
    ap.add_argument("--mesh", type=int, default=None, metavar="D",
                    help="serve one K-sharded job over the process group's D ranks (D = 1 starts a one-rank "
                         "group when none exists)")
    ap.add_argument("--serve", action="store_true",
                    help="stand up the socket front end (repro_torch.serve) instead of a self-driving loop; "
                         "combine with --mesh D for K-sharded jobs (at D > 1 on every rank of the started "
                         "group: rank 0 serves, the others follow), --async for staleness-ring serving, "
                         "--smoke for a loopback-driven run")
    ap.add_argument("--port", type=int, default=0, help="--serve listen port (0 = ephemeral)")
    ap.add_argument("--ckpt-dir", type=str, default=None, help="--serve: checkpoint directory for elastic restart")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="--serve: checkpoint every N served rounds (0 = only on drain)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="--serve: arm a seeded FaultPlan (engine crashes, checkpoint corruption, dropped "
                         "connections, slow dispatches) and prove the horizon completes through it")
    ap.add_argument("--smoke", action="store_true", help="a tiny run")
    ap.add_argument("--device", type=str, default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        args.jobs, args.rounds = 4, 10
    dev = resolve_device(args.device)
    K_max = args.clients or (512 if args.smoke else 4096)
    own_group = args.mesh is not None and not dist.is_initialized()
    if own_group:
        if args.mesh != 1:
            raise SystemExit(f"--mesh {args.mesh}: start the {args.mesh}-rank process group first "
                             "(one process per rank); only --mesh 1 starts its own")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        report, rep = _run(args, dev, K_max)
    finally:
        if own_group:
            dist.destroy_process_group()
    if report is None:  # a follower rank of --serve --mesh D
        return
    path = rep.save(report)
    with open(path) as f:
        print(f.read())  # the saved report is the command's output


def _run(args, dev, K_max):
    """The report of the path the command line picked, and its reporter."""
    if args.serve:
        leads = args.mesh is None or dist.get_rank() == 0
        rep = Reporter("serve_front_cli", config=vars(args)) if leads else None
        report = run_server(args, rep, device=dev)
    elif args.mesh is not None:
        K = args.clients or (65_536 if args.smoke else 1_000_000)
        S = args.staleness if args.async_mode else 0
        rep = Reporter("select_serve_sharded_async" if S else "select_serve_sharded", config=vars(args))
        report = run_service_sharded(K=K, rounds=args.rounds, D=args.mesh, seed=args.seed, staleness=S,
                                     alpha=args.alpha, fused=args.fused, reporter=rep, device=dev)
    elif args.async_mode:
        rep = Reporter("select_serve_async", config=vars(args))
        report = run_service_compiled(J=args.jobs, K_max=K_max, rounds=args.rounds, seed=args.seed,
                                      staleness=args.staleness, alpha=args.alpha, reporter=rep, device=dev)
    else:
        rep = Reporter("select_serve", config=vars(args))
        report = run_service(J=args.jobs, K_max=K_max, rounds=args.rounds, seed=args.seed, scenario=args.scenario,
                             reporter=rep, device=dev)
    return report, rep


if __name__ == "__main__":
    main()
