#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device: the card's name and its power limit (``nvidia-smi``);
2. build: compile the CUDA kernels under ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card at the
   main path's shapes (K = 1,000,000 and a ragged 1,000,003, k = 1000; the
   replay decode on a row of its own and on row 1 of a two-row trace, 8
   bytes past a 16-byte boundary for the bits; 3, 15 and 63 bisection caps
   in float32 and float64; the top-k and update kernels at every tile they
   are swept at), with its time, the plain version's, a
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
   it and read just after.  Every runner captures its round step as a CUDA
   graph at its first call (``[graph-capture]``: the warm-up's and the
   capture's host ms, the kernel launches one replay makes) and replays it
   each round of the timed run, whose launch counts are counted over the
   replays;
5. graph check (``[graph-check]``): for twelve runs at K = 1e6 (fused
   sync, fused async late-credit, the staged packed 1-bit and 2-bit
   replays, the fused mesh ``block=4`` sync run, the staged mesh async
   deadline run, fused Markov and regional-outage volatility, a staged
   flash crowd through its window, and the staged random, systematic and
   FedCS selectors, whose noise holds permutations) a captured
   ``carry_key`` runner, at its first call and again, equals a hand loop of
   ``build_step`` + ``draw_noise`` bit for bit: every output, the state,
   the rings and the generator state;
6. checks: cohorts of k distinct clients every round, counts, allocation
   bounds, re-centred finite weights, fused == staged cohorts, the mesh's
   ``block=1`` run == the dense run bit for bit, ``block=4`` allocations
   within ``BLOCK_P_RTOL`` of ``block=1``, launch counts;
7. profile: a dense and three mesh (``block=4``, ``block=1``, and
   ``block=4`` with taps and sketches as the fleet job runs them) fused
   horizons of replayed rounds under ``torch.profiler``: the device's idle
   share and its operations a round, then the same horizon's wall time
   without the profiler, beside the card's name and power limit;
8. fleet job: ``run_service_sharded(K=1e6, rounds=50, D=1, block=4,
   fused=True)`` at staleness 0 and 2 on the one-rank NCCL mesh, taps and
   sketches in the captured step, a ``Reporter`` writing under
   ``chiprun_out/results/``: counters, the ``selected`` series, the sketch
   stream, the fairness series, the alerts (no cohort-size alert) and the
   run log (``validate_records``); ``[fleet-job]`` logs its rates;
9. scenarios: the scenario subsystem's entry points at K = 1e6, k = 1000,
   T = 50 on the card, each with the launch counts set to 0 just before it
   and checked exactly just after (a fresh runner's first call warms its
   step up once and replays it T times: T + 1 launches a kernel a round):
   ``record_trace`` of the seven registry scenarios (each trace's success
   rate against the registry's rate hint, ``[scenario-trace]``) and
   ``record_lag_trace`` of one; ``run_replay`` of E3CS and the four
   baselines on the diurnal trace (the decode kernel a round, the same
   bits for every selector, the top-k kernel a round for FedCS and UCB);
   ``scan_selection_sim("e3cs", vol=<scenario>, allocator="bisect",
   fused=True)`` for each scenario; ``async_selection_sim`` replaying the
   lag trace (the 2-bit decode kernel); ``evaluate_cell("e3cs",
   "flash_crowd", staleness=2, feedback="late_credit")``; and
   ``sharded_selection_sim`` over Markov volatility on the one-rank mesh
   (``block=4``, 12 block sums a round); ``[scenario-run]`` logs each
   call's rounds/s (runner build, warm-up and capture included);
10. mesh (``[mesh-baselines]``, ``[mesh-scenarios]``): random, FedCS,
   pow-d (2k candidates) and UCB on the one-rank NCCL mesh at K = 1e6, k =
   1000, T = 50, each bit-identical to its dense run; fused E3CS over the
   diurnal, regional-outage and flash-crowd models at ``block=1``
   (bit-identical to dense) and ``block=4`` (12 block sums a round), and an
   async S = 2 flash crowd; each baseline and ``block=4`` runner also held
   against its eager step loop; first-call launch counts exact (T + 1),
   steady rounds/s;
11. multi-job (``[multi-job]``): the batched multi-job step against J
   single-job steps at K_max = 1e6 (cohorts bit for bit); the captured
   ``run_service_compiled`` horizon against its eager ticks (bit for bit);
   ``run_service_compiled`` (J = 8, K_max = 1e6, 50 ticks, S = 0 and 2),
   ``run_service`` (J = 8, K_max = 1e5, 30 ticks, Bernoulli and diurnal
   feedback) and ``run_grid_multi_job`` over the seven registry scenarios
   (K = 1e6, k = 1000, T = 50), each with its launch counts checked;
12. fl-train (``[fl-precision]``, ``[fl-check]``, ``[fl-train]``): the FL
   training stack at ``FLConfig``'s defaults (K = 100, k = 20, 500 samples
   a client, batch 40, epochs 1-4) on both CNNs at their published widths:
   EMNIST sync 16 rounds (accuracy above 0.15) and async S = 2 10 rounds
   (late updates applied), CIFAR sync 5 rounds; rounds/s, per round the
   gather, copy and device ms; one round of each profiled; one EMNIST round
   at K = 20 on the card against the CPU (cohort, mask, log-weights equal,
   parameters within the FL tests' tolerance); the convs in IEEE float32
   (``fl_train_path``);
13. zoo (``[zoo-check]``, ``[zoo-serve]``, ``[zoo-consistency]``,
   ``[zoo-width]``): the model zoo's serving path, after the fl-train phase
   with the device freed first: each of the ten archs' ``smoke_variant``
   on the card against the CPU from the same parameters (tokens and cache
   positions equal, logits and caches within ``ZOO_CHECK_TOL``, decode
   against the teacher-forced forward); gemma-2b at its full config, uncut,
   through ``launch.serve.main`` (batch 4, 32 tokens, prompt 64 and 1024:
   prefill ms, decode tokens/s, peak memory), its first decode step
   against the forward in bf16 and float32, a profiled prefill and decode
   step; the other nine at full width (``ZOO_DEPTH`` cuts llama3-405b,
   qwen2-vl-72b and deepseek-v3-671b to two layers), a prefill of 4 x 64
   and 8 decode steps each, finite logits (``zoo_serve_path``).  The zoo
   has no TPU kernel, so it launches none of the kernels line's;
14. zoo-train (``[zoo-train-check]``, ``[zoo-train]``, ``[zoo-train-remat]``,
   ``[zoo-train-consistency]``, ``[zoo-silo]``): the model zoo's training,
   after the zoo phase with the device freed first: each smoke arch's loss
   and gradients (``remat=True``) on the card against the CPU and remat on
   against off; one ``examples/fl_lm.py`` round of the gemma and qwen3-moe
   smokes on the card against the CPU; gemma-2b at its full config, uncut,
   through ``make_cohort_round`` (K = 32, k = 2, 2 local steps of 2 x 512
   tokens, 3 rounds: ms a round and a step, tokens/s, peak memory, remat
   against none, a profiled round); one bf16 local step against float32 at
   full width (2 layers); qwen3-moe at full width (``ZOO_TRAIN_DEPTH`` of
   48 layers) through ``make_silo_steps``, the update against a hand sum
   (``zoo_train_path``).  No kernel of the kernels line runs on it;
15. mesh-zoo (``[mesh-zoo]``, ``[dryrun]``, ``[dryrun-check]``): the model
   zoo on a mesh, after the zoo-train phase: gemma-2b at its full config on
   a one-rank NCCL ``make_mesh((1, 1), ("data", "model"))``, parameters
   placed as DTensors by the logical rules: prefill (4 x 64, 4 x 1024) and
   8 greedy decode steps, one ``make_silo_steps`` step under
   ``silo_rules``, one ``make_cohort_round(spmd_axes="data")`` round, each
   equal bit for bit to the same call without a mesh (``mesh_zoo_path``);
   after the ops phase, the last timed one, the dry run's records
   (``launch.dryrun`` in a process of its own on fake tensors over a
   ``"fake"`` group of 256 or 512 ranks: gemma-2b and llama3-405b
   ``train_4k``, deepseek-v3-671b ``decode_32k`` on two pods) and its
   check programs run for real: FLOPs equal, the predicted peak within
   ``DRYRUN_MEM_RTOL`` (``dryrun_path``).  No kernel of the kernels line
   runs on it;
16. serve (``[serve-slots]``, ``[serve-sharded]``, ``[serve-chaos]``):
   the selection service over loopback sockets, the
   slot engine at K_max = 1e5 (k_cap = 2000: the top-k kernel a row) with
   the standard fleet of 8 jobs at S = 0 and 2, the sharded engine (one-rank
   NCCL mesh, ``block=4``, S = 2) at K = 1e6 and 5e5 across a checkpoint,
   ``kill()`` and restore, and the JAX package's chaos plan at K = 1e6;
   cohorts bit for bit in-process engines', the top-k and block-sum kernels
   against their plain versions on the engines' own inputs, launch counts
   exact, the serving rates and the checkpoint's cost (``serve_path``);
   then the JAX key stream: the threefry kernel against its plain version
   (``threefry_kernel_rows``), JAX-key horizons, rates and JAX stems served
   (``jax_stream_path``), the int-seed entry points on JAX's keys
   (``jax_stream_drivers_path``), JAX's original threefry mode
   (``[jax-stream-original]``, ``jax_stream_original_path``: the committed
   goldens through captured runners, the compiled service and gemma-2b's
   sampled serving in that mode, each entry's original layout against its
   plain version), and ``[fl-pow-d-mesh]``: pow-d's FL server at
   Table I on the one-rank mesh against the unsharded server
   (``fl_pow_d_mesh_path``); then ``[serve-sharded-mesh]``: ``ShardedEngine(D=2, staleness=2,
   block=4)`` at K = 1e6 and 5e5 on two ranks that share the card, each a
   process of its own over a gloo group of the card's tensors (NCCL
   refuses two ranks on one device; the runners step uncaptured): rank 0
   serves, rank 1 follows; the served horizon across ``kill()`` and
   restore, and the chaos plan, bit for bit the in-process D = 2 engine's,
   B5 on both ranks' slabs held against plain and its launches exact
   (``serve_mesh_path``); after the mesh-zoo phase, ``[examples]``: the
   five ``examples/torch_*.py`` at their defaults (``examples_path``);
17. ops: the kernel layer's public ops, the path of the top-k and update
   kernels: ``autotune`` sweeps all four kernel families at K = 1e4, 1e5
   and 1e6 into a fresh cache under ``chiprun_out/autotune/``, then
   ``gumbel_topk_sample``, ``fused_gumbel_topk_sample`` and
   ``e3cs_update_tiled`` run at K = 1e6, k = 1000 with ``tile=None``,
   resolved through that cache; launch counts set to 0 before the phase and
   checked exactly after it, outputs against the plain versions;
18. times: rounds/s and client decisions/s of each run.

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
# the batched multi-job step against J single-job steps: the JAX package's own
# tolerances (tests/test_engine.py); cohorts must be equal exactly
MJ_LOGW_ATOL, MJ_P_ATOL = 1e-5, 1e-6
PSUM_RTOL = 1e-3  # sum of 1e6 float32 probabilities against k
# data-sheet rates (NVIDIA): HBM bytes/s and float32 (non-tensor) flop/s
CARDS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12), ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12))
TIMED_CALLS = 20
# inputs that reach every path of the radix select (all scores equal: the
# digits reach the index word; fewer than k positive: the -inf fill; one
# binade: the chosen bin overflows the candidate buffer; half the scores
# +inf: UCB's unexplored clients, ties at the top key), k = 1, k = 2048 and
# K = k, at K = 1e6 and 1,000,003; and the multi-job service's rows (K_max =
# 1e5, k_max = 2000)
ENGINE_CASES = [(case, K, k) for K in (K_MAIN, K_RAGGED)
                for case, k in (("equal", k_MAIN), ("few_positive", k_MAIN), ("binade", k_MAIN), ("inf_ties", k_MAIN),
                                ("gumbel", 1), ("gumbel", 2048))] + [("gumbel", 2048, 2048), ("equal", 2048, 2048),
                                                                     ("few_positive", 100_000, 2000),
                                                                     ("gumbel", 100_000, 2000)]
# fused runs with no staged partner: every other "-fused" run must have one
UNPAIRED_FUSED_RUNS = ("mesh-block1-sync-full-fused",)
SCENARIO_SEED = 3
SELECTORS = ("e3cs", "random", "fedcs", "pow_d", "ucb")
# pow-d's candidate set at k = 1000 (FLConfig's 40 holds only for k <= 40)
POW_D = 2 * k_MAIN
# a trace's mean success rate against its rate hint: standard deviations of
# the mean of its K * rounds Bernoulli draws, inflated by (1 + s) / (1 - s)
# for a Markov chain of stickiness s (the variance of a sum of draws whose
# lag-j correlation is s**j)
RATE_Z = 6.0
# the serving chaos run: device memory after the recovery against before the
# crash (the restored engine holds the same buffers and graphs as the crashed),
# and what an engine's whole life leaves allocated
SERVE_MEM_MARGIN = 16 << 20
CHIPRUN_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
GOLDEN_TORCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden_torch")
TESTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
GOLDENS_NPZ = os.path.join(TESTS_DIR, "golden", "round_program_goldens.npz")  # written in JAX's original mode
JAX_NOISE_ATOL = 2e-6  # a Gumbel value against JAX's: the last bit of two logs (measured 9.5e-7 at 1e6 draws)
# The H100's SM clocks a second, summed over its SMs: the data sheet's 67
# Tflop/s float32 is 132 SMs x 128 lanes x 2 flops x 1.98 GHz.  An SM issues
# 128 lanes a clock (four schedulers of 32); funnel shifts and LOP3 (xor, or)
# run only on its ALU pipe, 64 lanes a clock, while an add may also issue on
# the FMA pipe as IMAD.
H100_SM_CLOCKS = 132 * 1.98e9
THREEFRY_LANES = {"issue": 128, "alu": 64}
# A threefry2x32 hash (csrc/threefry.cu): 32 adds, 20 funnel shifts (the
# rotates) and 20 xors.  Each epilogue adds a ^ b (not "keys"), and for
# "uniform" and "gumbel" the mantissa's shift and or, the subtraction, the
# fused multiply-add and the max; "gumbel" then two logs, at least one
# instruction each.
THREEFRY_OPS = {"keys": {"issue": 72, "alu": 40}, "bits": {"issue": 73, "alu": 41},
                "sortkey": {"issue": 74, "alu": 42}, "uniform": {"issue": 78, "alu": 43},
                "gumbel": {"issue": 80, "alu": 43}}
JAX_STREAM_RATE_T = 200  # rounds of the timed twin and Philox horizons
# "normal" adds to "uniform" XLA's erf_inv: x * x, log1p (one MUFU and about
# eight FMA-pipe operations), the branch's compare, select, sqrt and
# subtract, the coefficients' selects and the final two multiplies (about 15
# float32 operations on the issue pipes), and eight multiply-adds taken as a
# float64 product and sum (16 float64 operations; the H100 runs 64 float64
# lanes an SM a clock).  "categorical" is "gumbel" plus the logit's add and
# the running argmax's compare and select.  JAX's bfloat16 Gumbel is a
# function of 7 random bits (tests/test_torch_prng_bf16_gumbel.py), so the
# least work a bfloat16 value needs is the hash and its xor, the byte's
# shift and mask (ALU), a read of a 128-entry table, the logit's add with
# its one rounding (three integer operations, ALU) and the compare and
# select: 81 issued, 46 on the ALU pipe (counting its two logs and four
# roundings a value, as the arithmetic is written, makes it 96 and 57).
THREEFRY_OPS.update({"normal": {"issue": 109, "alu": 43, "fp64": 16},
                     "categorical_f32": {"issue": 84, "alu": 45},
                     "categorical_bf16": {"issue": 81, "alu": 46}})
THREEFRY_LANES["fp64"] = 64
# the a ^ b each partitionable epilogue above starts with: the original
# layout's value is a word of its own (no xor), and one hash gives two words
THREEFRY_XOR = {"issue": 1, "alu": 1}
NORMAL_KERNEL_ATOL = 1e-6  # two float32 ulps at |x| <= 5.42, the largest normal: CUDA's log1pf against ATen's
DRIVER_SAMPLE = 4096  # positions a leaf the drivers' checks read (the fixture's SAMPLE)
DRIVER_PARAM_ULPS = 4  # a normal within 3 ulps of JAX's, times a float32 scale (tests/test_torch_prng_dists.py)


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
    from repro_torch.obs import SketchSpec

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
            # row 1 of a (2, B) trace, as the staged replay hands rows over:
            # byte offset B, 8 past a 16-byte boundary for the bits at K = 1e6
            odd = torch.stack([packed.roll(1), packed])[1]
            err = max(max_err({"out": fn(row, K)}, {"out": rfn(row, K)}) for row in (packed, odd))
            log("kernel-check", kernel=kname, K=K, rows="aligned,odd", odd_row_offset16=odd.data_ptr() % 16,
                max_abs_err=err)
            if K == K_MAIN:
                out = fn(packed, K)
                b = bound(nbytes(packed, out), 2 * K)
                ms = graph_ms(lambda: fn(packed, K))
                log("kernel-row-time", kernel=kname, K=K, aligned_ms=f"{ms:.4f}",
                    odd_row_ms=f"{graph_ms(lambda: fn(odd, K)):.4f}", odd_row_offset16=odd.data_ptr() % 16,
                    bound_ms=f"{b[0]:.4f}", card=repr(smi))
                rows[kname] = dict(route="cuda", source="src/repro_torch/kernels/csrc/unpack_bits.cu", replaces=line,
                                   max_abs_err=err, ms=ms, plain_ms=events_ms(lambda: rfn(packed, K)), bound_ms=b[0],
                                   bound_by=b[1], library_ms=None)
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
                       "fused_gumbel_topk": {tl: v[1] for tl, v in topk_ms.items()},
                       # B8's working set (5 input rows and the output, 24 MB)
                       # stays in the 50 MB L2 across replays on the same
                       # inputs, which read above its DRAM bound: B8 reports
                       # the rotation over four copies, each call L2-cold
                       "e3cs_update": upd_cold_ms}
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
                replaces="src/repro/kernels/e3cs_tiles.py:139", max_abs_err=err8, ms=upd_cold_ms[8192],
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
        graph_check(dev, K_MAIN, k_MAIN, T_SHORT, rng, mesh)
        check_runs(runs)
        # only the times are read again (phase 10): the K = 10^6 outputs go
        runs = {label: (None, secs, T, cfg) for label, (_, secs, T, cfg) in runs.items()}
        profile_round(dev, K_MAIN, k_MAIN, label="dense", card=smi)
        profile_round(dev, K_MAIN, k_MAIN, label="mesh-block4", card=smi, mesh=mesh, block=4)
        profile_round(dev, K_MAIN, k_MAIN, label="mesh-block1", card=smi, mesh=mesh, block=1)
        profile_round(dev, K_MAIN, k_MAIN, label="mesh-block4-taps-sketch", card=smi, mesh=mesh, block=4,
                      runner=dict(taps=True, sketch=SketchSpec(window=5, n_regions=4)))
        fleet_job(dev, K_MAIN, T_MAIN, card=smi)
        for n, c in scenarios_path(dev, K_MAIN, k_MAIN, T_MAIN, mesh, card=smi).items():
            launched.setdefault(n, c)
        for n, c in mesh_path(dev, K_MAIN, k_MAIN, T_MAIN, T_SHORT, mesh, card=smi).items():
            launched.setdefault(n, c)
        # the serving paths are this slice's main path: their counts go in the kernels line
        launched.update(serve_path(dev, card=smi))
        rows.update(threefry_kernel_rows(dev, card=smi, bw=bw))
        stream_counts = jax_stream_path(dev, card=smi)
        for n, c in stream_counts.items():
            launched[n] = launched.get(n, 0) + c
        # the int-seed drivers on the JAX key stream: a path of its own, counts read just after it
        driver_counts, driver_rows = jax_stream_drivers_path(dev, card=smi, bw=bw)
        missing = [n for n in driver_rows if not driver_counts.get(n)]
        if missing:
            raise AssertionError(f"jax-stream-drivers: no launch of {missing} on the drivers' path")
        rows.update(driver_rows)
        for n, c in driver_counts.items():
            launched[n] = launched.get(n, 0) + c
        # JAX's original threefry mode: a path of its own, counts read just after it
        original_counts, original_rows = jax_stream_original_path(dev, card=smi, bw=bw)
        rows.update(original_rows)
        for n, c in original_counts.items():
            launched[n] = launched.get(n, 0) + c
        fl_pow_d_mesh_path(dev, card=smi)
    finally:
        dist.destroy_process_group()
    # the sharded service on two ranks sharing the card: B5 on both ranks' slabs
    for n, c in serve_mesh_path(dev, card=smi).items():
        launched[n] = launched.get(n, 0) + c
    for n, c in multi_job_path(dev, K_MAIN, k_MAIN, T_MAIN, T_SHORT, card=smi).items():
        launched.setdefault(n, c)
    fl_train_path(dev, card=smi)
    release_engine_memory(card=smi)
    zoo_serve_path(dev, card=smi)
    zoo_train_path(dev, card=smi)
    mesh_zoo_path(dev, card=smi)
    examples_path(dev, card=smi)

    # -- 9. the ops and the autotuner ----------------------------------------------
    ops_counts, ops_tiles = ops_path(dev, K_MAIN, k_MAIN)
    for n, c in ops_counts.items():
        if c:
            launched.setdefault(n, c)
    # the ops' kernels are reported at the tile the ops resolved through the cache
    for kname, tname in (("gumbel_topk", "gumbel_topk"), ("fused_gumbel_topk", "gumbel_topk"),
                         ("e3cs_update", "e3cs_tiles")):
        rows[kname]["ms"] = tile_ms[kname][ops_tiles[tname]]
        log("kernel-time", kernel=kname, tile=ops_tiles[tname], ms=f"{rows[kname]['ms']:.4f}", card=repr(smi))

    # the dry run plans on the host, in a process of its own, after the last
    # timed phase: no time above shares the host with it
    dryrun_path(dev, card=smi)

    # -- 10. times --------------------------------------------------------------
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
    if case == "inf_ties":
        g = np.where(rng.random(K) < 0.5, np.inf, g)
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
    elif case == "inf_ties":  # UCB: every unexplored client scores +inf
        scores = np.where(rng.random(K) < 0.5, np.inf, scores)
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
    packed_bits, packed_lags = packed_rows(rng, T_short, K)
    runs = {}
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    launched = {}

    def drive(label, cfg, *, fused, outputs="full", T=T, expect, **opts):
        xs = opts.pop("xs", None)
        pm = RoundProgram.from_config(cfg, fused=fused, device=dev, **opts)
        xs = None if xs is None else pm.local_rows(xs)
        run, s0 = pm.build_runner(outputs=outputs, scan_length=T)
        run(s0, 7, xs)  # the first call: on the card, the warm-up and the capture
        sync()
        if on_card:
            hz = run.horizon
            log("graph-capture", run=label, warmup_ms=f"{hz.warmup_s * 1e3:.1f}",
                capture_ms=f"{hz.capture_s * 1e3:.1f}", launches_per_replay=json.dumps(hz.per_replay))
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


def packed_rows(rng, T, K):
    """``(T, ceil(K/8))`` 1-bit success rows and ``(T, ceil(K/4))`` 2-bit lag
    rows (codes 0, 1, 2 and the dead code 3), little-endian."""
    packed_bits = np.packbits(rng.random((T, K)) < 0.6, axis=1, bitorder="little")
    codes = rng.choice(np.arange(4, dtype=np.uint8), (T, K), p=[0.5, 0.15, 0.1, 0.25])
    packed_lags = np.bitwise_or.reduce(codes.reshape(T, -1, 4) << np.array([0, 2, 4, 6], np.uint8), axis=2)
    return packed_bits, packed_lags


def graph_check(dev, K, k, T, rng, mesh, seed=5):
    """Phase 5: each of twelve runs as a ``carry_key`` runner, called
    twice (the first call captures on the card), against a hand loop of
    ``build_step`` + ``draw_noise`` from the same seed: every output, the
    state, the rings and the generator state, bit for bit; an E3CS run's
    weights finite and re-centred to a maximum of 0."""
    import dataclasses

    import torch

    from repro_torch.configs import FLConfig
    from repro_torch.engine import RoundProgram

    fl = FLConfig(K=K, k=k, rounds=T_MAIN, scheme="e3cs", quota_frac=0.5, allocator="bisect",
                  volatility="bernoulli")
    fl_async = dataclasses.replace(fl, staleness_rounds=2)
    bits, lags = (torch.from_numpy(a).to(dev) for a in packed_rows(rng, T, K))
    m4 = dict(mesh=mesh, block=4)
    cases = {
        "sync-full-fused": (fl, dict(fused=True), None),
        "async-S2-late_credit-fused": (fl_async, dict(fused=True, feedback="late_credit"), None),
        "packed-staged": (fl, dict(fused=False, override="packed"), bits),
        "packed_lags-staged": (fl_async, dict(fused=False, override="packed_lags"), lags),
        "mesh-sync-full-fused": (fl, dict(fused=True, **m4), None),
        "mesh-async-S2-deadline-staged": (fl_async, dict(fused=False, **m4), None),
        "markov-fused": (dataclasses.replace(fl, volatility="markov"), dict(fused=True), None),
        "regional_outage-fused": (dataclasses.replace(fl, volatility="regional_outage"), dict(fused=True), None),
        # a 16-round flash crowd: its window [4, 8) falls inside the T rounds
        "flash_crowd-staged": (dataclasses.replace(fl, volatility="flash_crowd", rounds=16), dict(fused=False), None),
        "random-staged": (dataclasses.replace(fl, scheme="random"), dict(fused=False), None),
        "systematic-staged": (dataclasses.replace(fl, sampler="systematic"), dict(fused=False), None),
        "fedcs-staged": (dataclasses.replace(fl, scheme="fedcs"), dict(fused=False), None),
    }
    for label, (cfg, opts, xs) in cases.items():
        pm = RoundProgram.from_config(cfg, device=dev, **opts)
        graph_vs_eager(label, pm, T, seed, None if xs is None else pm.local_rows(xs))


def graph_vs_eager(label, pm, T, seed, xs=None):
    """A ``carry_key`` runner of ``pm``, called twice (the first call
    captures on the card), against a hand loop of ``build_step`` +
    ``draw_noise`` from the same seed: every output, the state, the rings
    and the generator state, bit for bit; an E3CS run's weights finite and
    re-centred to a maximum of 0."""
    import torch
    from torch.utils import _pytree as pytree

    run, s0 = pm.build_runner(outputs="full", carry_key=True, scan_length=T)
    rings0 = () if pm.staleness is None else (pm.init_rings(),)
    got = [run(s0, seed, *rings0, xs) for _ in range(2)]
    step, _ = pm.build_step()
    gen = pm.generator(seed)
    carry = (s0,) + tuple(tuple(r.clone() for r in rings) for rings in rings0)
    outs = []
    for t in range(T):
        carry, out = step(carry, None if xs is None else xs[t], pm.draw_noise(gen))
        outs.append(out)
    want = pytree.tree_leaves((carry[0], gen.get_state(), *carry[1:], *(torch.stack(c) for c in zip(*outs))))
    for call, result in enumerate(got):
        leaves = pytree.tree_leaves(result)
        same = len(leaves) == len(want) and all(
            torch.equal(a, b) if torch.is_tensor(a) else a == b for a, b in zip(leaves, want))
        if not same:
            raise AssertionError(f"graph check {label}: call {call + 1} of the runner differs from the eager "
                                 "step loop")
    logw = got[0][0].e3cs.logw
    if pm.fl.scheme == "e3cs" and not (bool(torch.isfinite(logw).all()) and float(logw.max()) == 0.0):
        raise AssertionError(f"graph check {label}: logw not finite or not re-centred to max 0")
    hz = run.horizon
    log("graph-check", run=label, K=pm.fl.K, rounds=T, calls=2, result="bit-identical",
        compared="outputs,state,rings,generator_state", captured=hz.graph is not None,
        launches_per_replay=json.dumps(hz.per_replay))


def fleet_job(dev, K, rounds, card):
    """Phase 8: the selection service's fleet job on the one-rank mesh, with its
    ``Reporter`` under ``chiprun_out/results/``, at staleness 0 and 2."""
    from repro_torch import kernels as kn
    from repro_torch.launch.select_serve import run_service_sharded
    from repro_torch.obs import Reporter, read_runlog, validate_records

    os.environ["REPRO_RESULTS"] = os.path.join(CHIPRUN_OUT, "results")

    class Recorder(Reporter):
        """A ``Reporter`` that keeps the raw series and sketch stream handed to it."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.raw, self.sketches = {}, None

        def metrics_stream(self, stream, series, window, better=None):
            self.raw[stream] = series
            return super().metrics_stream(stream, series, window, better)

        def fairness_stream(self, stream, sketches):
            self.sketches = sketches
            return super().fairness_stream(stream, sketches)

    for S in (0, 2):
        rep = Recorder(f"fleet_job_S{S}", config=dict(K=K, rounds=rounds, D=1, block=4, fused=True, staleness=S))
        kn.reset_launch_counts()
        report = run_service_sharded(K=K, rounds=rounds, D=1, block=4, fused=True, staleness=S, reporter=rep,
                                     device=dev)
        launches = {n: c for n, c in kn.launch_counts().items() if c}
        rep.save(report)
        k, counters = report["k"], report["tap_counters"]
        if counters["rounds"] != rounds or counters["cum_selected"] != rounds * k:
            raise AssertionError(f"fleet job S={S}: counters {counters}, want {rounds} rounds of {k}")
        selected = rep.raw["serve_sharded"]["selected"]
        if selected.shape != (rounds,) or not (selected == k).all():
            raise AssertionError(f"fleet job S={S}: the selected series is not k = {k} every round")
        W = max(1, rounds // 5)
        count_hist = rep.sketches["count_hist"]
        if count_hist.shape[0] != rounds // W or not (count_hist.sum(axis=1) == K).all():
            raise AssertionError(f"fleet job S={S}: sketch stream of {count_hist.shape[0]} rows with count_hist "
                                 f"sums {count_hist.sum(axis=1)}, want {rounds // W} rows of {K}")
        fair = rep.raw["fairness"]
        if not all(np.isfinite(v).all() for v in fair.values()):
            raise AssertionError(f"fleet job S={S}: fairness series not finite")
        for a in rep.data["alerts"]:
            log("fleet-alert", staleness=S, **{key: json.dumps(v) if isinstance(v, (dict, list, str)) else v
                                               for key, v in a.items()})
            if a["rule"] == "drift" and a.get("metric") == "selected":
                raise AssertionError(f"fleet job S={S}: a cohort-size alert fired: {a['message']}")
        records = read_runlog(rep.log.path)
        validate_records(records)
        log("fleet-job", staleness=S, K=K, k=k, rounds=rounds, mesh_devices=report["mesh_devices"],
            block=report["bisect_block"], rounds_per_s=report["rounds_per_s"],
            client_decisions_per_s=report["client_decisions_per_s"], round_us=report["round_us"],
            counters=json.dumps(counters), sketch_rows=count_hist.shape[0],
            jain_last=f"{fair['jain'][-1]:.6f}", alerts=len(rep.data["alerts"]), runlog_records=len(records),
            runlog=os.path.relpath(rep.log.path), launches=json.dumps(launches), card=repr(card))


def scenarios_path(dev, K, k, T, mesh, card, seed=SCENARIO_SEED):
    """Phase 9: the scenario subsystem's entry points at (K, k, T) on
    ``dev``.  Each call starts with the launch counts at 0 and must end with
    exactly the launches its path makes (none on the CPU): a fresh runner's
    first call warms its step up once and replays it T times, so a kernel of
    the step launches T + 1 times.  Returns the first launch count of each
    wrapper."""
    import torch

    from repro_torch import kernels as kn
    from repro_torch.configs import FLConfig
    from repro_torch.core.volatility import CompletionLag, make_volatility, paper_success_rates
    from repro_torch.engine import RoundProgram, async_selection_sim, scan_selection_sim, sharded_selection_sim
    from repro_torch.engine.sharded import N_ITERS
    from repro_torch.kernels.ref import unpack_bits_ref
    from repro_torch.scenarios import SCENARIOS, evaluate_cell, harness, make_scenario, record_lag_trace, record_trace

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    launched = {}
    n1 = T + 1  # one warm-up call of the step and T replays

    def timed(label, expect, fn, rounds=T):
        kn.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs = time.perf_counter() - t0
        counts = kn.launch_counts()
        want = {n: 0 for n in counts} | (expect if on_card else {})
        if counts != want:
            raise AssertionError(f"scenario run {label}: launches {counts}, expected {want}")
        for n, c in counts.items():
            if c:
                launched.setdefault(n, c)
        log("scenario-run", run=label, K=K, k=k, rounds=rounds, seconds=f"{secs:.4f}",
            call_rounds_per_s=f"{rounds / secs:.3f}", launches=json.dumps({n: c for n, c in counts.items() if c}),
            card=repr(card))
        return out

    def check_sim(label, out, allocated=True):
        masks, ps, sigmas = out["masks"], out["ps"], out["sigmas"]
        if masks.shape != (T, K) or not np.all(masks.sum(1) == k):
            raise AssertionError(f"{label}: a round's cohort is not k distinct clients")
        psum = ps.sum(1, dtype=np.float64)
        if not np.allclose(psum, k, rtol=PSUM_RTOL):
            raise AssertionError(f"{label}: sum(p) far from k: {psum.min()}..{psum.max()}")
        if allocated and not (np.all(ps >= sigmas[:, None] - 1e-7) and np.all(ps <= 1.0)):
            raise AssertionError(f"{label}: p outside [sigma, 1]")

    # -- the seven scenarios' traces against their rate hints ------------------------
    for name in SCENARIOS:
        vol, rho = make_scenario(name, K, T, seed, device=dev)
        packed = timed(f"record_trace-{name}", record_draws(T, len(vol.draw_rows())),
                       lambda: record_trace(vol, T, seed=seed, device=dev))
        if packed.shape != (T, (K + 7) // 8) or packed.dtype != np.uint8:
            raise AssertionError(f"record_trace {name}: {packed.dtype}{packed.shape}")
        check_rate_hint(name, vol, rho, unpack_bits_ref(torch.from_numpy(packed).to(dev), K), card)
    # recorded from another seed than the replay's selection noise (see run_replay)
    lag_vol, _ = make_scenario("diurnal", K, T, seed, device=dev)
    lags = timed("record_lag_trace-diurnal", record_draws(T, len(CompletionLag(lag_vol, max_lag=2).draw_rows())),
                 lambda: record_lag_trace(CompletionLag(lag_vol, max_lag=2), T, seed=seed + 1, device=dev))
    if lags.shape != (T, (K + 3) // 4):
        raise AssertionError(f"record_lag_trace: shape {lags.shape}")

    # -- E3CS and the four baselines on one frozen diurnal trace ---------------------
    # run_replay records the trace itself and keeps only each selector's
    # metric row; a recorder around the harness's scan_selection_sim checks
    # each selector's run (its bits, cohorts and launches) as it returns
    seen, traces_seen = [], []

    def recorder(sel, **kw):
        before = kn.launch_counts()
        t0 = time.perf_counter()
        out = scan_selection_sim(sel, **kw)
        sync()
        secs = time.perf_counter() - t0
        counts = {n: c - before[n] for n, c in kn.launch_counts().items() if c != before[n]}
        log("scenario-run", run=f"run_replay-diurnal/scan_selection_sim-{sel}", K=K, k=k, rounds=T,
            seconds=f"{secs:.4f}", call_rounds_per_s=f"{T / secs:.3f}", launches=json.dumps(counts), card=repr(card))
        bits = unpack_bits_ref(torch.from_numpy(kw["packed_override"]).to(dev), K).cpu().numpy()
        if not np.array_equal(out["xs"], bits):
            raise AssertionError(f"run_replay {sel}: its outcomes are not the recorded trace")
        check_sim(f"run_replay {sel}", out, allocated=sel == "e3cs")
        want = {"unpack_bits": n1} | ({"gumbel_topk": n1} if sel in ("fedcs", "ucb") else {}) | stream_draws(n1, sel)
        if on_card and counts != want:
            raise AssertionError(f"run_replay {sel}: launches {counts}, expected {want}")
        seen.append(sel)
        traces_seen.append(kw["packed_override"])
        return out

    harness.scan_selection_sim = recorder
    try:  # its time includes the recorder's checks
        replay_want = add_counts({"unpack_bits": len(SELECTORS) * n1, "gumbel_topk": 2 * n1},
                                 record_draws(T, len(make_scenario("diurnal", K, T, seed, device=dev)[0].draw_rows())),
                                 *(stream_draws(n1, sel) for sel in SELECTORS))
        rows, packed = timed("run_replay-diurnal", replay_want,
                             lambda: harness.run_replay(SELECTORS, "diurnal", K=K, k=k, T=T, seed=seed, frac=0.5,
                                                        pow_d=POW_D, device=dev), rounds=len(SELECTORS) * T)
    finally:
        harness.scan_selection_sim = scan_selection_sim
    if seen != list(SELECTORS) or any(p is not packed for p in traces_seen):
        raise AssertionError(f"run_replay ran {seen}, not every selector on the one recorded trace")
    for row in rows:
        if not all(np.isfinite(v) for v in row.values() if isinstance(v, float)):
            raise AssertionError(f"run_replay row not finite: {row}")
        log("scenario-row", **{key: f"{v:.6g}" if isinstance(v, float) else v for key, v in row.items()})

    # -- the fused E3CS round under each scenario's model ---------------------------
    fused = {"round_select.from_w": n1, "round_tail": n1}
    for name in SCENARIOS:
        vol, rho = make_scenario(name, K, T, seed, device=dev)
        out = timed(f"scan_selection_sim-e3cs-{name}-fused", fused | stream_draws(n1, rows=len(vol.draw_rows())),
                    lambda: scan_selection_sim("e3cs", K=K, k=k, T=T, frac=0.5, seed=seed, vol=vol, rho=rho,
                                               allocator="bisect", fused=True, device=dev))
        check_sim(f"scan_selection_sim {name}", out)
        del out

    # -- the async round replaying the 2-bit lag trace, and one harness cell ---------
    aout = timed("async_selection_sim-e3cs-S2-packed_lags", {"unpack_crumbs": n1} | stream_draws(n1),
                 lambda: async_selection_sim("e3cs", K=K, k=k, T=T, frac=0.5, seed=seed, staleness=2,
                                             packed_lag_override=lags, device=dev))
    codes = ((lags[..., None] >> np.arange(0, 8, 2, dtype=np.uint8)) & 3).reshape(T, -1)[:, :K].astype(np.int32)
    if not (np.array_equal(aout["lags"], np.where(codes == 3, -1, codes)) and np.all(aout["masks"].sum(1) == k)):
        raise AssertionError("async replay: lags are not the trace's, or a cohort is not k clients")
    logw = aout["final_logw"]
    if not (np.isfinite(logw).all() and float(logw.max()) == 0.0):
        raise AssertionError("async replay: logw not finite or not re-centred to max 0")
    del aout
    crowd_rows = len(make_scenario("flash_crowd", K, T, seed, device=dev)[0].draw_rows())
    cell_want = add_counts(stream_draws(n1, rows=crowd_rows), stream_draws(2 * n1, rows=crowd_rows + 2))
    row = timed("evaluate_cell-e3cs-flash_crowd-S2-late_credit", cell_want,
                lambda: evaluate_cell("e3cs", "flash_crowd", K=K, k=k, T=T, seed=seed, staleness=2,
                                      feedback="late_credit", device=dev), rounds=3 * T)
    if not all(np.isfinite(v) for v in row.values() if isinstance(v, float)):
        raise AssertionError(f"evaluate_cell row not finite: {row}")
    log("scenario-row", **{key: f"{v:.6g}" if isinstance(v, float) else v for key, v in row.items()})

    # -- steady rounds/s: each scenario model under the fused E3CS round, and
    # each selector over Bernoulli volatility, a runner's second call ------------
    steady = [(name, "e3cs", "plackett_luce", True) for name in SCENARIOS] + [
        ("paper_iid", sel, "plackett_luce", False) for sel in SELECTORS] + [("paper_iid", "e3cs", "systematic", False)]
    for name, sel, sampler, fuse in steady:
        cfg = FLConfig(K=K, k=k, rounds=T, scheme=sel, sampler=sampler, quota_frac=0.5, allocator="bisect",
                       volatility=name, seed=seed, pow_d=POW_D)
        pm = RoundProgram.from_config(cfg, fused=fuse, device=dev)
        run, s0 = pm.build_runner(outputs="full")
        run(s0, seed)  # warm-up and capture
        sync()
        label = f"{name}-{sel}{'-systematic' if sampler == 'systematic' else ''}-{'fused' if fuse else 'staged'}"
        per_round = {"round_select.from_w": T, "round_tail": T} if fuse else (
            {"gumbel_topk": T} if sel in ("fedcs", "ucb") or sampler == "systematic" else {})
        out = timed(f"steady-{label}", per_round, lambda: run(s0, seed))
        masks = out[1]
        if not bool((masks.sum(1) == k).all()):
            raise AssertionError(f"steady {label}: a round's cohort is not k distinct clients")
        hz = run.horizon
        if on_card:
            log("scenario-capture", run=label, warmup_ms=f"{hz.warmup_s * 1e3:.1f}", capture_ms=f"{hz.capture_s * 1e3:.1f}",
                launches_per_replay=json.dumps(hz.per_replay))
        del out, masks, run

    # -- the K-sharded round over Markov volatility ---------------------------------
    markov_rows = len(make_volatility("markov", paper_success_rates(8), device="cpu").draw_rows())
    out = timed("sharded_selection_sim-e3cs-markov-block4-fused",
                fused | {"bisect_block_sums": -(-N_ITERS // 4) * n1} | stream_draws(n1, rows=markov_rows),
                lambda: sharded_selection_sim("e3cs", mesh, K=K, k=k, T=T, frac=0.5, volatility="markov", seed=seed,
                                              block=4, fused=True, device=dev))
    check_sim("sharded_selection_sim markov", out)
    log("check", scenarios="all scenario-phase checks passed")
    return launched


def stream_draws(n, scheme="e3cs", sampler="plackett_luce", rows=0, K=K_MAIN):
    """The threefry launches of ``n`` rounds' noise on the JAX key stream
    (``RoundProgram._draw_jax``, a captured runner's first call draws T + 1
    times: its warm-up and T rounds): each round advances the key (one
    ``keys``), draws the selection's noise (E3CS's Gumbel row; a uniform row
    for FedCS and the systematic sampler; ``_permutation_rounds(K)`` sort-key
    rows a permutation, for random, pow-d and the systematic sampler) and
    ``rows`` volatility rows (``uniform``)."""
    from repro_torch.core.prng import _permutation_rounds

    pl = scheme == "e3cs" and sampler == "plackett_luce"
    perms = 1 if scheme in ("random", "pow_d") or (scheme == "e3cs" and not pl) else 0
    uniforms = rows + (1 if scheme == "fedcs" or (scheme == "e3cs" and not pl) else 0)
    c = {"threefry.keys": n, "threefry.gumbel": n if pl else 0, "threefry.uniform": n * uniforms,
         "threefry.sortkey": n * perms * _permutation_rounds(K)}
    return {name: v for name, v in c.items() if v}


def record_draws(T, rows):
    """The threefry launches of ``record_trace`` over ``T`` rounds of a model
    of ``rows`` rows: a uniform launch a row and the key's advance a round."""
    return {"threefry.keys": T, "threefry.uniform": T * rows}


def add_counts(*counts):
    out = {}
    for c in counts:
        for name, v in c.items():
            out[name] = out.get(name, 0) + v
    return out


def counted_call(label, expect, fn, dev, launched):
    """``fn()`` with the launch counts set to 0 just before it; the counts
    just after must be ``expect`` (none on the CPU, where every wrapper
    takes its plain version).  Each wrapper's first count goes into
    ``launched``.  Returns ``(result, seconds, the counts that are not 0)``."""
    import torch

    from repro_torch import kernels as kn

    kn.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = kn.launch_counts()
    want = {n: 0 for n in counts} | (expect if dev.type == "cuda" else {})
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    for n, c in counts.items():
        if c:
            launched.setdefault(n, c)
    return out, secs, {n: c for n, c in counts.items() if c}


def mesh_path(dev, K, k, T, T_short, mesh, card, seed=SCENARIO_SEED):
    """Phase 10: the baselines and the scenario models on the one-rank mesh
    at (K, k, T).  ``[mesh-baselines]``: random, FedCS, pow-d (2k
    candidates) and UCB, each bit-identical to the dense runner (masks, xs,
    p, sigmas, the final state); ``[mesh-scenarios]``: fused E3CS over the
    diurnal, regional-outage and flash-crowd models, at ``block=1``
    bit-identical to the dense bisect runner, at ``block=4`` cohorts of k
    distinct clients with 12 block sums a round, and one async S = 2 run
    over ``CompletionLag(flash_crowd)``.  Each runner's first call (warm-up,
    capture, T replays: T + 1 launches a kernel a round) and second call
    (T replays: the steady rate) run with the launch counts set to 0 just
    before and checked exactly just after; each ``block=4`` and baseline
    runner is also held against its eager step loop (``graph_vs_eager``, at
    ``T_short`` rounds).  Returns the first launch count of each wrapper."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.configs import FLConfig
    from repro_torch.engine import RoundProgram
    from repro_torch.engine.sharded import N_ITERS

    on_card = dev.type == "cuda"
    launched = {}
    n_block = -(-N_ITERS // 4)

    def counted(label, expect, fn):
        return counted_call(label, expect, fn, dev, launched)

    def drive(phase, label, pm, per_round):
        """The runner's first and second call; returns the second's outputs."""
        run, s0 = pm.build_runner(outputs="full")
        _, first_s, first = counted(f"{label} (first call)", {n: c * (T + 1) for n, c in per_round.items()},
                                    lambda: run(s0, seed))
        out, secs, steady = counted(f"{label} (second call)", {n: c * T for n, c in per_round.items()},
                                    lambda: run(s0, seed))
        masks = out[1]
        if not bool((masks.sum(1) == k).all()):
            raise AssertionError(f"{label}: a round's cohort is not k distinct clients")
        hz = run.horizon
        log(phase, run=label, K=K, k=k, rounds=T, first_call_s=f"{first_s:.4f}", steady_rounds_per_s=f"{T / secs:.3f}",
            client_decisions_per_s=f"{T * K / secs:.6g}",
            warmup_ms=f"{hz.warmup_s * 1e3:.1f}" if on_card else None,
            capture_ms=f"{hz.capture_s * 1e3:.1f}" if on_card else None,
            launches_first=json.dumps(first), launches_steady=json.dumps(steady), card=repr(card))
        return out

    def same(label, a, b):
        la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
        if len(la) != len(lb) or not all(torch.equal(x, y) for x, y in zip(la, lb)):
            raise AssertionError(f"{label}: the one-rank mesh differs from the dense runner")

    # -- [mesh-baselines] ------------------------------------------------------------
    for sel in ("random", "fedcs", "pow_d", "ucb"):
        cfg = FLConfig(K=K, k=k, rounds=T, scheme=sel, quota_frac=0.5, allocator="bisect", volatility="bernoulli",
                       seed=seed, pow_d=POW_D)
        per_round = {"gumbel_topk": 1} if sel in ("fedcs", "ucb") else {}
        dense = drive("mesh-baselines", f"{sel}-dense", RoundProgram.from_config(cfg, device=dev), per_round)
        pm = RoundProgram.from_config(cfg, device=dev, mesh=mesh)
        meshed = drive("mesh-baselines", f"{sel}-mesh", pm, per_round)
        same(f"mesh {sel}", meshed, dense)
        graph_vs_eager(f"mesh-{sel}", pm, T_short, seed)
        log("mesh-baselines", run=sel, mesh_vs_dense="bit-identical", compared="masks,xs,p,sigmas,state")
        del dense, meshed

    # -- [mesh-scenarios] -----------------------------------------------------------
    fused = {"round_select.from_w": 1, "round_tail": 1}
    for name in ("diurnal", "regional_outage", "flash_crowd"):
        cfg = FLConfig(K=K, k=k, rounds=T, scheme="e3cs", quota_frac=0.5, allocator="bisect", volatility=name,
                       seed=seed)
        dense = drive("mesh-scenarios", f"{name}-dense", RoundProgram.from_config(cfg, fused=True, device=dev), fused)
        b1 = drive("mesh-scenarios", f"{name}-mesh-block1",
                   RoundProgram.from_config(cfg, fused=True, device=dev, mesh=mesh, block=1), fused)
        same(f"mesh {name} block=1", b1, dense)
        del dense, b1
        pm = RoundProgram.from_config(cfg, fused=True, device=dev, mesh=mesh, block=4)
        drive("mesh-scenarios", f"{name}-mesh-block4", pm, fused | {"bisect_block_sums": n_block})
        graph_vs_eager(f"mesh-{name}-block4", pm, T_short, seed)
        log("mesh-scenarios", run=name, block1_vs_dense="bit-identical", block4="k distinct clients a round")
    cfg = FLConfig(K=K, k=k, rounds=T, scheme="e3cs", quota_frac=0.5, allocator="bisect", volatility="flash_crowd",
                   seed=seed, staleness_rounds=2)
    pm = RoundProgram.from_config(cfg, fused=True, device=dev, mesh=mesh, block=4)
    out = drive("mesh-scenarios", "flash_crowd-async-S2-mesh-block4", pm, fused | {"bisect_block_sums": n_block})
    if not (bool(torch.isfinite(out[0].e3cs.logw).all()) and float(out[0].cep) > 0):
        raise AssertionError("async flash crowd on the mesh: logw not finite or no credit")
    graph_vs_eager("mesh-flash_crowd-async-S2-block4", pm, T_short, seed)
    log("check", mesh="all mesh-phase checks passed")
    return launched


def multi_job_path(dev, K, k, T, T_short, card, seed=SCENARIO_SEED, J=8, K_service=100_000, rounds_service=30):
    """Phase 11 (``[multi-job]``): the multi-job engine and its users.

    * The batched step against J independent ``job_step`` calls over
      ``T_short`` ticks at K_max = K, on the service's standard fleet (k_max
      = K/50: the stable sort) and on the grid's seven jobs of k clients
      (the top-k kernel a row): ``idx`` and ``mask`` bit for bit, ``logw``
      within ``MJ_LOGW_ATOL`` and ``p`` within ``MJ_P_ATOL``.
    * ``run_service_compiled`` at J jobs, K_max = K, T ticks, S = 0 and 2,
      and its captured horizon against the eager tick loop over ``T_short``
      ticks, bit for bit (state, ring, per-tick credit).
    * ``run_service`` at J jobs, K_max = ``K_service``, ``rounds_service``
      ticks, Bernoulli and diurnal feedback: ticks/s, request latency, and
      the host's share (``feedback`` and ``dispatch`` spans).
    * ``run_grid_multi_job`` over the seven registry scenarios at (K, k, T).

    Each path runs with the launch counts set to 0 just before it and checked
    exactly just after.  Returns the first launch count of each wrapper."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch import kernels as kn
    from repro_torch.core.selection.sampling import gumbel_from_uniform
    from repro_torch.engine import MultiJobConfig, make_multi_job, multi_job_init, pack_jobs
    from repro_torch.engine.multi_job import job_generator
    from repro_torch.kernels import ref
    from repro_torch.launch import select_serve
    from repro_torch.obs import Reporter
    from repro_torch.scenarios import SCENARIOS, make_scenario, run_grid_multi_job

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    launched = {}
    os.environ["REPRO_RESULTS"] = os.path.join(CHIPRUN_OUT, "results")

    def counted(label, expect, fn):
        out, secs, counts = counted_call(label, expect, fn, dev, launched)
        return out, secs, json.dumps(counts)

    # -- the batched step against its rows ------------------------------------------
    Ks, ks, fracs, etas = select_serve._heterogeneous_fleet(J, K, np.random.default_rng(seed))
    n_sc = len(SCENARIOS)
    for label, mix in (("standard-fleet", (Ks, ks, fracs, etas)), ("grid-jobs", ([K] * n_sc, [k] * n_sc,
                                                                                 [0.5] * n_sc, [0.5] * n_sc))):
        cfg, k_max = pack_jobs(*mix, K_max=K, device=dev)
        job_step, batched = make_multi_job(k_max)
        state = multi_job_init(cfg)
        n_jobs = cfg.active.shape[0]
        gens = [job_generator(seed, j, dev) for j in range(n_jobs)]
        xgen = torch.Generator(device=dev).manual_seed(seed)
        single = [(state.logw[j].clone(), state.t[j].clone()) for j in range(n_jobs)]
        d_logw = d_p = 0.0
        t_batched = 0.0
        for tick in range(T_short):
            gs = gumbel_from_uniform(torch.stack([torch.rand(K, generator=g, device=dev) for g in gens]))
            xs = (torch.rand((n_jobs, K), generator=xgen, device=dev) < 0.6).float()
            sync()
            t0 = time.perf_counter()
            state, out = batched(cfg, state, gs, xs)
            sync()
            t_batched += time.perf_counter() - t0 if tick else 0.0
            for j in range(n_jobs):
                row = MultiJobConfig(*(v[j] for v in cfg))
                lw, tt, o = job_step(row, single[j][0], single[j][1], gs[j], xs[j])
                single[j] = (lw, tt)
                if not (torch.equal(o["idx"], out["idx"][j]) and torch.equal(o["mask"], out["mask"][j])):
                    raise AssertionError(f"multi-job {label}: tick {tick} job {j}: the batched cohort differs "
                                         "from the job's own step")
                d_logw = max(d_logw, float((lw - state.logw[j]).abs().max()))
                d_p = max(d_p, float((o["p"] - out["p"][j]).abs().max()))
                if (out["idx"][j] >= 0).sum() != int(cfg.k[j]):
                    raise AssertionError(f"multi-job {label}: job {j} selected {(out['idx'][j] >= 0).sum()} clients")
        if not (d_logw <= MJ_LOGW_ATOL and d_p <= MJ_P_ATOL):
            raise AssertionError(f"multi-job {label}: batched vs rows logw {d_logw} > {MJ_LOGW_ATOL} or p {d_p} > "
                                 f"{MJ_P_ATOL}")
        per = next(iter(batched.graphs.values()))[3] if on_card else {}
        log("multi-job", check=f"batched-vs-rows-{label}", jobs=n_jobs, K_max=K, k_max=k_max, ticks=T_short,
            cohorts="bit-identical", logw_max_abs_diff=d_logw, p_max_abs_diff=d_p,
            topk="gumbel_topk kernel a row" if k_max <= 2048 else "stable sort (k_max > 2048)",
            batched_step_ms=f"{t_batched / max(1, T_short - 1) * 1e3:.3f}", launches_per_replay=json.dumps(per),
            card=repr(card))
        if on_card:
            profile_calls(f"batched-step-{label}", lambda: batched(cfg, state, gs, xs), card)
        del cfg, state, single, out, gs, xs, batched
    # -- the service's fleet at K_max = K_service: the top-k kernel a row ----------
    # each tick's rows as the step ranks them (log p + g, -inf on dead slots)
    # through the kernel and its plain version, bit for bit, and the kernel's
    # first k_j indices against the step's cohort
    mix = select_serve._heterogeneous_fleet(J, K_service, np.random.default_rng(seed))
    cfg, k_max = pack_jobs(*mix, K_max=K_service, device=dev)
    _, batched = make_multi_job(k_max)
    state = multi_job_init(cfg)
    gens = [job_generator(seed, j, dev) for j in range(J)]
    xgen = torch.Generator(device=dev).manual_seed(seed)
    for tick in range(T_short):
        gs = gumbel_from_uniform(torch.stack([torch.rand(K_service, generator=g, device=dev) for g in gens]))
        xs = (torch.rand((J, K_service), generator=xgen, device=dev) < 0.6).float()
        state, out = batched(cfg, state, gs, xs)
        scores = torch.where(cfg.active > 0, torch.log(torch.clamp(out["p"], min=1e-20)) + gs, float("-inf"))
        for j in range(J):
            vals, idx = kn.gumbel_topk_kernel_call(scores[j], k_max)
            want_vals, want_idx = ref.gumbel_topk_kernel_ref(scores[j], k_max)
            kj = int(cfg.k[j])
            if not (torch.equal(vals, want_vals) and torch.equal(idx, want_idx)
                    and torch.equal(idx[:kj], out["idx"][j, :kj])):
                raise AssertionError(f"multi-job service fleet K_max={K_service}: tick {tick} job {j}: the top-k "
                                     f"kernel at k={k_max} differs from its plain version or from the step's cohort")
    log("multi-job", check=f"topk-rows-service-fleet-K{K_service}", jobs=J, K_max=K_service, k_max=k_max,
        ticks=T_short, dead_slots=int((cfg.active == 0).sum()), kernel_vs_plain="bit-identical",
        kernel_vs_step_cohort="bit-identical", card=repr(card))
    if on_card:
        profile_calls(f"batched-step-service-fleet-K{K_service}", lambda: batched(cfg, state, gs, xs), card)
    del cfg, batched, gs, xs, state, out, scores

    # -- run_service_compiled: the captured horizon against the eager ticks, then the rates
    for S in (0, 2):
        captured, _, ks_c = select_serve._service_horizon(J, K, seed, S, 0.5, 0.7, 0.5, 48, 8192, dev)
        eager, _, _ = select_serve._service_horizon(J, K, seed, S, 0.5, 0.7, 0.5, 48, 8192, dev)
        got = captured.run(T_short)
        want = eager.run(T_short, eager=True)
        if not all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want))):
            raise AssertionError(f"run_service_compiled S={S}: the captured horizon differs from the eager ticks")
        if not bool((got[2] <= torch.tensor(ks_c, device=dev)).all()):
            raise AssertionError(f"run_service_compiled S={S}: more on-time clients than a cohort")
        log("multi-job", check=f"service-horizon-S{S}", jobs=J, K_max=K, ticks=T_short, captured_vs_eager="bit-identical",
            compared="state,ring,on_time,stale", warmup_ms=f"{captured.warmup_s * 1e3:.1f}" if on_card else None,
            capture_ms=f"{captured.capture_s * 1e3:.1f}" if on_card else None,
            launches_per_replay=json.dumps(captured.per_replay), card=repr(card))
        del captured, eager, got, want
        rep = Reporter(f"chip_select_serve_async_S{S}", config=dict(J=J, K_max=K, rounds=T, staleness=S))
        # the horizon's keys (one launch), then a draw a tick (the fleet's
        # lag rows, the key's advance, the jobs' Gumbel rows) for the
        # capture's warm-up tick and the off-clock and three timed horizons
        lag_rows = 3 if S else 1  # CompletionLag over Bernoulli: 1 + 2 rows; BinaryLag: the base's
        ticks = 1 + 4 * T
        compiled_want = {"threefry.keys": 1 + ticks, "threefry.uniform": lag_rows * ticks, "threefry.rows": ticks}
        report, secs, launches = counted(f"run_service_compiled S={S}", compiled_want,
                                         lambda: select_serve.run_service_compiled(J=J, K_max=K, rounds=T, seed=seed,
                                                                                   staleness=S, reporter=rep,
                                                                                   device=dev))
        rep.save(report)
        log("multi-job", run=f"run_service_compiled-S{S}", jobs=J, K_max=K, rounds=T, mode=report["mode"],
            ticks_per_s=report["ticks_per_s"], client_decisions_per_s=report["client_decisions_per_s"],
            scan_step_us=report["scan_step_us"], tick_us=report["tick_us"], on_time_total=report["on_time_total"],
            stale_credit_total=report["stale_credit_total"], call_s=f"{secs:.3f}", launches=launches, card=repr(card))

    # -- run_service: the host queue, Bernoulli and diurnal feedback ------------------
    for scenario in (None, "diurnal"):
        rep = Reporter(f"chip_select_serve_{scenario or 'bernoulli'}", config=dict(J=J, K_max=K_service))
        ks_s = select_serve._heterogeneous_fleet(J, K_service, np.random.default_rng(seed))[1]
        # the top-k kernel a job a dispatch (k_max <= 2048): the first dispatch
        # warms up, captures and replays (2 J), then one replay a tick
        per_tick = {"gumbel_topk": J} if max(ks_s) <= 2048 else {}
        # the jobs' keys (one launch), their Gumbel rows a dispatch (one
        # launch, the warm-up's too), and with a scenario a trace a job
        service_want = add_counts({n: c * (rounds_service + 2) for n, c in per_tick.items()},
                                  {"threefry.keys": 1, "threefry.rows": rounds_service + 1},
                                  *([record_draws(rounds_service, len(make_scenario(scenario, 8, 2, 0, device=dev)[0]
                                                                      .draw_rows()))] * J if scenario else []))
        report, secs, launches = counted(
            f"run_service {scenario}", service_want,
            lambda: select_serve.run_service(J=J, K_max=K_service, rounds=rounds_service, seed=seed,
                                             scenario=scenario, reporter=rep, device=dev))
        rep.save(report)
        hists = rep.data["hists"]
        lat = report["latency_ms"]
        log("multi-job", run=f"run_service-{scenario or 'bernoulli'}", jobs=J, K_max=K_service, rounds=rounds_service,
            ticks_per_s=report["ticks_per_s"], client_decisions_per_s=report["client_decisions_per_s"],
            latency_p50_ms=lat["p50"], latency_p99_ms=lat["p99"],
            dispatch_p50_ms=f"{hists['dispatch_latency']['p50_s'] * 1e3:.3f}",
            feedback_p50_ms=f"{hists['feedback_latency']['p50_s'] * 1e3:.3f}", call_s=f"{secs:.3f}", launches=launches,
            card=repr(card))

    # -- run_grid_multi_job over the seven registry scenarios --------------------------
    names = list(SCENARIOS)
    grid_rows = sum(len(make_scenario(n, K, T, seed, device=dev)[0].draw_rows()) for n in names)
    grid_want = {"gumbel_topk": len(names) * (T + 1), "threefry.keys": 1, "threefry.rows": T,
                 "threefry.uniform": T * grid_rows}
    rows, secs, launches = counted("run_grid_multi_job", grid_want,
                                   lambda: run_grid_multi_job(names, K=K, k=k, T=T, seed=seed, device=dev))
    for row in rows:
        if not (0 < row["cep"] <= T * k and all(np.isfinite(v) for v in row.values() if isinstance(v, float))):
            raise AssertionError(f"run_grid_multi_job row out of range: {row}")
        log("multi-job-row", **{key: f"{v:.6g}" if isinstance(v, float) else v for key, v in row.items()})
    log("multi-job", run="run_grid_multi_job", jobs=len(names), K=K, k=k, rounds=T, call_s=f"{secs:.3f}",
        call_rounds_per_s=f"{T / secs:.3f}", launches=launches, card=repr(card))
    log("check", multi_job="all multi-job checks passed")
    return launched


FL_RUNS = (("emnist", 0, 16), ("emnist", 2, 10), ("cifar", 0, 5))  # (task, staleness S, rounds)
FL_ACC_MIN = 0.15  # EMNIST after 16 rounds: the threshold of the JAX package's test_end_to_end_fl_learns
# card against CPU: the FL tests' tolerance on trained parameters (tests/test_torch_fl.py)
FL_PARAM_RTOL, FL_PARAM_ATOL = 1e-3, 1e-4
FL_CHECK = dict(K=20, k=4, rounds=1, samples_per_client=40, batch_size=10, local_epochs=(1, 2))
FL_POW_D_ROUNDS = 3  # rounds of pow-d's server on the mesh and off it
FL_POW_D_LOSS_RTOL = 1e-5  # a candidate's loss looped against vmapped, on the same parameters
FP32_CONV_RTOL = 1e-5  # a float32 conv against float64; TF32 misses by ~1e-3


def fl_train_path(dev, card, runs=FL_RUNS, fl_kw=None, acc_min=FL_ACC_MIN):
    """Phase 12 (``[fl-train]``; ``fl_kw`` overrides ``FLConfig`` fields for
    a small rehearsal): the FL training stack at ``FLConfig``'s
    defaults (the paper's Table I: K = 100, k = 20, 500 samples a client,
    batch 40, local epochs 1-4, SGD lr 1e-2 momentum 0.9, fedavg, E3CS at
    quota_frac 0.5, Bernoulli volatility) on both CNNs at their published
    widths, through ``launch.train.build_task`` and ``FLServer``.

    * ``[fl-precision]``: a conv under ``fp32_convs`` against float64 (no
      TF32), and the TF32 time of one CIFAR cohort's training beside the
      float32 one, as information (``[fl-tf32]``).
    * ``[fl-check]``: one EMNIST round at ``FL_CHECK`` from the same state
      and noise on the card and on the CPU: cohort, mask and log-weights
      equal, parameters within the FL tests' tolerance.
    * ``[fl-train]``: the runs of ``runs``; for each, rounds/s (host clock,
      set-up excluded), per round the host gather ms, the host-to-device
      copy ms and the round's device ms (CUDA events around ``round_fn``:
      the cohort's training, then aggregation and the selector's update),
      eval accuracy and loss; EMNIST sync above ``acc_min``, the async run
      with late updates applied, finite parameters.
    * ``[profile-call]``: one round of each CNN under ``torch.profiler``.
    """
    import torch

    from repro_torch.core import prng

    from repro_torch.configs import FLConfig
    from repro_torch.fl import FLServer, make_local_update
    from repro_torch.launch.train import build_task
    from repro_torch.models.cnn import fp32_convs
    from repro_torch.optim import sgd

    fl_kw = fl_kw or {}
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # -- the convs run in IEEE float32 ---------------------------------------------
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(40, 64, 16, 16)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(64, 64, 5, 5)) / 40).astype(np.float32))
    want = torch.nn.functional.conv2d(x.double(), w.double(), padding=2)
    with fp32_convs():
        got = torch.nn.functional.conv2d(x.to(dev), w.to(dev), padding=2).cpu().double()
    rel = float((got - want).abs().max() / want.abs().max())
    if not rel <= FP32_CONV_RTOL:
        raise AssertionError(f"fp32_convs: conv error {rel} relative to float64 > {FP32_CONV_RTOL} (TF32?)")
    log("fl-precision", conv_max_rel_err_vs_f64=f"{rel:.3g}", rtol=FP32_CONV_RTOL,
        cudnn_allow_tf32_outside=torch.backends.cudnn.allow_tf32)

    # -- one round on the card against the CPU ---------------------------------------
    from torch.utils import _pytree as pytree

    fl = FLConfig(**FL_CHECK)
    params0 = noise = None
    out = {}
    for d in (torch.device("cpu"), dev):
        model, store, _ = build_task("emnist", fl, device=d)
        srv = FLServer(model, fl, store, device=d)
        if params0 is None:  # drawn once on the CPU, handed to both
            params0 = model.init(prng.PRNGKey(7, "cpu"))[0]
            noise = srv._draw(srv.program.generator(prng.PRNGKey(11, d)))[0]
        idxs = []
        select = srv._select
        srv._select = lambda st, nz, select=select: (lambda o: (idxs.append(o[0].cpu()), o)[1])(select(st, nz))
        st, _ = srv.run(srv.init_state(params={n: v.to(d) for n, v in params0.items()}),
                        noise=[(pytree.tree_map(lambda v: None if v is None else v.to(d), noise), None)])
        out[d.type] = (idxs, st)
    (gidx, gst), (cidx, cst) = out[dev.type], out["cpu"]
    same = all(torch.equal(a, b) for a, b in zip(gidx, cidx)) and torch.equal(gst.sel_counts.cpu(), cst.sel_counts) \
        and torch.equal(gst.e3cs.logw.cpu(), cst.e3cs.logw)
    if not same:
        raise AssertionError(f"fl-check: cohort, mask or log-weights differ, card {gidx} vs cpu {cidx}")
    err = 0.0
    for n, v in cst.params.items():
        a = gst.params[n].cpu()
        np.testing.assert_allclose(a.numpy(), v.numpy(), rtol=FL_PARAM_RTOL, atol=FL_PARAM_ATOL, err_msg=n)
        err = max(err, float((a - v).abs().max()))
    log("fl-check", device=dev.type, K=fl.K, k=fl.k, rounds=fl.rounds, cohort=gidx[0].tolist(),
        cohort_mask_logw="equal", params_max_abs_err=f"{err:.3g}", rtol=FL_PARAM_RTOL, atol=FL_PARAM_ATOL)
    del out

    # -- the training runs at the defaults --------------------------------------------
    for task, S, rounds in runs:
        fl = FLConfig(rounds=rounds, staleness_rounds=S, **fl_kw)
        t0 = time.perf_counter()
        model, store, eval_fn = build_task(task, fl, device=dev)
        srv = FLServer(model, fl, store, eval_fn, device=dev)
        state = srv.init_state(prng.PRNGKey(fl.seed, dev))
        setup_s = time.perf_counter() - t0
        gather, copy, events, nbytes = [], [], [], []
        round_batches, to_device, round_fn = store.round_batches, srv._to_device, srv._round

        def timed_gather(*a, **kw):
            t = time.perf_counter()
            res = round_batches(*a, **kw)
            gather.append(time.perf_counter() - t)
            nbytes.append(sum(r.nbytes for r in res))
            return res

        def timed_copy(*arrays):
            sync()
            t = time.perf_counter()
            res = to_device(*arrays)
            sync()
            if len(arrays) == 3:  # the round's batches and mask
                copy.append(time.perf_counter() - t)
            return res

        def timed_round(*a):
            if on_card:  # device time between two events on the stream
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                res = round_fn(*a)
                ev[1].record()
                events.append(lambda ev=ev: ev[0].elapsed_time(ev[1]))
            else:  # a CPU rehearsal: host clock
                t = time.perf_counter()
                res = round_fn(*a)
                events.append(lambda secs=time.perf_counter() - t: secs * 1e3)
            last_args.append(a)
            return res

        last_args = []
        store.round_batches, srv._to_device, srv._round = timed_gather, timed_copy, timed_round
        sync()
        t0 = time.perf_counter()
        state, hist = srv.run(state, eval_every=rounds)
        sync()
        secs = time.perf_counter() - t0
        round_ms = [ms() for ms in events]
        finite = all(bool(torch.isfinite(v).all()) for v in state.params.values())
        acc, loss = hist["acc"][-1], hist["loss"][-1]
        label = f"{task}-{'sync' if S == 0 else f'async-S{S}'}"
        log("fl-train", run=label, K=fl.K, k=fl.k, rounds=rounds, n_steps=srv.n_steps, batch=fl.batch_size,
            rounds_per_s=f"{rounds / secs:.4f}", setup_s=f"{setup_s:.2f}",
            round_device_ms_median=f"{np.median(round_ms):.2f}", round_device_ms_first=f"{round_ms[0]:.2f}",
            gather_ms_median=f"{np.median(gather) * 1e3:.2f}", copy_ms_median=f"{np.median(copy) * 1e3:.2f}",
            batch_mb=f"{np.median(nbytes) / 1e6:.1f}", eval_acc=f"{acc:.4f}", eval_loss=f"{loss:.4f}",
            cep=float(state.cep), n_late=hist.get("n_late"), card=repr(card))
        if not finite:
            raise AssertionError(f"fl-train {label}: non-finite parameters")
        if task == "emnist" and S == 0 and not acc > acc_min:
            raise AssertionError(f"fl-train {label}: accuracy {acc} after {rounds} rounds, not above {acc_min}")
        if S and not hist["n_late"] > 0:
            raise AssertionError(f"fl-train {label}: no late update was applied")
        if S == 0 and on_card:
            profile_calls(f"fl-round-{task}", lambda: round_fn(*last_args[-1]), card, n=2)
        if task == "cifar" and on_card:  # TF32 beside float32 on one cohort's training, information only
            a = last_args[-1]
            local = make_local_update(model, sgd(fl.lr, fl.momentum))
            ms = {}
            for tf32 in (False, True, True, False):  # each warmed up once: the least of two
                c = torch.backends.cudnn
                with c.flags(enabled=c.enabled, benchmark=c.benchmark, deterministic=c.deterministic,
                             allow_tf32=tf32):
                    t = time.perf_counter()
                    local(a[0].params, a[5], a[6])
                    sync()
                    ms.setdefault(tf32, []).append((time.perf_counter() - t) * 1e3)
            log("fl-tf32", task=task, fp32_ms=f"{min(ms[False]):.1f}", tf32_ms=f"{min(ms[True]):.1f}",
                note="information; the port trains in float32", card=repr(card))
        del srv, store, state, last_args
        torch.cuda.empty_cache()
    log("check", fl_train="all fl-train checks passed")


# the model zoo's serving phase
ZOO_CHECK = dict(B=2, S=32, steps=4)  # each smoke arch on the card against the CPU
# card against CPU in float32 (TF32 off): the same products summed in other
# orders (cuBLAS's tiles against ATen's CPU loops); the CPU tests hold the
# CPU against JAX to 1e-4 with gaps below 5e-5 seen
ZOO_CHECK_TOL = dict(rtol=2e-4, atol=2e-4)
ZOO_CONSISTENCY_TOL = 2e-3  # a decode step against the teacher-forced forward (tests/test_models.py's bound)
# gemma-2b at its full config in bf16: the first decode step's logits against
# the full forward's last position.  Each op rounds to 8 significant bits and
# the decode and the forward run other GEMM shapes through 18 layers of a bf16
# residual stream: the card showed 0.578 on logits of at most 9.5 (NVIDIA
# H100 80GB HBM3, 700 W); the bound is about twice that.  The same check in float32 is held to
# ZOO_CONSISTENCY_TOL.
ZOO_BF16_ATOL = 1.25
ZOO_SERVE_RUNS = (("cold", 64), ("warm", 64), ("long", 1024))  # (label, prompt length): launch.serve defaults else
ZOO_WIDTH = dict(B=4, S=64, steps=8)
# the depth a config keeps on one 80 GB card (the rest run uncut)
ZOO_DEPTH = {"llama3-405b": dict(n_layers=2), "qwen2-vl-72b": dict(n_layers=2),
             "deepseek-v3-671b": dict(n_layers=2, n_dense_layers=1)}


def zoo_serve_path(dev, card, smoke_widths=False):
    """Phase 13 (``[zoo-check]``, ``[zoo-serve]``, ``[zoo-consistency]``,
    ``[zoo-width]``): the model zoo's serving path (``build_model``,
    ``prefill``, ``decode``, ``launch.serve``).  ``smoke_widths`` runs the
    full-width parts at ``smoke_variant`` (a CPU rehearsal).

    * ``[zoo-check]``: each of the ten archs' ``smoke_variant`` (MoE at
      ``capacity_factor=64``) from one CPU generator's parameters, a prefill
      of ``ZOO_CHECK`` and greedy decode steps on ``dev`` and on the CPU,
      float32 matmuls without TF32: tokens and cache ``pos`` equal, logits
      and cache leaves within ``ZOO_CHECK_TOL``; each decode step against the
      teacher-forced forward (dense, moe, ssm, hybrid) within
      ``ZOO_CONSISTENCY_TOL``.
    * ``[zoo-serve]``: gemma-2b at its full config through
      ``launch.serve.main`` (batch 4, 32 tokens; prompt 64 twice, then 1024):
      prefill ms, decode tokens/s, peak device memory.
    * ``[zoo-consistency]``: gemma-2b full, in bf16 and in float32: the first
      decode step's logits against the full forward's last position (max
      abs difference within ``ZOO_BF16_ATOL``, float32 within
      ``ZOO_CONSISTENCY_TOL``; greedy agreement printed); a bf16 prefill and
      decode step under ``torch.profiler`` (``[profile-call]``).
    * ``[zoo-width]``: the other nine at their full configs (``ZOO_DEPTH``
      cuts three): a prefill of ``ZOO_WIDTH`` and greedy decode steps,
      finite logits, init / prefill / decode ms, peak device memory.
    """
    import dataclasses
    import gc

    import torch

    from repro_torch.core import prng
    from torch.utils import _pytree as pytree

    from repro_torch.configs import ASSIGNED, get_config, smoke_variant
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.layers import fp32_matmuls

    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")
    t_phase = time.time()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    held = {}

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held["bytes"] = torch.cuda.memory_allocated()

    def peak_mib():
        """The peak allocation since ``free()`` above what was held then (the
        earlier phases' tensors still alive), and that holding."""
        if not on_card:
            return "not measured"
        return (f"{(torch.cuda.max_memory_allocated() - held['bytes']) / 2**20:.1f} "
                f"held_before_mib={held['bytes'] / 2**20:.1f}")

    def clone(tree):
        return pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)

    def max_err(a, b):
        """max |a - b| over two cache trees (structure, types, pos equal)."""
        if isinstance(a, dict) and a.keys() == b.keys():
            return max(max_err(a[k], b[k]) for k in a)
        if isinstance(a, tuple) and type(a) is type(b) and getattr(a, "pos", None) == getattr(b, "pos", None):
            return max(max_err(x, y) for x, y in zip(a, b) if isinstance(x, torch.Tensor))
        if not (isinstance(a, torch.Tensor) and a.shape == b.shape and a.dtype == b.dtype):
            raise AssertionError(f"zoo-check: cache trees differ: {type(a)} {getattr(a, 'pos', '')} against "
                                 f"{type(b)} {getattr(b, 'pos', '')}")
        ok = torch.allclose(a.float(), b.float().to(a.device), **ZOO_CHECK_TOL)
        err = float((a.float() - b.float().to(a.device)).abs().max())
        if not ok:
            raise AssertionError(f"zoo-check: a cache leaf {tuple(a.shape)} parts by {err}")
        return err

    def run(model, params, batch, steps):
        """Greedy prefill + decode: (prefill logits, prefill caches, step
        logits, tokens fed, final caches)."""
        S = batch["tokens"].shape[1] + (model.cfg.n_patches if model.cfg.family == "vlm" else 0)
        logits, caches = model.prefill(params, batch, max_len=S + steps)
        first = clone(caches)
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        fed, outs = [], []
        for _ in range(steps):
            fed.append(tok)
            lg, caches = model.decode(params, tok, caches)
            outs.append(lg)
            tok = torch.argmax(lg[:, -1:], -1).to(torch.int32)
        return logits, first, outs, fed, caches

    free()
    # -- [zoo-check] ---------------------------------------------------------
    with torch.no_grad(), fp32_matmuls():
        for arch in ASSIGNED:
            cfg = smoke_variant(get_config(arch))
            if cfg.family == "moe":
                cfg = dataclasses.replace(cfg, capacity_factor=64.0)
            model = build_model(cfg)
            p_cpu, _ = model.init(prng.PRNGKey(0, "cpu"))
            b_cpu = serve.make_batch(cfg, ZOO_CHECK["B"], ZOO_CHECK["S"], prng.PRNGKey(1, "cpu"))
            p_dev = pytree.tree_map(lambda t: t.to(dev), p_cpu)
            b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
            got = run(model, p_dev, b_dev, ZOO_CHECK["steps"])
            sync()
            want = run(model, p_cpu, b_cpu, ZOO_CHECK["steps"])
            for a, b in zip(got[3], want[3]):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"zoo-check {arch}: greedy tokens differ: {a.cpu().tolist()} vs {b.tolist()}")
            logit_err = 0.0
            for a, b in zip([got[0]] + got[2], [want[0]] + want[2]):
                logit_err = max(logit_err, float((a.cpu() - b).abs().max()))
                if not torch.allclose(a.cpu(), b, **ZOO_CHECK_TOL):
                    raise AssertionError(f"zoo-check {arch}: logits part by {logit_err}")
            cache_err = max(max_err(got[1], want[1]), max_err(got[4], want[4]))
            consistency = "n/a"
            if cfg.family in ("dense", "moe", "ssm", "hybrid"):
                full = torch.cat([b_dev["tokens"]] + got[3], 1)
                ref = model.forward(p_dev, {**b_dev, "tokens": full})
                S = b_dev["tokens"].shape[1]
                consistency = max(float((lg[:, 0] - ref[:, S + i]).abs().max()) for i, lg in enumerate(got[2]))
                for i, lg in enumerate(got[2]):
                    if not torch.allclose(lg[:, 0], ref[:, S + i], atol=ZOO_CONSISTENCY_TOL, rtol=ZOO_CONSISTENCY_TOL):
                        raise AssertionError(f"zoo-check {arch}: decode step {i} against the forward: {consistency}")
                consistency = f"{consistency:.3g}"
            log("zoo-check", arch=cfg.name, device=dev.type, prefill=f"{ZOO_CHECK['B']}x{ZOO_CHECK['S']}",
                steps=ZOO_CHECK["steps"], tokens_equal=True, pos=got[4][next(iter(got[4]))].pos,
                logits_max_abs_err=f"{logit_err:.3g}", cache_max_abs_err=f"{cache_err:.3g}",
                decode_vs_forward=consistency, tol=ZOO_CHECK_TOL)
            del model, p_cpu, p_dev, b_cpu, b_dev, got, want
    free()

    def full_cfg(arch):
        cfg = get_config(arch)
        return smoke_variant(cfg) if smoke_widths else dataclasses.replace(cfg, **ZOO_DEPTH.get(arch, {}))

    # -- [zoo-serve] ---------------------------------------------------------
    extra = ["--smoke", "--device", dev.type] if smoke_widths else []
    for label, prompt in ZOO_SERVE_RUNS:
        free()
        r = serve.main(["--arch", "gemma-2b", "--prompt-len", str(prompt)] + extra)
        log("zoo-serve", arch=r["arch"], run=label, batch=4, prompt=prompt, gen=32,
            prefill_ms=f"{r['prefill_s'] * 1e3:.3f}", decode_tok_per_s=r["decode_tok_per_s"],
            peak_mib=peak_mib(), card=repr(card))
        if r["generated_shape"] != [4, 33]:
            raise AssertionError(f"zoo-serve: generated {r['generated_shape']}")

    # -- [zoo-consistency] ---------------------------------------------------
    for dtype, bound in (("bfloat16", ZOO_BF16_ATOL), ("float32", ZOO_CONSISTENCY_TOL)):
        free()
        with torch.no_grad(), fp32_matmuls():
            cfg = dataclasses.replace(full_cfg("gemma-2b"), dtype=dtype, param_dtype=dtype)
            model = build_model(cfg)
            gen = prng.PRNGKey(0, dev)
            params, _ = model.init(gen)
            batch = serve.make_batch(cfg, 4, 64, gen)
            logits, caches = model.prefill(params, batch, max_len=65)
            tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
            ld, _ = model.decode(params, tok, caches)
            ref = model.forward(params, {"tokens": torch.cat([batch["tokens"], tok], 1)})[:, -1]
            err = float((ld[:, 0].float() - ref.float()).abs().max())
            agree = float((ld[:, 0].argmax(-1) == ref.argmax(-1)).float().mean())
            log("zoo-consistency", arch=cfg.name, dtype=cfg.dtype, logits_max_abs_diff=f"{err:.4g}",
                logits_max_abs=f"{float(ref.float().abs().max()):.4g}", greedy_agreement=agree, bound=bound,
                card=repr(card))
            if not (math.isfinite(err) and err <= bound):
                raise AssertionError(f"zoo-consistency {dtype}: decode against forward {err} > {bound}")
            if on_card and dtype == "bfloat16":  # where a served step's time goes (the same slot rewritten)
                profile_calls("zoo-prefill-gemma-2b", lambda: model.prefill(params, batch, max_len=65), card, n=2)
                profile_calls("zoo-decode-gemma-2b", lambda: model.decode(params, tok, caches), card, n=4)
            del model, params, batch, logits, caches, ld, ref

    # -- [zoo-width] ---------------------------------------------------------
    for arch in ASSIGNED:
        if arch == "gemma-2b":
            continue
        free()
        cfg = full_cfg(arch)
        with torch.no_grad():
            model = build_model(cfg)
            gen = prng.PRNGKey(0, dev)
            sync()
            t0 = time.perf_counter()
            params, _ = model.init(gen)
            sync()
            init_s = time.perf_counter() - t0
            n_params = sum(t.numel() for t in pytree.tree_leaves(params))
            batch = serve.make_batch(cfg, ZOO_WIDTH["B"], ZOO_WIDTH["S"], gen)
            S = ZOO_WIDTH["S"] + (cfg.n_patches if cfg.family == "vlm" else 0)
            sync()
            t0 = time.perf_counter()
            logits, caches = model.prefill(params, batch, max_len=S + ZOO_WIDTH["steps"])
            finite = torch.isfinite(logits).all()
            tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
            sync()
            prefill_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(ZOO_WIDTH["steps"]):
                lg, caches = model.decode(params, tok, caches)
                finite &= torch.isfinite(lg).all()
                tok = torch.argmax(lg[:, -1:], -1).to(torch.int32)
            sync()
            decode_s = time.perf_counter() - t0
        log("zoo-width", arch=cfg.name, layers=cfg.n_layers, cut=ZOO_DEPTH.get(arch, "none") if not smoke_widths
            else "smoke", params=n_params, dtype=cfg.param_dtype, batch=ZOO_WIDTH["B"], prompt=S,
            steps=ZOO_WIDTH["steps"], finite=bool(finite), init_s=f"{init_s:.2f}",
            prefill_ms=f"{prefill_s * 1e3:.3f}", decode_ms_per_step=f"{decode_s * 1e3 / ZOO_WIDTH['steps']:.3f}",
            decode_tok_per_s=f"{ZOO_WIDTH['B'] * ZOO_WIDTH['steps'] / decode_s:.2f}", peak_mib=peak_mib(),
            card=repr(card))
        if not bool(finite):
            raise AssertionError(f"zoo-width {arch}: non-finite logits")
        del model, params, batch, logits, caches, lg, tok
    free()
    log("check", zoo="all zoo checks passed", seconds=f"{time.time() - t_phase:.1f}")


# the model zoo's training phase
ZOO_TRAIN_CHECK = dict(B=2, S=32)  # each smoke arch's loss and gradients, card against CPU
# card against CPU in float32 (TF32 off), loss and every gradient leaf, and
# remat on against off on the card: the same products summed in other
# orders, and the MoE backward adds its rows by atomics on the card.  The
# card showed 9.06e-6 at most (zamba2's gradients; remat on against off
# equal; NVIDIA H100 80GB HBM3, 700 W); the CPU tests hold JAX to the same
ZOO_TRAIN_TOL = dict(rtol=1e-4, atol=2e-5)
ZOO_TRAIN_FL = dict(K=32, k=8, rounds=25, scheme="e3cs", quota="inc", lr=5e-3)  # examples/fl_lm.py
ZOO_TRAIN_FL_RUN = dict(n_steps=2, B=8, S=64)  # examples/fl_lm.py's round
ZOO_TRAIN = dict(K=32, k=2, rounds=3, n_steps=2, B=2, S=512)  # gemma-2b uncut, through make_cohort_round
ZOO_TRAIN_LR = 5e-3  # examples/fl_lm.py's learning rate
# gemma-2b at full width cut to two layers: one local step in bf16 against
# float32 (TF32 off), the loss and the largest difference of a parameter's
# change.  The card showed 0.00124 on a loss of 17.09 and 2.57e-4 on changes
# of at most 6.4e-4 (NVIDIA H100 80GB HBM3, 700 W); the bounds are twice that
ZOO_TRAIN_BF16 = dict(n_layers=2, B=2, S=512, loss_atol=2.5e-3, delta_atol=5e-4)
# qwen3-moe at full width on the silo mapping: 4 of its 48 layers keep the
# parameters, the momentum, the gradients, two clients' local copies and the
# float32 accumulator on one 80 GB card (8 would need ~67 GB before
# activations)
ZOO_TRAIN_DEPTH = 4
ZOO_SILO = dict(clients=2, steps=2, B=2, S=512, weights=(0.25, 0.75))


def release_engine_memory(card):
    """Before the zoo phases, which take most of the card (the gemma-2b
    round of ``[zoo-train]`` peaks at 48.7 GB over what is held): the
    engine phases' runners that ``scan_sim`` caches (K = 10^6 horizons, their
    buffers and captured graphs) are dropped and the cache emptied, so that
    what earlier phases left in the allocator's segments does not fragment
    the zoo's.  Logs ``[memory]``: allocated and reserved MiB before and
    after."""
    import gc

    import torch

    from repro_torch.engine import scan_sim

    before = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    scan_sim._cached_runner.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    log("memory", at="before the zoo phases", allocated_mib=f"{before[0] / 2**20:.1f}",
        reserved_mib=f"{before[1] / 2**20:.1f}", allocated_after_mib=f"{after[0] / 2**20:.1f}",
        reserved_after_mib=f"{after[1] / 2**20:.1f}", card=repr(card))


def zoo_train_path(dev, card, smoke_widths=False):
    """Phase 14 (``[zoo-train-check]``, ``[zoo-train]``,
    ``[zoo-train-consistency]``, ``[zoo-silo]``): the model zoo's training,
    after the zoo phase with the device freed first.  ``smoke_widths`` runs
    the full-width parts at ``smoke_variant`` (a CPU rehearsal).

    * ``[zoo-train-check]``: each of the ten archs' ``smoke_variant`` with
      ``remat=True`` (MoE at ``capacity_factor=64``), from one CPU
      generator's parameters and batch, float32 without TF32: the loss and
      every gradient leaf (``torch.func.grad_and_value``) on ``dev`` against
      the CPU, and remat on against off on ``dev``, within
      ``ZOO_TRAIN_TOL``; then one ``make_cohort_round`` of the gemma and
      qwen3-moe smokes (scatter MoE) at ``ZOO_TRAIN_FL`` as
      ``examples/fl_lm.py`` runs it, from the same state and noise: cohort,
      mask and log-weights equal, parameters within the FL tests' tolerance.
    * ``[zoo-train]``: gemma-2b at its full config, uncut (bf16,
      ``remat=True``), through ``make_cohort_round`` at ``ZOO_TRAIN``, data
      from ``make_lm_dataset`` and ``lm_client_batches``, the selector's noise
      drawn on the device: ms a round and a local step, tokens/s, peak device
      memory; one round under ``torch.profiler`` (``[profile-call]``); remat
      on against off (``[zoo-train-remat]``): the local update's and one
      step's gradients' times and peaks (the gradients' lower with remat,
      or none without it) and the memory the forward keeps for the
      backward (lower with remat).
    * ``[zoo-train-consistency]``: gemma-2b at full width cut to two layers,
      one local step in bf16 against float32 (TF32 off).
    * ``[zoo-silo]``: qwen3-moe at full width cut to ``ZOO_TRAIN_DEPTH``
      layers, ``make_silo_steps`` for ``ZOO_SILO``: ms a local step, peak
      memory, and the update against a hand sum of the weighted deltas.
    """
    import dataclasses
    import gc

    import torch

    from repro_torch.core import prng
    from torch.func import grad_and_value, vmap
    from torch.utils import _pytree as pytree

    from repro_torch.configs import ASSIGNED, FLConfig, get_config, smoke_variant
    from repro_torch.data import lm_client_batches, make_lm_dataset
    from repro_torch.engine import RoundProgram
    from repro_torch.fl import init_server_state, make_cohort_round, make_local_update, make_silo_steps
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.layers import fp32_matmuls
    from repro_torch.optim import sgd

    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")
    t_phase = time.time()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    held = {}

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held["bytes"] = torch.cuda.memory_allocated()

    def peak_mib():
        if not on_card:
            return "not measured"
        return f"{(torch.cuda.max_memory_allocated() - held['bytes']) / 2**20:.1f}"

    def to(tree, d):
        return pytree.tree_map(lambda t: t.to(d) if isinstance(t, torch.Tensor) else t, tree)

    def tree_err(got, want, what, tol=ZOO_TRAIN_TOL):
        """max |got - want| over two trees of one structure, each leaf
        within ``tol``."""
        err = 0.0
        for (path, a), b in zip(pytree.tree_leaves_with_path(got), pytree.tree_leaves(want)):
            a, b = a.float().cpu(), b.float().cpu()
            if a.shape != b.shape or not torch.allclose(a, b, **tol):
                raise AssertionError(f"{what} {pytree.keystr(path)}: max |difference| "
                                     f"{float((a - b).abs().max())} (tol {tol})")
            err = max(err, float((a - b).abs().max()))
        return err

    def lm_batches(cfg, K, idx, n_steps, B, S, seed, stream, d):
        blocks = lm_client_batches(stream, K, idx.cpu().numpy(), n_steps, B, S, seed=seed)
        tok = torch.from_numpy(blocks[..., :-1]).to(d)
        return {"tokens": tok, "labels": tok}

    free()
    # -- [zoo-train-check]: gradients -----------------------------------------
    with fp32_matmuls():
        for arch in ASSIGNED:
            cfg = dataclasses.replace(smoke_variant(get_config(arch)), remat=True)
            if cfg.family == "moe":
                cfg = dataclasses.replace(cfg, capacity_factor=64.0)
            p_cpu, _ = build_model(cfg).init(prng.PRNGKey(0, "cpu"))
            b_cpu = serve.make_batch(cfg, ZOO_TRAIN_CHECK["B"], ZOO_TRAIN_CHECK["S"], prng.PRNGKey(1, "cpu"))
            b_cpu["labels"] = b_cpu["tokens"]
            out = {}
            for label, d, remat in (("cpu", cpu, True), ("card", dev, True), ("card-no-remat", dev, False)):
                m = build_model(dataclasses.replace(cfg, remat=remat))
                out[label] = grad_and_value(m.loss, has_aux=True)(to(p_cpu, d), to(b_cpu, d))
            sync()
            (g_cpu, (l_cpu, _)), (g_dev, (l_dev, _)), (g_off, (l_off, _)) = out["cpu"], out["card"], out["card-no-remat"]
            loss_err = abs(float(l_dev) - float(l_cpu))
            if not loss_err <= ZOO_TRAIN_TOL["atol"] + ZOO_TRAIN_TOL["rtol"] * abs(float(l_cpu)):
                raise AssertionError(f"zoo-train-check {arch}: loss {float(l_dev)} on the card, {float(l_cpu)} on the CPU")
            err = tree_err(g_dev, g_cpu, f"zoo-train-check {arch} gradient")
            remat_err = max(tree_err(g_dev, g_off, f"zoo-train-check {arch} remat on/off"),
                            abs(float(l_dev) - float(l_off)))
            log("zoo-train-check", arch=cfg.name, device=dev.type, batch=f"{ZOO_TRAIN_CHECK['B']}x{ZOO_TRAIN_CHECK['S']}",
                loss=f"{float(l_dev):.6f}", loss_abs_err=f"{loss_err:.3g}", grad_max_abs_err=f"{err:.3g}",
                remat_on_off_max_abs_diff=f"{remat_err:.3g}", leaves=len(pytree.tree_leaves(g_dev)), tol=ZOO_TRAIN_TOL)
            del out, g_cpu, g_dev, g_off, p_cpu, b_cpu
    free()

    # -- [zoo-train-check]: one examples/fl_lm.py round, card against CPU --------
    fl = FLConfig(**ZOO_TRAIN_FL)
    run = ZOO_TRAIN_FL_RUN
    for arch in ("gemma-2b", "qwen3-moe-30b-a3b"):
        cfg = dataclasses.replace(smoke_variant(get_config(arch)), remat=True)
        model = build_model(cfg)
        stream = make_lm_dataset(cfg.vocab, 200_000, n_chains=fl.K, seed=0)
        p0, _ = model.init(torch.Generator().manual_seed(0))
        noise = None
        res = {}
        with fp32_matmuls():
            for d in (cpu, dev):
                pm = RoundProgram.from_config(fl, device=d)
                if noise is None:  # drawn once on the CPU, handed to both
                    noise = pm.draw_noise(pm.generator(11))
                nz = pytree.tree_map(lambda v: v.to(d) if isinstance(v, torch.Tensor) else v, noise)
                select = pm.select_fn()
                _, round_fn = make_cohort_round(model, fl, pm.quota_fn, pm.base_vol, pm.rho, select=select)
                st = init_server_state(to(p0, d), fl.K, pm.base_vol.init_state(), d)
                idx, p, capped, sigma = select(st, nz)
                batches = lm_batches(cfg, fl.K, idx, run["n_steps"], run["B"], run["S"], 0, stream, d)
                ones = torch.ones(fl.k, device=d)
                st, met = round_fn(st, idx, p, capped, sigma, batches, torch.ones(fl.k, run["n_steps"], device=d),
                                   ones, torch.tensor(float(fl.K), device=d), ones, nz.u)
                res[d.type] = (idx.cpu(), st, float(met["mean_local_loss"]))
        (cidx, cst, closs), (gidx, gst, gloss) = res["cpu"], res[dev.type]
        same = torch.equal(gidx, cidx) and torch.equal(gst.sel_counts.cpu(), cst.sel_counts) \
            and torch.equal(gst.e3cs.logw.cpu(), cst.e3cs.logw)
        if not same:
            raise AssertionError(f"zoo-train-check {arch} round: cohort, mask or log-weights differ: {gidx} vs {cidx}")
        err = tree_err(gst.params, cst.params, f"zoo-train-check {arch} round params",
                       tol=dict(rtol=FL_PARAM_RTOL, atol=FL_PARAM_ATOL))
        log("zoo-train-check", arch=cfg.name, run="cohort-round", K=fl.K, k=fl.k, n_steps=run["n_steps"],
            batch=f"{run['B']}x{run['S']}", moe_impl=cfg.moe_impl if cfg.family == "moe" else None,
            cohort=gidx.tolist(), cohort_mask_logw="equal", local_loss=f"{gloss:.5f}",
            local_loss_abs_err=f"{abs(gloss - closs):.3g}", params_max_abs_err=f"{err:.3g}",
            rtol=FL_PARAM_RTOL, atol=FL_PARAM_ATOL)
        del res, cst, gst, model, p0
    free()

    def full_cfg(arch, **over):
        cfg = get_config(arch)
        return dataclasses.replace(smoke_variant(cfg) if smoke_widths else cfg, **over)

    # -- [zoo-train]: gemma-2b uncut through make_cohort_round --------------------
    cfg = full_cfg("gemma-2b", remat=True)
    z = ZOO_TRAIN
    fl = FLConfig(K=z["K"], k=z["k"], rounds=z["rounds"], scheme="e3cs", quota="inc", lr=ZOO_TRAIN_LR)
    model = build_model(cfg)
    pm = RoundProgram.from_config(fl, device=dev)
    gen = pm.generator(1)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    stream = make_lm_dataset(cfg.vocab, 200_000, n_chains=fl.K, seed=0)
    select = pm.select_fn()
    _, round_fn = make_cohort_round(model, fl, pm.quota_fn, pm.base_vol, pm.rho, select=select)
    state = init_server_state(params, fl.K, pm.base_vol.init_state(), dev)
    del params
    ones = torch.ones(fl.k, device=dev)
    mask = torch.ones(fl.k, z["n_steps"], device=dev)
    total = torch.tensor(float(fl.K), device=dev)
    tokens = fl.k * z["n_steps"] * z["B"] * z["S"]
    free()
    held_round = held.get("bytes", 0)
    round_ms, losses, last = [], [], None
    for t in range(z["rounds"]):
        noise = pm.draw_noise(gen)
        idx, p, capped, sigma = select(state, noise)
        batches = lm_batches(cfg, fl.K, idx, z["n_steps"], z["B"], z["S"], t, stream, dev)
        sync()
        t0 = time.perf_counter()
        state, met = round_fn(state, idx, p, capped, sigma, batches, mask, ones, total, ones, noise.u)
        sync()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["mean_local_loss"]))
        last = (state, idx, p, capped, sigma, batches, mask, ones, total, ones, noise.u)
    peak = peak_mib()
    finite = all(math.isfinite(v) for v in losses) and all(bool(torch.isfinite(t).all())
                                                           for t in pytree.tree_leaves(state.params))
    log("zoo-train", arch=cfg.name, layers=cfg.n_layers, params=n_params, dtype=cfg.param_dtype, remat=True,
        K=fl.K, k=fl.k, rounds=z["rounds"], n_steps=z["n_steps"], batch=f"{z['B']}x{z['S']}",
        round_ms=",".join(f"{v:.1f}" for v in round_ms), round_ms_warm=f"{np.median(round_ms[1:]):.1f}",
        tokens_per_s=f"{tokens / (np.median(round_ms[1:]) / 1e3):.1f}", peak_mib=peak,
        held_before_mib=f"{held_round / 2**20:.1f}", mean_local_loss=",".join(f"{v:.4f}" for v in losses),
        finite=finite, card=repr(card))
    if not finite:
        raise AssertionError("zoo-train: non-finite loss or parameters")
    if on_card:
        profile_calls("zoo-train-round-gemma-2b", lambda: round_fn(*last), card, n=1)

    def measured(fn):
        """(ms, peak MiB) of ``fn``'s second call, or "does not fit" twice."""
        try:
            free()
            out = fn()
            del out
            free()
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            return f"{(time.perf_counter() - t0) * 1e3:.1f}", peak_mib()
        except torch.cuda.OutOfMemoryError:
            return "does not fit", "does not fit (80 GB)"

    # remat on against off: the local update and one step's gradients, and
    # what the forward keeps for the backward (one client, plain autograd)
    batch0 = {k: v[:, 0] for k, v in last[5].items()}
    leaves, spec = pytree.tree_flatten(state.params)
    rm = {}
    for remat in (True, False):
        m = build_model(dataclasses.replace(cfg, remat=remat))
        grad_fn = vmap(grad_and_value(lambda p, b, m=m: m.loss(p, b)[0]), in_dims=(None, 0))
        rm["local", remat] = measured(lambda: make_local_update(m, sgd(fl.lr, fl.momentum))(state.params, last[5],
                                                                                            mask))
        rm["grad", remat] = measured(lambda: grad_fn(state.params, batch0))
        if on_card and remat:  # where a step's gradients spend the card's time
            profile_calls("zoo-train-grad-gemma-2b", lambda: grad_fn(state.params, batch0), card, n=1)
        free()
        before = torch.cuda.memory_allocated() if on_card else 0
        loss, _ = m.loss(pytree.tree_unflatten([t.detach().requires_grad_() for t in leaves], spec),
                         {k: v[0] for k, v in batch0.items()})
        rm["saved", remat] = (torch.cuda.memory_allocated() - before) / 2**20 if on_card else 0.0
        del loss, m, grad_fn
    log("zoo-train-remat", arch=cfg.name, batch=f"{z['B']}x{z['S']}",
        local_step_ms=f"{float(rm['local', True][0]) / z['n_steps']:.1f}" if rm["local", True][0][0].isdigit()
        else rm["local", True][0],
        local_update_ms_remat=rm["local", True][0], local_update_ms_no_remat=rm["local", False][0],
        local_update_peak_mib_remat=rm["local", True][1], local_update_peak_mib_no_remat=rm["local", False][1],
        grad_step_ms_remat=rm["grad", True][0], grad_step_ms_no_remat=rm["grad", False][0],
        grad_step_peak_mib_remat=rm["grad", True][1], grad_step_peak_mib_no_remat=rm["grad", False][1],
        forward_saved_mib_remat=f"{rm['saved', True]:.1f}", forward_saved_mib_no_remat=f"{rm['saved', False]:.1f}",
        held_before_mib=f"{held['bytes'] / 2**20:.1f}" if on_card else "not measured", card=repr(card))
    if on_card:
        if not rm["saved", True] < rm["saved", False]:
            raise AssertionError(f"zoo-train: the forward keeps {rm['saved', True]} MiB with remat, "
                                 f"{rm['saved', False]} without")
        gp = rm["grad", True][1], rm["grad", False][1]
        if gp[0].startswith("does") or not (gp[1].startswith("does") or float(gp[0]) < float(gp[1])):
            raise AssertionError(f"zoo-train: a step's gradients peak at {gp[0]} MiB with remat, {gp[1]} without")
    del state, last, round_fn, model, batches
    free()

    # -- [zoo-train-consistency]: one local step in bf16 against float32 ----------
    zc = ZOO_TRAIN_BF16
    with fp32_matmuls():
        steps = {}
        for dtype in ("float32", "bfloat16"):
            c = full_cfg("gemma-2b", remat=True, n_layers=zc["n_layers"], dtype=dtype, param_dtype=dtype)
            m = build_model(c)
            if dtype == "float32":
                p32, _ = m.init(torch.Generator(device=dev).manual_seed(0))
                g = torch.Generator(device=dev).manual_seed(1)
                tok = torch.randint(0, c.vocab, (1, 1, zc["B"], zc["S"]), generator=g, device=dev, dtype=torch.int32)
            p = pytree.tree_map(lambda t: t.to(getattr(torch, dtype)), p32)
            new, stats = make_local_update(m, sgd(ZOO_TRAIN_LR, 0.9))(p, {"tokens": tok, "labels": tok},
                                                                    torch.ones(1, 1, device=dev))
            delta = pytree.tree_map(lambda a, b: a[0].float() - b.float(), new, p)
            steps[dtype] = (float(stats["local_loss"][0]), delta)
            del new, p
        (l32, d32), (l16, d16) = steps["float32"], steps["bfloat16"]
        loss_gap = abs(l16 - l32)
        delta_gap = max(float((a - b).abs().max()) for a, b in zip(pytree.tree_leaves(d16), pytree.tree_leaves(d32)))
        delta_max = max(float(a.abs().max()) for a in pytree.tree_leaves(d32))
    log("zoo-train-consistency", arch=c.name, layers=zc["n_layers"], batch=f"{zc['B']}x{zc['S']}",
        loss_f32=f"{l32:.5f}", loss_bf16=f"{l16:.5f}", loss_abs_diff=f"{loss_gap:.4g}",
        param_change_max_f32=f"{delta_max:.4g}", param_change_max_abs_diff=f"{delta_gap:.4g}",
        loss_atol=zc["loss_atol"], delta_atol=zc["delta_atol"], card=repr(card))
    if not (loss_gap <= zc["loss_atol"] and delta_gap <= zc["delta_atol"]):
        raise AssertionError(f"zoo-train-consistency: bf16 against float32: loss {loss_gap}, change {delta_gap}")
    del steps, d32, d16, p32, m
    free()

    # -- [zoo-silo]: qwen3-moe at full width on the silo mapping ----------------------
    cfg = full_cfg("qwen3-moe-30b-a3b", remat=True, **({} if smoke_widths else dict(n_layers=ZOO_TRAIN_DEPTH)))
    zs = ZOO_SILO
    model = build_model(cfg)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    local_step, opt_init, agg_accum, agg_apply = make_silo_steps(model, FLConfig(lr=ZOO_TRAIN_LR))
    g = torch.Generator(device=dev).manual_seed(2)
    free()
    acc = pytree.tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=dev), params)
    step_ms, losses, locals_ = [], [], []
    for c, w in zip(range(zs["clients"]), zs["weights"]):
        q, s = params, opt_init(params)
        for i in range(zs["steps"]):
            tok = torch.randint(0, cfg.vocab, (zs["B"], zs["S"]), generator=g, device=dev, dtype=torch.int32)
            sync()
            t0 = time.perf_counter()
            q, s, loss = local_step(q, s, {"tokens": tok, "labels": tok}, i)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        del s
        acc = agg_accum(acc, q, params, w)
        locals_.append(to(q, cpu))  # kept on the host for the check below, off the card's peak
        del q
    new = agg_apply(params, acc)
    sync()
    peak = peak_mib()
    # the update against a hand sum of the weighted deltas, leaf by leaf in float32 on the card
    err = 0.0
    for leaves in zip(pytree.tree_leaves(params), pytree.tree_leaves(acc), pytree.tree_leaves(new),
                      *(pytree.tree_leaves(q) for q in locals_)):
        gl, a, n, qs = leaves[0], leaves[1], leaves[2], leaves[3:]
        hand = sum(w * (q.to(dev).to(torch.float32) - gl.to(torch.float32)) for w, q in zip(zs["weights"], qs))
        err = max(err, float((a - hand).abs().max()))
        if not (torch.equal(a, hand) and torch.equal(n, (gl.to(torch.float32) + hand).to(gl.dtype))):
            raise AssertionError(f"zoo-silo: the update differs from the hand sum by {err}")
    finite = all(math.isfinite(v) for v in losses) and all(bool(torch.isfinite(t).all())
                                                           for t in pytree.tree_leaves(new))
    log("zoo-silo", arch=cfg.name, layers=cfg.n_layers, cut=f"{ZOO_TRAIN_DEPTH} of 48" if not smoke_widths else "smoke",
        params=n_params, dtype=cfg.param_dtype, moe_impl=cfg.moe_impl, experts=cfg.n_experts, top_k=cfg.moe_top_k,
        clients=zs["clients"], steps=zs["steps"], batch=f"{zs['B']}x{zs['S']}",
        step_ms=",".join(f"{v:.1f}" for v in step_ms), step_ms_warm=f"{np.median(step_ms[1:]):.1f}",
        loss=",".join(f"{v:.4f}" for v in losses), update_vs_hand_sum=f"equal (max abs diff {err})",
        finite=finite, peak_mib=peak, card=repr(card))
    if not finite:
        raise AssertionError("zoo-silo: non-finite loss or parameters")
    del params, acc, new, locals_, model
    free()
    log("check", zoo_train="all zoo-train checks passed", seconds=f"{time.time() - t_phase:.1f}")


# the mesh phase: gemma-2b uncut on a one-rank (data, model) mesh against the
# same calls without one (PR 23's round and silo settings)
MESH_ZOO = dict(B=4, prompts=(64, 1024), decode=8, silo_B=2, silo_S=512, K=32, k=2, n_steps=2, B_round=2,
                S_round=512)
# the dry run's cells (one process, a "fake" group of 256 or 512 ranks) and
# its check programs at a one-rank mesh (gemma-2b prefill 4 x 1024, and the
# silo step of 2 x 512 tokens on gemma-2b mapped to the silo mapping)
DRYRUN_CELLS = (("gemma-2b", "train_4k", "single"), ("llama3-405b", "train_4k", "single"),
                ("deepseek-v3-671b", "decode_32k", "multi"))
DRYRUN_CHECKS = (("prefill", 1024, 4), ("train", 512, 2))
# predicted peak above what is held against torch.cuda.max_memory_allocated:
# the caching allocator rounds each block up (to 512 B, and large ones to
# 2 MiB segments), which the count of live storages does not see; the H100
# read 0.0000 to 0.0002 of the measured peak in two calls, and 1 % of it
# leaves room for the allocator's rounding and no more
DRYRUN_MEM_RTOL = 0.01
# the CPU rehearsal's silo step and cohort round on the mesh against
# without (on the card they must be equal bit for bit): the silo step's tied
# embedding adds its lookup's and its logits head's gradients in another
# order on a mesh (autograd's accumulation over DTensor's graph), and the
# CPU's threaded backward sums differ between two runs of one round, by
# float32 ulps; after the step's rounding to bf16 an element that crosses a
# rounding boundary moves by one bf16 ulp, at most 2^-7 of it
MESH_TRAIN_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
DRYRUN_TIMEOUT = 600  # seconds the dry-run process may take


def dryrun_worker(out_dir):
    """The ``[dryrun]`` process (``chip_smoke.py --dryrun-worker DIR``,
    started and read by ``dryrun_path``): each of ``DRYRUN_CELLS`` through
    ``launch.dryrun.run_one``, then the check programs at a one-rank fake
    mesh, their summaries as JSON in ``DIR``.  It never touches the card:
    the dry run plans on ``meta`` tensors."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, make_mesh

    os.makedirs(out_dir, exist_ok=True)
    for arch, shape, mesh in DRYRUN_CELLS:
        t0 = time.time()
        rec = dryrun.run_one(arch, shape, mesh, out_dir, skip_existing=False)
        print(f"[dryrun-cell] {arch} {shape} {mesh} {rec['status']} {time.time() - t0:.1f}s", flush=True)
    dryrun._fake_group(1)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    checks = {}
    for kind, S, B in DRYRUN_CHECKS:
        cfg, shape = dryrun_check_program(kind, S, B, get_config, InputShape, dataclasses)
        build = dryrun.build_serve_program if kind == "prefill" else dryrun.build_train_program
        step, args, rules, held = build(cfg, shape, mesh, fill=dryrun.meta_fill)
        summary, _ = dryrun.run_program(step, args, rules, held, train=kind == "train")
        checks[kind] = summary
        print(f"[dryrun-cell] check {kind} flops={summary['flops']}", flush=True)
    with open(os.path.join(out_dir, "checks.json"), "w") as f:
        json.dump(checks, f)
    torch.distributed.destroy_process_group()


def dryrun_check_program(kind, S, B, get_config, InputShape, dataclasses):
    """gemma-2b at its full config and the check's shape (the train check on
    the silo mapping, one microbatch)."""
    cfg = get_config("gemma-2b")
    if kind == "train":
        cfg = dataclasses.replace(cfg, fl_mapping="silo")
    return cfg, InputShape(f"check_{kind}", S, B, kind)


def mesh_zoo_path(dev, card, smoke_widths=False):
    """Phase 15 (``[mesh-zoo]``): the model zoo on a mesh.  On a one-rank
    NCCL ``make_mesh((1, 1), ("data", "model"))``, gemma-2b at its full
    config (``smoke_widths``: its smoke, a CPU rehearsal on a gloo group),
    parameters placed by the dry run's ``serve_rules`` / ``silo_rules`` /
    ``cohort_rules`` as DTensors, each against the same call without a mesh
    from the same seed, all equal bit for bit on the card (a one-rank mesh
    runs the same local operations: the einsums on the local shards, the
    vocab-parallel pick a gather over the whole vocab, the data axis of one
    rank the vectorised local update):

    * prefill at 4 x 64 and 4 x 1024, then 8 greedy decode steps: tokens
      and logits;
    * one ``make_silo_steps`` step under ``silo_rules`` (2 x 512): loss and
      parameters (the CPU rehearsal: parameters within ``MESH_TRAIN_TOL``);
    * one ``make_cohort_round(spmd_axes="data")`` round at PR 23's settings
      (K = 32, k = 2, 2 steps of 2 x 512): cohort, mask and log-weights
      equal, loss and parameters (the CPU rehearsal: within
      ``MESH_TRAIN_TOL``)."""
    import gc

    import torch

    from repro_torch.core import prng
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree

    from repro_torch.configs import FLConfig, get_config, smoke_variant
    from repro_torch.data import lm_client_batches, make_lm_dataset
    from repro_torch.engine import RoundProgram
    from repro_torch.fl import init_server_state, make_cohort_round, make_silo_steps
    from repro_torch.launch import axis_sizes, dryrun, make_mesh
    from repro_torch.launch.serve import make_batch
    from repro_torch.models import build_model
    from repro_torch.models.sharding import cohort_rules, distribute_params, silo_rules, use_rules

    on_card = dev.type == "cuda"
    t_phase = time.time()
    held = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held["bytes"] = torch.cuda.memory_allocated()

    def peak_mib():
        return f"{(torch.cuda.max_memory_allocated() - held['bytes']) / 2**20:.1f}" if on_card else "not measured"

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def max_diff(a, b):
        """max |a - b| over two trees of tensors of one structure (0.0: equal bit for bit)."""
        err = 0.0
        for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
            x, y = whole(x), whole(y)
            if x.shape != y.shape:
                raise AssertionError(f"mesh-zoo: shapes {tuple(x.shape)} and {tuple(y.shape)}")
            if not torch.equal(x, y):
                err = max(err, float((x.float() - y.float()).abs().max()), 1e-30)
        return err

    tol = "bit for bit" if on_card else MESH_TRAIN_TOL

    def hold(what, a, b):
        """``(elements differing, max |a - b|)`` over two trees of tensors
        of one structure, each pair equal bit for bit on the card and within
        ``MESH_TRAIN_TOL`` on the CPU, else it raises."""
        n_diff, worst = 0, 0.0
        for (path, x), y in zip(pytree.tree_leaves_with_path(a), pytree.tree_leaves(b)):
            x, y = whole(x), whole(y)
            d = float((x.float() - y.float()).abs().max()) if x.numel() else 0.0
            if not (torch.equal(x, y) if on_card else torch.allclose(x.float(), y.float(), **MESH_TRAIN_TOL)):
                raise AssertionError(f"mesh-zoo: {what} {pytree.keystr(path)} differs on the mesh by {d} (tol {tol})")
            n_diff += int((x != y).sum())
            worst = max(worst, d)
        return n_diff, worst

    dist.init_process_group("nccl" if on_card else "gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        sizes = axis_sizes(mesh)
        base = get_config("gemma-2b")
        cfg = smoke_variant(base) if smoke_widths else base
        model = build_model(cfg)
        params, specs = model.init(torch.Generator(device=dev).manual_seed(0))
        n_params = sum(t.numel() for t in pytree.tree_leaves(params))
        z = MESH_ZOO

        # -- serving: prefill and greedy decode --------------------------------
        for S in z["prompts"]:
            batch = make_batch(cfg, z["B"], S, prng.PRNGKey(S, dev))
            out = {}
            for sharded in (False, True):
                pre = dryrun.serve_rules(cfg, sizes, "prefill") if sharded else None
                dec = dryrun.serve_rules(cfg, sizes, "decode") if sharded else None
                pp = distribute_params(params, specs, mesh, pre) if sharded else params
                pd = distribute_params(params, specs, mesh, dec) if sharded else params
                free()
                with torch.no_grad():
                    sync()
                    t0 = time.perf_counter()
                    with use_rules(pre):
                        logits, caches = model.prefill(pp, batch, max_len=S + z["decode"])
                    sync()
                    pre_ms = (time.perf_counter() - t0) * 1e3
                    tok = torch.argmax(whole(logits)[:, -1:], -1).to(torch.int32)
                    toks, logs = [tok], [whole(logits)[:, -1:]]
                    sync()
                    t0 = time.perf_counter()
                    for _ in range(z["decode"]):
                        with use_rules(dec):
                            ld, caches = model.decode(pd, tok, caches)
                        tok = torch.argmax(whole(ld)[:, -1:], -1).to(torch.int32)
                        toks.append(tok)
                        logs.append(whole(ld))
                    sync()
                    dec_s = time.perf_counter() - t0
                out[sharded] = (torch.cat(toks, 1), torch.cat(logs, 1), whole(logits))
                log("mesh-zoo", what="serve", arch=cfg.name, mesh="1x1 (data, model)", sharded=sharded,
                    batch=f"{z['B']}x{S}", prefill_ms=f"{pre_ms:.3f}",
                    decode_tokens_per_s=f"{z['B'] * z['decode'] / dec_s:.2f}", peak_mib=peak_mib(), card=repr(card))
                del logits, caches, ld, pp, pd
            if not torch.equal(out[False][0], out[True][0]):
                raise AssertionError(f"mesh-zoo: greedy tokens differ on the mesh at prompt {S}")
            diff = max_diff(out[True][1:], out[False][1:])
            log("mesh-zoo", what="serve-check", batch=f"{z['B']}x{S}", tokens="equal",
                logits_max_abs_diff=diff, tol="bit for bit")
            if diff:
                raise AssertionError(f"mesh-zoo: logits differ on the mesh at prompt {S} by {diff}")
            del out
        free()

        # -- one silo step under silo_rules -------------------------------------
        local_step, opt_init, _, _ = make_silo_steps(model, FLConfig(lr=5e-3, momentum=0.9))
        g = torch.Generator(device=dev).manual_seed(2)
        tok = torch.randint(0, cfg.vocab, (z["silo_B"], z["silo_S"]), generator=g, device=dev, dtype=torch.int32)
        res = {}
        for sharded in (False, True):
            rules = silo_rules(cfg, sizes) if sharded else None
            p0 = distribute_params(params, specs, mesh, rules) if sharded else params
            free()
            with use_rules(rules):
                s0 = opt_init(p0)
                sync()
                t0 = time.perf_counter()
                q, s1, loss = local_step(p0, s0, {"tokens": tok, "labels": tok}, 0)
                sync()
            ms = (time.perf_counter() - t0) * 1e3
            log("mesh-zoo", what="silo-step", arch=cfg.name, sharded=sharded, batch=f"{z['silo_B']}x{z['silo_S']}",
                step_ms=f"{ms:.1f}", loss=f"{float(whole(loss)):.6f}", peak_mib=peak_mib(), card=repr(card))
            res[sharded] = (whole(loss), pytree.tree_map(whole, q))
            del q, s0, s1, p0
        loss_diff = max_diff(res[True][0], res[False][0])
        n_diff, worst = hold("the silo step's parameter", res[True][1], res[False][1])
        log("mesh-zoo", what="silo-check", loss_max_abs_diff=loss_diff, params_max_abs_diff=worst,
            params_elements_differing=n_diff, loss_tol="bit for bit", params_tol=tol)
        if loss_diff:
            raise AssertionError(f"mesh-zoo: the silo step's loss differs on the mesh by {loss_diff}")
        del res
        free()

        # -- one cohort round over the data axis ---------------------------------
        fl = FLConfig(K=z["K"], k=z["k"], rounds=3, scheme="e3cs", quota="inc", lr=5e-3)
        pm = RoundProgram.from_config(fl, device=dev)
        noise = pm.draw_noise(pm.generator(1))
        stream = make_lm_dataset(cfg.vocab, 200_000, n_chains=fl.K, seed=0)
        ones = torch.ones(fl.k, device=dev)
        mask = torch.ones(fl.k, z["n_steps"], device=dev)
        total = torch.tensor(float(fl.K), device=dev)
        rounds = {}
        for sharded in (False, True):
            rules = cohort_rules(cfg, sizes) if sharded else None
            select = pm.select_fn()
            _, round_fn = make_cohort_round(model, fl, pm.quota_fn, pm.base_vol, pm.rho,
                                            "data" if sharded else None, select=select)
            p0 = distribute_params(params, specs, mesh, rules) if sharded else params
            state = init_server_state(p0, fl.K, pm.base_vol.init_state(), dev)
            idx, p, capped, sigma = select(state, noise)
            blocks = lm_client_batches(stream, fl.K, idx.cpu().numpy(), z["n_steps"], z["B_round"], z["S_round"],
                                       seed=0)
            b = torch.from_numpy(blocks[..., :-1]).to(dev)
            free()
            sync()
            t0 = time.perf_counter()
            with use_rules(rules):
                state, met = round_fn(state, idx, p, capped, sigma, {"tokens": b, "labels": b}, mask, ones, total,
                                      ones, noise.u)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            tokens = fl.k * z["n_steps"] * z["B_round"] * z["S_round"]
            log("mesh-zoo", what="cohort-round", arch=cfg.name, sharded=sharded, spmd_axes="data" if sharded else None,
                K=fl.K, k=fl.k, n_steps=z["n_steps"], batch=f"{z['B_round']}x{z['S_round']}", round_ms=f"{ms:.1f}",
                tokens_per_s=f"{tokens / (ms / 1e3):.1f}", loss=f"{float(met['mean_local_loss']):.6f}",
                peak_mib=peak_mib(), card=repr(card))
            rounds[sharded] = (idx, state.sel_counts, state.e3cs.logw, met["mean_local_loss"],
                               pytree.tree_map(whole, state.params))
            del state, p0, b
        a, b = rounds[True], rounds[False]
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])):
            raise AssertionError("mesh-zoo: the cohort, mask or log-weights differ on the mesh")
        n_diff, worst = hold("the cohort round's", a[3:], b[3:])
        log("mesh-zoo", what="cohort-check", cohort="equal", mask="equal", logw="equal",
            loss_and_params_max_abs_diff=worst, elements_differing=n_diff, tol=tol)
        del rounds, a, b, params
        free()

    finally:
        dist.destroy_process_group()
    log("check", mesh_zoo="all mesh-zoo checks passed", params=n_params,
        seconds=f"{time.time() - t_phase:.1f}")


def dryrun_path(dev, card, smoke_widths=False):
    """Phase 15, its second part (``[dryrun]``, ``[dryrun-check]``), after
    the last timed phase, so that no time shares the host with it: the dry
    run in a process of its own (its ``"fake"`` process group never meets
    this one's), ``dryrun_worker`` planning ``DRYRUN_CELLS`` while this
    process runs the check programs for real on a one-rank NCCL
    ``make_mesh((1, 1), ("data", "model"))`` under the same counter.  Then
    ``[dryrun]``: each cell's record (per-device GB, FLOPs, collective
    bytes, the roofline's bottleneck at data-sheet rates), and
    ``[dryrun-check]``: FLOPs planned equal to FLOPs run, and the predicted
    peak within ``DRYRUN_MEM_RTOL`` of the allocator's (``smoke_widths``: a
    CPU rehearsal on a gloo group, which runs the checks at smoke widths and
    holds them against nothing)."""
    import dataclasses
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, make_mesh

    on_card = dev.type == "cuda"
    t_phase = time.time()
    out_dir = os.path.join(CHIPRUN_OUT, "dryrun_torch")
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"),
               CUDA_VISIBLE_DEVICES="")
    configs = (lambda a: smoke_variant(get_config(a))) if smoke_widths else get_config
    ran = {}
    with open(os.path.join(out_dir, "worker.log"), "w") as worker_log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dryrun-worker", out_dir],
                                env=env, stdout=worker_log, stderr=subprocess.STDOUT)
        try:
            dist.init_process_group("nccl" if on_card else "gloo", store=dist.HashStore(), rank=0, world_size=1)
            try:
                mesh = make_mesh((1, 1), ("data", "model"), device=dev)
                for kind, S, B in DRYRUN_CHECKS:
                    cfg_c, shape = dryrun_check_program(kind, S, B, configs, InputShape, dataclasses)
                    build = dryrun.build_serve_program if kind == "prefill" else dryrun.build_train_program
                    step, args, rules, held_trees = build(cfg_c, shape, mesh)
                    gc.collect()
                    if on_card:
                        torch.cuda.empty_cache()
                        torch.cuda.reset_peak_memory_stats()
                        held = torch.cuda.memory_allocated()
                    summary, out = dryrun.run_program(step, args, rules, held_trees, train=kind == "train")
                    if on_card:
                        torch.cuda.synchronize()
                    ran[kind] = (summary, (torch.cuda.max_memory_allocated() - held) if on_card
                                 else summary["peak_above_start"])
                    del step, args, held_trees, out
            finally:
                dist.destroy_process_group()
            rc = proc.wait(timeout=DRYRUN_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"dryrun: the dry-run process exited {rc}; see {out_dir}/worker.log")
    for arch, shape, mk in DRYRUN_CELLS:
        with open(os.path.join(out_dir, f"{arch}__{shape}__{mk}.json")) as f:
            rec = json.load(f)
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun {arch} {shape} {mk}: {rec['status']}: {rec.get('error')}")
        r, c = rec["roofline"], rec["collectives"]
        log("dryrun", arch=arch, shape=shape, mesh=mk, mesh_shape="x".join(map(str, rec["mesh_shape"])),
            per_device_gb=rec["per_device_hbm_gb"], flops_per_dev=f"{rec['flops_per_dev']:.4g}",
            collective_bytes_per_dev=f"{c['total']:.4g}", bottleneck=r["bottleneck"],
            compute_s=f"{r['compute_s']:.4g}", memory_s=f"{r['memory_s']:.4g}",
            collective_s=f"{r['collective_s']:.4g}", run_s=rec["run_s"],
            rates="H100 data-sheet peaks (989 TFLOP/s bf16, 3.35 TB/s HBM, 50 GB/s a link), not measured")
    with open(os.path.join(out_dir, "checks.json")) as f:
        planned = json.load(f)
    for kind, S, B in DRYRUN_CHECKS:
        summary, measured = ran[kind]
        want = planned[kind]
        rel = abs(want["peak_above_start"] - measured) / max(measured, 1)
        log("dryrun-check", program=f"gemma-2b {kind} {B}x{S}", flops_planned=want["flops"],
            flops_run=summary["flops"], predicted_peak_mib=f"{want['peak_above_start'] / 2**20:.1f}",
            counted_peak_mib=f"{summary['peak_above_start'] / 2**20:.1f}",
            allocator_peak_mib=f"{measured / 2**20:.1f}", rel_diff=f"{rel:.4f}", rtol=DRYRUN_MEM_RTOL,
            collectives_planned=want["collectives"]["total"], card=repr(card))
        if smoke_widths:
            continue  # the rehearsal plans the full config: nothing to hold against
        if want["flops"] != summary["flops"]:
            raise AssertionError(f"dryrun-check {kind}: FLOPs planned {want['flops']} != run {summary['flops']}")
        if rel > DRYRUN_MEM_RTOL:
            raise AssertionError(f"dryrun-check {kind}: predicted peak {want['peak_above_start']} B against "
                                 f"{measured} B measured (relative {rel:.3f} > {DRYRUN_MEM_RTOL})")
    log("check", dryrun="all dry-run checks passed", seconds=f"{time.time() - t_phase:.1f}")


def _feed(seed, j, t, K, S):
    """Job ``j``'s round-``t`` feedback, made anew from ``(seed, j, t)``: the
    paper's success rates decide who is on time (bits, S = 0); under S > 0 a
    failure is late by 1..S rounds (p = 0.7) or never (lag codes)."""
    from repro_torch.core.volatility import paper_success_rates

    rng = np.random.default_rng([seed, j, t])
    ok = rng.random(K) < paper_success_rates(K)
    if not S:
        return ok
    return np.where(ok, 0, np.where(rng.random(K) < 0.7, rng.integers(1, S + 1, K), -1)).astype(np.int32)


def _serve_clients(srv, jobs, feed_of):
    """Each job ticked by its own loopback client on its own thread,
    round-tagged, so ticks are in flight together and dispatches coalesce.
    ``jobs`` maps job uid -> (its index, first round, rounds).  Returns
    ({uid: [cohort a round]}, [request seconds], wall seconds)."""
    import threading

    from repro_torch.serve import ServeClient

    cohorts = {u: [] for u in jobs}
    lat, errors = [], []

    def drive(uid, j, t0, n):
        try:
            with ServeClient.connect(srv.address, timeout=600.0) as c:
                for t in range(t0, t0 + n):
                    feed = feed_of(j, t)
                    s = time.perf_counter()
                    out = c.tick(uid, round=t, **({"bits": feed} if feed.dtype == bool else {"lags": feed}))
                    lat.append(time.perf_counter() - s)
                    cohorts[uid].append(out["cohort"])
        except Exception as e:  # raised in the main thread below
            errors.append(e)

    threads = [threading.Thread(target=drive, args=(u, *spec)) for u, spec in jobs.items()]
    w0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900.0)
    wall = time.perf_counter() - w0
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"serving clients: {errors or 'a client thread did not finish'}")
    return cohorts, lat, wall


def _ms_quantiles(seconds):
    a = np.asarray(seconds) * 1e3
    return f"{np.percentile(a, 50):.3f}", f"{np.percentile(a, 99):.3f}"


def block_sums_on_jobs(eng, label):
    """The block-sum kernel (B5) against its plain version on the inputs each
    job of a ``ShardedEngine`` gives it next: the job's allocation run
    eagerly on the rank's state (every rank of the engine's group at once),
    every call of the kernel's wrapper recorded and held at ``BISECT_RTOL``.
    Returns one log field a job."""
    import torch

    from repro_torch import kernels as kn
    from repro_torch.engine import sharded
    from repro_torch.engine.sharded import N_ITERS
    from repro_torch.kernels import ref

    rows = {}
    for uid, job in sorted(eng.jobs.items()):
        _, _, program = eng._runner(job["spec"])
        state, calls = job["state"], []

        def recorded(w, caps, tile=None):
            out = kn.bisect_block_sums(w, caps, tile=tile)
            calls.append((w, caps.clone(), tile, out.clone()))
            return out

        logw, mesh = state.e3cs.logw, program.mesh
        wrapper, sharded.bisect_block_sums = sharded.bisect_block_sums, recorded
        try:
            sharded.masked_prob_alloc(torch.exp(logw - mesh.pmax(torch.max(logw))), program.fl.k,
                                      program.quota_fn(state.t), active=torch.ones_like(logw), mesh=mesh,
                                      block=program.block)
        finally:
            sharded.bisect_block_sums = wrapper
        errs = []
        for w, caps, tile, got in calls:
            want = ref.bisect_block_sums_ref(w, caps, tile=tile)
            errs.append((float((got - want).abs().max()), float(((got - want).abs() / want.abs()).max())))
        rel = max(e[1] for e in errs)
        if len(calls) != -(-N_ITERS // program.block) or not rel <= BISECT_RTOL["float32"]:
            raise AssertionError(f"{label}: job {uid}: {len(calls)} block sums, max relative error {rel} against "
                                 f"the plain version (rtol {BISECT_RTOL['float32']})")
        rows[f"job{uid}_K{job['spec'].K}_slab{logw.shape[0]}"] = dict(
            calls=len(calls), max_abs_err=max(e[0] for e in errs), max_rel_err=rel)
    return rows


def serve_path(dev, card, seed=SCENARIO_SEED, J=8, K_slots=100_000, k_cap=2000, rounds=30, K_sharded=1_000_000,
               k_sharded=1000, rounds_sharded=50, rounds_chaos=30):
    """Phase 15: the selection service (``repro_torch.serve``) on the card,
    driven over loopback sockets by ``ServeClient``s; the process group is
    up (``ShardedEngine`` runs on it).  Each server runs with the launch
    counts set to 0 just before it and checked exactly just after.  Returns
    the launch counts of the serving paths.

    * ``[serve-slots]``: a ``SelectionServer`` over ``SlotEngine(K_max=
      K_slots, k_cap)`` at S = 0 and 2, the JAX package's standard fleet (J
      jobs, ``_heterogeneous_fleet``) admitted one at a time: four jobs tick
      once (the J = 4 capture), four more join (the ladder grows to 8, the
      second capture) and all eight tick once, then every job ticks to
      ``rounds`` rounds (the timed part), each on its own client thread.
      Every cohort holds k_j distinct clients of [0, K_j); each job's
      cohorts equal those of an in-process engine that ticks the job alone,
      bit for bit; the top-k kernel equals its plain version on the live
      rows of that engine and of an in-process engine of all J jobs (the
      served bucket of 8); it launches J a dispatch plus one warm-up
      dispatch's J a capture.
    * ``[serve-sharded]``: a ``SelectionServer`` over ``ShardedEngine(D=1,
      staleness=2, block=4)``, jobs of (K_sharded, k_sharded) and half that,
      ``rounds_sharded`` rounds over ``xl`` lags; after half of them a
      checkpoint and ``kill()``, and a new server restored from disk
      finishes.  Every cohort equals an uninterrupted in-process engine's;
      the block sums launch 12 a tick a job plus one warm-up round's 12 a
      capture (the restore captures again), and equal their plain version
      on each job's own inputs at the checkpoint and at the horizon's end.
    * ``[serve-chaos]``: the JAX package's chaos plan against the sharded
      async server, ``rounds_chaos`` rounds: the horizon equals the
      fault-free run, ``fired()`` is as scheduled, recovery restores step
      18, the device memory allocated after it is within
      ``SERVE_MEM_MARGIN`` of its level before the crash, and the
      fault-free run's engine leaves at most that margin behind it.
    """
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch import checkpoint as ckpt
    from repro_torch import kernels as kn
    from repro_torch.engine import MultiJobState
    from repro_torch.engine.multi_job import plain_batched_step
    from repro_torch.engine.sharded import N_ITERS
    from repro_torch.kernels import ref
    from repro_torch.launch import select_serve
    from repro_torch.obs import LatencyHistogram
    from repro_torch.serve import FaultPlan, JobSpec, SelectionServer, ServeClient, ServeError, ShardedEngine
    from repro_torch.serve import SlotEngine, load_server

    on_card = dev.type == "cuda"
    launched = {}

    def checked(label, want):
        got = {n: c for n, c in kn.launch_counts().items() if c}
        want = {n: c for n, c in want.items() if c} if on_card else {}
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        for n, c in got.items():
            launched[n] = launched.get(n, 0) + c
        return json.dumps(got)

    def distinct(label, cohorts, K, k):
        for t, cohort in enumerate(cohorts):
            if len(cohort) != k or len(set(cohort)) != k or not all(0 <= i < K for i in cohort):
                raise AssertionError(f"{label}: round {t}'s cohort is not {k} distinct clients of [0, {K})")

    def topk_on_live_rows(eng, before, outs, label):
        """The top-k kernel against its plain version on each live row of the
        slot engine's last dispatch (the scores its step ranked), and the
        row's top k_j against the job's cohort; returns the rows checked."""
        cfg, g = eng.cfg, eng._step.g
        x = (eng._step.lag == 0).float() * cfg.active
        _, o = plain_batched_step(cfg, before, g, x, k_max=k_cap)
        scores = torch.where(cfg.active > 0, torch.log(torch.clamp(o["p"], min=1e-20)) + g, float("-inf"))
        for uid, out in outs.items():
            row, k = scores[eng.jobs[uid]["slot"]], eng.jobs[uid]["spec"].k
            vals, idx = kn.gumbel_topk_kernel_call(row, k_cap)
            wv, wi = ref.gumbel_topk_kernel_ref(row, k_cap)
            if not (torch.equal(vals, wv) and torch.equal(idx, wi)):
                raise AssertionError(f"{label}: the top-k kernel differs from its plain version on job {uid}'s row")
            if idx[:k].tolist() != out["cohort"]:
                raise AssertionError(f"{label}: job {uid}: the kernel's top k_j is not the cohort")
        return len(outs)

    # -- [serve-slots] ------------------------------------------------------------------
    Ks, ks, fracs, etas = select_serve._heterogeneous_fleet(J, K_slots, np.random.default_rng(seed))
    per_row = 1 if k_cap <= 2048 else 0  # the top-k kernel a row, or a stable sort
    for S in (0, 2):
        def feed_of(j, t):
            return _feed(seed, j, t, Ks[j], S)

        def admit(c, j):
            return c.admit(K=Ks[j], k=ks[j], sigma_frac=fracs[j], eta=etas[j], seed=seed + j)

        kn.reset_launch_counts()
        srv = SelectionServer(SlotEngine(K_max=K_slots, k_cap=k_cap, staleness=S, device=dev), max_queue=4 * J)
        srv.start()
        with ServeClient.connect(srv.address, timeout=600.0) as c:
            uids = [admit(c, j) for j in range(4)]
            got, _, _ = _serve_clients(srv, {u: (j, 0, 1) for j, u in enumerate(uids)}, feed_of)
            d4 = srv.stats["dispatches"]
            uids += [admit(c, j) for j in range(4, J)]
        slots = srv.engine.n_slots
        step = srv.engine._step
        warm, _, _ = _serve_clients(srv, {u: (j, int(j < 4), 1) for j, u in enumerate(uids)}, feed_of)
        d_warm = srv.stats["dispatches"]
        srv.latency = LatencyHistogram(lo=1e-5, hi=60.0)  # the timed part's dispatches only
        rest, lat, wall = _serve_clients(srv, {u: (j, 1 + int(j < 4), rounds - 1 - int(j < 4))
                                               for j, u in enumerate(uids)}, feed_of)
        srv.close(checkpoint=False)
        d_all, ticks = srv.stats["dispatches"], srv.stats["ticks"]
        launches = checked(f"serve-slots S={S}", {"gumbel_topk": per_row * (4 * d4 + slots * (d_all - d4) + 4 + slots)})
        cohorts = {u: got.get(u, []) + warm[u] + rest[u] for u in uids}
        if slots != 8 or ticks != J * rounds:
            raise AssertionError(f"serve-slots S={S}: {slots} slots, {ticks} ticks")
        # each job alone in an in-process engine: the same cohorts; the top-k
        # kernel against its plain version on that engine's live row, and on
        # the rows of an engine of all J jobs (the served bucket)
        def lags(j, t):
            lag = feed_of(j, t)
            return np.where(lag, 0, -1) if lag.dtype == bool else lag

        def spec(j):
            return JobSpec(K=Ks[j], k=ks[j], sigma_frac=fracs[j], eta=etas[j], seed=seed + j)

        alone = SlotEngine(K_max=K_slots, k_cap=k_cap, staleness=S, device=dev)
        rows_alone = 0
        for j, u in enumerate(uids):
            distinct(f"serve-slots S={S} job {j}", cohorts[u], Ks[j], ks[j])
            a = alone.admit(spec(j))
            for t in range(rounds):
                before = MultiJobState(alone.state.logw.clone(), alone.state.t.clone())
                outs = alone.tick([(a, lags(j, t))])
                if outs[a]["cohort"] != cohorts[u][t]:
                    raise AssertionError(f"serve-slots S={S}: job {j} round {t}: the server's cohort differs from "
                                         "the job's alone")
                if t < 2:
                    rows_alone += topk_on_live_rows(alone, before, outs, f"serve-slots S={S} alone round {t}")
            alone.retire(a)
        batch = SlotEngine(K_max=K_slots, k_cap=k_cap, staleness=S, device=dev)
        b_uids = [batch.admit(spec(j)) for j in range(J)]
        rows_batch = 0
        for t in range(2):
            before = MultiJobState(batch.state.logw.clone(), batch.state.t.clone())
            outs = batch.tick([(b, lags(j, t)) for j, b in enumerate(b_uids)])
            if batch.n_slots != 8 or [outs[b]["cohort"] for b in b_uids] != [cohorts[u][t] for u in uids]:
                raise AssertionError(f"serve-slots S={S}: round {t} of the {batch.n_slots}-slot batch differs from "
                                     "the served cohorts")
            rows_batch += topk_on_live_rows(batch, before, outs, f"serve-slots S={S} batch round {t}")
        p50, p99 = _ms_quantiles(lat)
        n_timed = len(lat)
        log("serve-slots", S=S, jobs=J, K_max=K_slots, k_cap=k_cap, rounds=rounds, slots=slots,
            ticks_per_s=f"{n_timed / wall:.1f}", request_p50_ms=p50, request_p99_ms=p99,
            dispatch_p50_ms=f"{srv.latency.quantile(0.5) * 1e3:.3f}",
            dispatch_p99_ms=f"{srv.latency.quantile(0.99) * 1e3:.3f}",
            jobs_per_dispatch=f"{ticks / d_all:.2f}", timed_ticks=n_timed, timed_dispatches=d_all - d_warm,
            warmup_ms=f"{step.warmup_s * 1e3:.1f}" if on_card else None,
            capture_ms=f"{step.capture_s * 1e3:.1f}" if on_card else None,
            launches=launches, card=repr(card))
        log("serve-slots", S=S, check="cohorts", alone_vs_served="bit-identical", batch8_vs_served="bit-identical",
            topk_live_rows_vs_plain=json.dumps({"alone_J4": rows_alone, "batch_J8": rows_batch}),
            topk_vs_plain="bit-identical", distinct="k_j clients of [0, K_j) every round")
        del srv, alone, batch, step
    if on_card:
        torch.cuda.empty_cache()

    # -- [serve-sharded] ----------------------------------------------------------------
    n_block = -(-N_ITERS // 4)
    specs = [dict(K=K_sharded, k=k_sharded, rounds=rounds_sharded, seed=seed),
             dict(K=K_sharded // 2, k=k_sharded // 2, rounds=rounds_sharded, seed=seed + 1)]

    def reference(specs, feed_of, n):
        eng = ShardedEngine(D=1, staleness=2, block=4, device=dev)
        uids = [eng.admit(JobSpec(**s)) for s in specs]
        ticks = [eng.tick([(u, feed_of(i, t)) for i, u in enumerate(uids)]) for t in range(n)]
        return [[r[u]["cohort"] for r in ticks] for u in uids]

    def sharded_feed(i, t):
        return _feed(seed + 10, i, t, specs[i]["K"], 2)

    want = reference(specs, sharded_feed, rounds_sharded)
    half = rounds_sharded // 2
    tmp = tempfile.mkdtemp(prefix="serve_ckpt_")
    try:
        kn.reset_launch_counts()
        srv = SelectionServer(ShardedEngine(D=1, staleness=2, block=4, device=dev), ckpt_dir=tmp)
        srv.start()
        with ServeClient.connect(srv.address, timeout=600.0) as c:
            uids = [c.admit(**s) for s in specs]
            got, _, _ = _serve_clients(srv, {u: (i, 0, 1) for i, u in enumerate(uids)}, sharded_feed)  # the captures
            more, lat1, wall1 = _serve_clients(srv, {u: (i, 1, half - 1) for i, u in enumerate(uids)}, sharded_feed)
            t0 = time.perf_counter()
            stem = c.checkpoint()
            ckpt_ms = (time.perf_counter() - t0) * 1e3
        srv.kill()
        killed = srv.engine
        t0 = time.perf_counter()
        engine, step_ = load_server(stem, device=dev)
        restore_ms = (time.perf_counter() - t0) * 1e3
        srv2 = SelectionServer(engine, ckpt_dir=tmp)
        srv2.start()
        first, _, first_s = _serve_clients(srv2, {u: (i, half, 1) for i, u in enumerate(uids)}, sharded_feed)
        rest, lat2, wall2 = _serve_clients(srv2, {u: (i, half + 1, rounds_sharded - half - 1)
                                                  for i, u in enumerate(uids)}, sharded_feed)
        srv2.close(checkpoint=False)
        launches = checked("serve-sharded", {"bisect_block_sums": n_block * (len(specs) * rounds_sharded + 4)})
        if step_ != len(specs) * half:
            raise AssertionError(f"serve-sharded: restored step {step_}, not {len(specs) * half}")
        for when, eng in ((f"round {half}", killed), (f"round {rounds_sharded}", engine)):
            log("serve-sharded", check="block_sums_vs_plain", at=when, rtol=BISECT_RTOL["float32"],
                jobs=json.dumps(block_sums_on_jobs(eng, f"serve-sharded {when}")))
        for i, u in enumerate(uids):
            served = got[u] + more[u] + first[u] + rest[u]
            distinct(f"serve-sharded job {i}", served, specs[i]["K"], specs[i]["k"])
            if served != want[i]:
                raise AssertionError(f"serve-sharded: job {i}: the served horizon differs from the uninterrupted one")
        lat = lat1 + lat2
        p50, p99 = _ms_quantiles(lat)
        log("serve-sharded", jobs="K=%d,k=%d;K=%d,k=%d" % (specs[0]["K"], specs[0]["k"], specs[1]["K"], specs[1]["k"]),
            rounds=rounds_sharded, staleness=2, block=4, ticks_per_s=f"{len(lat) / (wall1 + wall2):.1f}",
            request_p50_ms=p50, request_p99_ms=p99, checkpoint_write_ms=f"{ckpt_ms:.1f}",
            checkpoint_bytes=os.path.getsize(stem + ".ckpt"), codec=ckpt.checkpoint.CODEC,
            restore_ms=f"{restore_ms:.1f}", first_ticks_after_restore_ms=f"{first_s * 1e3:.1f}",
            restored_step=step_, served_vs_uninterrupted="bit-identical", launches=launches, card=repr(card))
        del srv, srv2, engine, killed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if on_card:
        torch.cuda.empty_cache()

    def left_behind(fn):
        """Device bytes still allocated after ``fn`` returns."""
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev) if on_card else 0
        fn()
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
        return (torch.cuda.memory_allocated(dev) if on_card else 0) - before

    # -- [serve-chaos] ------------------------------------------------------------------
    specs = [dict(s, rounds=rounds_chaos) for s in specs]

    def chaos_feed(i, t):
        return _feed(seed + 20, i, t, specs[i]["K"], 2)

    want = []
    engine_left = left_behind(lambda: want.extend(reference(specs, chaos_feed, rounds_chaos)))
    if engine_left > SERVE_MEM_MARGIN:
        raise AssertionError(f"serve-chaos: the fault-free run's engine left {engine_left} bytes allocated behind it")
    if on_card:
        torch.cuda.empty_cache()
    plan = FaultPlan(crash_steps=(25,), corrupt_checkpoints=(3,), drop_responses=(12, 31), slow_steps={5: 0.02})
    tmp = tempfile.mkdtemp(prefix="serve_chaos_")
    try:
        kn.reset_launch_counts()
        srv = SelectionServer(ShardedEngine(D=1, staleness=2, block=4, device=dev), ckpt_dir=tmp, ckpt_every=6,
                              faults=plan, restart_backoff=0.01)
        mem_before = None
        with srv, ServeClient.connect(srv.address, timeout=600.0, retries=6, seed=5) as c:
            uids = [c.admit(**s) for s in specs]
            cursors, got = {i: 0 for i in range(2)}, {i: {} for i in range(2)}
            t0 = time.perf_counter()
            while any(t < rounds_chaos for t in cursors.values()):
                for i, u in enumerate(uids):
                    t = cursors[i]
                    if t >= rounds_chaos:
                        continue
                    if mem_before is None and srv.stats["dispatches"] == 25:  # the next dispatch crashes
                        mem_before = torch.cuda.memory_allocated(dev) if on_card else 0
                    try:
                        out = c.tick(u, lags=chaos_feed(i, t), round=t)
                    except ServeError as e:
                        if e.code == "round_desync":
                            cursors[i] = int(e.response["expected"])
                            continue
                        raise
                    got[i][out["round"]] = out["cohort"]
                    cursors[i] = out["round"] + 1
            wall = time.perf_counter() - t0
            mem_after = torch.cuda.memory_allocated(dev) if on_card else 0
            gc.collect()  # logged beside: a difference would be a reference cycle's
            mem_after_gc = torch.cuda.memory_allocated(dev) if on_card else 0
            ticks = srv.stats["ticks"]
        launches = checked("serve-chaos", {"bisect_block_sums": n_block * (ticks + 4)})
        fired = plan.fired()
        restart = [a for a in srv.alerts if a.rule == "engine_restart"]
        if fired != {"crash": 1, "corrupt": 1, "drop": 2, "slow": 1} or len(restart) != 1 \
                or restart[0].detail["restored_step"] != 18:
            raise AssertionError(f"serve-chaos: fired {fired}, restarts {[a.detail for a in restart]}")
        for i in range(2):
            if [got[i].get(t) for t in range(rounds_chaos)] != want[i]:
                raise AssertionError(f"serve-chaos: job {i}: the horizon differs from the fault-free run")
        if mem_before is None or abs(mem_after - mem_before) > SERVE_MEM_MARGIN:
            raise AssertionError(f"serve-chaos: device memory {mem_before} before the crash, {mem_after} after")
        log("serve-chaos", jobs="K=%d;K=%d" % (specs[0]["K"], specs[1]["K"]), rounds=rounds_chaos, fired=json.dumps(fired),
            restored_step=18, recovery_ms=f"{srv.recoveries[0] * 1e3:.1f}", ticks=ticks,
            replayed=srv.stats["replayed"], horizon_s=f"{wall:.3f}", mem_before_bytes=mem_before,
            mem_after_bytes=mem_after, mem_after_collect_bytes=mem_after_gc, mem_margin_bytes=SERVE_MEM_MARGIN,
            fault_free_engine_left_bytes=engine_left, horizon_vs_fault_free="bit-identical",
            launches=launches, card=repr(card))
        del srv
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("check", serve="all serving checks passed")
    return launched


SERVE_MESH = dict(D=2, K=1_000_000, k=1000, rounds=20, rounds_chaos=30, seed=SCENARIO_SEED + 30)
SERVE_MESH_TIMEOUT = 300  # seconds the ranks of [serve-sharded-mesh] may take


def jax_stream_feedback(j, t, K, S):
    """``scripts/make_jax_stream_fixture.py``'s feedback rows: job ``j``'s
    round-``t`` lag codes, an integer hash of (j, t, client)."""
    h = (np.arange(K, dtype=np.uint64) * np.uint64(2654435761) + np.uint64(40503 * t + 9973 * j + 1)) % np.uint64(1000)
    h = h.astype(np.int64)
    if not S:
        return np.where(h < 700, 0, -1).astype(np.int32)
    return np.where(h < 550, 0, np.where(h < 700, 1, np.where(h < 800, S, -1))).astype(np.int32)


def _cohort_check(label, t, cohort, want, scores, kth):
    """A cohort equals JAX's, or else every client that differs scores within
    ``JAX_NOISE_ATOL`` of JAX's k-th score; returns whether it was equal."""
    if np.array_equal(cohort, want):
        return True
    diff = np.setxor1d(cohort, want)
    off = np.abs(scores[diff] - kth)
    if not np.all(off <= JAX_NOISE_ATOL):
        raise AssertionError(f"{label} round {t}: {diff.size} clients differ from JAX's cohort, up to "
                             f"{float(off.max())} from its k-th score")
    return False


def graph_call_ms(fn, reps=TIMED_CALLS):
    """Per-call device time of ``reps`` calls captured in one CUDA graph
    (no host gaps), CUDA events around one replay after a warm one."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def eager_call_ms(fn, reps=3):
    """Per-call time of ``reps`` eager calls on the host clock, the device
    synchronised around them (a plain version's many launches)."""
    import torch

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def threefry_kernel_rows(dev, card, bw, K=K_MAIN):
    """Phase 16, ``[jax-stream-kernel]``: the threefry kernel on the card;
    returns its rows for the kernels line (see ``jax_stream_path``)."""
    import torch

    from repro_torch import kernels as kn
    from repro_torch.core import prng
    from repro_torch.kernels import ref

    rows = {}
    key = prng.PRNGKey(12345, dev).data
    path, errs = (3, 2**33 + 7), {}
    # 10^6 counters at two offsets, then odd sizes, offsets and blocks in both
    # layouts: the draw kernels' edges (a thread's group of counters cut
    # short, a group whose low words wrap, a block of a draw across its
    # halves, an odd draw's padded pair)
    for mode, lo, hi in THREEFRY_MODES_CHECKED:
        cases = [(offset, 3 if mode == "keys" else K, 0) for offset in (0, 2**32 - 2)]
        for n in (1, 3, 255, K + 1):
            cases += [(offset, n, 0) for offset in (0, 5, 2**32 - 2)]
            cases += [(0, n, n), (0, n, 2 * n + 1), (n + 1, n, 2 * n + 1), (n // 2, n, 2 * n + 1)]
        for offset, m, total in cases:
            got = kn.threefry(key, path, offset, m, mode, lo, hi, total=total)
            errs[mode] = max(errs.get(mode, 0.0), _held_threefry(
                f"threefry {mode} [{lo}, {hi}) n={m} offset={offset} total={total}", got,
                ref.threefry_ref(key, path, offset, m, mode, lo, hi, total=total), mode))
    adv = key.clone()
    want = key.clone()
    for _ in range(3):  # a carried key advanced in place, three times
        kn.threefry(adv, (), 0, 1, "keys", out=adv.view(1, 2))
        want = ref.threefry_ref(want, (), 0, 1, "keys").view(2)
        if not torch.equal(adv, want):
            raise AssertionError("threefry: the in-place advance of a key differs from its plain version")
    blocked = threefry_blocked_draw(dev, key, path)
    log("jax-stream-kernel", K=K, modes=",".join(errs), gumbel_max_abs_err=errs["gumbel"],
        normal_max_abs_err=errs["normal"], others="equal", in_place_advance="equal", sizes="1,3,255,K+1",
        layouts="partitionable,original", blocked_draw=blocked)
    # the epilogues the horizons and drivers launch at their shapes, each a
    # row of the kernels line: a key's in-place advance, volatility rows,
    # Gumbel rows, a permutation's sort keys (random and pow-d on the key
    # stream) and 32-bit words (randint: the served prompt)
    out_u, out_g = (torch.empty(K, dtype=torch.float32, device=dev) for _ in range(2))
    out_b = torch.empty(K, dtype=torch.int32, device=dev)
    rand_ms = graph_call_ms(lambda: torch.rand(K, device=dev, out=out_u))
    cases = {"keys": (adv, (), 1, adv.view(1, 2), 16), "uniform": (key, path, K, out_u, 8 + 4 * K),
             "gumbel": (key, path, K, out_g, 8 + 4 * K), "bits": (key, path, K, out_b, 8 + 4 * K),
             "sortkey": (key, path, K, out_b, 8 + 4 * K)}
    for mode, (kk, pp, n, out, nbytes) in cases.items():
        ms = graph_call_ms(lambda: kn.threefry(kk, pp, 0, n, mode, out=out))
        plain = eager_call_ms(lambda: ref.threefry_ref(kk, pp, 0, n, mode), reps=5)
        # n hashes and their epilogues, and the key's folds (one hash each)
        b = _threefry_bound(mode, n, nbytes, bw, folds=len(pp))
        rows[f"threefry.{mode}"] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/threefry.cu",
            replaces="src/repro/engine/round_program.py:415 (jax.random: XLA's threefry, no Pallas kernel)",
            max_abs_err=errs[mode], ms=ms, plain_ms=plain, bound_ms=b[0], bound_by=b[1], library_ms=None)
        log("jax-stream-kernel-time", mode=mode, layout="partitionable", n=n, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
            bound_ms=f"{b[0]:.6f}", bound_by=b[1], of_bound=f"{b[0] / ms:.3f}", torch_rand_ms=f"{rand_ms:.4f}",
            torch_rand="a different stream, not the same function", card=repr(card))
    # the two draw kernels in both layouts at 10^6 and a gemma-2b MLP leaf
    # (normal): the times PERF.md's threefry table gives (the kernels line's
    # rows of normal and of the original layout come from their own phases)
    leaf = torch.empty(GEMMA_LEAF, dtype=torch.float32, device=dev)
    for layout in ("partitionable", "original"):
        for mode, n in [(m, K) for m in ("bits", "sortkey", "uniform", "gumbel", "normal")] + [("normal", GEMMA_LEAF)]:
            if layout == "partitionable" and n == K and mode != "normal":
                continue  # timed above
            out = (out_b if mode in ("bits", "sortkey") else out_u if n == K else leaf)
            total = n if layout == "original" else 0
            ms = graph_call_ms(lambda: kn.threefry(key, path, 0, n, mode, out=out, total=total))
            plain = eager_call_ms(lambda: ref.threefry_ref(key, path, 0, n, mode, total=total), reps=1)
            b = (_threefry_bound(mode, n, 8 + 4 * n, bw, folds=len(path)) if layout == "partitionable" else
                 _threefry_bound_original(mode, n, (n + 1) // 2, 8 + 4 * n, bw, folds=len(path)))
            log("jax-stream-kernel-time", mode=mode, layout=layout, n=n, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
                bound_ms=f"{b[0]:.6f}", bound_by=b[1], of_bound=f"{b[0] / ms:.3f}", card=repr(card))
    del leaf
    return rows


# the entries and [minval, maxval) threefry_kernel_rows holds to plain at odd sizes
THREEFRY_MODES_CHECKED = (("bits", 0.0, 1.0), ("sortkey", 0.0, 1.0), ("uniform", 0.0, 1.0), ("uniform", 1e-7, 1.0),
                          ("gumbel", 0.0, 1.0), ("normal", 0.0, 1.0), ("keys", 0.0, 1.0))
GEMMA_LEAF = 2048 * 16384  # gemma-2b's d_model x d_ff: normal's largest draw at init
BLOCKED_TOTAL = 2**32 + 5  # an original-layout draw past 2**32 - 1 words: JAX's blocks under split keys
BLOCKED_CHUNK = 2**28  # words a launch of the blocked draw's check


def _held_threefry(what, got, want, mode="bits"):
    """|kernel - plain| of a threefry entry: Gumbel within JAX_NOISE_ATOL,
    normal within NORMAL_KERNEL_ATOL, the others equal; returns it."""
    import torch

    atol = {"gumbel": JAX_NOISE_ATOL, "normal": NORMAL_KERNEL_ATOL}.get(mode)
    if torch.equal(got, want):
        return 0.0
    e = float((got.float() - want.float()).abs().max()) if got.shape == want.shape else float("inf")
    if atol is None or not e <= atol:
        raise AssertionError(f"{what}: kernel and plain version differ (max |d| = {e})")
    return e


def threefry_blocked_draw(dev, key, path, total=BLOCKED_TOTAL, chunk=BLOCKED_CHUNK):
    """An original-layout draw of ``total`` bits words on the card (more than
    2**32 - 1: JAX's blocks under split keys) in launches of ``chunk`` words,
    each launch's words around its ends held to plain, and the words around
    the draw's structure: the padded last pair of its full block (word 2**31
    - 1), the block boundary (word 2**32 - 1) and the rem block.  Returns a
    summary for the log line."""
    import torch

    from repro_torch import kernels as kn
    from repro_torch.kernels import ref

    out = torch.empty(chunk, dtype=torch.int32, device=dev)
    edges = [2**31 - 1, 2**32 - 1, total - 6]
    held = 0
    for lo in range(0, total, chunk):
        n = min(chunk, total - lo)
        kn.threefry(key, path, lo, n, "bits", out=out[:n], total=total)
        marks = [lo, lo + n] + [e for e in edges if lo <= e < lo + n]
        for mark in marks:
            a, b = max(lo, mark - 6), min(lo + n, mark + 6)
            if b > a:
                _held_threefry(f"blocked draw of {total}: words {a} .. {b}", out[a - lo:b - lo],
                               ref.threefry_ref(key, path, a, b - a, "bits", total=total))
                held += b - a
    return f"{total}words/{-(-total // chunk)}launches/{held}held"


def jax_stream_path(dev, card, golden=GOLDEN_TORCH, rate_T=JAX_STREAM_RATE_T):
    """Phase 16, ``[jax-stream]``: the JAX package's key stream on the card
    (``repro_torch.core.prng``), held against the fixtures of
    ``scripts/make_jax_stream_fixture.py``; the process group is up.
    Returns the launch counts of the twin horizons (the counts set to 0 just
    before them).

    * ``[jax-stream-kernel]`` (``threefry_kernel_rows``): the threefry
      kernel against its plain version on the same 10^6 counters under a
      key folded twice: bits, sort keys,
      uniforms (also on ``[1e-7, 1)``) and key pairs equal, Gumbel within
      ``JAX_NOISE_ATOL``, normal within ``NORMAL_KERNEL_ATOL``; both layouts
      at sizes 1, 3, 255 and 10^6 + 1, at offsets (one whose group of
      counters wraps its low word) and in blocks of an original draw (its
      tail, one across its halves); a key advanced in place three times;
      an original ``bits`` draw of ``BLOCKED_TOTAL`` words (JAX's blocks
      under split keys) in launches of ``BLOCKED_CHUNK``, the words around
      each launch's ends, the padded pair, the block boundary and the rem
      block held to plain (``threefry_blocked_draw``).
    * ``[jax-stream-kernel-time]``: times of the epilogues the horizons
      launch (a key's in-place advance, uniform and Gumbel rows of 10^6:
      the kernels line's rows) and of bits and sort keys at 10^6, then of
      both draw kernels in both layouts at 10^6 and at a gemma-2b MLP leaf
      (``normal``), each with the plain version's, the bound
      (``THREEFRY_OPS`` over ``THREEFRY_LANES``) and its share, and
      ``torch.rand`` at 10^6 (a different stream, not the same function: a
      scale only).
    * ``[jax-stream-horizon]``: the fused E3CS horizon at the fixture's K =
      10^6, k = 1000, captured, sync and S = 2, run from ``PRNGKey(0)``:
      cohorts equal to JAX's (or differing only within ``JAX_NOISE_ATOL`` of
      the k-th score, after which rounds are not compared), round 0's first
      Gumbel values within the atol and the key carried out equal; then
      ``rate_T`` rounds of the twin horizon and of the Philox one, each a
      runner's second call, for rounds/s.
    * ``[jax-stream-resume]``: the committed JAX stems (slot and sharded
      engines, sync and S = 2) restored through ``load_server`` and served
      over the transport for the ticks the fixture recorded: cohorts,
      rounds and on-time counts equal to the uninterrupted JAX server's.
    """
    import shutil
    import tempfile

    import torch

    from repro_torch import kernels as kn
    from repro_torch.configs import FLConfig
    from repro_torch.core import prng
    from repro_torch.core.volatility import CompletionLag, make_volatility, paper_success_rates
    from repro_torch.engine import RoundProgram
    from repro_torch.serve import SelectionServer, ServeClient, load_server

    on_card = dev.type == "cuda"
    fix = np.load(os.path.join(golden, "jax_stream.npz"))
    cfg = json.loads(str(fix["config"]))
    K, k, T = cfg["K"], cfg["k"], cfg["T"]
    counts = {}
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    # -- the twin horizon against JAX's ---------------------------------------
    rho = paper_success_rates(K)

    def program(S, rounds):
        vol = make_volatility("bernoulli", rho, device=dev)
        if S is not None:
            vol = CompletionLag(vol, max_lag=S)
        fl = FLConfig(K=K, k=k, rounds=rounds, scheme="e3cs", quota_frac=cfg["quota_frac"], allocator="bisect")
        return RoundProgram(fl=fl, vol=vol, rho=rho, staleness=S, alpha=cfg["alpha"], fused=True, device=dev)

    g0 = prng.gumbel(prng.split(prng.PRNGKey(cfg["seed"], dev), 3)[1], (K,))[: cfg["gumbel_head"]].cpu().numpy()
    g_err = float(np.abs(g0 - fix["gumbel_head"]).max())
    if not g_err <= JAX_NOISE_ATOL:
        raise AssertionError(f"round 0's Gumbel row differs from JAX's by {g_err}")
    for S in (None, 2):
        tag = "sync" if S is None else f"S{S}"
        pm = program(S, T)
        run, s0 = pm.build_runner(outputs="full", carry_key=True)
        extra = () if S is None else (pm.init_rings(),)
        kn.reset_launch_counts()
        out = run(s0, prng.PRNGKey(cfg["seed"], dev), *extra)
        sync()
        got_counts = {n: c for n, c in kn.launch_counts().items() if c}
        idle = [m for m in ("keys", "uniform", "gumbel") if not got_counts.get(f"threefry.{m}")]
        if on_card and idle:
            raise AssertionError(f"twin horizon {tag}: no threefry launch of {idle} ({got_counts})")
        for n, c in got_counts.items():
            counts[n] = counts.get(n, 0) + c
        key_out = out[1]
        masks, ps = (out[2], out[4]) if S is None else (out[3], out[5])
        masks, ps = masks.cpu().numpy(), ps.cpu().numpy()
        kk, equal = prng.PRNGKey(cfg["seed"], dev), 0
        for t in range(T):
            kk, k1, _ = prng.split(kk, 3)
            kk = prng.Key(prng.key_data(kk).clone())
            cohort = np.nonzero(masks[t] > 0)[0]
            scores = np.log(np.maximum(ps[t], 1e-30)) + prng.gumbel(k1, (K,)).cpu().numpy()
            if not _cohort_check(f"twin horizon {tag}", t, cohort, fix[f"{tag}/cohorts"][t], scores,
                                 fix[f"{tag}/bounds"][t, 0]):
                break
            equal += 1
        if not np.array_equal(key_out.data.cpu().numpy(), fix[f"{tag}/key"].view(np.int32)):
            raise AssertionError(f"twin horizon {tag}: the key after {T} rounds differs from JAX's")
        gaps = fix[f"{tag}/bounds"][:, 0] - fix[f"{tag}/bounds"][:, 1]
        # rounds/s: the twin and the Philox horizon, each a runner's second call
        rates = {}
        for stream in ("jax", "philox"):
            pr = program(S, rate_T)
            r, st0 = pr.build_runner(outputs="lean")
            kf = (lambda: prng.PRNGKey(cfg["seed"], dev)) if stream == "jax" else (lambda: cfg["seed"])
            r(st0, kf())
            sync()
            t0 = time.perf_counter()
            r(st0, kf())
            sync()
            rates[stream] = rate_T / (time.perf_counter() - t0)
            del r, st0, pr
        log("jax-stream-horizon", run=tag, K=K, k=k, T=T, captured=run.horizon.captured,
            cohorts_equal_rounds=f"{equal}/{T}", key_equal=True, gumbel_head_max_abs_err=g_err,
            jax_kth_gap_min=f"{float(gaps.min()):.3e}", launches=json.dumps(got_counts),
            twin_rounds_per_s=f"{rates['jax']:.3f}", philox_rounds_per_s=f"{rates['philox']:.3f}",
            rate_T=rate_T, card=repr(card))
        del run, s0, out, pm
        if on_card:
            torch.cuda.empty_cache()

    # -- the JAX stems restored and served ------------------------------------
    for kind in ("slots", "sharded"):
        for S in (0, 2):
            d = os.path.join(golden, "stems", f"{kind}_S{S}")
            with open(os.path.join(d, "served.json")) as f:
                want = json.load(f)
            stems = sorted(n[:-len(".json")] for n in os.listdir(d) if n.startswith("ckpt_") and n.endswith(".json"))
            tmp = tempfile.mkdtemp(prefix="jax_stems_", dir=CHIPRUN_OUT if os.path.isdir(CHIPRUN_OUT) else None)
            t0 = time.perf_counter()
            eng, step = load_server(os.path.join(d, stems[-1]), device=dev)
            load_s = time.perf_counter() - t0
            if step != want["ticks_before"] or eng.stream != "jax":
                raise AssertionError(f"{kind} S={S}: restored step {step}, stream {eng.stream}")
            srv = SelectionServer(eng, ckpt_dir=tmp)
            srv.start()
            try:
                with ServeClient.connect(srv.address, timeout=600.0) as c:
                    for i, served in enumerate(want["served"]):
                        t = want["ticks_before"] + i
                        for j, uid in enumerate(want["uids"]):
                            out = c.tick(uid, round=t, lags=jax_stream_feedback(j, t, want["jobs"][j]["K"], S))
                            w = served[str(uid)]
                            if out["round"] != w["round"] or out["cohort"] != w["cohort"] or \
                                    out["on_time"] != w["on_time"]:
                                raise AssertionError(f"{kind} S={S} job {uid} round {t}: the port served another "
                                                     f"cohort than the JAX server")
            finally:
                srv.close(checkpoint=False)
                shutil.rmtree(tmp, ignore_errors=True)
            log("jax-stream-resume", engine=kind, S=S, K=want["jobs"][0]["K"], jobs=len(want["uids"]),
                ticks=len(want["served"]), cohorts="equal to the JAX server's", load_s=f"{load_s:.3f}",
                card=repr(card))
            del eng, srv
            if on_card:
                torch.cuda.empty_cache()

    return counts


def _positions(n):
    """``scripts/make_jax_stream_fixture.py``'s ``positions``: the flat
    positions of a leaf of ``n`` elements a check reads."""
    if n <= DRIVER_SAMPLE:
        return np.arange(n, dtype=np.int64)
    return (np.arange(DRIVER_SAMPLE, dtype=np.int64) * 2654435761 + 12345) % n


def _threefry_bound(mode, n, nbytes, bw, folds=0):
    """The least time of ``n`` hashes and their ``mode`` epilogue and
    ``folds`` hashes of a key, and of ``nbytes`` through memory: the larger
    of the two, each pipe's operations over its lanes (``THREEFRY_OPS``,
    ``THREEFRY_LANES``)."""
    clocks = max((n * THREEFRY_OPS[mode].get(p, 0) + folds * THREEFRY_OPS["keys"].get(p, 0)) / lanes
                 for p, lanes in THREEFRY_LANES.items())
    t_ops, t_bytes = clocks / H100_SM_CLOCKS * 1e3, nbytes / bw * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def jax_stream_drivers_path(dev, card, bw, golden=GOLDEN_TORCH, gemma=True):
    """Phase 16, ``[jax-stream-drivers]``: the int-seed drivers on the JAX
    package's keys at full size, held against ``jax_drivers.npz``
    (``scripts/make_jax_stream_fixture.py drivers``); the process group is
    up.  Returns ``(counts, rows)``: the drivers' launch counts (set to 0
    just before each driver call and read just after it, so no check's
    launches are in them) and the kernels line's rows of
    ``threefry.normal``, ``threefry.rows`` and ``threefry.categorical``.

    * ``[jax-drivers-fl]``: ``FLServer`` at Table I (EMNIST, K = 100, k =
      20, E3CS) from ``init_state(PRNGKey(0))`` for the fixture's rounds:
      initial parameters within ``DRIVER_PARAM_ULPS`` of JAX's at
      ``DRIVER_SAMPLE`` positions a leaf, every cohort and its success bits
      equal, the parameters after round 1 within the FL tests' tolerance.
    * ``[jax-drivers-fleet]``: ``run_service_sharded`` at K = 10^6, k = 1000,
      S = 0 and 2 (``block=4``, fused) on the one-rank mesh: the report's
      tap counters equal JAX's; then, as a check outside the counts, the
      same program's full-output runner from ``PRNGKey(0)`` gives JAX's
      cohorts (``_cohort_check``; the driver's lean runner returns none).
    * ``[jax-drivers-compiled]``: ``run_service_compiled`` (J = 8, K_max =
      100,000): on-time and stale totals equal JAX's.
    * ``[jax-drivers-replay]``: ``run_replay("e3cs", "markov")`` at K = 10^6,
      T = 5: the packed trace's sha256 equal, then its cohorts.
    * ``[jax-drivers-gemma]`` (``gemma``): gemma-2b uncut through
      ``launch.serve.main --seed 0 --temperature 1`` (prefill ms: the
      process's first gemma-2b prefill, cold; decode tokens/s; peak memory;
      beside PR 22's figures, which ``[zoo-serve]`` took warm); the same ``model.init(PRNGKey(0))`` on the
      ``normal`` kernel equal to JAX's bfloat16 values at sampled positions
      of ``tok_emb`` and a stacked ``wq`` (within one bfloat16 ulp);
      ``categorical`` on a decode step's own ``(4, 256000)`` logits equal to
      its plain version.
    * ``[jax-drivers-kernel]``: the three new entries of the threefry kernel
      against their plain versions and timed at their paths' shapes:
      ``normal`` at a gemma MLP leaf, ``rows`` at the compiled service's
      ``(8, 100000)`` Gumbel rows, ``categorical`` at ``(4, 256000)`` in
      bfloat16 (and float32, checked only).
    """
    import hashlib

    import torch

    from repro_torch import kernels as kn
    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core import prng
    from repro_torch.engine import RoundProgram, scan_selection_sim
    from repro_torch.fl import FLServer
    from repro_torch.kernels import ref
    from repro_torch.launch import make_host_mesh, serve
    from repro_torch.launch.select_serve import run_service_compiled, run_service_sharded
    from repro_torch.launch.train import build_task
    from repro_torch.models import build_model
    from repro_torch.scenarios import harness

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    fix = np.load(os.path.join(golden, "jax_drivers.npz"))
    cfg = json.loads(str(fix["config"]))
    t_phase = time.perf_counter()
    counts = {}

    def driven(fn, *a, **kw):
        """``fn(*a, **kw)`` with the launch counts set to 0 just before it
        and added to ``counts`` just after it: the drivers' launches, not
        the checks' around them."""
        kn.reset_launch_counts()
        out = fn(*a, **kw)
        sync()
        for n, c in kn.launch_counts().items():
            if c:
                counts[n] = counts.get(n, 0) + c
        return out

    # -- FL at Table I -----------------------------------------------------------------
    fl = FLConfig(rounds=cfg["fl_rounds"])
    model, store, _ = build_task("emnist", fl, device=dev)
    srv = FLServer(model, fl, store, device=dev)
    cohorts, success, after = [], [], []
    round_fn = srv._round

    def recording_round(state, idx, *args):
        x_full, _ = srv.vol.sample(args[-1], state.vol_state)
        cohorts.append(idx.cpu().numpy())
        success.append((x_full[idx] > 0).cpu().numpy())
        res = round_fn(state, idx, *args)
        if not after:
            after.append({n: v.detach().clone() for n, v in res[0].params.items()})
        return res

    def fl_driver():
        st0 = srv.init_state(prng.PRNGKey(0, dev))
        init = {n: v.detach().clone() for n, v in st0.params.items()}
        return init, srv.run(st0)[0]

    srv._round = recording_round
    t0 = time.perf_counter()
    init, st = driven(fl_driver)
    fl_s = time.perf_counter() - t0
    ulps = 0
    for n, v in init.items():
        got = v.reshape(-1)[torch.as_tensor(_positions(v.numel()), device=dev)].cpu().numpy()
        d = np.abs(got.view(np.int32).astype(np.int64) - fix[f"fl/init/{n}"].view(np.int32)).max()
        if not d <= DRIVER_PARAM_ULPS:
            raise AssertionError(f"FL init {n}: {d} ulps from JAX's > {DRIVER_PARAM_ULPS}")
        ulps = max(ulps, int(d))
    if not (np.array_equal(np.stack(cohorts), fix["fl/cohorts"])
            and np.array_equal(np.stack(success), fix["fl/success"]) and float(st.cep) == float(fix["fl/cep"])):
        raise AssertionError(f"FL at Table I: cohorts or success bits differ from JAX's ({np.stack(cohorts)[0]} vs "
                             f"{fix['fl/cohorts'][0]})")
    p_err = 0.0
    for n, v in after[0].items():
        got = v.reshape(-1)[torch.as_tensor(_positions(v.numel()), device=dev)].cpu().numpy()
        np.testing.assert_allclose(got, fix[f"fl/round1/{n}"], rtol=FL_PARAM_RTOL, atol=FL_PARAM_ATOL, err_msg=n)
        p_err = max(p_err, float(np.abs(got - fix[f"fl/round1/{n}"]).max()))
    log("jax-drivers-fl", K=fl.K, k=fl.k, rounds=fl.rounds, cohorts_success_cep="equal", init_max_ulps=ulps,
        round1_params_max_abs_err=f"{p_err:.3g}", seconds=f"{fl_s:.2f}", card=repr(card))
    del srv, model, store, st, init, after
    if on_card:
        torch.cuda.empty_cache()

    # -- the fleet job ------------------------------------------------------------------
    fc = cfg["fleet"]
    mesh = make_host_mesh(1, device=dev)
    for S in (0, 2):
        rep = driven(run_service_sharded, K=fc["K"], rounds=fc["rounds"], D=1, k=fc["k"], block=fc["block"], reps=1,
                     staleness=S, fused=True, device=dev)
        flc = FLConfig(K=fc["K"], k=fc["k"], rounds=fc["rounds"], scheme="e3cs", quota_frac=0.5, allocator="bisect",
                       volatility="bernoulli", staleness_rounds=S, staleness_alpha=0.5)
        pm = RoundProgram.from_config(flc, mesh=mesh, block=fc["block"], fused=True)
        run, s0 = pm.build_runner(outputs="full")
        _, masks, _, ps, *_ = run(s0, prng.PRNGKey(0, dev))
        masks, ps = masks[:, :fc["K"]].cpu().numpy(), ps[:, :fc["K"]].cpu().numpy()
        kk, equal = prng.PRNGKey(0, dev), 0
        for t in range(fc["rounds"]):
            kk, k1, _ = prng.split(kk, 3)
            kk = prng.Key(prng.key_data(kk).clone())
            scores = np.log(np.maximum(ps[t], 1e-30)) + prng.gumbel(k1, (fc["K"],)).cpu().numpy()
            if not _cohort_check(f"fleet S={S}", t, np.nonzero(masks[t] > 0)[0], fix[f"fleet/S{S}/cohorts"][t], scores,
                                 fix[f"fleet/S{S}/bounds"][t, 0]):
                break
            equal += 1
        want = json.loads(str(fix[f"fleet/S{S}/tap_counters"]))
        got = {n: float(v) for n, v in rep["tap_counters"].items()}
        if equal == fc["rounds"] and got != want:
            raise AssertionError(f"fleet S={S}: tap counters {got} vs JAX's {want}")
        log("jax-drivers-fleet", S=S, K=fc["K"], k=fc["k"], rounds=fc["rounds"],
            cohorts_equal_rounds=f"{equal}/{fc['rounds']}", tap_counters="equal" if got == want else "differ",
            rounds_per_s=rep["rounds_per_s"], card=repr(card))
        del run, s0, pm

    # -- run_service_compiled ---------------------------------------------------------------
    cc = cfg["compiled"]
    for S in (0, 2):
        rep = driven(run_service_compiled, J=cc["J"], K_max=cc["K_max"], rounds=cc["rounds"], seed=0, staleness=S,
                     reps=1, device=dev)
        got = [rep["on_time_total"], rep["stale_credit_total"]]
        if got != fix[f"compiled/S{S}"].tolist():
            raise AssertionError(f"run_service_compiled S={S}: on-time and stale totals {got} vs JAX's "
                                 f"{fix[f'compiled/S{S}'].tolist()}")
        log("jax-drivers-compiled", S=S, J=cc["J"], K_max=cc["K_max"], ticks=cc["rounds"], on_time_stale=got,
            ticks_per_s=rep["ticks_per_s"], card=repr(card))

    # -- the replay cell ---------------------------------------------------------------------
    rc = cfg["replay"]
    _, packed = driven(harness.run_replay, "e3cs", rc["scenario"], K=rc["K"], k=rc["k"], T=rc["T"], seed=0,
                       frac=rc["frac"], device=dev)
    sha = hashlib.sha256(np.ascontiguousarray(packed).tobytes()).hexdigest()
    if sha != str(fix["replay/sha256"]):
        raise AssertionError(f"replay cell: the packed trace's sha256 {sha} is not JAX's")
    _, rho = harness.make_scenario(rc["scenario"], rc["K"], rc["T"], 0, device=dev)
    out = scan_selection_sim("e3cs", K=rc["K"], k=rc["k"], T=rc["T"], frac=rc["frac"], seed=0, rho=rho,
                             packed_override=packed, device=dev)
    kk, equal = prng.PRNGKey(0, dev), 0
    for t in range(rc["T"]):
        kk, k1, _ = prng.split(kk, 3)
        kk = prng.Key(prng.key_data(kk).clone())
        scores = np.log(np.maximum(out["ps"][t], 1e-30)) + prng.gumbel(k1, (rc["K"],)).cpu().numpy()
        if not _cohort_check("replay cell", t, np.nonzero(out["masks"][t] > 0)[0], fix["replay/cohorts"][t], scores,
                             fix["replay/bounds"][t, 0]):
            break
        equal += 1
    log("jax-drivers-replay", scenario=rc["scenario"], K=rc["K"], k=rc["k"], T=rc["T"], sha256="equal",
        cohorts_equal_rounds=f"{equal}/{rc['T']}", card=repr(card))

    # -- the three new kernel entries at their paths' shapes ---------------------------------------
    rows = {}

    gcfg = get_config("gemma-2b")
    if on_card:  # the kernel entries against their plain versions, timed (CUDA graphs)
        key = prng.PRNGKey(12345, dev).data
        path = (3, 2**33 + 7)
        n_normal = gcfg.d_model * gcfg.d_ff
        got = kn.threefry(key, path, 0, n_normal, "normal", ref.NORMAL_LO, 1.0)
        want = ref.threefry_ref(key, path, 0, n_normal, "normal", ref.NORMAL_LO, 1.0)
        err_n = float((got - want).abs().max())
        if not err_n <= NORMAL_KERNEL_ATOL:
            raise AssertionError(f"threefry normal: max |kernel - plain| = {err_n} > {NORMAL_KERNEL_ATOL}")
        del want
        keys = prng.split_data(prng.PRNGKey(0, dev), cc["J"]).data
        err_r = float((kn.threefry_rows(keys, (3,), cc["K_max"]) - ref.threefry_rows_ref(keys, (3,), cc["K_max"]))
                      .abs().max())
        if not err_r <= NORMAL_KERNEL_ATOL:
            raise AssertionError(f"threefry rows: max |kernel - plain| = {err_r} > {NORMAL_KERNEL_ATOL}")
        out_n = torch.empty(n_normal, dtype=torch.float32, device=dev)
        out_r = torch.empty((cc["J"], cc["K_max"]), dtype=torch.float32, device=dev)
        ms = graph_call_ms(lambda: kn.threefry(key, path, 0, n_normal, "normal", ref.NORMAL_LO, 1.0, out=out_n))
        b = _threefry_bound("normal", n_normal, 8 + 4 * n_normal, bw, folds=len(path))
        rows["threefry.normal"] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/threefry.cu",
            replaces="src/repro/models/layers.py:53 (jax.random.normal: XLA's threefry and erf_inv, no Pallas kernel)",
            max_abs_err=err_n, ms=ms, plain_ms=eager_call_ms(lambda: ref.threefry_ref(key, path, 0, n_normal, "normal",
                                                                              ref.NORMAL_LO, 1.0), reps=1),
            bound_ms=b[0], bound_by=b[1], library_ms=None)
        ms = graph_call_ms(lambda: kn.threefry_rows(keys, (3,), cc["K_max"], out=out_r))
        b = _threefry_bound("gumbel", cc["J"] * cc["K_max"], 8 * cc["J"] + 4 * out_r.numel(), bw, folds=cc["J"])
        rows["threefry.rows"] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/threefry.cu",
            replaces="src/repro/engine/multi_job.py:186 (jax.random.gumbel under a job's key, vmapped: no Pallas kernel)",
            max_abs_err=err_r, ms=ms, plain_ms=eager_call_ms(lambda: ref.threefry_rows_ref(keys, (3,), cc["K_max"])),
            bound_ms=b[0], bound_by=b[1], library_ms=None)
        log("jax-drivers-kernel", entry="normal", n=n_normal, max_abs_err=err_n, atol=NORMAL_KERNEL_ATOL,
            ms=f"{rows['threefry.normal']['ms']:.4f}", plain_ms=f"{rows['threefry.normal']['plain_ms']:.4f}",
            bound_ms=f"{rows['threefry.normal']['bound_ms']:.6f}", bound_by=rows["threefry.normal"]["bound_by"],
            card=repr(card))
        log("jax-drivers-kernel", entry="rows", shape=f"{cc['J']}x{cc['K_max']}", gumbel_max_abs_err=err_r,
            atol=NORMAL_KERNEL_ATOL, ms=f"{rows['threefry.rows']['ms']:.4f}",
            plain_ms=f"{rows['threefry.rows']['plain_ms']:.4f}",
            bound_ms=f"{rows['threefry.rows']['bound_ms']:.6f}", bound_by=rows["threefry.rows"]["bound_by"],
            card=repr(card))
        del got, out_n, out_r

    # -- gemma-2b uncut ---------------------------------------------------------------------------
    if gemma:
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        r = driven(serve.main, ["--arch", "gemma-2b", "--seed", "0", "--temperature", "1"]
                   + ([] if on_card else ["--device", "cpu"]))
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
        gm = build_model(gcfg)
        rng = prng.PRNGKey(0, dev)
        params, _ = gm.init(rng)
        gl = cfg["gemma"]["layer"]
        checks = (("tok_emb", params["tok_emb"], "gemma/tok_emb"),
                  ("seg0/attn/wq", params["seg0"]["attn"]["wq"][gl], "gemma/wq"))
        worst = {}
        for name, leaf, fkey in checks:
            flat = leaf.reshape(-1)
            got = flat[torch.as_tensor(_positions(flat.numel()), device=dev)].view(torch.int16).cpu().numpy()
            d = np.abs(got.astype(np.int64) - fix[fkey].astype(np.int64))
            if not d.max() <= 1:
                raise AssertionError(f"gemma-2b {name}: {int(d.max())} bfloat16 ulps from JAX's")
            worst[name] = f"{int(d.max())}ulp/{float((d == 0).mean()):.4f}equal"
        if tuple(params["seg0"]["attn"]["wq"].shape[1:]) != tuple(fix["gemma/wq_shape"]):
            raise AssertionError("gemma-2b wq: another shape than JAX's")
        batch = serve.make_batch(gcfg, 4, 64, rng)
        with torch.no_grad():
            logits, caches = gm.prefill(params, batch, max_len=66)
            tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
            logits_i, _ = gm.decode(params, tok, caches)
            scaled = (logits_i[:, -1] / 1.0).contiguous()
        del caches, logits
        ckey = prng.key_data(prng.fold_in(prng.fold_in(rng, 7), 0))
        got_c, want_c = kn.threefry_categorical(ckey, (), scaled), ref.categorical_ref(ckey, (), scaled)
        if not torch.equal(got_c, want_c):
            raise AssertionError(f"categorical on gemma's decode logits: kernel {got_c.tolist()} vs plain "
                                 f"{want_c.tolist()}")
        f32 = torch.randn(scaled.shape, device=dev) * 3
        if not torch.equal(kn.threefry_categorical(ckey, (5,), f32), ref.categorical_ref(ckey, (5,), f32)):
            raise AssertionError("categorical on float32 logits: kernel and plain version differ")
        ms = graph_call_ms(lambda: kn.threefry_categorical(ckey, (), scaled))
        b = _threefry_bound("categorical_bf16", scaled.numel(), scaled.numel() * 2 + 8 + 4 * scaled.shape[0], bw)
        rows["threefry.categorical"] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/threefry.cu",
            replaces="src/repro/launch/serve.py:67 (jax.random.categorical: XLA's threefry and argmax, no Pallas kernel)",
            max_abs_err=0.0, ms=ms, plain_ms=eager_call_ms(lambda: ref.categorical_ref(ckey, (), scaled)),
            bound_ms=b[0], bound_by=b[1], library_ms=None)
        log("jax-drivers-gemma", arch="gemma-2b", prefill_ms=f"{r['prefill_s'] * 1e3:.3f}",
            decode_tok_per_s=r["decode_tok_per_s"], peak_gib=f"{peak:.3f}", init_vs_jax=json.dumps(worst),
            categorical=f"{tuple(scaled.shape)} {scaled.dtype} equal to plain", pr22_decode_tok_per_s="130.45-135.25",
            pr22_prefill_ms="47.230-73.409", card=repr(card))
        log("jax-drivers-kernel", entry="categorical", shape=f"{tuple(scaled.shape)}", dtype=str(scaled.dtype),
            ms=f"{ms:.4f}", plain_ms=f"{rows['threefry.categorical']['plain_ms']:.4f}", bound_ms=f"{b[0]:.6f}",
            bound_by=b[1], card=repr(card))
        del params, gm, scaled, logits_i, f32
        if on_card:
            torch.cuda.empty_cache()
    log("jax-drivers", seconds=f"{time.perf_counter() - t_phase:.1f}", launches=json.dumps(counts), card=repr(card))
    return counts, rows


def _threefry_bound_original(mode, values, hashes, nbytes, bw, folds=0):
    """``_threefry_bound`` in the original layout: ``hashes`` hashes (one
    gives two words), ``values`` epilogues without the partitionable
    ``a ^ b`` (none for ``"keys"``), ``folds`` hashes of a key."""
    hash_ops = THREEFRY_OPS["keys"]

    def epilogue(p):
        return 0 if mode == "keys" else THREEFRY_OPS[mode].get(p, 0) - hash_ops.get(p, 0) - THREEFRY_XOR.get(p, 0)

    clocks = max(((hashes + folds) * hash_ops.get(p, 0) + values * epilogue(p)) / lanes
                 for p, lanes in THREEFRY_LANES.items())
    t_ops, t_bytes = clocks / H100_SM_CLOCKS * 1e3, nbytes / bw * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


ORIGINAL_MODES = (("bits", 0.0, 1.0), ("sortkey", 0.0, 1.0), ("uniform", 0.0, 1.0), ("uniform", 1e-7, 1.0),
                  ("gumbel", 0.0, 1.0), ("normal", 0.0, 1.0), ("keys", 0.0, 1.0))
ORIGINAL_COMPILED = dict(J=8, K_max=100_000, rounds=5, seed=0, staleness=2, reps=1)
ORIGINAL_GEMMA = ["--arch", "gemma-2b", "--seed", "0", "--temperature", "1", "--gen", "8"]


def jax_stream_original_path(dev, card, bw, K=K_MAIN, gemma=True):
    """Phase 16, ``[jax-stream-original]``: JAX's original threefry mode
    (``jax_threefry_partitionable=False``) on the card, every draw under
    ``prng.threefry_partitionable(False)``.  Returns ``(counts, rows)``: the
    launch counts of the path (set to 0 just before it and read just after
    it) and the kernels line's rows of the eight ``threefry.original.*``
    entries.

    * ``[jax-stream-original]``: the path.  The repo's goldens
      (``tests/golden/round_program_goldens.npz``, written by the JAX package
      in that mode): every D = 1 cell of ``tests/golden/gen_goldens.py``,
      sync and async, through the port's captured runners
      (``tests/torch_goldens_ranks.port_cell``), all 43 arrays bit for bit;
      ``run_service_compiled`` (``ORIGINAL_COMPILED``: the rows entry) with
      its on-time and stale totals equal to the same call's on the CPU
      (the plain versions); gemma-2b uncut through ``launch.serve.main``
      (``normal`` at init, ``bits`` for the prompt, ``categorical`` a decode
      step), its tokens in the vocabulary.
    * ``[jax-stream-original-kernel]``: each entry's original layout against
      its plain version at ``K`` and ``K + 1`` values (an odd draw pads its
      last pair), whole and in blocks (one across the draw's halves, its
      last value): equal, Gumbel within ``JAX_NOISE_ATOL`` and normal within
      ``NORMAL_KERNEL_ATOL``; a carried key's round (``JaxStream``: the
      round's ``split(key, num)`` and the key's advance to its first key),
      num = 2 to 4; ``split_data``; the rows entry at (8, 100000) and (8,
      100001); ``categorical`` over float32 and bfloat16 logits at (4,
      256000) and (3, 100001), equal; a gemma-2b MLP leaf's ``normal``
      (``d_model * d_ff`` values), whole and in three blocks of its one
      draw, within ``NORMAL_KERNEL_ATOL``.
    * ``[jax-stream-original-time]``: each entry timed (CUDA graphs) at the
      path's shapes (a round's split of 3 keys, rows of ``K``, the service's
      (8, 100000) rows, gemma-2b's (4, 256000) bfloat16 decode logits)
      against ``_threefry_bound_original``.
    """
    import tempfile

    import torch

    from repro_torch import kernels as kn
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core import prng
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.engine.round_program import JaxStream
    from repro_torch.launch.select_serve import run_service_compiled

    sys.path.insert(0, TESTS_DIR)
    import torch_goldens_ranks as golden_cells

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    goldens = np.load(GOLDENS_NPZ)

    # -- the path, in the original mode ------------------------------------------------
    got, served = {}, None
    kn.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp, prng.threefry_partitionable(False):
        for cell, _ in golden_cells.CELLS:
            if cell != "d8":  # D = 8 is eight ranks: tests/test_torch_goldens.py
                got.update(golden_cells.port_cell(cell, tmp, device=dev))
        compiled = run_service_compiled(**ORIGINAL_COMPILED, device=dev)
        if gemma:
            served = serve.main(ORIGINAL_GEMMA + ([] if on_card else ["--device", "cpu", "--smoke"]))
    sync()
    counts = {n: c for n, c in kn.launch_counts().items() if c}
    path_s = time.perf_counter() - t_phase
    differ = [n for n, v in got.items() if not (v.shape == goldens[n].shape and np.array_equal(v, goldens[n]))]
    if differ or len(got) != 43:
        raise AssertionError(f"jax-stream-original: {len(differ)} of {len(got)} golden arrays differ: {differ}")
    with prng.threefry_partitionable(False):
        plain = run_service_compiled(**ORIGINAL_COMPILED, device="cpu")
    totals = [compiled["on_time_total"], compiled["stale_credit_total"]]
    if totals != [plain["on_time_total"], plain["stale_credit_total"]]:
        raise AssertionError(f"run_service_compiled, original mode: totals {totals} on {dev}, "
                             f"{[plain['on_time_total'], plain['stale_credit_total']]} on the CPU")
    if served is not None:
        gcfg = get_config("gemma-2b")
        vocab = (smoke_variant(gcfg) if not on_card else gcfg).vocab
        toks = np.asarray(served["sample_tokens"])
        if served["generated_shape"] != [4, 9] or toks.min() < 0 or toks.max() >= vocab:
            raise AssertionError(f"gemma-2b, original mode: generated {served}")
    log("jax-stream-original", goldens=f"{len(got) - len(differ)}/{len(got)} equal", cells=len(golden_cells.CELLS) - 1,
        compiled_on_time_stale=totals, compiled_vs_cpu="equal",
        gemma_tokens=None if served is None else served["sample_tokens"][:6],
        decode_tok_per_s=None if served is None else served["decode_tok_per_s"], seconds=f"{path_s:.1f}",
        launches=json.dumps(counts), card=repr(card))

    # -- each entry's original layout against its plain version ------------------------
    key = prng.PRNGKey(12345, dev).data
    path, errs = (3, 2**33 + 7), {}

    def held(what, got_, want, atol=0.0):
        e = float((got_.float() - want.float()).abs().max()) if got_.numel() else 0.0
        if not (e <= atol if atol else torch.equal(got_, want)):
            raise AssertionError(f"original layout, {what}: kernel and plain version differ (max |d| = {e})")
        errs[what.split()[0]] = max(errs.get(what.split()[0], 0.0), e)

    for n in (K, K + 1):
        for mode, lo, hi in ORIGINAL_MODES:
            atol = JAX_NOISE_ATOL if mode == "gumbel" else NORMAL_KERNEL_ATOL if mode == "normal" else 0.0
            for offset, cnt in ((0, n), (n // 4, n // 2), (n - 1, 1)):
                held(f"{mode} [{lo}, {hi}) values {offset}+{cnt} of {n}",
                     kn.threefry(key, path, offset, cnt, mode, lo, hi, total=n),
                     ref.threefry_ref(key, path, offset, cnt, mode, lo, hi, total=n), atol)
    for num in (2, 3, 4):  # a carried key's round: split(key, num), then the key takes the first of them
        stream = JaxStream(prng.Key(key, partitionable=False), dev, num)
        want = ref.threefry_ref(key, (), 0, num, "keys", total=num)
        held(f"keys round split num={num}", torch.stack([k.data for k in stream.round_keys()]), want)
        stream.advance()
        held(f"keys advance num={num}", stream.key, want[0])
    for J in (3, 1000, 1001):
        held(f"keys split_data J={J}", prng.split_data(prng.Key(key, path, partitionable=False), J).data,
             ref.threefry_ref(key, path, 0, J, "keys", total=J))
    keys8 = prng.split_data(prng.PRNGKey(4, dev, partitionable=False), 8).data
    for n in (100_000, 100_001):
        held(f"rows (8, {n})", kn.threefry_rows(keys8, (3,), n, original=True),
             ref.threefry_rows_ref(keys8, (3,), n, original=True), JAX_NOISE_ATOL)
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, V in ((4, 256_000), (3, 100_001)):
        logits = torch.randn((B, V), generator=gen, device=dev) * 3
        for dt in (torch.float32, torch.bfloat16):
            lg = logits.to(dt)
            held(f"categorical {dt} ({B}, {V})", kn.threefry_categorical(key, (5,), lg, original=True),
                 ref.categorical_ref(key, (5,), lg, original=True))
    # a gemma-2b MLP leaf (d_model x d_ff values), whole and in blocks of its one draw (one across its halves)
    gcfg = get_config("gemma-2b")
    gcfg = gcfg if on_card else smoke_variant(gcfg)
    n_leaf = gcfg.d_model * gcfg.d_ff
    leaf_key = prng.fold_in(prng.fold_in(prng.PRNGKey(0, dev, partitionable=False), 2), 5)
    leaf = ref.threefry_ref(leaf_key.data, leaf_key.path, 0, n_leaf, "normal", ref.NORMAL_LO, 1.0, total=n_leaf)
    held(f"normal gemma-2b leaf ({gcfg.d_model}, {gcfg.d_ff})",
         prng.normal(leaf_key, (gcfg.d_model, gcfg.d_ff)).view(-1), leaf, NORMAL_KERNEL_ATOL)
    for lo, hi in ((0, n_leaf // 4), (n_leaf // 4, 3 * n_leaf // 4), (3 * n_leaf // 4, n_leaf)):
        held(f"normal gemma-2b leaf values {lo}..{hi}", prng.normal(leaf_key, (hi - lo,), start=lo, total=n_leaf),
             leaf[lo:hi], NORMAL_KERNEL_ATOL)
    del leaf
    log("jax-stream-original-kernel", K=K, gemma_leaf=n_leaf, entries=",".join(errs), gumbel_max_abs_err=errs["gumbel"],
        normal_max_abs_err=errs["normal"], rows_max_abs_err=errs["rows"], others="equal", card=repr(card))
    if not on_card:
        return counts, {}

    # -- timed at the path's shapes ------------------------------------------------------
    rows = {}
    out_f = torch.empty(K, dtype=torch.float32, device=dev)
    out_b = torch.empty(K, dtype=torch.int32, device=dev)
    out_k = torch.empty((3, 2), dtype=torch.int32, device=dev)
    out_r = torch.empty((8, 100_000), dtype=torch.float32, device=dev)
    gemma_logits = (torch.randn((4, 256_000), generator=gen, device=dev) * 3).to(torch.bfloat16)
    B, V = gemma_logits.shape
    cases = {  # entry: (kernel call, plain call, values, hashes, bytes, folds, shape)
        "keys": (lambda: kn.threefry(key, (), 0, 3, "keys", out=out_k, total=3),
                 lambda: ref.threefry_ref(key, (), 0, 3, "keys", total=3), 3, 3, 8 + 24, 0, "split(key, 3)"),
        **{mode: (lambda mode=mode, out=out: kn.threefry(key, path, 0, K, mode, out=out, total=K),
                  lambda mode=mode: ref.threefry_ref(key, path, 0, K, mode, total=K), K, (K + 1) // 2, 8 + 4 * K,
                  len(path), f"({K},)")
           for mode, out in (("bits", out_b), ("sortkey", out_b), ("uniform", out_f), ("gumbel", out_f),
                             ("normal", out_f))},
        "rows": (lambda: kn.threefry_rows(keys8, (3,), 100_000, out=out_r, original=True),
                 lambda: ref.threefry_rows_ref(keys8, (3,), 100_000, original=True), 8 * 100_000, 8 * 50_000,
                 8 * 8 + 4 * out_r.numel(), 8, "(8, 100000)"),
        "categorical": (lambda: kn.threefry_categorical(key, (), gemma_logits, original=True),
                        lambda: ref.categorical_ref(key, (), gemma_logits, original=True), B * V,
                        (-(-B * V // 4) + 1) // 2, 2 * B * V + 8 + 4 * B, 0, f"({B}, {V}) bfloat16"),
    }
    for entry, (call, plain_call, values, hashes, nbytes, folds, shape) in cases.items():
        ms, plain_ms = graph_call_ms(call), eager_call_ms(plain_call)
        mode = {"rows": "gumbel", "categorical": "categorical_bf16"}.get(entry, entry)
        b = _threefry_bound_original(mode, values, hashes, nbytes, bw, folds)
        rows[f"threefry.original.{entry}"] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/threefry.cu",
            replaces="src/repro/engine/round_program.py:415 (jax.random under jax_threefry_partitionable=False: "
                     "XLA's threefry, no Pallas kernel)",
            max_abs_err=errs[entry], ms=ms, plain_ms=plain_ms, bound_ms=b[0],
            bound_by=b[1], library_ms=None)
        log("jax-stream-original-time", entry=entry, shape=shape, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{b[0]:.6f}", bound_by=b[1], of_bound=f"{b[0] / ms:.3f}", launches=counts.get(
                f"threefry.original.{entry}", 0), card=repr(card))
    missing = [n for n in rows if not counts.get(n)]
    if missing:
        raise AssertionError(f"jax-stream-original: no launch of {missing} on the path")
    log("jax-stream-original-phase", seconds=f"{time.perf_counter() - t_phase:.1f}", card=repr(card))
    return counts, rows


def fl_pow_d_mesh_path(dev, card, rounds=FL_POW_D_ROUNDS, fl_kw=None):
    """``[fl-pow-d-mesh]``: pow-d's FL server on a one-rank NCCL mesh
    (``FLServer(spmd_axes="data", scheme="pow_d")``: each candidate's loss
    one after another; the process group is up) against the unsharded
    server (the candidates' losses vmapped), EMNIST at ``FLConfig``'s
    Table I defaults as ``[fl-train]`` (``fl_kw`` overrides fields for a
    small rehearsal), from the same initial parameters.

    * ``rounds`` rounds under cuDNN's deterministic algorithms, each of both
      servers from the unsharded server's state on its own draws
      (``run(state, rounds=1)``: the JAX package's key schedule's first
      round): selection counts equal; the parameters and the loss cache's
      entries of the round's cohort (their local losses, written by the
      round's training) equal; its other entries (losses on the same
      parameters, looped against vmapped) within ``FL_POW_D_LOSS_RTOL``; a
      round's ms on the host clock, each server's median.  Under cuDNN's
      default algorithms two calls of the same local update part from its
      first step (the convolutions' gradients are summed in another order
      from call to call) and training widens the gap, so the two servers
      are only compared there as information
      (``scripts/pow_d_mesh_parting.py`` measures both modes).
    * ``[fl-pow-d-mesh-drift]``: both servers' own ``rounds``-round runs,
      as a user calls them (cuDNN's default algorithms): how far their
      parameters and loss caches drift apart, as information; parameters
      finite."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from repro_torch.configs import FLConfig
    from repro_torch.fl import FLServer
    from repro_torch.launch import make_mesh
    from repro_torch.launch.train import build_task

    fl = FLConfig(scheme="pow_d", rounds=rounds, **(fl_kw or {}))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mesh = make_mesh((1,), ("data",), device=dev)
    servers = {}
    for placed in (False, True):
        model, store, _ = build_task("emnist", fl, device=dev)  # a store each: its batch order advances a round
        servers[placed] = FLServer(model, fl, store, spmd_axes="data" if placed else None, device=dev)
    params0, _ = model.init(torch.Generator(device=dev).manual_seed(fl.seed))

    def init(placed):
        params = {n: distribute_tensor(t, mesh, [Replicate()]) for n, t in params0.items()} if placed else params0
        return servers[placed].init_state(params=params)

    def place(state):
        return state._replace(params={n: distribute_tensor(t, mesh, [Replicate()]) for n, t in state.params.items()})

    def whole(state):
        return {n: v.full_tensor() if isinstance(v, DTensor) else v for n, v in state.params.items()}

    def gaps(a, b):
        wa, wb = whole(a), whole(b)
        return float((a.loss_cache - b.loss_cache).abs().max()), max(float((wa[n] - wb[n]).abs().max()) for n in wa)

    state, ms, cand_rel = init(False), {False: [], True: []}, 0.0
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        for t in range(rounds):
            got = {}
            for placed, srv in servers.items():
                sync()
                t0 = time.perf_counter()
                got[placed], _ = srv.run(place(state) if placed else state, rounds=1)
                sync()
                ms[placed].append((time.perf_counter() - t0) * 1e3)
            a, b = got[False], got[True]
            if not torch.equal(a.sel_counts, b.sel_counts):
                raise AssertionError(f"pow-d on a one-rank mesh, round {t}: the selection differs")
            trained = a.sel_counts != state.sel_counts
            if not torch.equal(a.loss_cache[trained], b.loss_cache[trained]):
                raise AssertionError(f"round {t}: the cohort's local losses differ between the mesh and plain servers")
            wa, wb = whole(a), whole(b)
            for n in wa:
                if not torch.equal(wa[n], wb[n]):
                    raise AssertionError(f"round {t}: parameter {n} differs between the mesh and plain servers")
            ca, cb = a.loss_cache[~trained].cpu().numpy(), b.loss_cache[~trained].cpu().numpy()
            np.testing.assert_allclose(cb, ca, rtol=FL_POW_D_LOSS_RTOL, atol=0,
                                       err_msg=f"round {t}: candidates' losses")
            cand_rel = max(cand_rel, float((np.abs(cb - ca) / np.maximum(np.abs(ca), 1e-30)).max()))
            state = a
    log("fl-pow-d-mesh", K=fl.K, k=fl.k, pow_d=fl.pow_d, rounds=rounds, samples_per_client=fl.samples_per_client,
        mesh="(data,)=(1,)", draws="the servers' own (JAX key schedule)", cudnn="deterministic",
        selected=int(state.sel_counts.sum()), sel_counts="equal every round",
        params_and_cohort_losses="equal every round", candidate_loss_max_rel_diff=f"{cand_rel:.3g}",
        loss_rtol=FL_POW_D_LOSS_RTOL, mesh_round_ms_median=f"{np.median(ms[True]):.1f}",
        plain_round_ms_median=f"{np.median(ms[False]):.1f}", card=repr(card))

    runs = {placed: servers[placed].run(init(placed))[0] for placed in (False, True)}
    if not all(bool(torch.isfinite(v).all()) for st in runs.values() for v in whole(st).values()):
        raise AssertionError("pow-d's servers: non-finite parameters after their own runs")
    loss_gap, param_gap = gaps(runs[False], runs[True])
    log("fl-pow-d-mesh-drift", rounds=rounds, cudnn="default", sel_counts_equal=torch.equal(runs[False].sel_counts,
                                                                                          runs[True].sel_counts),
        loss_cache_max_abs_diff=loss_gap, params_max_abs_diff=param_gap, card=repr(card))


def serve_mesh_worker(rank, out_dir, store, device, params):
    """One rank of ``[serve-sharded-mesh]`` (``chip_smoke.py
    --serve-mesh-worker RANK DIR STORE DEVICE PARAMS``, started and read by
    ``serve_mesh_path``): a gloo group of ``D`` ranks over a ``FileStore``,
    every rank on ``DEVICE`` (``cuda:0``: two ranks share the one card).
    Rank 0 leads four phases and the other ranks ``follow`` each; after each
    phase every rank records its kernel launches and sets them to 0.

    * ``reference``: ``ShardedEngine(D, staleness=2, block=4)`` ticked in
      process, two jobs, ``rounds`` rounds;
    * ``served``: the same jobs behind a ``SelectionServer``, a client thread
      a job: half the rounds, a checkpoint, ``kill()``, ``load_server`` and
      a new server for the rest; then B5 against its plain version on every
      rank's slab of each job's next allocation;
    * ``chaos-reference`` and ``chaos``: the JAX package's chaos plan against
      the served engine for ``rounds_chaos`` rounds, and its fault-free run.

    Rank 0 writes the cohorts' comparisons and the serving figures, every
    rank its launches, to ``DIR/rank<r>.json``."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import kernels as kn
    from repro_torch.launch import make_host_mesh
    from repro_torch.obs import LatencyHistogram
    from repro_torch.serve import FaultPlan, JobSpec, SelectionServer, ServeClient, ServeError, ShardedEngine
    from repro_torch.serve import follow, load_server, stop_followers

    p = json.loads(params)
    D, K, k, seed = p["D"], p["K"], p["k"], p["seed"]
    dev = torch.device(device)
    dist.init_process_group("gloo", store=dist.FileStore(store, D), rank=rank, world_size=D)
    if dev.type == "cuda":
        from repro_torch.kernels._build import load_library

        load_library()
    mesh = make_host_mesh(D, device=dev)
    specs = [dict(K=K, k=k, rounds=p["rounds"], seed=seed), dict(K=K // 2, k=k // 2, rounds=p["rounds"], seed=seed + 1)]
    out = {"launches": {}}

    def phase(name, lead):
        """``lead()`` on rank 0, ``follow`` elsewhere; returns (rank 0's
        result, this rank's last engine)."""
        kn.reset_launch_counts()
        if mesh.rank == 0:
            try:
                res = lead()
            finally:
                stop_followers()
            eng = res.pop("engine", None)
        else:
            res, eng = None, follow(D, device=dev)
        out["launches"][name] = {n: c for n, c in kn.launch_counts().items() if c}
        return res, eng

    def feed_of(i, t, salt=0):
        return _feed(seed + salt, i, t, specs[i]["K"], 2)

    def reference(rounds, salt):
        eng = ShardedEngine(D=D, staleness=2, block=4, device=dev)
        uids = [eng.admit(JobSpec(**dict(s, rounds=rounds))) for s in specs]
        t0 = time.perf_counter()
        ticks = [eng.tick([(u, feed_of(i, t, salt)) for i, u in enumerate(uids)]) for t in range(rounds)]
        wall = time.perf_counter() - t0
        return {"cohorts": [[r[u]["cohort"] for r in ticks] for u in uids], "wall_s": wall,
                "captured": sorted({run.horizon.captured for run, _, _ in eng._runners.values()})}

    def served():
        rounds, half = p["rounds"], p["rounds"] // 2
        tmp = tempfile.mkdtemp(prefix="serve_mesh_")
        try:
            srv = SelectionServer(ShardedEngine(D=D, staleness=2, block=4, device=dev), ckpt_dir=tmp)
            srv.start()
            with ServeClient.connect(srv.address, timeout=600.0) as c:
                uids = [c.admit(**s) for s in specs]
                got, _, _ = _serve_clients(srv, {u: (i, 0, 1) for i, u in enumerate(uids)}, feed_of)
                more, lat1, wall1 = _serve_clients(srv, {u: (i, 1, half - 1) for i, u in enumerate(uids)}, feed_of)
                t0 = time.perf_counter()
                stem = c.checkpoint()
                ckpt_ms = (time.perf_counter() - t0) * 1e3
            srv.kill()
            t0 = time.perf_counter()
            engine, step = load_server(stem, device=dev)
            restore_ms = (time.perf_counter() - t0) * 1e3
            srv2 = SelectionServer(engine, ckpt_dir=tmp)
            srv2.start()
            srv2.latency = LatencyHistogram(lo=1e-5, hi=60.0)
            rest, lat2, wall2 = _serve_clients(srv2, {u: (i, half, rounds - half) for i, u in enumerate(uids)},
                                               feed_of)
            srv2.close(checkpoint=False)
            ckpt_bytes = os.path.getsize(stem + ".ckpt")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        lat = lat1 + lat2
        return {"cohorts": [got[u] + more[u] + rest[u] for u in uids], "ticks": len(specs) * rounds,
                "timed_ticks": len(lat), "ticks_per_s": len(lat) / (wall1 + wall2),
                "request_p50_ms": float(np.percentile(np.asarray(lat) * 1e3, 50)),
                "request_p99_ms": float(np.percentile(np.asarray(lat) * 1e3, 99)),
                "dispatch_p50_ms": srv2.latency.quantile(0.5) * 1e3, "checkpoint_ms": ckpt_ms,
                "checkpoint_bytes": ckpt_bytes, "restore_ms": restore_ms, "restored_step": step,
                "captured": sorted({run.horizon.captured for run, _, _ in engine._runners.values()}),
                "engine": engine}

    def chaos():
        rounds = p["rounds_chaos"]
        plan = FaultPlan(crash_steps=(25,), corrupt_checkpoints=(3,), drop_responses=(12, 31), slow_steps={5: 0.02})
        tmp = tempfile.mkdtemp(prefix="serve_mesh_chaos_")
        try:
            srv = SelectionServer(ShardedEngine(D=D, staleness=2, block=4, device=dev), ckpt_dir=tmp, ckpt_every=6,
                                  faults=plan, restart_backoff=0.01)
            with srv, ServeClient.connect(srv.address, timeout=600.0, retries=6, seed=5) as c:
                uids = [c.admit(**dict(s, rounds=rounds)) for s in specs]
                cursors, got = {i: 0 for i in range(2)}, {i: {} for i in range(2)}
                t0 = time.perf_counter()
                while any(t < rounds for t in cursors.values()):
                    for i, u in enumerate(uids):
                        t = cursors[i]
                        if t >= rounds:
                            continue
                        try:
                            res = c.tick(u, lags=feed_of(i, t, 20), round=t)
                        except ServeError as e:
                            if e.code == "round_desync":
                                cursors[i] = int(e.response["expected"])
                                continue
                            raise
                        got[i][res["round"]] = res["cohort"]
                        cursors[i] = res["round"] + 1
                wall = time.perf_counter() - t0
                ticks = srv.stats["ticks"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        restart = [a for a in srv.alerts if a.rule == "engine_restart"]
        return {"cohorts": [[got[i].get(t) for t in range(rounds)] for i in range(2)], "fired": plan.fired(),
                "restored_step": [a.detail["restored_step"] for a in restart], "ticks": ticks,
                "replayed": srv.stats["replayed"], "recovery_ms": [r * 1e3 for r in srv.recoveries],
                "horizon_s": wall}

    try:
        ref_out, _ = phase("reference", lambda: reference(p["rounds"], 0))
        srv_out, eng = phase("served", served)
        out["block_sums"] = block_sums_on_jobs(eng, f"serve-sharded-mesh rank {mesh.rank}")
        del eng
        cref_out, _ = phase("chaos-reference", lambda: reference(p["rounds_chaos"], 20))
        chaos_out, _ = phase("chaos", chaos)
        if mesh.rank == 0:
            out.update(reference=ref_out, served=srv_out, chaos_reference=cref_out, chaos=chaos_out,
                       device=str(dev), name=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def serve_mesh_path(dev, card, **over):
    """Phase 16's ``[serve-sharded-mesh]``: the sharded engine served on ``D``
    ranks (``SERVE_MESH``, ``over`` for a rehearsal), each a process of its
    own on this card (``serve_mesh_worker``: a gloo group over the card's
    tensors, since NCCL refuses two ranks on one device; the runners step
    uncaptured).  Checks: the served cohorts equal the in-process engine's
    and, through the JAX package's chaos plan, the fault-free run's, bit for
    bit; recovery restores step 18; every runner is uncaptured; each rank
    launches B5 exactly ``ceil(48 / 4)`` times a job-tick and it equals its
    plain version on every rank's slab.  Returns both ranks' launches in the
    served and chaos phases."""
    import shutil
    import tempfile

    from repro_torch.engine.sharded import N_ITERS

    p = dict(SERVE_MESH, **over)
    t_phase = time.time()
    out_dir = os.path.join(CHIPRUN_OUT, "serve_mesh")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    store = os.path.join(tempfile.mkdtemp(prefix="serve_mesh_store_"), "store")
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    device = "cuda:0" if dev.type == "cuda" else "cpu"
    procs, logs = [], []
    try:
        for r in range(p["D"]):
            logs.append(open(os.path.join(out_dir, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--serve-mesh-worker", str(r),
                                           out_dir, store, device, json.dumps(p)],
                                          env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.time() + SERVE_MESH_TIMEOUT
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
        shutil.rmtree(os.path.dirname(store), ignore_errors=True)
    if any(proc.returncode for proc in procs):
        tails = [open(os.path.join(out_dir, f"rank{r}.log")).read()[-3000:] for r in range(p["D"])]
        raise AssertionError(f"serve-sharded-mesh: ranks exited {[proc.returncode for proc in procs]}:\n"
                             + "\n".join(tails))
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(p["D"])]
    lead = ranks[0]
    ref, srv, cref, chaos = lead["reference"], lead["served"], lead["chaos_reference"], lead["chaos"]
    if srv["cohorts"] != ref["cohorts"]:
        raise AssertionError("serve-sharded-mesh: the served horizon (across kill and restore) differs from the "
                             "in-process engine's")
    if chaos["cohorts"] != cref["cohorts"] or chaos["restored_step"] != [18] \
            or chaos["fired"] != {"crash": 1, "corrupt": 1, "drop": 2, "slow": 1}:
        raise AssertionError(f"serve-sharded-mesh chaos: fired {chaos['fired']}, restored {chaos['restored_step']}, "
                             f"horizon equal {chaos['cohorts'] == cref['cohorts']}")
    for i, s in enumerate(ref["cohorts"]):
        K, k = p["K"] // (1 + i), p["k"] // (1 + i)
        if any(len(c) != k or len(set(c)) != k or not all(0 <= j < K for j in c) for c in s):
            raise AssertionError(f"serve-sharded-mesh: job {i}: a cohort is not {k} distinct clients of [0, {K})")
    if ref["captured"] != [False] or srv["captured"] != [False]:
        raise AssertionError(f"serve-sharded-mesh: runners captured {ref['captured']} / {srv['captured']} on gloo")
    n_block = -(-N_ITERS // 4)
    on_card = dev.type == "cuda"
    want = {"reference": 2 * p["rounds"], "served": srv["ticks"], "chaos-reference": 2 * p["rounds_chaos"],
            "chaos": chaos["ticks"]}
    launched = {}
    for r, rk in enumerate(ranks):
        for name, ticks in want.items():
            got = rk["launches"].get(name, {})
            exp = {"bisect_block_sums": n_block * ticks} if on_card else {}
            if got != exp:
                raise AssertionError(f"serve-sharded-mesh rank {r} {name}: launches {got}, expected {exp}")
            if name in ("served", "chaos"):
                for n, c in got.items():
                    launched[n] = launched.get(n, 0) + c
        log("serve-sharded-mesh", rank=r, check="block_sums_vs_plain", rtol=BISECT_RTOL["float32"],
            jobs=json.dumps(rk["block_sums"]), launches=json.dumps(rk["launches"]))
    jobs = "K=%d,k=%d;K=%d,k=%d" % (p["K"], p["k"], p["K"] // 2, p["k"] // 2)
    log("serve-sharded-mesh", D=p["D"], device=lead["device"], group="gloo", captured=False, jobs=jobs,
        rounds=p["rounds"], staleness=2, block=4, ticks_per_s=f"{srv['ticks_per_s']:.2f}",
        request_p50_ms=f"{srv['request_p50_ms']:.3f}", request_p99_ms=f"{srv['request_p99_ms']:.3f}",
        dispatch_p50_ms=f"{srv['dispatch_p50_ms']:.3f}", in_process_ticks_per_s=f"{2 * p['rounds'] / ref['wall_s']:.2f}",
        checkpoint_write_ms=f"{srv['checkpoint_ms']:.1f}", checkpoint_bytes=srv["checkpoint_bytes"],
        restore_ms=f"{srv['restore_ms']:.1f}", restored_step=srv["restored_step"],
        served_vs_in_process="bit-identical", card=repr(card))
    log("serve-sharded-mesh", D=p["D"], plan="chaos", rounds=p["rounds_chaos"], fired=json.dumps(chaos["fired"]),
        restored_step=18, recovery_ms=f"{chaos['recovery_ms'][0]:.1f}", ticks=chaos["ticks"],
        replayed=chaos["replayed"], horizon_s=f"{chaos['horizon_s']:.3f}", horizon_vs_fault_free="bit-identical",
        launches_both_ranks=json.dumps(launched), seconds=f"{time.time() - t_phase:.1f}", card=repr(card))
    return launched


EXAMPLES = (("quickstart", []), ("scenarios_demo", []), ("serve_demo", []), ("paper_repro", ["--rounds", "6"]),
            ("fl_lm", []))


def examples_path(dev, card, argv_of=None):
    """``[examples]``: the port's five examples (``examples/torch_*.py``) at
    their defaults (``paper_repro`` at ``--rounds 6``) on ``dev``, each
    through its ``main(argv)``, its printout under
    ``chiprun_out/examples/``; the wall time, the kernels each launched and
    a figure of its result.  ``argv_of`` (a rehearsal) maps a name to the
    arguments it runs with instead."""
    import contextlib
    import importlib.util

    import torch

    from repro_torch import kernels as kn

    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(CHIPRUN_OUT, "examples")
    os.makedirs(out_dir, exist_ok=True)
    dev_arg = ["--device", "cuda" if dev.type == "cuda" else "cpu"]
    for name, argv in EXAMPLES:
        argv = (argv_of or {}).get(name, argv) + dev_arg
        spec = importlib.util.spec_from_file_location(f"torch_{name}", os.path.join(root, "examples",
                                                                                   f"torch_{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        kn.reset_launch_counts()
        t0 = time.perf_counter()
        with open(os.path.join(out_dir, f"{name}.txt"), "w") as f, contextlib.redirect_stdout(f):
            res = mod.main(argv)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if name == "quickstart":
            fig = dict(cep=res["cep"])
        elif name == "scenarios_demo":
            if not res["packed_same_as_dense"]:
                raise AssertionError("examples: scenarios_demo's packed replay differs from the dense one")
            fig = dict(cells=len(res["grid"]), packed_same_as_dense=True)
        elif name == "serve_demo":
            fig = dict(restored_step=res["restored_step"], ticks=res["stats"]["ticks"])
        elif name == "paper_repro":
            p1 = res["phase1"]
            if not p1["regret"] <= p1["bound"]:
                raise AssertionError(f"examples: Theorem 1 regret {p1['regret']} above its bound {p1['bound']}")
            fig = dict(cep_order=">".join(p1["order"]), regret=f"{p1['regret']:.1f}", bound=f"{p1['bound']:.1f}",
                       final_acc=json.dumps({n: v["acc"][-1] for n, v in res["phase2"].items()}))
        else:
            if not all(math.isfinite(v) for v in res["losses"]):
                raise AssertionError("examples: fl_lm's local loss is not finite")
            fig = dict(loss_first=f"{res['losses'][0]:.3f}", loss_last=f"{res['losses'][-1]:.3f}")
        log("examples", example=f"examples/torch_{name}.py", argv=" ".join(argv), seconds=f"{secs:.2f}",
            launches=json.dumps({n: c for n, c in kn.launch_counts().items() if c}), **fig, card=repr(card))
        del mod, res
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def profile_calls(label, fn, card, n=5):
    """Where ``n`` calls of ``fn`` spend the card's time: ``torch.profiler``
    over them after one warm call, the device's busy time and operations a
    call, its idle share of the window's wall time, and the operations that
    take the most device time (``[profile-call]``, ``[profile-call-kernel]``)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in ops)
    log("profile-call", call=label, calls=n, wall_ms_per_call=f"{wall_us / n / 1e3:.3f}",
        device_busy_ms_per_call=f"{busy_us / n / 1e3:.3f}", device_ops_per_call=f"{len(ops) / n:.1f}",
        device_idle_share=f"{1 - busy_us / wall_us:.4f}", card=repr(card))
    by_name = {}
    for e in ops:
        calls, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    for kname, (calls, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        log("profile-call-kernel", call=label, name=repr(kname[:80]), calls_per_call=calls / n,
            device_ms_per_call=f"{us / n / 1e3:.4f}")


def check_rate_hint(name, vol, rho, xs, card):
    """A trace's mean success rate against the registry's rate hint, over
    the rounds where the hint is the trace's expected rate: every round of
    the iid, Markov (stationary from the start) and deadline (calibrated)
    scenarios, the whole periods of the diurnal one, and the flash crowd's
    rounds before its window.  A regional outage starts with every region
    up, so its hint, the stationary rate, is not a 50-round trace's
    expectation: its mean must lie between the all-down and the all-up
    rates.  Within ``RATE_Z`` standard deviations of the draws' mean."""
    import torch

    T = xs.shape[0]
    per_round = xs.to(torch.float64).mean(1).cpu().numpy()
    rho = rho.to(torch.float64)
    inflate = 1.0
    rounds = T
    if name.startswith("markov"):
        s = vol.stickiness
        inflate = (1 + s) / (1 - s)
    elif name == "diurnal":
        rounds = vol.period * (T // vol.period)
    elif name == "flash_crowd":
        rounds = vol.t_start
    got = float(per_round[:rounds].mean())
    if name == "regional_outage":
        base = vol.rho.to(torch.float64)
        lo, hi = float((base * (1 - vol.severity)).mean()), float(base.mean())
        ok = lo <= got <= hi
        log("scenario-trace", scenario=name, rounds=T, mean_rate=f"{got:.6f}", hint_mean=f"{float(rho.mean()):.6f}",
            bounds=f"[{lo:.6f},{hi:.6f}]", card=repr(card))
    else:
        want = float(rho.mean())
        sd = math.sqrt(float((rho * (1 - rho)).sum()) * rounds * inflate) / (xs.shape[1] * rounds)
        ok = abs(got - want) <= RATE_Z * sd
        log("scenario-trace", scenario=name, rounds=rounds, mean_rate=f"{got:.6f}", hint_mean=f"{want:.6f}",
            diff=f"{got - want:.3g}", bound=f"{RATE_Z * sd:.3g}", card=repr(card))
    if not ok:
        raise AssertionError(f"scenario {name}: the trace's mean success rate {got} misses its rate hint")


def ops_path(dev, K, k, K_list=AUTOTUNE_K):
    """Phase 16: the kernel layer's public ops with their autotuner, on
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


def profile_round(dev, K, k, rounds=5, label="dense", card="", runner=None, **opts):
    """Where a fused sync round's time goes (``opts``: the mesh and block;
    ``runner``: ``build_runner``'s taps and sketch): ``torch.profiler`` over
    a horizon of a few replayed rounds after the runner's first call (which
    captures the step): device time by kernel, the device's operations a
    round, the span from its first operation to its last, and its busy
    share of the window's wall time (profiler overhead included in the wall
    time); then the median wall time of five horizons without the profiler,
    and the idle share that the same busy time leaves of it.  The stage
    annotations fire at the capture only, so the window shows none."""
    import torch

    from repro_torch.configs import FLConfig
    from repro_torch.engine import RoundProgram

    fl = FLConfig(K=K, k=k, rounds=T_MAIN, scheme="e3cs", quota_frac=0.5, allocator="bisect")
    pm = RoundProgram.from_config(fl, fused=True, device=dev, **opts)
    run, s0 = pm.build_runner(outputs="lean", scan_length=rounds, **(runner or {}))
    run(s0, 1)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(s0, 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    plain_us = []
    for _ in range(5):
        t0 = time.perf_counter()
        run(s0, 1)
        torch.cuda.synchronize()
        plain_us.append((time.perf_counter() - t0) * 1e6)
    plain = float(np.median(plain_us))
    cuda = torch.autograd.DeviceType.CUDA
    # device-side events: kernels and memory ops; the "round.*" ones are the
    # GPU spans of the stage annotations, which cover gaps and other events
    dev_events = [e for e in prof.events() if e.device_type == cuda]
    ops = [e for e in dev_events if not e.name.startswith("round.")]
    busy_us = sum(e.time_range.elapsed_us() for e in ops)
    # first operation's start to last one's end: the idle time inside it is
    # the gaps between the graphs' nodes, the rest of the wall time the host's
    span_us = (max(e.time_range.end for e in ops) - min(e.time_range.start for e in ops)) if ops else 0.0
    log("profile", program=label, rounds=rounds, wall_ms=f"{wall_us / 1e3:.3f}", device_busy_ms=f"{busy_us / 1e3:.3f}",
        device_span_ms=f"{span_us / 1e3:.3f}", device_idle_share=f"{1 - busy_us / wall_us:.4f}",
        rounds_per_s=f"{rounds / wall_us * 1e6:.3f}",
        device_ops_per_round=f"{len(ops) / rounds:.1f}", unprofiled_wall_ms=f"{plain / 1e3:.3f}",
        unprofiled_idle_share=f"{1 - busy_us / plain:.4f}", unprofiled_rounds_per_s=f"{rounds / plain * 1e6:.3f}",
        card=repr(card))
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
    if sys.argv[1:2] == ["--dryrun-worker"]:
        sys.exit(dryrun_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--serve-mesh-worker"]:
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
        sys.exit(serve_mesh_worker(int(sys.argv[2]), *sys.argv[3:7]))
    sys.exit(main())
