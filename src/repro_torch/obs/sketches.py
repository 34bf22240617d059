"""Fixed-size, mergeable sketches over the client axis (the port of
``repro.obs.sketches``).

At K = 10^6 nobody can afford to haul per-client state to the host every
round, yet the paper's central tradeoff (effective participation against
fairness) is per client: which clients E3CS starves, which it over-selects,
how credit distributes across volatility regions.  A *sketch* compresses
the K axis into a handful of small dense arrays the round carries and emits:

* ``count_hist`` / ``count_mass``: clients (and their selection mass) per
  log2 bucket of cumulative selection count,
* ``p_hist``: clients per uniform bucket of this round's allocation p,
* ``region_clients`` / ``region_selected`` / ``region_on_time``:
  segment-sum rollups over a per-client region id (volatility class),
* ``lag_hist``: cumulative outcome-code histogram over all selections
  (sync: on-time / failed; async: lag 0..S plus never-completed),
* ``sum_c`` / ``sum_c2``: exact first two moments of the count vector
  (an exact streaming Jain index, whatever the bucketing).

Every field is a **sum over clients**, so sketches merge by addition: under
a mesh each rank accumulates its slab's partial sums and one ``all_reduce``
of the emitted stream after the horizon gives the global sketch, the same
on every rank and equal to the dense runner's.  Emission happens every
``window`` rounds, gated on the round counter ``state.t`` on the device
(the host never reads it).  The histograms are ``index_add_`` into fixed
bins (spread over copies of the bins, so that no bin serialises a card's
atomic adds); every summand is an integer-valued float and every sum stays
below 2^24, so they are exact in any order.

Sketches observe values the round already computes and never touch its
noise or its state.  The host side derives the streamed **fairness
series** (``fairness_series``): exact Jain index, grouped-data Gini,
top-decile selection share and per-region CEP skew, registered as
``fairness``-group gauges in ``ROUND_TAPS``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

__all__ = [
    "SketchSpec",
    "SKETCH_FIELDS",
    "FAIRNESS_SERIES",
    "region_ids",
    "lag_bins",
    "sketch_carry0",
    "sketch_step",
    "sketch_to_numpy",
    "merge_sketches",
    "sketch_from_dense",
    "fairness_series",
]

# every field is a per-client sum -> merge = add; order is the emission order
SKETCH_FIELDS = (
    "count_hist", "count_mass", "p_hist",
    "region_clients", "region_selected", "region_on_time",
    "lag_hist", "sum_c", "sum_c2",
)
FAIRNESS_SERIES = ("jain", "gini", "top_decile_share", "region_cep_skew")


@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """Geometry of the client-axis sketch the round carries.

    ``window`` is the emission cadence W (one sketch row every W rounds,
    gated on the round counter); ``count_bins`` buckets cumulative
    selection counts by ``floor(log2(c + 1))``; ``prob_bins`` buckets the
    round's allocation p uniformly on [0, 1]; ``regions`` is an optional
    (K,) int32 region-id vector (volatility class per client) rolled up by
    segment sum — when omitted, ``n_regions`` contiguous equal slabs of the
    client axis are used (the paper's ordered-by-rho class layout), and
    ``n_regions=1`` collapses the rollup to fleet totals.
    """

    window: int = 50
    count_bins: int = 12
    prob_bins: int = 10
    n_regions: int = 1
    regions: Optional[object] = None  # (K,) int32 region ids

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"sketch window must be >= 1, got {self.window}")
        if self.count_bins < 2 or self.prob_bins < 2:
            raise ValueError("sketch needs at least 2 count and 2 prob buckets")
        if self.n_regions < 1:
            raise ValueError(f"n_regions must be >= 1, got {self.n_regions}")
        if self.regions is not None:
            r = np.asarray(self.regions)
            if r.ndim != 1:
                raise ValueError(f"regions must be a 1-D id vector, got shape {r.shape}")
            if r.size and (int(r.min()) < 0 or int(r.max()) >= self.n_regions):
                raise ValueError(
                    f"region ids must lie in [0, {self.n_regions}), got "
                    f"[{int(r.min())}, {int(r.max())}]"
                )


def region_ids(spec: SketchSpec, K: int) -> np.ndarray:
    """The (K,) int32 region-id vector a program sketches under.

    ``spec.regions`` verbatim when given (validated against K), else
    ``n_regions`` contiguous equal slabs of the client axis.
    """
    if spec.regions is not None:
        r = np.asarray(spec.regions, np.int32)
        if r.shape != (K,):
            raise ValueError(f"regions shape {r.shape} != (K,) = ({K},)")
        return r
    if spec.n_regions == 1:
        return np.zeros((K,), np.int32)
    return ((np.arange(K, dtype=np.int64) * spec.n_regions) // K).astype(np.int32)


def lag_bins(staleness: Optional[int]) -> int:
    """Outcome-code bins L: sync rounds code {on-time, failed}; async rounds
    code the completion lag {0..S} plus a never-completed bin."""
    return 2 if staleness is None else int(staleness) + 2


def sketch_carry0(K_loc: int, L: int, device=None):
    """Zeroed per-rank sketch accumulators for the round's carry, on
    ``device`` (``None``: CUDA, which raises without it)."""
    import torch

    from repro_torch.device import resolve_device

    device = resolve_device(device)
    return {
        "cum_on_time": torch.zeros(K_loc, dtype=torch.float32, device=device),
        "lag_hist": torch.zeros(L, dtype=torch.float32, device=device),
    }


_LANES = 2048  # copies of a histogram's bins that its adds are spread over


def sketch_step(spec: SketchSpec, skc, mask, x, lag, p, counts, t, region, active, L: int):
    """One round of sketch accumulation and (window-gated) emission.

    All inputs are the rank's slabs the round body already holds: ``mask``
    this round's cohort, ``x`` the on-time success bits, ``lag`` the
    completion lags (None when sync), ``p`` the allocation, ``counts`` the
    post-update cumulative selection counts, ``t`` the post-update round
    counter (a 0-d tensor), ``region`` the ``(K_loc,)`` region ids,
    ``active`` a ``(K_loc,)`` 0/1 mask excluding mesh padding (None = all
    active).

    Returns ``(skc', row)``: ``row`` holds the slab's partial sums of
    ``SKETCH_FIELDS`` on emission rounds (``t % window == 0``) and zeros
    otherwise.  The histograms are computed every round and the row is
    selected on the device, so the step has no branch the host decides.
    """
    import torch

    B, PB, R, W = spec.count_bins, spec.prob_bins, spec.n_regions, spec.window
    act = torch.ones_like(counts) if active is None else active
    # client j adds into copy j % _LANES of a histogram's bins, and the copies
    # are summed: no bin takes more than K / _LANES atomic adds on a card
    lane = torch.bitwise_and(torch.arange(counts.shape[0], dtype=torch.int32, device=counts.device), _LANES - 1)

    def hist(idx, n_bins, *weights):
        slot = torch.add(lane, idx, alpha=_LANES)
        out = []
        for w in weights:
            h = torch.zeros(n_bins * _LANES, dtype=w.dtype, device=w.device).index_add_(0, slot, w)
            out.append(h.view(n_bins, _LANES).sum(1))
        return out

    cum = skc["cum_on_time"] + mask * x
    if lag is None:
        code = (1 - x).to(torch.int64)  # 0 = on-time, 1 = failed
    else:
        code = torch.where(lag < 0, torch.full_like(lag, L - 1), torch.clamp(lag, 0, L - 2)).to(torch.int64)
    (lag_now,) = hist(code, L, mask)
    lag_hist = skc["lag_hist"] + lag_now
    cb = torch.clamp(torch.floor(torch.log2(counts + 1.0)), 0, B - 1).to(torch.int64)
    pb = torch.clamp(torch.floor(p * PB), 0, PB - 1).to(torch.int64)
    ca = counts * act
    count_hist, count_mass = hist(cb, B, act, ca)
    (p_hist,) = hist(pb, PB, act)
    region_clients, region_selected, region_on_time = hist(region.to(torch.int64), R, act, ca, cum * act)
    emitted = {
        "count_hist": count_hist,
        "count_mass": count_mass,
        "p_hist": p_hist,
        "region_clients": region_clients,
        "region_selected": region_selected,
        "region_on_time": region_on_time,
        "lag_hist": lag_hist,
        "sum_c": torch.sum(ca),
        "sum_c2": torch.dot(counts, ca),
    }
    emit = torch.remainder(t, W) == 0
    row = {n: torch.where(emit, v, torch.zeros_like(v)) for n, v in emitted.items()}
    return {"cum_on_time": cum, "lag_hist": lag_hist}, row


# ---------------------------------------------------------------------------
# Host side: reference recompute, merging and fairness derivation
# ---------------------------------------------------------------------------


def sketch_to_numpy(stream) -> Dict[str, np.ndarray]:
    """Host view of a runner's ``"sketches"`` payload: float64 numpy."""
    return {n: np.asarray(stream[n], np.float64) for n in SKETCH_FIELDS}


def merge_sketches(*streams: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Merge independent sketch streams (ranks, hosts): plain addition,
    exact by construction (every field is a per-client sum)."""
    out = {n: np.asarray(streams[0][n], np.float64).copy() for n in SKETCH_FIELDS}
    for s in streams[1:]:
        for n in SKETCH_FIELDS:
            out[n] = out[n] + np.asarray(s[n], np.float64)
    return out


def sketch_from_dense(
    spec: SketchSpec,
    counts: np.ndarray,
    p: np.ndarray,
    cum_on_time: np.ndarray,
    lag_hist: np.ndarray,
    region: np.ndarray,
    active: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Recompute one emission row from dense per-client state (the oracle
    for the round's sketch stream and for the merge over ranks)."""
    B, PB, R = spec.count_bins, spec.prob_bins, spec.n_regions
    counts = np.asarray(counts, np.float64)
    p = np.asarray(p, np.float64)
    cum = np.asarray(cum_on_time, np.float64)
    region = np.asarray(region, np.int64)
    act = np.ones_like(counts) if active is None else np.asarray(active, np.float64)
    cb = np.clip(np.floor(np.log2(counts + 1.0)), 0, B - 1).astype(np.int64)
    pb = np.clip(np.floor(p * PB), 0, PB - 1).astype(np.int64)
    ca = counts * act
    return {
        "count_hist": np.bincount(cb, weights=act, minlength=B)[:B],
        "count_mass": np.bincount(cb, weights=ca, minlength=B)[:B],
        "p_hist": np.bincount(pb, weights=act, minlength=PB)[:PB],
        "region_clients": np.bincount(region, weights=act, minlength=R)[:R],
        "region_selected": np.bincount(region, weights=ca, minlength=R)[:R],
        "region_on_time": np.bincount(region, weights=cum * act, minlength=R)[:R],
        "lag_hist": np.asarray(lag_hist, np.float64),
        "sum_c": np.asarray(ca.sum()),
        "sum_c2": np.asarray((counts * ca).sum()),
    }


def _top_share(count_hist: np.ndarray, count_mass: np.ndarray, frac: float) -> float:
    """Selection-mass share of the top ``frac`` of clients, walking the
    count buckets from the top with a fractional final bucket."""
    n = count_hist.sum()
    s = count_mass.sum()
    if n <= 0 or s <= 0:
        return 0.0
    target = frac * n
    taken = 0.0
    mass = 0.0
    for b in range(count_hist.shape[0] - 1, -1, -1):
        nb, sb = count_hist[b], count_mass[b]
        if nb <= 0:
            continue
        if taken + nb <= target:
            taken += nb
            mass += sb
        else:
            mass += sb * (target - taken) / nb
            break
    return float(mass / s)


def fairness_series(stream: Dict[str, np.ndarray], top_frac: float = 0.1) -> Dict[str, np.ndarray]:
    """Derive the streamed fairness gauges from a sketch stream.

    ``stream`` maps ``SKETCH_FIELDS`` to (n_emits, ...) arrays (a runner's
    ``"sketches"`` payload).  Returns (n_emits,) float64 series:

    * ``jain`` — exact Jain index ``sum_c^2 / (n_active * sum_c2)`` (the
      moments are exact, not bucketed),
    * ``gini`` — grouped-data Gini from the count histogram (trapezoid
      Lorenz over the log2 buckets; within-bucket equality assumed),
    * ``top_decile_share`` — selection-mass share of the most-selected
      ``top_frac`` of clients (fractional top bucket),
    * ``region_cep_skew`` — max per-region per-client on-time credit rate
      over the fleet-average rate (1.0 = perfectly balanced regions).
    """
    s = sketch_to_numpy(stream)
    n_emits = s["count_hist"].shape[0]
    out = {name: np.zeros((n_emits,), np.float64) for name in FAIRNESS_SERIES}
    for i in range(n_emits):
        nh, mh = s["count_hist"][i], s["count_mass"][i]
        n_act, sum_c, sum_c2 = nh.sum(), float(s["sum_c"][i]), float(s["sum_c2"][i])
        out["jain"][i] = sum_c * sum_c / (n_act * sum_c2) if n_act > 0 and sum_c2 > 0 else 0.0
        if sum_c > 0 and n_act > 0:
            p_b = nh / n_act
            cum_l = np.cumsum(mh) / sum_c
            prev_l = np.concatenate([[0.0], cum_l[:-1]])
            out["gini"][i] = 1.0 - float(np.sum(p_b * (prev_l + cum_l)))
        out["top_decile_share"][i] = _top_share(nh, mh, top_frac)
        rc, ro = s["region_clients"][i], s["region_on_time"][i]
        tot_c, tot_o = rc.sum(), ro.sum()
        if tot_c > 0 and tot_o > 0:
            rates = np.where(rc > 0, ro / np.maximum(rc, 1.0), 0.0)
            out["region_cep_skew"][i] = float(rates.max() / (tot_o / tot_c))
        else:
            out["region_cep_skew"][i] = 1.0
    return out
