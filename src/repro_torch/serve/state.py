"""Elastic-restart persistence for the serving front end (the port of
``repro.serve.state``).

A server checkpoint is two files with one stem (``ckpt_<step>``):

* ``ckpt_<step>.json`` — the **meta sidecar**: engine kind, static config,
  the live job table (uid → slot/round/spec), the sha256 + byte size of
  the array payload, and ``"writer": "repro_torch"``.  Human-readable, and the structural recipe:
  ``load_server`` rebuilds an identically-shaped engine from it *before*
  touching the array file (``repro_torch.checkpoint.restore`` needs a
  structurally matching ``like`` tree).
* ``ckpt_<step>.ckpt`` — the evolving arrays (selector weights, round
  counters, seeds or generator states, staleness/late-credit rings) in the
  port's own checkpoint format (``repro_torch.checkpoint``).

Crash safety is layered:

* **write order** — the array payload lands first (itself fsync'd +
  atomically renamed), the sidecar last (fsync'd + atomically renamed), so
  a stem without its sidecar is never considered restorable and a torn
  write never produces a sidecar pointing at missing bytes.
* **integrity** — the sidecar records ``ckpt_sha256``; ``validate_stem``
  recomputes it, so silent payload corruption (truncation, bit rot, a
  fault-injected flip) is detected rather than restored.
* **walk-back** — ``latest_server_checkpoint`` scans stems newest-first and
  returns the newest stem that *validates*, skipping corrupt or truncated
  ones; the supervisor in ``repro_torch.serve.transport`` restarts from whatever
  it returns.
* **retention** — ``save_server(keep=N)`` prunes to the newest N stems, so
  a long-running server keeps a bounded window of restore points instead of
  an unbounded directory.

Restoring reproduces the engine **bit-identically**: every array the step
function reads is in the payload and every job's noise derives from its own
seed and round counter (or its carried generator state or key), so a
restored server's subsequent cohorts match an uninterrupted run exactly.

A stem the JAX package wrote (a sidecar without ``"writer": "repro_torch"``;
its format is otherwise this one) loads too: ``load_server`` builds the
engine from the JAX meta on the JAX key stream (``stream="jax"``) and reads
the JAX payload (``checkpoint.jax_format``): a slot engine's ``logw``, ``t``,
``pending`` and ``base_keys`` (``convert.slot_state_from_jax``), a sharded
engine's jobs' ``state``, ``key`` and ``rings``
(``convert.sharded_job_from_jax``, which also takes JAX's mesh layout of the
state's scalars).  So a ``SelectionServer`` whose ``ckpt_dir`` holds JAX
stems resumes from them and serves the cohorts the JAX service would have
served; a stem it saves then is the port's, and reloads on the JAX
stream.  A zstd payload needs the ``zstandard`` package
(``ValueError`` naming the codec without it): the JAX package writes zlib
where ``zstandard`` is absent.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Tuple

from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import jax_format

from .engines import engine_from_meta

__all__ = [
    "save_server",
    "load_server",
    "latest_server_checkpoint",
    "validate_stem",
]

_PREFIX = "ckpt_"
WRITER = "repro_torch"  # the sidecar's mark of the package that wrote the stem


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(directory: str) -> None:
    """Durably record renames in the directory entry (best-effort: not all
    platforms allow opening a directory)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_server(directory: str, engine, step: int, *, keep: int = 0, faults=None) -> str:
    """Write ``ckpt_<step>.{json,ckpt}`` crash-safely (payload first and
    fsync'd, sha256-carrying sidecar last) and prune to the newest ``keep``
    stems (0 = keep all).  ``faults`` is the chaos hook
    (:class:`repro_torch.serve.faults.FaultPlan`): scheduled writes are corrupted
    *after* landing, so the restore walk-back has something to skip.
    Returns the stem path."""
    os.makedirs(directory, exist_ok=True)
    stem = os.path.join(directory, f"{_PREFIX}{step:08d}")
    ckpt.save(stem + ".ckpt", engine.arrays(), step=step)
    meta = {
        "step": step,
        "engine": engine.meta(),
        "ckpt_sha256": _sha256_file(stem + ".ckpt"),
        "ckpt_bytes": os.path.getsize(stem + ".ckpt"),
        "writer": WRITER,
    }
    tmp = stem + ".json.tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, stem + ".json")
    _fsync_dir(directory)
    if faults is not None:
        faults.on_checkpoint(stem)
    if keep:
        for old in _stems(directory)[:-keep]:
            if old == stem:
                continue
            for suffix in (".json", ".ckpt"):
                try:
                    os.remove(old + suffix)
                except FileNotFoundError:
                    pass
    return stem


def _stems(directory: str) -> list:
    return sorted(
        os.path.join(directory, name[: -len(".json")])
        for name in os.listdir(directory)
        if name.startswith(_PREFIX) and name.endswith(".json")
    )


def validate_stem(stem: str) -> bool:
    """True iff the stem is restorable: sidecar parses, payload exists, and
    the payload's sha256 matches the sidecar's record (legacy sidecars
    without a digest validate on presence alone)."""
    try:
        with open(stem + ".json") as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError):
        return False
    if "engine" not in meta or not os.path.exists(stem + ".ckpt"):
        return False
    want = meta.get("ckpt_sha256")
    if want is None:
        return True
    size = meta.get("ckpt_bytes")
    if size is not None and os.path.getsize(stem + ".ckpt") != size:
        return False
    return _sha256_file(stem + ".ckpt") == want


def latest_server_checkpoint(directory: str) -> Optional[str]:
    """Newest stem that validates (see :func:`validate_stem`), walking back
    past corrupt or truncated stems; None when nothing restorable exists."""
    if not os.path.isdir(directory):
        return None
    for stem in reversed(_stems(directory)):
        if validate_stem(stem):
            return stem
    return None


def load_server(stem: str, device=None) -> Tuple[object, int]:
    """Rebuild ``(engine, step)`` on ``device`` (``None``: CUDA) from a
    checkpoint stem: meta sidecar → engine shell (``engine_from_meta``) →
    array restore with the shell's own fresh arrays as the ``like`` tree.
    A JAX package stem loads on the JAX key stream (module docstring)."""
    with open(stem + ".json") as f:
        meta = json.load(f)
    if meta.get("writer") == WRITER:
        engine = engine_from_meta(meta["engine"], device=device)
        engine.load_arrays(ckpt.restore(stem + ".ckpt", like=engine.arrays()))
        return engine, int(meta["step"])
    from repro_torch.convert import sharded_job_from_jax, slot_state_from_jax

    engine = engine_from_meta({**meta["engine"], "stream": "jax"}, device=device)  # JAX's meta names no stream
    _, arrays = jax_format.read(stem + ".ckpt")
    if engine.kind == "slots":
        slot_state_from_jax(engine, arrays)
    else:
        for uid in sorted(engine.jobs):
            sharded_job_from_jax(engine, uid, arrays[str(uid)])
    return engine, int(meta["step"])
