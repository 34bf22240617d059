"""The port's checkpoint format (``repro_torch.checkpoint``) and the serving
stems built on it (``repro_torch.serve.state``).

* A ``ServerState`` with its rings and generator state, and a slot engine's
  arrays, round-trip bit for bit; each leaf lands on the device and in the
  dtype of the ``like`` tree's leaf.  A payload under another codec tag is
  refused.
* A truncated or bit-flipped payload fails ``validate_stem`` (the sidecar's
  sha256), and the walk-back skips it.
* The codec timing command reads every case back as written.
* A stem the JAX package's ``save_server`` wrote (msgpack) is refused by
  ``restore`` with the error that names its readers, and loads through
  ``load_server`` on the JAX key stream (``test_torch_jax_resume.py`` holds
  what it serves against JAX's); a file of neither format is refused.
"""
import os

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.serve import JobSpec as JJobSpec
from repro.serve import SlotEngine as JSlotEngine
from repro.serve import save_server as jsave_server
from repro_torch.checkpoint import latest_checkpoint, restore, save
from repro_torch.checkpoint import codec_times
from repro_torch.checkpoint.checkpoint import read_header
from repro_torch.configs import FLConfig
from repro_torch.engine import RoundProgram
from repro_torch.serve import FaultPlan, JobSpec, SlotEngine, latest_server_checkpoint, load_server, save_server
from repro_torch.serve import validate_stem

def _equal(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb) and pytree.tree_structure(a) == pytree.tree_structure(b)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)


def _server_state(feedback="late_credit", staleness=2):
    """A mid-horizon ServerState, its rings and generator state."""
    fl = FLConfig(K=256, k=16, rounds=4, scheme="e3cs", quota_frac=0.5, allocator="bisect",
                  staleness_rounds=staleness)
    pm = RoundProgram.from_config(fl, feedback=feedback, device="cpu")
    run, s0 = pm.build_runner(outputs="lean", carry_key=True, scan_length=4)
    if staleness:
        state, key, rings, *_ = run(s0, 5, pm.init_rings())
    else:
        (state, key, *_), rings = run(s0, 5), ()
    return {"state": state, "key": key, "rings": list(rings)}


@pytest.mark.parametrize("feedback,staleness", [("deadline", 0), ("deadline", 2), ("late_credit", 2)])
def test_server_state_round_trips_bit_for_bit(tmp_path, feedback, staleness):
    tree = _server_state(feedback, staleness)
    path = save(str(tmp_path / "s.ckpt"), tree, step=4)
    assert not os.path.exists(path + ".tmp")
    header = read_header(path)
    assert header["step"] == 4 and header["codec"] == "raw"
    assert header["nbytes"] == sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree))
    back = restore(path, like=tree)
    _equal(back, tree)
    assert type(back["state"]) is type(tree["state"]) and type(back["state"].e3cs) is type(tree["state"].e3cs)


def test_a_payload_under_another_codec_is_refused(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    path = save(str(tmp_path / "c.ckpt"), tree)
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob.replace(b'"codec":"raw"', b'"codec":"zlib:6"', 1))
    assert read_header(path)["codec"] == "zlib:6"
    with pytest.raises(ValueError, match="codec"):
        restore(path, like=tree)


@pytest.mark.parametrize("staleness", [0, 2])
def test_slot_engine_arrays_round_trip(tmp_path, staleness):
    eng = SlotEngine(K_max=64, k_cap=8, staleness=staleness, buckets=(2, 4), device="cpu")
    uids = [eng.admit(JobSpec(K=48 - 8 * j, k=4, seed=j)) for j in range(3)]  # grows 2 -> 4
    rng = np.random.default_rng(0)
    for _ in range(3):
        eng.tick([(u, rng.integers(-1, staleness + 1, eng.jobs[u]["spec"].K)) for u in uids])
    save(str(tmp_path / "e.ckpt"), eng.arrays(), step=9)
    fresh = SlotEngine.from_meta(eng.meta(), device="cpu")
    back = restore(str(tmp_path / "e.ckpt"), like=fresh.arrays())
    _equal(back, eng.arrays())
    fresh.load_arrays(back)
    _equal(fresh.arrays(), eng.arrays())
    assert [fresh.job_round(u) for u in uids] == [3, 3, 3]


def test_restore_takes_the_like_trees_dtype_and_checks_shapes(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3), "b": (torch.ones(2, dtype=torch.bfloat16),
                                                                        torch.tensor(True))}
    path = save(str(tmp_path / "t.ckpt"), tree)
    like = {"a": torch.zeros(2, 3, dtype=torch.float64), "b": (torch.zeros(2), torch.tensor(False))}
    back = restore(path, like)
    assert back["a"].dtype == torch.float64 and back["a"].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert back["b"][0].dtype == torch.float32 and back["b"][0].tolist() == [1.0, 1.0] and bool(back["b"][1])
    with pytest.raises(ValueError, match="shape|leaf"):
        restore(path, {"a": torch.zeros(3, 2), "b": like["b"]})
    with pytest.raises(ValueError, match="structure"):
        restore(path, {"a": like["a"]})
    assert latest_checkpoint(str(tmp_path)) is None and latest_checkpoint(str(tmp_path / "none")) is None
    save(str(tmp_path / "ckpt_3.ckpt"), tree)
    save(str(tmp_path / "ckpt_12.ckpt"), tree)
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_12.ckpt")


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_a_corrupt_payload_fails_validation_and_is_walked_past(tmp_path, mode):
    eng = SlotEngine(K_max=32, k_cap=4, buckets=(4,), device="cpu")
    uid = eng.admit(JobSpec(K=32, k=4, seed=3))
    rng = np.random.default_rng(5)
    plan = FaultPlan(corrupt_checkpoints=(1,), corrupt_mode=mode)  # the second write
    stems = []
    for step in (1, 2):
        eng.tick([(uid, rng.integers(-1, 1, 32))])
        stems.append(save_server(str(tmp_path), eng, step=step, faults=plan))
    assert plan.fired()["corrupt"] == 1
    assert validate_stem(stems[0]) and not validate_stem(stems[1])
    assert latest_server_checkpoint(str(tmp_path)) == stems[0]
    restored, step = load_server(stems[0], device="cpu")
    assert step == 1 and restored.job_round(uid) == 1


def test_a_jax_stem_is_refused_with_the_a2_error(tmp_path):
    jeng = JSlotEngine(K_max=32, k_cap=4, buckets=(4,))
    uid = jeng.admit(JJobSpec(K=32, k=4, seed=1))
    jeng.tick([(uid, np.zeros(32, np.int32))])
    stem = jsave_server(str(tmp_path), jeng, step=1)
    assert validate_stem(stem)  # the sidecar's digest holds: the stem is intact, only foreign
    with pytest.raises(ValueError, match="JAX package.*jax_format.read.*load_server"):
        restore(stem + ".ckpt", like={})
    with open(tmp_path / "junk.ckpt", "wb") as f:
        f.write(b"not a checkpoint")
    with pytest.raises(ValueError, match="magic"):
        restore(str(tmp_path / "junk.ckpt"), like={})


def test_a_jax_stem_loads_through_load_server_on_the_jax_stream(tmp_path):
    jeng = JSlotEngine(K_max=32, k_cap=4, buckets=(4,))
    uid = jeng.admit(JJobSpec(K=32, k=4, seed=1))
    jeng.tick([(uid, np.zeros(32, np.int32))])
    stem = jsave_server(str(tmp_path), jeng, step=1)
    restored, step = load_server(stem, device="cpu")
    assert step == 1 and restored.stream == "jax" and restored.job_round(uid) == 1


def test_the_codec_timing_command_reads_every_case_back(capsys):
    codec_times.main(["--device", "cpu", "--K", "4096", "--rounds", "3"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[ckpt-codec]")]
    rows = [dict(kv.split("=") for kv in ln.split()[1:]) for ln in lines]
    assert [(r["arrays"], r["codec"]) for r in rows] == [
        (a, c) for a in ("served", "dense") for c in ("raw", "zlib:1", "zlib:6")]
    assert len({r["raw_bytes"] for r in rows}) == 1
    raw = {r["arrays"]: int(r["file_bytes"]) for r in rows if r["codec"] == "raw"}
    assert all(int(r["file_bytes"]) < raw[r["arrays"]] for r in rows if r["codec"] != "raw")
