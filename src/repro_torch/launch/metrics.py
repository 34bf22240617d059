"""Per-device counts of a program, the port's counterpart of
``repro.launch.metrics``, and the closed-form attention cost.

JAX's ``corrected_metrics`` exists because ``compiled.cost_analysis()``
counts each ``while`` (scan) body once: its proof programs scan over layers
and chunks, so it compiles unrolled variants of one to three layers and
extrapolates.  Eager PyTorch has no scan: the port's model runs every layer
and every attention chunk as its own operations, and a counter that sees
each operation counts the whole program.  So there is no extrapolation
here; ``ProgramCounter`` counts what ran, on each rank's local shards:

* FLOPs with ``torch.utils.flop_counter``'s formulas (``flop_registry``,
  what ``FlopCounterMode`` counts: the matmuls), in place of
  ``cost_analysis()["flops"]``;
* bytes accessed: each operation's input and output bytes.  Eager PyTorch
  runs unfused, so an elementwise chain reads and writes every
  intermediate: this is not comparable with XLA's fused count;
* collectives (``launch.comms``);
* the peak of live storage bytes, by category, in place of
  ``memory_analysis()``: ``parameters``, ``optimizer`` and ``inputs``
  (registered before the step), ``activations`` (storage a forward made:
  what autograd keeps for the backward, and the forward's intermediates and
  outputs) and ``temporaries`` (storage a backward made: gradients and
  rematerialised layers).  A storage counts from the operation that made it
  to its release.

The counter lets DTensor run first (``NotImplemented`` for DTensor
arguments), so it sees each rank's local operations and its collectives.
DTensor's sharding propagation runs the same operations on fake tensors of
the global shapes to learn an output's shape; those are not the program's,
and the counter skips every operation issued from inside it.
"""
from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import InputShape, ModelConfig

from .comms import CollectiveTally, collective_kind

__all__ = ["attention_analytic", "model_flops", "ProgramCounter"]

_PROPAGATION = "tensor/_sharding_prop.py"  # DTensor's sharding propagation (its fake runs)
_META = {"size", "stride", "sym_size", "sym_stride", "dim", "numel", "sym_numel", "is_contiguous",
         "storage_offset", "sym_storage_offset", "device", "layout"}


def _in_propagation(depth: int = 48) -> bool:
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ProgramCounter(TorchDispatchMode):
    """``with ProgramCounter() as c: step()`` then ``c.summary()``.
    ``c.register(tree, "parameters")`` first counts a tree's storages as
    held; the peak is taken over the block."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.ops: Dict[str, int] = defaultdict(int)
        self.comms = CollectiveTally()
        self._live: Dict[int, list] = {}  # storage key -> [bytes, category]
        self._by_cat: Dict[str, float] = defaultdict(float)
        self.held_at_start = 0.0
        self.peak = 0.0
        self.peak_by_category: Dict[str, float] = {}

    # -- memory ---------------------------------------------------------------

    def _storage(self, t: torch.Tensor):
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t._local_tensor
        return t.untyped_storage()

    def _track(self, t: torch.Tensor, category: str) -> None:
        st = self._storage(t)
        key = st._cdata
        if key in self._live:
            return
        n = float(st.nbytes())
        self._live[key] = [n, category]
        self._by_cat[category] += n
        weakref.finalize(st, self._free, key)
        total = sum(self._by_cat.values())
        if total > self.peak:
            self.peak = total
            self.peak_by_category = dict(self._by_cat)

    def _free(self, key: int) -> None:
        entry = self._live.pop(key, None)
        if entry is not None:
            self._by_cat[entry[1]] -= entry[0]

    def register(self, tree, category: str) -> None:
        """Count every tensor storage of ``tree`` as live in ``category``."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._track(t, category)
        self.held_at_start = sum(self._by_cat.values())

    # -- dispatch ---------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if name in _META or _in_propagation():
            return out
        self.ops[name] += 1
        kind = collective_kind(func)
        if kind is not None:
            self.comms.add(kind, out)
        else:
            from torch.utils.flop_counter import flop_registry

            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += float(formula(*args, **kwargs, out_val=out))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes_accessed += float(sum(_nbytes(t) for t in ins + outs))
        category = "activations" if torch._C._current_autograd_node() is None else "temporaries"
        for t in outs:
            self._track(t, category)
        return out

    def summary(self) -> Dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collectives": self.comms.summary(),
            "peak_bytes": self.peak,
            "peak_above_start": self.peak - self.held_at_start,
            "held_at_start": self.held_at_start,
            "peak_by_category": dict(self.peak_by_category),
            "n_ops": int(sum(self.ops.values())),
        }


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """The useful FLOPs of a step, ``6 N_active`` a trained token and ``2
    N_active`` a served one, as the JAX dry run counts them."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    return float((6 if shape.kind == "train" else 2) * cfg.n_active_params() * tokens)


def attention_analytic(cfg: ModelConfig, shape: InputShape, n_chips: int, window: int = 0) -> Dict[str, float]:
    """Closed-form quadratic-attention FLOPs + flash-style bytes per device
    (the JAX package's; its dry run adds them for chunked prefill, whose
    inner scans ``cost_analysis`` counts once)."""
    B, S = shape.global_batch, shape.seq_len
    W = min(window, S) if window else S
    if cfg.family == "ssm":
        return {"flops": 0.0, "bytes": 0.0}
    hd = cfg.resolved_head_dim
    if cfg.attn == "mla":
        H = cfg.n_heads
        dqk = cfg.kv_lora_rank + cfg.qk_rope_head_dim  # absorbed scores
        dv = cfg.kv_lora_rank
        per_layer = 2.0 * B * S * (W / 2 if not window else W) * H * (dqk + dv)
        n_attn = cfg.n_layers
    elif cfg.family == "hybrid":
        H = cfg.n_heads
        per_layer = 2.0 * B * S * (W / 2 if not window else W) * H * (2 * hd)
        n_attn = cfg.n_layers // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 0
    else:
        H = cfg.n_heads
        per_layer = 2.0 * B * S * (W / 2 if not window else W) * H * (2 * hd)
        n_attn = cfg.n_layers + (cfg.n_enc_layers if cfg.family == "encdec" else 0)
    flops = per_layer * n_attn
    # flash-style HBM traffic: Q read once, K/V streamed once per q-pass
    kv_dim = cfg.n_kv_heads * hd if cfg.attn != "mla" else (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    bytes_ = n_attn * B * S * (2 * H * hd + 2 * kv_dim) * 2.0
    return {"flops": flops / n_chips, "bytes": bytes_ / n_chips}
