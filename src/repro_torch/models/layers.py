"""Shared building blocks, the port of ``repro.models.layers``: the parameter
factory, norms, MLPs, RoPE / M-RoPE and sinusoidal positions.

Each function keeps the reference's casts: norms and RoPE compute in float32
and cast back to the input's dtype; everything else computes in its inputs'
dtype.  ``fp32_matmuls()`` scopes float32 matmuls to IEEE float32 (no TF32)
on the card, as ``cnn.fp32_convs`` scopes cuDNN.
"""
from __future__ import annotations

import itertools
import math
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.core.prng import Key

from .sharding import einsum, shard

__all__ = [
    "ParamBuilder",
    "rmsnorm",
    "layernorm",
    "norm_init",
    "norm_apply",
    "mlp_init",
    "mlp_apply",
    "rope_freqs",
    "apply_rope",
    "apply_mrope",
    "sinusoidal_positions",
    "fp32_matmuls",
]


class ParamBuilder:
    """Creates parameters and records their logical sharding axes.

    ``pb = ParamBuilder(rng, dtype)`` then
    ``w = pb.p("wq", (d, H, hd), ("embed", "q_heads", "head_dim"), fan_in=d)``.
    ``pb.params`` / ``pb.specs`` hold mirrored dicts, on ``device`` (the
    ``rng``'s unless given).  On the ``meta`` device nothing is drawn: the
    tree has its shapes and dtypes and no memory.

    ``rng`` is a ``core.prng.Key``: the JAX package's draws.  Each random
    parameter, and each child, takes the builder's next count ``n`` and the
    key ``fold_in(rng, n)``; a parameter is ``prng.normal(key, shape)``
    cast to ``dtype`` and then scaled in ``dtype``, as the reference's
    builder does it.  ``child(name, fold=f)`` takes ``fold_in(rng, f)``
    instead and leaves the count alone (the reference's segment and
    encoder/decoder keys).  A ``torch.Generator`` draws ``torch.randn`` in
    the order the parameters are made instead (the port's Philox stream;
    a caller asks for it by passing one).

    ``stack=n`` makes every parameter a stack of ``n`` layers, ``(n, *shape)``
    with ``"layers"`` first in its axes, as the reference's ``vmap``-ed init
    does: layer ``i`` draws under the reference's ``split(rng, n)[i]`` first
    (in partitionable mode ``fold_in(rng, i)``; in the original mode the n
    keys of one split, made once per instance), then the counts.  A stack, and
    the leading ``experts`` axis of an MoE weight, is drawn one block at a
    time in float32 (a block of JAX's one draw: ``prng.normal(..., start=,
    total=)``) and written into the preallocated tensor in ``dtype``: no
    whole stack is ever held in float32.
    """

    def __init__(self, rng, dtype=torch.float32, device=None, stack: int = 0, path: Tuple[int, ...] = ()):
        self.rng = rng
        self.device = torch.device(device) if device is not None else rng.device
        self.dtype = dtype
        self.stack = stack
        self.path = tuple(path)  # the folds after a stack's layer index, on a Key
        self.params: Dict = {}
        self.specs: Dict = {}
        self._n = 0
        self._layers = None  # split(rng, stack), made at the first layer's key

    def _jax(self) -> bool:
        return isinstance(self.rng, Key)

    def _next(self) -> Tuple[int, ...]:
        self._n += 1
        return self.path + (self._n,)

    def _key(self, path: Tuple[int, ...], layer: Optional[int] = None) -> Key:
        key = self.rng
        if layer is not None:
            if self._layers is None:
                self._layers = prng.split(self.rng, self.stack)
            key = self._layers[layer]
        for d in path:
            key = prng.fold_in(key, d)
        return key

    def _fill(self, dst: torch.Tensor, key, std: float, experts: bool) -> None:
        """``dst`` (one layer) from ``key``, an expert at a time when
        ``experts``: JAX's ``normal(key, shape).astype(dtype) * std``."""
        scale = torch.tensor(std, dtype=self.dtype, device=self.device)
        if not experts:
            dst.copy_(prng.normal(key, tuple(dst.shape)).to(self.dtype) * scale)
            return
        block = math.prod(dst.shape[1:])
        for e in range(dst.shape[0]):
            dst[e] = prng.normal(key, tuple(dst.shape[1:]), start=e * block, total=dst.numel()).to(self.dtype) * scale

    def _normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.rng, dtype=torch.float32, device=self.device).to(self.dtype)

    def p(self, name, shape, axes, init="normal", fan_in=None, scale=None):
        assert len(shape) == len(axes), (name, shape, axes)
        full = ((self.stack,) if self.stack else ()) + tuple(shape)
        if init == "zeros":
            v = torch.zeros(full, dtype=self.dtype, device=self.device)
        elif init == "ones":
            v = torch.ones(full, dtype=self.dtype, device=self.device)
        elif init in ("normal", "embed"):
            if init == "normal":
                std = scale if scale is not None else 1.0 / math.sqrt(fan_in or shape[0])
            else:
                std = scale or 0.02
            v = torch.empty(full, dtype=self.dtype, device=self.device)
            experts = bool(axes) and axes[0] == "experts"
            if self._jax():
                path = self._next()
                if self.device.type != "meta":
                    for layer in range(self.stack) if self.stack else (None,):
                        self._fill(v if layer is None else v[layer], self._key(path, layer), std, experts)
            elif self.device.type != "meta":
                lead = (1 if self.stack else 0) + (1 if experts else 0)
                for idx in itertools.product(*(range(n) for n in full[:lead])):
                    v[idx] = self._normal(full[lead:]) * std
        else:
            raise ValueError(init)
        self.params[name] = v
        self.specs[name] = (("layers",) if self.stack else ()) + tuple(axes)
        return v

    def child(self, name, stack: Optional[int] = None, fold: Optional[int] = None) -> "ParamBuilder":
        """A builder of parameters nested under ``name`` (kept apart when
        ``name`` is None): its key is the next count's, or ``fold_in(rng,
        fold)`` with ``fold``; ``stack`` starts a stack (``fold`` given, this
        builder unstacked: the reference's ``split(fold_in(rng, fold), n)``)."""
        stack = self.stack if stack is None else stack
        if not self._jax():
            pb = ParamBuilder(self.rng, self.dtype, self.device, stack)
        elif fold is None:
            if stack != self.stack:
                raise ValueError("a stack starts from a fold of its own (child(..., fold=))")
            pb = ParamBuilder(self.rng, self.dtype, self.device, stack, self._next())
        elif self.stack:
            raise ValueError("a stacked builder's children take its counts, not folds")
        else:
            pb = ParamBuilder(self._key(self.path + (int(fold),)), self.dtype, self.device, stack)
        if name is not None:
            self.params[name] = pb.params
            self.specs[name] = pb.specs
        return pb


@contextmanager
def fp32_matmuls():
    """CUDA float32 matmuls in IEEE float32 inside the block (no TF32; the
    reference computes in float32); the flag is restored after it."""
    m = torch.backends.cuda.matmul
    prev = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = prev


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5, plus_one: bool = False) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    g = w.to(torch.float32)
    if plus_one:
        g = 1.0 + g
    return (y * g).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(dt)


def norm_init(pb: ParamBuilder, name: str, d: int, kind: str):
    if kind == "rmsnorm":
        pb.p(name, (d,), ("embed",), init="ones")
    else:
        pb.p(name + "_w", (d,), ("embed",), init="ones")
        pb.p(name + "_b", (d,), ("embed",), init="zeros")


def norm_apply(params, name: str, x, kind: str, eps: float, plus_one: bool = False):
    if kind == "rmsnorm":
        return rmsnorm(x, params[name], eps, plus_one)
    return layernorm(x, params[name + "_w"], params[name + "_b"], eps)


# ---------------------------------------------------------------- MLP ------


def mlp_init(pb: ParamBuilder, d: int, d_ff: int, act: str):
    gated = act in ("silu", "geglu")
    if gated:
        pb.p("w_in", (d, 2, d_ff), ("mlp_embed", None, "mlp"), fan_in=d)
    else:
        pb.p("w_in", (d, d_ff), ("mlp_embed", "mlp"), fan_in=d)
    pb.p("w_out", (d_ff, d), ("mlp", "mlp_embed"), fan_in=d_ff)


def gated_act(g: torch.Tensor, act: str) -> torch.Tensor:
    """The gate's activation: SiLU, or GELU (tanh form, the reference's
    ``approximate=True``) for GeGLU."""
    return F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")


def plain_act(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    if act == "sqrelu":
        r = F.relu(h)
        return r * r
    raise ValueError(act)


def mlp_apply(p, x: torch.Tensor, act: str) -> torch.Tensor:
    """x: (..., d) -> (..., d).  Gated (SiLU/GeGLU) or plain (GELU/sqReLU)."""
    if act in ("silu", "geglu"):
        h = einsum("...d,dgf->...gf", x, p["w_in"])
        h = gated_act(h[..., 0, :], act) * h[..., 1, :]
    else:
        h = plain_act(einsum("...d,df->...f", x, p["w_in"]), act)
    h = shard(h, *((None,) * (h.dim() - 1)), "mlp")
    return einsum("...f,fd->...d", h, p["w_out"])


# ---------------------------------------------------------------- RoPE -----


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # float32 theta to float32 exponents, as the reference; a Python base
    # (not a device tensor built from one: that is a blocking host copy)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def _rotate(x, cos, sin):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (B,S,hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return _rotate(x.to(torch.float32), cos, sin).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float, sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: (B, S, H, hd); positions3: (3, B, S) — temporal/height/width position
    ids; ``sections`` gives the number of frequency *pairs* taken from each
    component (sum == hd/2).
    """
    hd = x.shape[-1]
    assert sum(sections) * 2 == hd, (sections, hd)
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    # component id per frequency pair: [0]*s0 + [1]*s1 + [2]*s2
    comp = torch.cat([torch.full((n,), i, dtype=torch.int64, device=x.device) for i, n in enumerate(sections)])
    pos_sel = torch.movedim(positions3.to(torch.float32), 0, -1)[..., comp]  # (B, S, hd/2)
    ang = pos_sel * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return _rotate(x.to(torch.float32), cos, sin).to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (n, d)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    out = torch.zeros((n, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out
