"""The paper's own FL workloads (§VI-A "Datasets and network structure"),
the port of ``repro.models.cnn``.

* EMNIST-Letter net: two 5x5 conv layers (10 channels each) + 2x2 max-pool,
  FC 1280 -> 256 -> 26 softmax.
* CIFAR-10 net: two 5x5 conv layers (64 channels each) + 2x2 max-pool,
  FC 384 -> 192 -> 10 softmax.

Layout.  Batches arrive NHWC, as ``data.ClientStore`` serves them and the
JAX package computes; ``cnn_forward`` permutes them to NCHW as a view (a
channels-last tensor, which cuDNN takes as it is).  The conv kernels are
stored OIHW, PyTorch's layout (the JAX package's are HWIO:
``convert.cnn_params_from_jax`` permutes them).  ``fc1``'s rows keep the JAX
package's flatten order, ``(H/4, W/4, C)``: the pooled activation is
permuted back to NHWC before the flatten (a view again when it is channels
last), so the dense weights cross between packages unchanged.  A 5x5
stride-1 SAME conv is a symmetric padding of 2; the pool is VALID 2x2
(28 -> 14 -> 7, 32 -> 16 -> 8); the biases are added after each conv and
dense product, as in JAX.

``fp32_convs()`` scopes cuDNN to IEEE float32 (no TF32) for the FL round.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ParamBuilder

__all__ = ["CNN_SHAPES", "PaperCNN", "cnn_init", "cnn_forward", "cnn_param_shapes", "fp32_convs"]

# dataset image shapes (H, W, C) and fc sizes per paper
CNN_SHAPES = {
    "emnist-cnn": dict(img=(28, 28, 1), ch=10, fc1=1280, fc2=256, classes=26),
    "cifar-cnn": dict(img=(32, 32, 3), ch=64, fc1=384, fc2=192, classes=10),
}


def _spec(cfg):
    return CNN_SHAPES[cfg.name.replace("-smoke", "")]


def cnn_param_shapes(cfg) -> dict:
    """``name -> (shape, fan_in)`` in the order the parameters are made;
    ``fan_in`` is None for a bias (zeros)."""
    s = _spec(cfg)
    H, W, C = s["img"]
    ch = s["ch"]
    flat = (H // 4) * (W // 4) * ch  # two 2x2 pools after SAME convs
    return {
        "conv1": ((ch, C, 5, 5), 5 * 5 * C),
        "b1": ((ch,), None),
        "conv2": ((ch, ch, 5, 5), 5 * 5 * ch),
        "b2": ((ch,), None),
        "fc1": ((flat, s["fc1"]), flat),
        "fb1": ((s["fc1"],), None),
        "fc2": ((s["fc1"], s["fc2"]), s["fc1"]),
        "fb2": ((s["fc2"],), None),
        "head": ((s["fc2"], s["classes"]), s["fc2"]),
        "hb": ((s["classes"],), None),
    }


def cnn_init(rng, cfg):
    """``(params, specs)``: weights normal at ``1/sqrt(fan_in)``, biases
    zero, drawn from ``rng`` (a ``core.prng.Key``: the reference's values)
    on its device.  A conv kernel is drawn in the reference's HWIO layout,
    then laid out OIHW."""
    pb = ParamBuilder(rng, torch.float32)
    for name, (shape, fan_in) in cnn_param_shapes(cfg).items():
        axes = (None,) * len(shape)
        if fan_in is None:
            pb.p(name, shape, axes, init="zeros")
        elif len(shape) == 4:
            o, i, h, w = shape
            pb.params[name] = pb.p(name, (h, w, i, o), axes, fan_in=fan_in).permute(3, 2, 0, 1).contiguous()
        else:
            pb.p(name, shape, axes, fan_in=fan_in)
    return pb.params, pb.specs


def _pool(x):
    return F.max_pool2d(x, 2, 2)


def cnn_forward(params, cfg, batch):
    """batch: {'x': (B,H,W,C), 'y': (B,) int}. Returns logits (B, classes)."""
    x = batch["x"].permute(0, 3, 1, 2)
    h = F.conv2d(x, params["conv1"], padding=2)
    h = _pool(F.relu(h + params["b1"][:, None, None]))
    h = F.conv2d(h, params["conv2"], padding=2)
    h = _pool(F.relu(h + params["b2"][:, None, None]))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # the JAX package's (H, W, C) flatten
    h = F.relu(h @ params["fc1"] + params["fb1"])
    h = F.relu(h @ params["fc2"] + params["fb2"])
    return h @ params["head"] + params["hb"]


class PaperCNN(nn.Module):
    """The paper's CNN as a module: its parameters are named as the JAX
    package's (``conv1``, ``b1``, ..., ``head``, ``hb``) and its forward is
    ``cnn_forward`` of an NHWC image batch.  ``params=None`` makes them on
    the meta device, a frame for ``torch.func.functional_call``."""

    def __init__(self, cfg, params=None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = {n: torch.empty(shape, device="meta") for n, (shape, _) in cnn_param_shapes(cfg).items()}
        for name, v in params.items():
            self.register_parameter(name, nn.Parameter(v))

    def forward(self, x):
        return cnn_forward(dict(self.named_parameters()), self.cfg, {"x": x})


@contextmanager
def fp32_convs():
    """cuDNN convolutions in IEEE float32 inside the block (PyTorch lets
    cuDNN use TF32 by default; the reference computes in float32).  The
    other cuDNN flags keep their values, and all are restored after it."""
    c = torch.backends.cudnn
    with c.flags(enabled=c.enabled, benchmark=c.benchmark, deterministic=c.deterministic, allow_tf32=False):
        yield
