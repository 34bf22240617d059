"""Synthetic datasets with the *statistical structure* the paper's
experiments rely on (nothing is downloaded; numpy, a copy of
``repro.data.synthetic``, so a seed gives the JAX package's arrays).

``make_image_dataset`` draws class-conditional images: each class c gets a
random smooth prototype ``mu_c``; samples are ``mu_c + noise`` pushed through
a mild nonlinearity.  A CNN can genuinely learn this task (accuracy rises
from chance to >90%), and *biased client selection measurably hurts*: under
the primary-label partition, a model trained on a subset of clients overfits
their primary classes — exactly the mechanism behind the paper's Fig. 1/
fairness story.

``make_lm_dataset`` draws token streams from a per-client mixture of k-gram
Markov chains, giving the LM-scale FL runs heterogeneous local distributions.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["make_image_dataset", "make_lm_dataset"]


def make_image_dataset(
    n_classes: int,
    img_shape: Tuple[int, int, int],
    n_train: int,
    n_test: int,
    seed: int = 0,
    noise: float = 0.9,
) -> Dict[str, np.ndarray]:
    """Returns {'x': (N,H,W,C), 'y': (N,), 'x_test', 'y_test'} float32/int32."""
    rng = np.random.default_rng(seed)
    H, W, C = img_shape
    # smooth prototypes: low-frequency random fields per class
    base = rng.normal(size=(n_classes, H // 4 + 1, W // 4 + 1, C)).astype(np.float32)
    protos = np.stack([_upsample(b, H, W) for b in base])  # (n_classes, H, W, C)
    protos /= protos.std(axis=(1, 2, 3), keepdims=True) + 1e-6

    def draw(n):
        y = rng.integers(0, n_classes, n).astype(np.int32)
        x = protos[y] + noise * rng.normal(size=(n, H, W, C)).astype(np.float32)
        x = np.tanh(x)
        return x.astype(np.float32), y

    x, y = draw(n_train)
    xt, yt = draw(n_test)
    return {"x": x, "y": y, "x_test": xt, "y_test": yt}


def _upsample(b: np.ndarray, H: int, W: int) -> np.ndarray:
    """Bilinear-ish upsample of a coarse field to (H, W, C)."""
    h0, w0, C = b.shape
    yi = np.linspace(0, h0 - 1, H)
    xi = np.linspace(0, w0 - 1, W)
    y0 = np.floor(yi).astype(int)
    x0 = np.floor(xi).astype(int)
    y1 = np.minimum(y0 + 1, h0 - 1)
    x1 = np.minimum(x0 + 1, w0 - 1)
    fy = (yi - y0)[:, None, None]
    fx = (xi - x0)[None, :, None]
    out = (
        b[y0][:, x0] * (1 - fy) * (1 - fx)
        + b[y0][:, x1] * (1 - fy) * fx
        + b[y1][:, x0] * fy * (1 - fx)
        + b[y1][:, x1] * fy * fx
    )
    return out.astype(np.float32)


def make_lm_dataset(vocab: int, n_tokens: int, n_chains: int = 8, seed: int = 0) -> np.ndarray:
    """Token stream from a mixture of sparse bigram chains (heterogeneous)."""
    rng = np.random.default_rng(seed)
    out = np.empty(n_tokens, np.int32)
    # sparse transition tables: each token can go to 16 candidates
    cands = rng.integers(0, vocab, (n_chains, min(vocab, 4096), 16))
    t = int(rng.integers(0, vocab))
    chain = int(rng.integers(0, n_chains))
    for i in range(n_tokens):
        if rng.random() < 0.001:
            chain = int(rng.integers(0, n_chains))
        row = cands[chain, t % cands.shape[1]]
        t = int(row[rng.integers(0, 16)])
        out[i] = t
    return out
