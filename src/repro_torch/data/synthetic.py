"""Synthetic datasets (offline container: no downloads).

* ``image_dataset`` - FMNIST-shaped (28x28, C classes) class-conditional
  Gaussian-blob images: each class has a random prototype; samples are
  prototype + noise.  Linearly-separable enough for the paper's SVM
  experiments while remaining non-trivial.
* ``token_dataset`` - LM token streams from a seeded Zipfian bigram chain
  (so there is actual structure to learn for transformer examples).
* ``token_windows`` - slices a token stream into fixed-length next-token
  classification rows, the layout the ``tiny_transformer`` ModelSpec
  consumes through the same (x, y) batch plumbing as the image models.
"""
from __future__ import annotations

import math

import numpy as np


def image_dataset(
    n: int,
    *,
    n_classes: int = 10,
    dim: int = 784,
    noise: float = 0.6,
    seed: int = 0,
    proto_seed: int = 1234,
    smooth: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (x (n, dim) float32 in ~[0,1], y (n,) int32).

    Class prototypes come from ``proto_seed`` (fixed across train/test splits
    so the task is consistent); ``seed`` controls sampling/noise.

    ``smooth > 0`` box-blurs the prototypes over the (side, side) image grid
    (window 2*smooth+1 per axis, contrast renormalized), giving the images
    the local spatial correlation conv/pooling models need -- iid per-pixel
    prototypes carry no neighborhood signal, so a CNN is structurally
    handicapped on them while any linear model saturates.  ``smooth=0`` (the
    default) is bit-identical to the historical stream; the labels ``y`` are
    drawn before the blur touches anything, so they match across smooth
    settings."""
    rng = np.random.default_rng(seed)
    protos = np.random.default_rng(proto_seed).normal(
        0.5, 0.35, size=(n_classes, dim)).astype(np.float32)
    if smooth:
        side = math.isqrt(dim)
        if side * side != dim:
            raise ValueError(f"smooth needs a square dim (got dim={dim})")
        p = protos.reshape(n_classes, side, side).astype(np.float64)
        k = np.ones(2 * smooth + 1) / (2 * smooth + 1)
        for ax in (1, 2):
            p = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax, p)
        p = 0.5 + (p - p.mean()) * (0.35 / p.std())  # undo the blur's contrast loss
        protos = p.reshape(n_classes, dim).astype(np.float32)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = protos[y] + rng.normal(0.0, noise, size=(n, dim)).astype(np.float32)
    return np.clip(x, 0.0, 1.0).astype(np.float32), y


def token_dataset(n_tokens: int, *, vocab: int = 512, seed: int = 0) -> np.ndarray:
    """Zipfian bigram stream: P(next | cur) concentrated on a few successors.

    The reference's stream, token for token.  Its ``rng.choice(vocab,
    p=zipf)`` is numpy's inverse-CDF draw: ``cdf = p.cumsum(); cdf /=
    cdf[-1]`` and ``cdf.searchsorted(rng.random(), side="right")``.  Here
    the CDF is built once instead of at every draw, the same numbers from
    the same generator state, ~50x faster at a vocabulary of 49152."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, 4))
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    zipf = (1.0 / ranks) / (1.0 / ranks).sum()
    cdf = zipf.cumsum()
    cdf /= cdf[-1]
    out = np.empty(n_tokens, dtype=np.int32)
    cur = int(rng.integers(0, vocab))
    for i in range(n_tokens):
        out[i] = cur
        if rng.random() < 0.75:
            cur = int(succ[cur, rng.integers(0, 4)])
        else:
            cur = int(cdf.searchsorted(rng.random(), side="right"))
    return out


def token_windows(
    stream: np.ndarray, seq_len: int, *, stride: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Next-token windows over a token stream: returns
    (x (n, seq_len) int32, y (n,) int32) where ``y[i]`` is the token that
    follows window i.  With vocab == n_classes these are ordinary
    classification rows, so the ``tiny_transformer`` ModelSpec (last-
    position logits) rides the identical partition/batch/eval plumbing as
    the image models.  ``stride`` defaults to ``seq_len`` (disjoint
    windows)."""
    stream = np.asarray(stream, np.int32)
    stride = seq_len if stride is None else int(stride)
    n = (len(stream) - seq_len - 1) // stride + 1
    if n <= 0:
        raise ValueError(
            f"stream of {len(stream)} tokens is too short for "
            f"seq_len={seq_len} next-token windows")
    starts = np.arange(n, dtype=np.int64) * stride
    x = stream[starts[:, None] + np.arange(seq_len)[None, :]]
    y = stream[starts + seq_len]
    return np.ascontiguousarray(x), np.ascontiguousarray(y)
