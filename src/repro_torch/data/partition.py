"""Non-iid federated partitioners (paper Sec. IV-A: "each device only
contains samples of the data set from a subset of the labels").

* ``by_labels``  - exactly L labels per device (paper: 1 for FMNIST, 3 for
  FEMNIST); labels assigned round-robin so every label is covered.
* ``dirichlet``  - label-proportions drawn from Dir(alpha) per device
  (standard FL benchmark partitioner), alpha -> 0 = extreme skew.
"""
from __future__ import annotations

import numpy as np


def by_labels(
    y: np.ndarray, m: int, labels_per_device: int, *, seed: int = 0
) -> list[np.ndarray]:
    """Vectorized and memory-lean: the per-sample device assignment is
    computed in flat numpy arrays and grouped with one lexsort, instead of
    growing m Python lists of boxed ints -- at m >= 16384 fleets the old
    path's list overhead (~10x the index bytes) dominated host staging.
    Realization-identical to the original loop: same per-class permutation
    draws in the same order, same round-robin holders, same strided shards.
    """
    rng = np.random.default_rng(seed)
    y = np.asarray(y)
    classes = np.unique(y)
    n_classes = len(classes)
    L = labels_per_device
    idx_by_class = [rng.permutation(np.nonzero(y == c)[0]) for c in classes]
    # round-robin label assignment: device i gets labels [i*L .. i*L+L) mod C;
    # holders of class c listed in (device, label-slot) iteration order
    class_of_slot = (np.arange(m, dtype=np.int64)[:, None] * L
                     + np.arange(L, dtype=np.int64)[None, :]) % n_classes
    slot_dev = np.repeat(np.arange(m, dtype=np.int64), L)
    order = np.argsort(class_of_slot.ravel(), kind="stable")
    holders = np.split(slot_dev[order],
                       np.searchsorted(class_of_slot.ravel()[order],
                                       np.arange(1, n_classes)))
    dev_chunks: list[np.ndarray] = []
    idx_chunks: list[np.ndarray] = []
    for ci in range(n_classes):
        idx_c, h = idx_by_class[ci], holders[ci]
        if h.size == 0 or idx_c.size == 0:
            continue
        # sample t of the class permutation lands in shard t % n_holders,
        # i.e. exactly the old idx_c[shard::n_holders] strided slices
        dev_chunks.append(h[np.arange(idx_c.size, dtype=np.int64) % h.size])
        idx_chunks.append(idx_c)
    if not dev_chunks:
        return [np.empty(0, np.int64) for _ in range(m)]
    dev = np.concatenate(dev_chunks)
    idx = np.concatenate(idx_chunks).astype(np.int64)
    grouped = np.lexsort((idx, dev))  # per device, ascending sample indices
    bounds = np.cumsum(np.bincount(dev, minlength=m))[:-1]
    return np.split(idx[grouped], bounds)


def dirichlet(y: np.ndarray, m: int, alpha: float, *, seed: int = 0) -> list[np.ndarray]:
    """Vectorized like ``by_labels``: flat device assignments grouped by one
    lexsort instead of m Python lists of boxed ints (the list overhead
    dominated host staging at m >= 16384 fleets).  Realization-identical to
    ``dirichlet_reference``: same per-class (permutation, Dir(alpha)) draw
    order, same floor-of-cumsum cuts, so every sample lands on the same
    device; the final per-device sort matches ``sorted()`` on int indices."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    dev_chunks: list[np.ndarray] = []
    idx_chunks: list[np.ndarray] = []
    for c in classes:
        idx = rng.permutation(np.nonzero(y == c)[0])
        props = rng.dirichlet(alpha * np.ones(m))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        # np.split(idx, cuts) gives device d the slice [cuts[d-1], cuts[d]):
        # position t's device is the count of cut points <= t
        dev_chunks.append(np.searchsorted(cuts, np.arange(len(idx)),
                                          side="right"))
        idx_chunks.append(idx)
    if not idx_chunks:
        return [np.empty(0, np.int64) for _ in range(m)]
    dev = np.concatenate(dev_chunks)
    idx = np.concatenate(idx_chunks).astype(np.int64)
    grouped = np.lexsort((idx, dev))  # per device, ascending sample indices
    bounds = np.cumsum(np.bincount(dev, minlength=m))[:-1]
    return np.split(idx[grouped], bounds)


def dirichlet_reference(y: np.ndarray, m: int, alpha: float, *, seed: int = 0) -> list[np.ndarray]:
    """The original per-device list-growing loop, retained as the
    realization oracle for ``dirichlet`` (tests/test_partition.py)."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    parts: list[list[int]] = [[] for _ in range(m)]
    for c in classes:
        idx = rng.permutation(np.nonzero(y == c)[0])
        props = rng.dirichlet(alpha * np.ones(m))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for dev, sl in enumerate(np.split(idx, cuts)):
            parts[dev].extend(sl.tolist())
    return [np.asarray(sorted(p), dtype=np.int64) for p in parts]


def heterogeneity_delta(x: np.ndarray, y: np.ndarray, parts: list[np.ndarray], n_classes: int) -> float:
    """Empirical proxy for the paper's Assumption-5 delta: max_i distance of
    device i's label distribution from the global one (total variation)."""
    global_p = np.bincount(y, minlength=n_classes) / len(y)
    worst = 0.0
    for p in parts:
        if len(p) == 0:
            continue
        local = np.bincount(y[p], minlength=n_classes) / len(p)
        worst = max(worst, 0.5 * float(np.abs(local - global_p).sum()))
    return worst
