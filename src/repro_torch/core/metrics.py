"""Paper Sec. IV metrics (host numpy; the port's copy of
``repro.core.metrics``).

Resource-utilization score at iteration k (Sec. IV-A):

    (1/m) sum_i ( sum_j v_ij^(k) / d_i^(k) ) * rho_i * n

With rho_i = 1/b_i this equals the average transmission time
(1/m) sum_i (sum_j v_ij / d_i) * n / b_i.
"""
from __future__ import annotations

import numpy as np


def transmission_time(comm: np.ndarray, adj: np.ndarray, bandwidths: np.ndarray, n: int) -> float:
    deg = adj.sum(axis=1).astype(np.float64)
    used = comm.sum(axis=1).astype(np.float64)
    frac = np.where(deg > 0, used / np.maximum(deg, 1.0), 0.0)
    return float(np.mean(frac * n / bandwidths))


def utilization_score(comm: np.ndarray, adj: np.ndarray, rho: np.ndarray, n: int) -> float:
    deg = adj.sum(axis=1).astype(np.float64)
    used = comm.sum(axis=1).astype(np.float64)
    frac = np.where(deg > 0, used / np.maximum(deg, 1.0), 0.0)
    return float(np.mean(frac * rho * n))


def accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    return float((logits.argmax(-1) == labels).mean())


def consensus_error(w_stack: np.ndarray) -> float:
    """|| W - 1 w_bar ||_F^2 (paper's consensus error)."""
    mean = w_stack.mean(axis=0, keepdims=True)
    return float(((w_stack - mean) ** 2).sum())
