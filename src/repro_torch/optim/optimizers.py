"""Minimal functional optimizers on parameter trees (nested dicts and
lists) of stacked (m, ...) tensors, or (C, m, ...) in a batched run (the
updates are elementwise, so the cells are more devices).

Each optimizer is ``(init, update)``: ``init(params) -> state``,
``update(grads, state, params, lr) -> (new_params, new_state)``, the
reference's contract (``repro.optim.optimizers``).  Event 4 of the paper
is plain SGD; momentum and Adam serve the beyond-paper runs.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import first_leaf, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], tuple[Any, Any]]


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        return tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                     params, grads), state

    return Optimizer(init, update)


def momentum(beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    def update(grads, state, params, lr):
        vel = tree_map(lambda v, g: beta * v + g.float(), state, grads)
        new = tree_map(lambda p, v: (p.float() - lr * v).to(p.dtype), params, vel)
        return new, vel

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        dev = first_leaf(params).device
        return AdamState(mu=z, nu=tree_map(torch.clone, z),
                         count=torch.zeros((), dtype=torch.int32, device=dev))

    def update(grads, state, params, lr):
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * torch.square(g.float()),
                   state.nu, grads)
        bc1 = 1 - b1 ** count.float()
        bc2 = 1 - b2 ** count.float()
        new = tree_map(lambda p, m, n: (p.float() - lr * (m / bc1)
                                     / (torch.sqrt(n / bc2) + eps)).to(p.dtype),
                    params, mu, nu)
        return new, AdamState(mu, nu, count)

    return Optimizer(init, update)


# canonical Event-4 update rules; SimConfig/ScenarioSpec validate against this
OPT_NAMES: tuple[str, ...] = ("sgd", "momentum", "adam")

_OPTS = {"sgd": sgd, "momentum": momentum, "adam": adam}


def init_opt(name: str) -> Optimizer:
    if name not in _OPTS:
        raise ValueError(f"unknown optimizer {name!r}; allowed: {OPT_NAMES}")
    return _OPTS[name]()
