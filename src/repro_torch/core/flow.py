"""Information-flow graph analysis (paper Prop. 1, Appendix A) and the
B-connectivity watchdog.

Port of ``repro.core.flow``.  The information-flow graph G'^(k) holds the
links used for parameter exchange at iteration k.  Prop. 1: under
Assumption 8, G'^(k) is B-connected with B = (l~ + 2) B_1 where
l~ B_1 <= B_2 <= (l~ + 1) B_1 - 1.

* host (numpy) trace analysis -- ``union_connectivity`` /
  ``failing_windows`` / ``trigger_bound`` / ``predicted_b`` over recorded
  link trajectories (dense bool (T, m, m) or the packed uint32 words of
  ``trace="packed"``), and ``empirical_b`` / ``b_certificate`` over the
  watchdog's ``window_needed`` channel;
* the watchdog, run inside the step: each neighbor-list slot carries an
  age (iterations since its edge last carried parameters), and a
  minimax-age distance to device 0 is relaxed over the neighbor list for
  ``n_prop`` rounds,

      d[i] <- min(d[i], min_s max(d[nbr[i, s]], age[i, s])),

  after which ``max_i d[i] + 1`` is the smallest window whose union graph
  is connected (``window_needed``; ``window_connected`` = needed <=
  window).  The rounds run over all cells at once, in plain torch.  The
  sharded engine's twin, ``watchdog_step_halo``, relaxes a shard's rows
  and takes its neighbors' distances over the halo exchange each round.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

# "never active" slot age / unreachable distance; +1 stays in int32
AGE_INF = 1 << 30


# ---------------------------------------------------------------------------
# host-side trace analysis (numpy)
# ---------------------------------------------------------------------------

def _connected(a: np.ndarray) -> bool:
    m = a.shape[0]
    seen = np.zeros(m, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        u = stack.pop()
        for v in np.nonzero(a[u])[0]:
            if not seen[v]:
                seen[v] = True
                stack.append(int(v))
    return bool(seen.all())


def as_dense_links(adjs: np.ndarray, m: int | None = None) -> np.ndarray:
    """A recorded link trajectory as dense (T, m, m) bool: the bool
    storage of ``trace="full"`` passes, the packed uint32 words of
    ``trace="packed"`` unpack (they need ``m``: the padded last word makes
    it ambiguous)."""
    a = np.asarray(adjs)
    if a.dtype == np.uint32:
        if m is None:
            raise ValueError(
                "packed link trajectories need the device count: pass "
                "union_connectivity(..., m=result.m) -- the zero-padded "
                "last word makes m ambiguous from the shape alone")
        from repro_torch.fl import trace as trace_mod

        return trace_mod.unpack_links(a, m)
    if a.dtype != np.bool_:
        raise TypeError(
            f"expected a bool (T, m, m) or packed uint32 (T, m, W) link "
            f"trajectory; got dtype {a.dtype}")
    return a


def union_connectivity(adjs: np.ndarray, *, m: int | None = None) -> int:
    """Smallest window size B such that the union of every B consecutive
    graphs in ``adjs`` is connected; -1 if no window size works."""
    adjs = as_dense_links(adjs, m)
    t = adjs.shape[0]
    for b in range(1, t + 1):
        if failing_windows(adjs, b).size == 0:
            return b
    return -1


def failing_windows(adjs: np.ndarray, b: int, *,
                    m: int | None = None) -> np.ndarray:
    """The start indices ``s`` whose union ``adjs[s : s + b]`` is not
    connected (empty: the trace is b-connected)."""
    adjs = as_dense_links(adjs, m)
    t = adjs.shape[0]
    if b < 1:
        raise ValueError(f"window size must be >= 1; got b={b}")
    bad = [s for s in range(0, t - b + 1)
           if not _connected(adjs[s:s + b].any(axis=0))]
    return np.asarray(bad, np.int64)


def trigger_bound(v_trace: np.ndarray) -> int:
    """Smallest B_2 such that every device fires at least once in every
    window of B_2 consecutive iterations (Assumption 8-(b)); -1 if never."""
    t, m = v_trace.shape
    worst = 0
    for i in range(m):
        fired = np.nonzero(v_trace[:, i])[0]
        if len(fired) == 0:
            return -1
        gaps = np.diff(np.concatenate([[-1], fired, [t]]))
        worst = max(worst, int(gaps.max()))
    return worst


def predicted_b(b1: int, b2: int) -> int:
    """Prop. 1: B = (l~ + 2) B_1 with l~ B_1 <= B_2 <= (l~ + 1) B_1 - 1."""
    l_tilde = b2 // b1
    if l_tilde * b1 > b2 or b2 > (l_tilde + 1) * b1 - 1:
        l_tilde = max(0, -(-b2 // b1) - 1)
    return (l_tilde + 2) * b1


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """``window`` is the sliding union window the run should stay
    connected over (0 disables the watchdog); ``n_prop`` the propagation
    rounds per iteration (0: ``default_prop_rounds``)."""

    window: int = 0
    n_prop: int = 0

    def __post_init__(self):
        if self.window < 0:
            raise ValueError(f"window must be >= 0; got {self.window}")
        if self.n_prop < 0:
            raise ValueError(f"n_prop must be >= 0; got {self.n_prop}")

    @property
    def enabled(self) -> bool:
        return self.window > 0

    def rounds(self, m: int) -> int:
        return self.n_prop if self.n_prop > 0 else default_prop_rounds(m)


def default_prop_rounds(m: int) -> int:
    """``m`` rounds (exact: minimax Bellman-Ford converges within m - 1)
    up to m=256, then 4 ceil(sqrt(m)) + 32 (the union graphs of the
    geometric fabrics have O(sqrt(m)) diameter); too few rounds can only
    overestimate ``window_needed``."""
    if m <= 256:
        return m
    return int(4 * np.ceil(np.sqrt(m))) + 32


class WatchdogState(NamedTuple):
    """Per neighbor-list slot ages, (C, m, d_max) int32; pad slots stay at
    AGE_INF."""

    age: torch.Tensor


def watchdog_init(rows: int, d_max: int, lead: tuple[int, ...] = (),
                  device="cpu") -> WatchdogState:
    return WatchdogState(age=torch.full(tuple(lead) + (rows, d_max), AGE_INF,
                                        dtype=torch.int32, device=device))


def _age_update(comm_ell: torch.Tensor, age: torch.Tensor) -> torch.Tensor:
    # active slots reset to 0, the rest (pad slots too) age, saturating
    return torch.where(comm_ell, torch.zeros((), dtype=age.dtype, device=age.device),
                       torch.clamp(age + 1, max=AGE_INF))


def watchdog_step(cfg: WatchdogConfig, nbr_idx: torch.Tensor,
                  comm_ell: torch.Tensor, age: torch.Tensor):
    """One monitor iteration over ``comm_ell`` (..., m, d_max), the step's
    information-flow slots, and the carried ``age``.  Returns ``(age_new,
    window_connected, window_needed)``, the last two one per leading
    index (per cell)."""
    m = age.shape[-2]
    age_new = _age_update(comm_ell, age)
    d = torch.full(age.shape[:-1], AGE_INF, dtype=torch.int32, device=age.device)
    d[..., 0] = 0
    for _ in range(cfg.rounds(m)):
        cand = torch.maximum(d[..., nbr_idx], age_new)  # pad slots: max with INF
        d = torch.minimum(d, cand.amin(dim=-1))
    needed = torch.clamp(d.amax(dim=-1), max=AGE_INF - 1) + 1
    return age_new, needed <= cfg.window, needed


def watchdog_step_halo(cfg: WatchdogConfig, m: int, nbr_loc: torch.Tensor,
                       owned: torch.Tensor, comm_ell: torch.Tensor,
                       age: torch.Tensor, buf: Callable[[torch.Tensor], torch.Tensor],
                       fleet_max: Callable[[torch.Tensor], torch.Tensor]):
    """The sharded twin of ``watchdog_step`` over the local rows ``owned``
    (n,) of an m-device fleet: ``nbr_loc`` (n, d_max) indexes the ``[own;
    halo]`` buffer that ``buf(x)`` builds for a per-row x through the
    engine's halo exchange (one exchange a round, as the mixing payload),
    and ``fleet_max`` takes the max over every shard.  The slot arithmetic
    is ``watchdog_step``'s, so ``window_needed`` is the single-device
    engine's bit for bit."""
    age_new = _age_update(comm_ell, age)
    d = torch.where(owned == 0, 0, AGE_INF).to(torch.int32)
    for _ in range(cfg.rounds(m)):
        cand = torch.maximum(buf(d)[nbr_loc], age_new)
        d = torch.minimum(d, cand.amin(dim=-1))
    needed = torch.clamp(fleet_max(d), max=AGE_INF - 1) + 1
    return age_new, needed <= cfg.window, needed


def comm_ell_from_dense(comm: torch.Tensor, nbr_idx: torch.Tensor,
                        nbr_mask: torch.Tensor) -> torch.Tensor:
    """A dense (..., m, m) information-flow matrix gathered into the
    watchdog's (..., m, d_max) slot layout."""
    idx = nbr_idx.expand(comm.shape[:-2] + tuple(nbr_idx.shape))
    return torch.logical_and(torch.gather(comm, -1, idx), nbr_mask)


# ---------------------------------------------------------------------------
# empirical-B certificate (host side, over the watchdog channels)
# ---------------------------------------------------------------------------

def empirical_b(window_needed: np.ndarray) -> int:
    """The realized B of a ``window_needed`` trajectory: the smallest b
    such that every size-b window of the run's information-flow graphs is
    connected, i.e. min{b : max(needed[b-1:]) <= b}; -1 if none."""
    needed = np.asarray(window_needed, np.int64)
    t = needed.shape[0]
    if t == 0:
        return -1
    suffix_max = np.maximum.accumulate(needed[::-1])[::-1]
    ok = np.nonzero(suffix_max <= np.arange(1, t + 1))[0]
    return int(ok[0]) + 1 if ok.size else -1


def b_certificate(window_needed: np.ndarray, v_trace: np.ndarray,
                  b1: int, *, window: int = 0) -> dict:
    """Observed B from the watchdog trajectory, the trigger bound B_2,
    Prop. 1's predicted B = (l~ + 2) B_1, and whether the run honored
    both the bound and the configured window.  ``b1`` is the physical
    fabric's union window."""
    obs = empirical_b(window_needed)
    b2 = trigger_bound(np.asarray(v_trace, bool))
    pred = predicted_b(int(b1), int(b2)) if b2 > 0 and b1 > 0 else -1
    needed = np.asarray(window_needed, np.int64)
    violations = (np.nonzero(needed > window)[0] if window > 0
                  else np.empty(0, np.int64))
    return {
        "observed_b": int(obs),
        "b1": int(b1),
        "b2": int(b2),
        "predicted_b": int(pred),
        "bound_holds": bool(obs > 0 and pred > 0 and obs <= pred),
        "window": int(window),
        "violation_steps": [int(s) for s in violations],
        "window_violated": bool(violations.size > 0),
    }
