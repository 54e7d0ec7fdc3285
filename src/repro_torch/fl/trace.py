"""Trace-mode storage for per-iteration link matrices, in torch.

Port of ``repro.fl.trace``.  The step emits the link matrices ``comm``
(activated information-flow edges) and ``adj`` (physical adjacency) once
per iteration; the simulator stores them per the run's trace mode:

* ``full``    - dense (T, m, m) bool.
* ``packed``  - each length-m bool row bit-packed little-endian into
                ceil(m/32) uint32 words on the device (word w, bit b <->
                column w*32 + b), unpacked losslessly on the host.
* ``summary`` - no matrices; only the per-device row sums survive.

``pack_links`` runs on the device in torch; unpacking is the reference's
host numpy.
"""
from __future__ import annotations

import numpy as np
import torch

TRACE_MODES: tuple[str, ...] = ("full", "packed", "summary")
WORD = 32  # bits per packed word

# scenario-dynamics channels, one value per iteration (per cell) in every
# trace mode, like the row sums; all-zero (all-True for window_connected)
# for a run without that process:
# devices down by churn / out of broadcast budget
RESOURCE_CHANNELS: tuple[str, ...] = ("down_count", "exhausted_count")
# devices silenced by a crash or cluster outage / worst rejoin staleness
FAULT_CHANNELS: tuple[str, ...] = ("fault_down_count", "stale_max")
# the watchdog's union-window verdict / smallest connecting window
WATCHDOG_CHANNELS: tuple[str, ...] = ("window_connected", "window_needed")


def check_trace_mode(trace: str) -> str:
    if trace not in TRACE_MODES:
        raise ValueError(f"unknown trace mode {trace!r}; known: {TRACE_MODES}")
    return trace


def packed_words(m: int) -> int:
    """Number of uint32 words per length-m bit row."""
    return -(-m // WORD)


def pack_links(b: torch.Tensor) -> torch.Tensor:
    """(..., m) bool -> (..., ceil(m/32)) words, little-endian bit order.

    The words are int64 tensors holding uint32 values (torch has no
    general uint32 arithmetic); the host casts them to uint32."""
    m = b.shape[-1]
    w = packed_words(m)
    pad = w * WORD - m
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    words = b.reshape(b.shape[:-1] + (w, WORD)).long()
    shifts = torch.arange(WORD, dtype=torch.int64, device=b.device)
    return (words << shifts).sum(dim=-1)


def unpack_links(packed: np.ndarray, m: int) -> np.ndarray:
    """(..., ceil(m/32)) uint32 -> (..., m) bool; exact inverse of packing.

    Word-to-byte view + ``np.unpackbits``: the only transient is the uint8
    bit array, the same size as the bool result (a naive shift-and-mask
    expansion would allocate 4-byte-per-bit intermediates, an 8x host-memory
    spike over the dense trace this mode exists to avoid)."""
    p = np.ascontiguousarray(np.asarray(packed)).astype("<u4", copy=False)
    by = p.view(np.uint8)  # (..., W*4) little-endian bytes
    bits = np.unpackbits(by, axis=-1, bitorder="little")  # (..., W*32) uint8
    return bits[..., :m].astype(bool)


def link_dtype(trace: str):
    """Host dtype of the stored link trajectories for a trace mode."""
    return np.uint32 if trace == "packed" else bool


def stored_links(stored: np.ndarray | None, trace: str, m: int, name: str) -> np.ndarray:
    """Resolve a result object's stored link trajectory to dense bool.

    ``full`` passes through, ``packed`` unpacks, ``summary`` raises (the
    matrices were never recorded -- use the per-device counts instead)."""
    if trace == "summary":
        raise ValueError(
            f"{name} link matrices were not recorded with trace='summary' "
            "(only per-device counts survive: comm_count / deg); rerun with "
            "trace='full' or trace='packed' to get the full matrices")
    assert stored is not None, f"{name} missing from a {trace!r}-trace result"
    if trace == "packed":
        return unpack_links(stored, m)
    return stored
