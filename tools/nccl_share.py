"""The share of a card's busy time that NCCL's kernels take in one call,
read from ``torch.profiler``'s CUDA activities: the union of all the
activities' intervals (busy) and of the NCCL kernels' (overlapping
intervals counted once).  Imported by ``train_sharded.py`` and
``serve_sharded.py``."""
from __future__ import annotations

import torch


def busy_ms(intervals) -> float:
    """The union's length (ms) of (start, end) intervals in us."""
    total, end = 0.0, -1.0
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def profile_share(run) -> dict:
    """One ``run()`` under ``torch.profiler``: the device's busy ms, the
    NCCL kernels' ms and launches, their share of busy, the activities."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    nccl = [e for e in ev if "nccl" in e.name.lower()]
    busy = busy_ms((e.time_range.start, e.time_range.end) for e in ev)
    comm = busy_ms((e.time_range.start, e.time_range.end) for e in nccl)
    return {"busy_ms": busy, "nccl_ms": comm, "nccl_share": comm / busy if busy else 0.0,
            "nccl_kernels": len(nccl), "activities": len(ev)}
