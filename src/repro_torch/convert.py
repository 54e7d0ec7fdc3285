"""Hand-over of parameters and EF-HC state between the JAX package and the
port, as numpy arrays (the port never imports jax).

``params_from_jax`` takes a stacked parameter dict whose leaves are numpy
arrays (``jax.device_get`` of the reference's pytree) and returns the
port's ``dict[str, Tensor]``; ``params_to_numpy`` goes back.
``state_from_jax`` does the same for an ``EFHCState``-like object, so a
test can start both implementations from one state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import efhc


def params_from_jax(np_tree: dict, device) -> dict[str, torch.Tensor]:
    """{name: (m, ...) array} -> {name: tensor on ``device``} (copies)."""
    return {k: torch.as_tensor(np.array(v)).to(device)
            for k, v in sorted(np_tree.items())}


def params_to_numpy(tree: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in sorted(tree.items())}


def state_from_jax(state, device, *, opt_state=None) -> efhc.EFHCState:
    """An object with the reference ``EFHCState``'s fields ``w``, ``w_hat``,
    ``k``, ``prev_adj``, ``bandwidths`` and ``key`` (numpy leaves) -> the
    port's ``EFHCState`` on ``device``."""
    return efhc.EFHCState(
        w=params_from_jax(state.w, device),
        w_hat=params_from_jax(state.w_hat, device),
        k=torch.tensor(int(np.asarray(state.k)), dtype=torch.int64,
                       device=device),
        prev_adj=torch.as_tensor(np.array(state.prev_adj, bool)).to(device),
        bandwidths=torch.as_tensor(
            np.array(state.bandwidths, np.float32)).to(device),
        # a legacy uint32[2] jax key -> the port's int64 key words
        key=torch.as_tensor(np.asarray(state.key, np.uint32).astype(np.int64)
                            ).to(device),
        opt_state=opt_state)
