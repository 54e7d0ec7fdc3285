"""Hand-over of parameters and EF-HC state between the JAX package and the
port, as numpy arrays (the port never imports jax).

``params_from_jax`` takes a stacked parameter tree (nested dicts and
lists) whose leaves are numpy arrays (``jax.device_get`` of the
reference's pytree) and returns the port's tree of tensors;
``params_to_numpy`` goes back.
``state_from_jax`` does the same for an ``EFHCState``-like object, so a
test can start both implementations from one state.
``arch_params_from_jax`` carries an architecture model's nested parameter
tree (``repro_torch.models.model``) across, bf16 leaves included.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import efhc
from repro_torch.tree import tree_map


def tensor_from_numpy(a) -> torch.Tensor:
    """numpy array -> tensor (a copy); an ``ml_dtypes`` bfloat16 array,
    which ``torch.as_tensor`` rejects, crosses as its uint16 bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(np_tree, device):
    """A tree of (m, ...) arrays -> the same tree of tensors on ``device``
    (copies)."""
    return tree_map(lambda a: tensor_from_numpy(a).to(device), np_tree)


def params_to_numpy(tree):
    """A tree of tensors -> the same tree of host numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def arch_params_from_jax(np_tree, device, dtype=None):
    """The reference's nested parameter tree (dicts and lists of numpy
    arrays, ``jax.device_get`` of ``repro.models.model.init_params``) -> the
    same tree of tensors on ``device``, cast to ``dtype`` if given."""
    def leaf(a):
        t = tensor_from_numpy(a).to(device)
        return t if dtype is None else t.to(dtype)

    return tree_map(leaf, np_tree)


def state_from_jax(state, device, *, opt_state=None) -> efhc.EFHCState:
    """An object with the reference ``EFHCState``'s fields ``w``, ``w_hat``,
    ``k``, ``prev_adj``, ``bandwidths`` and ``key`` (numpy leaves) -> the
    port's one-cell ``EFHCState`` on ``device`` (the per-cell fields gain
    a leading cell axis of 1; ``opt_state`` is passed as it is)."""
    def cell(tree):
        return tree_map(lambda t: t[None], params_from_jax(tree, device))

    return efhc.EFHCState(
        w=cell(state.w), w_hat=cell(state.w_hat),
        k=torch.tensor(int(np.asarray(state.k)), dtype=torch.int64,
                       device=device),
        prev_adj=torch.as_tensor(np.array(state.prev_adj, bool)).to(device),
        bandwidths=torch.as_tensor(
            np.array(state.bandwidths, np.float32)[None]).to(device),
        # a legacy uint32[2] jax key -> the port's int64 key words
        key=torch.as_tensor(np.asarray(state.key, np.uint32).astype(np.int64)[None]
                            ).to(device),
        opt_state=opt_state)
