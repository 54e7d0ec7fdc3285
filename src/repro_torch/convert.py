"""Hand-over of parameters and EF-HC state between the JAX package and the
port, as numpy arrays (the port never imports jax).

``params_from_jax`` takes a stacked parameter tree (nested dicts and
lists) whose leaves are numpy arrays (``jax.device_get`` of the
reference's pytree) and returns the port's tree of tensors;
``params_to_numpy`` goes back.
``state_from_jax`` does the same for an ``EFHCState``-like object, so a
test can start both implementations from one state.
``arch_params_from_jax`` carries an architecture model's nested parameter
tree (``repro_torch.models.model``) across, bf16 leaves included (the Mamba
leaves of hybrid blocks and the xLSTM cores' too), and
``mamba_cache_from_jax``, ``mlstm_cache_from_jax`` and
``slstm_state_from_jax`` a Mamba, mLSTM or sLSTM decode state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import efhc
from repro_torch.models.ssm import MambaCache, MLSTMCache, SLSTMState
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
    arrays, ``jax.device_get`` of ``repro.models.model.init_params``: the
    stages' stacked leaves, the MoE expert stacks, the ``mtp`` subtree) ->
    the same tree of tensors on ``device``, each leaf in its own dtype, or
    cast to ``dtype`` if given; a MoE ``router`` stays fp32, as the model
    keeps it whatever its dtype."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key) for v in node)
        t = tensor_from_numpy(node).to(device)
        return t if dtype is None or key == "router" else t.to(dtype)

    return walk(np_tree)


def mamba_cache_from_jax(cache, device):
    """A reference ``MambaCache`` (conv (B, kw-1, di) in the model's dtype,
    ssm (B, di, n) fp32; numpy or jax arrays) -> the port's
    ``models.ssm.MambaCache`` of tensors on ``device`` (copies)."""
    return MambaCache(conv=tensor_from_numpy(cache.conv).to(device),
                      ssm=tensor_from_numpy(cache.ssm).to(device))


def mlstm_cache_from_jax(cache, device):
    """A reference ``MLSTMCache`` (c (B, H, dh, dh), n (B, H, dh), m (B, H),
    fp32) -> the port's ``models.ssm.MLSTMCache`` on ``device`` (copies)."""
    return MLSTMCache(*(tensor_from_numpy(t).to(device) for t in cache))


def slstm_state_from_jax(state, device):
    """A reference ``SLSTMState`` (c, n, h, m, fp32 (B, H, dh) each) -> the
    port's ``models.ssm.SLSTMState`` on ``device`` (copies)."""
    return SLSTMState(*(tensor_from_numpy(t).to(device) for t in state))


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
