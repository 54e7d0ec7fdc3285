"""ModelSpec: the contract between a model and the FL engine, in torch.

Port of ``repro.fl.modelspec`` for the paper's models, ``svm`` (linear
multi-class SVM, multi-margin loss) and ``mlp`` (one hidden relu layer,
cross-entropy).  Parameters are dicts of tensors with a leading device
axis (m, ...), keys in sorted order: that is ``jax.tree.leaves`` order, so
the canonical (m, D) flat rows have the reference's column order, ``[b | w]``
for svm and ``[b1 | b2 | w1 | w2]`` for mlp.

The reference vmaps a per-device function over the device axis; here the
device axis is written out.  Forward passes are batched products over
(m, batch, dim), and ``loss_and_grad`` takes one autograd pass over the
sum of the per-device mean losses, which gives each device its own
gradient.  Init keeps the reference's stream: ``split(key, m)``, one
subkey per device, and the same ``normal`` draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import prng

# the reference's registry; the deep models arrive with ROADMAP.md Queue 1
# item 6 ("Real models")
MODEL_NAMES: tuple[str, ...] = ("svm", "mlp", "cnn", "mlp_blocks",
                                "tiny_transformer")
PORTED_MODELS: tuple[str, ...] = ("svm", "mlp")

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One model family: ``init_stack(key, m)`` stacked params,
    ``logits(w, x)`` for x (m, batch, dim) or a shared (n, dim),
    ``loss_fn(logits, y) -> (m,)`` per-device mean loss, and ``flat_dim``
    the parameter count D of the flat view."""

    name: str
    leaf_shapes: dict[str, tuple[int, ...]]  # per device, sorted keys
    init_stack: Callable[[torch.Tensor, int], Params]
    logits: Callable[[Params, torch.Tensor], torch.Tensor]
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

    @property
    def flat_dim(self) -> int:
        return sum(math.prod(s) for s in self.leaf_shapes.values())

    def loss_and_grad(self, w: Params, batch) -> tuple[torch.Tensor, Params]:
        """Per-device (loss (m,), grads) on the batch (x (m, B, dim), y (m, B))."""
        x, y = batch
        leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()}
        with torch.enable_grad():
            loss = self.loss_fn(self.logits(leaves, x), y)
            grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))


def _affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # x (m, B, d) @ w (m, d, k) as one batched product, or a shared x (n, d)
    # against every device as one (n, d) @ (d, m k) product: a broadcast
    # matmul would copy x m times
    if x.dim() == 2:
        return torch.einsum("nd,mdk->mnk", x, w) + b[:, None, :]
    return torch.bmm(x, w) + b[:, None, :]


def svm_logits(w: Params, x: torch.Tensor) -> torch.Tensor:
    return _affine(x, w["w"], w["b"])


def multi_margin_loss(logits: torch.Tensor, y: torch.Tensor,
                      margin: float = 1.0) -> torch.Tensor:
    """Paper's SVM loss per device: mean_b sum_{j != y} max(0, margin -
    s_y + s_j) / C, with the true-class column zeroed (and so given no
    gradient).  ``maximum`` splits the gradient at a tie, as jax does."""
    correct = torch.gather(logits, -1, y[..., None].long())
    viol = torch.maximum(torch.zeros((), dtype=logits.dtype, device=logits.device),
                         margin - correct + logits)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    viol = viol.masked_fill(classes == y[..., None], 0.0)
    return viol.sum(-1).mean(-1) / logits.shape[-1]


def mlp_logits(w: Params, x: torch.Tensor) -> torch.Tensor:
    return _affine(torch.relu(_affine(x, w["w1"], w["b1"])), w["w2"], w["b2"])


def xent_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, -1)
    return -torch.gather(logp, -1, y[..., None].long())[..., 0].mean(-1)


def _zeros(keys: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((keys.shape[0], n), dtype=torch.float32, device=keys.device)


def make_model_spec(name: str, *, dim: int, n_classes: int,
                    hidden: int = 64) -> ModelSpec:
    if name not in MODEL_NAMES:
        raise ValueError(f"unknown model {name!r}; known: {MODEL_NAMES}")
    if name == "svm":
        def init_stack(key, m):
            keys = prng.split(key, m)
            return {"b": _zeros(keys, n_classes),
                    "w": prng.normal(keys, (dim, n_classes)) * 0.01}

        shapes = {"b": (n_classes,), "w": (dim, n_classes)}
        return ModelSpec(name, shapes, init_stack, svm_logits, multi_margin_loss)
    if name == "mlp":
        def init_stack(key, m):
            keys = prng.split(key, m)
            k12 = prng.split(keys, 2)
            return {
                "b1": _zeros(keys, hidden),
                "b2": _zeros(keys, n_classes),
                "w1": prng.normal(k12[:, 0], (dim, hidden)) * (1.0 / math.sqrt(dim)),
                "w2": prng.normal(k12[:, 1], (hidden, n_classes)) * (1.0 / math.sqrt(hidden)),
            }

        shapes = {"b1": (hidden,), "b2": (n_classes,), "w1": (dim, hidden),
                  "w2": (hidden, n_classes)}
        return ModelSpec(name, shapes, init_stack, mlp_logits, xent_loss)
    raise NotImplementedError(
        f"model {name!r} is not ported yet: ROADMAP.md Queue 1 item 6 "
        f"(real models); the port runs {PORTED_MODELS}")
