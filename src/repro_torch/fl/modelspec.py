"""ModelSpec: the contract between a model and the FL engine, in torch.

Port of ``repro.fl.modelspec``: the paper's models, ``svm`` (linear
multi-class SVM, multi-margin loss) and ``mlp`` (one hidden relu layer,
cross-entropy), and the deep models ``cnn`` (LeNet-style conv net on square
images), ``mlp_blocks`` (a residual pre-norm MLP stack from
``repro_torch.models.layers``) and ``tiny_transformer`` (a causal
transformer from ``repro_torch.models.model`` on int token windows,
predicting the next token).  Parameters are trees (``repro_torch.tree``)
of tensors with a leading device axis (m, ...): flat dicts for svm and
mlp, nested dicts and lists for the deep models.  The canonical (m, D)
flat rows concatenate the leaves in ``jax.tree.leaves`` order, so their
columns are the reference's, ``[b | w]`` for svm and ``[b1 | b2 | w1 |
w2]`` for mlp.

The reference vmaps a per-device function over the device axis; here the
device axis is written out.  svm, mlp and mlp_blocks run batched products
over (m, batch, dim); cnn runs its convolutions as image patches
(``F.unfold``) times one batched product over the devices;
tiny_transformer runs ``torch.func.vmap`` over
``model.forward``.  ``loss_and_grad`` takes one autograd pass over the
sum of the per-device mean losses, which gives each device its own
gradient.  A batched run (``efhc.step`` over C cells) folds the cells
into the device axis and calls it once with C m devices.

Init keeps the reference's streams.  svm and mlp split the key into one
subkey per device (``split(key, m)``); the deep models draw one device's
init from the key and copy it to every device (``shared_init``: the
reference's common init for nonlinear models).  A batched run calls
``init_stack`` once per cell key, as the reference's
``_EngineCore.init(seed)`` does per cell.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.models import layers, model
from repro_torch.models.common import ArchConfig
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# the reference's registry
MODEL_NAMES: tuple[str, ...] = ("svm", "mlp", "cnn", "mlp_blocks",
                                "tiny_transformer")

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One model family: ``init_stack(key, m)`` stacked params,
    ``logits(w, x)`` for x (m, batch, ...) or a shared (n, ...),
    ``loss_fn(logits, y) -> (m,)`` per-device mean loss, and ``flat_dim``
    the parameter count D of the flat view.  Exactly one of ``init_keys``
    (per-device keys (n, 2) -> the n devices' params: svm, mlp) and
    ``init_one`` (one device's params from a key: the deep models) is
    set."""

    name: str
    flat_dim: int
    logits: Callable[[Params, torch.Tensor], torch.Tensor]
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    init_keys: Callable[[torch.Tensor], Params] | None = None
    init_one: Callable[[torch.Tensor], Params] | None = None

    def init_stack(self, key: torch.Tensor, m: int) -> Params:
        """The m devices' params: one subkey per device (``split(key,
        m)``), or for a deep model ONE ``init_one(key)`` draw copied to
        every device (the reference's ``shared_init``: the average of m
        independent deep-net inits has its per-layer scale shrunk, and the
        fleet would sit at chance)."""
        if self.init_keys is not None:
            return self.init_keys(prng.split(key, m))
        return _copies(self.init_one(key), m)

    def init_rows(self, key: torch.Tensor, m: int, rows: torch.Tensor) -> Params:
        """The rows ``rows`` (n,) of ``init_stack(key, m)``, without the
        whole stack: a shard initializes only the devices it owns, as the
        single-device engine does them."""
        if self.init_keys is not None:
            return self.init_keys(prng.split(key, m)[rows])
        return _copies(self.init_one(key), int(rows.shape[0]))

    def loss_and_grad(self, w: Params, batch) -> tuple[torch.Tensor, Params]:
        """Per-device (loss (m,), grads) on the batch (x (m, B, ...), y (m, B))."""
        x, y = batch
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(w)]
        with torch.enable_grad():
            loss = self.loss_fn(self.logits(tree_unflatten(w, leaves), x), y)
            grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        return loss.detach(), tree_unflatten(w, grads)


def _affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None
            ) -> torch.Tensor:
    # x (m, B, d) @ w (m, d, k) as one batched product, or a shared x (n, d)
    # against every device as one (n, d) @ (d, m k) product: a broadcast
    # matmul would copy x m times
    y = torch.einsum("nd,mdk->mnk", x, w) if x.dim() == 2 else torch.bmm(x, w)
    return y if b is None else y + b[:, None, :]


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


def _flat_dim(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree))


def _copies(one: Params, n: int) -> Params:
    """n copies of one device's params, stacked on a leading axis."""
    return tree_map(lambda t: t[None].expand((n,) + tuple(t.shape)).contiguous(), one)


# ---------------------------------------------------------------------------
# cnn: LeNet-style conv net on square images (dim must be a square)
# ---------------------------------------------------------------------------

def init_cnn(key, dim: int, n_classes: int, c1: int = 8, c2: int = 16,
             hidden: int = 32, device=None) -> Params:
    """One device's cnn params (HWIO conv kernels, as the reference), He
    init from ``key``; ``device="meta"`` gives the shapes alone."""
    side = math.isqrt(dim)
    if side * side != dim:
        raise ValueError(
            f"model='cnn' needs a square input dim (got dim={dim}); the "
            "flat feature rows are reshaped to (side, side, 1) images")
    s_out = -(-side // 2)  # two stride-2 SAME pools: ceil each time
    s_out = -(-s_out // 2)
    feat = s_out * s_out * c2
    dev = key.device if device is None else device
    ks = layers.split_keys(key, 4)

    def nrm(k, shape, fan_in):
        # He init: the relu stages halve activation variance
        return layers.draw_normal(k, shape, dev) * math.sqrt(2.0 / fan_in)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    return {
        "c1": nrm(ks[0], (3, 3, 1, c1), 9), "cb1": zeros(c1),
        "c2": nrm(ks[1], (3, 3, c1, c2), 9 * c1), "cb2": zeros(c2),
        "w3": nrm(ks[2], (feat, hidden), feat), "b3": zeros(hidden),
        "w4": nrm(ks[3], (hidden, n_classes), hidden), "b4": zeros(n_classes),
    }


def _avgpool2(h: torch.Tensor) -> torch.Tensor:
    """Stride-2 SAME average pool over NCHW, each window divided by the
    number of its cells inside the image (the reference's exact
    partial-window counts at an odd side)."""
    return F.avg_pool2d(h, 2, 2, ceil_mode=True)


def _conv3x3(h: torch.Tensor, k: torch.Tensor, groups: int) -> torch.Tensor:
    """Stride-1 SAME 3x3 convolution of h (N, G Cin, H, W) by one kernel
    per group, k (G, Cin, 3, 3, Cout) -> (N, G Cout, H, W): the image
    patches (``F.unfold``) times the kernels as one batched fp32 product
    over the G groups."""
    n, c, hh, ww = h.shape
    cin, cout = c // groups, k.shape[-1]
    cols = F.unfold(h, 3, padding=1).reshape(n, groups, cin * 9, hh * ww)
    cols = cols.permute(1, 2, 0, 3).reshape(groups, cin * 9, n * hh * ww)
    out = torch.bmm(k.reshape(groups, cin * 9, cout).transpose(1, 2), cols)
    return out.reshape(groups * cout, n, hh, ww).transpose(0, 1)


# a shared x (an evaluation) runs the devices in chunks of at most this
# many (device, sample) pairs: ~150 kB of fp32 patches and activations
# each, ~2.5 GB in all
CNN_EVAL_ROWS = 1 << 14


def cnn_logits(w: Params, x: torch.Tensor) -> torch.Tensor:
    """x (m, B, side^2) per device, or a shared (n, side^2), the latter
    over chunks of the devices (``CNN_EVAL_ROWS``).  The m devices'
    convolutions run as patches times one batched product over the
    devices (``_conv3x3``, NCHW with the devices' channels side by side);
    a shared x runs the first one against all devices' kernels as one
    group."""
    m = w["c1"].shape[0]
    step = max(1, CNN_EVAL_ROWS // x.shape[0]) if x.dim() == 2 else m
    if step >= m:
        return _cnn_logits(w, x)
    return torch.cat([_cnn_logits(tree_map(lambda t: t[i:i + step], w), x)
                      for i in range(0, m, step)])


def _cnn_logits(w: Params, x: torch.Tensor) -> torch.Tensor:
    m, c1, c2 = w["c1"].shape[0], w["c1"].shape[-1], w["c2"].shape[-1]
    side = math.isqrt(x.shape[-1])
    # HWIO kernels to (device, I, H, W, O): the unfolded patches' order
    k1 = w["c1"].permute(0, 3, 1, 2, 4)
    k2 = w["c2"].permute(0, 3, 1, 2, 4)
    if x.dim() == 2:
        k1 = k1.permute(1, 2, 3, 0, 4).reshape(1, 1, 3, 3, m * c1)
        h = _conv3x3(x.reshape(-1, 1, side, side).float(), k1, 1)
    else:
        h = x.permute(1, 0, 2).reshape(x.shape[1], m, side, side).float()
        h = _conv3x3(h, k1, m)
    h = _avgpool2(torch.relu(h + w["cb1"].reshape(1, m * c1, 1, 1)))
    h = _conv3x3(h, k2, m)
    h = _avgpool2(torch.relu(h + w["cb2"].reshape(1, m * c2, 1, 1)))
    n = h.shape[0]
    s4 = h.shape[-1]
    # the reference flattens NHWC: (row, column, channel)
    h = h.reshape(n, m, c2, s4, s4).permute(1, 0, 3, 4, 2).reshape(m, n, -1)
    h = torch.relu(_affine(h, w["w3"], w["b3"]))
    return _affine(h, w["w4"], w["b4"])


# ---------------------------------------------------------------------------
# mlp_blocks: residual pre-norm MLP stack from repro_torch.models.layers
# ---------------------------------------------------------------------------

def _blocks_cfg(n_classes: int, d_model: int, d_ff: int, depth: int) -> ArchConfig:
    # minimal ArchConfig: only act (MLP gating) and norm are consumed by the
    # layers this model uses; layer_plan just satisfies the schema invariant
    return ArchConfig(
        name="fl_mlp_blocks", family="dense", source="repro-fl",
        n_layers=depth, d_model=d_model, n_heads=1, n_kv_heads=1,
        d_ff=d_ff, vocab=max(n_classes, 2), layer_plan=((("attn",), depth),),
        act="gelu", norm="rmsnorm", remat=False, dtype="float32")


def make_mlp_blocks(dim: int, n_classes: int, *, d_model: int = 32,
                    d_ff: int = 64, depth: int = 3):
    """(init_one, logits_fn): input proj -> depth x [h + MLP(norm(h))] ->
    norm -> head, the blocks one stacked (depth, ...) subtree."""
    cfg = _blocks_cfg(n_classes, d_model, d_ff, depth)
    f32 = torch.float32

    def init_one(key, device=None):
        dev = key.device if device is None else device
        kp, kb, kh = layers.split_keys(key, 3)
        blocks = [{"norm": layers.init_norm(cfg, d_model, f32, dev),
                   "mlp": layers.init_mlp(cfg, k, d_model, d_ff, f32, dev)}
                  for k in layers.split_keys(kb, depth)]
        return {
            "proj": layers.dense_init(kp, (dim, d_model), dim, f32, dev),
            "blocks": tree_map(lambda *ts: torch.stack(ts), *blocks),
            "out_norm": layers.init_norm(cfg, d_model, f32, dev),
            "head": layers.dense_init(kh, (d_model, n_classes), d_model, f32, dev),
        }

    def norm(p, h):  # scale (m, d) against h (m, B, d)
        return layers.apply_norm(cfg, {"scale": p["scale"][:, None]}, h)

    def logits_fn(w, x):
        h = _affine(x.float(), w["proj"])
        for i in range(depth):
            bp = tree_map(lambda t: t[:, i], w["blocks"])
            h = h + layers.apply_mlp(cfg, bp["mlp"], norm(bp["norm"], h))
        return norm(w["out_norm"], h) @ w["head"]

    return init_one, logits_fn


# ---------------------------------------------------------------------------
# tiny_transformer: repro_torch.models end to end on int token windows
# ---------------------------------------------------------------------------

def make_tiny_transformer(n_classes: int, *, d_model: int = 32,
                          n_heads: int = 2, d_ff: int = 64, depth: int = 2):
    """(init_one, logits_fn) for next-token prediction: x is (batch, seq)
    int tokens with ids in [0, n_classes); the logits are the model's
    prediction at the last position.  Assembled by
    ``repro_torch.models.model`` (embeddings, causal attention blocks, tied
    head) in float32; the m devices run under ``torch.func.vmap``."""
    cfg = ArchConfig(
        name="fl_tiny_transformer", family="dense", source="repro-fl",
        n_layers=depth, d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads,
        d_ff=d_ff, vocab=n_classes, layer_plan=((("attn",), depth),),
        act="gelu", norm="rmsnorm", tie_embeddings=True, causal=True,
        remat=False, dtype="float32")

    def init_one(key, device=None):
        if key is None:
            return model.init_params(cfg, None, device="meta")
        return model.init_params(cfg, key, device=key.device)

    def one(w, tokens):
        logits, _aux = model.forward(cfg, w, {"tokens": tokens})
        return logits[:, -1, :]  # (batch, vocab): next-token prediction

    def logits_fn(w, x):
        return torch.func.vmap(one, in_dims=(0, None if x.dim() == 2 else 0))(
            w, x.long())

    return init_one, logits_fn


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def make_model_spec(name: str, *, dim: int, n_classes: int, **hp) -> ModelSpec:
    """The spec of one registry model.  ``dim`` is the flat feature width
    (svm/mlp), the square image dim (cnn), the input width (mlp_blocks), or
    the token-window length (tiny_transformer: unused by the model, any
    sequence length runs).  ``hp`` forwards hidden widths and depth."""
    if name not in MODEL_NAMES:
        raise ValueError(f"unknown model {name!r}; known: {MODEL_NAMES}")
    if name == "svm":
        def init_keys(keys):
            return {"b": _zeros(keys, n_classes),
                    "w": prng.normal(keys, (dim, n_classes)) * 0.01}

        return ModelSpec(name, (dim + 1) * n_classes, svm_logits, multi_margin_loss,
                         init_keys=init_keys)
    if name == "mlp":
        hidden = hp.get("hidden", 64)

        def init_keys(keys):
            k12 = prng.split(keys, 2)
            return {
                "b1": _zeros(keys, hidden),
                "b2": _zeros(keys, n_classes),
                "w1": prng.normal(k12[:, 0], (dim, hidden)) * (1.0 / math.sqrt(dim)),
                "w2": prng.normal(k12[:, 1], (hidden, n_classes)) * (1.0 / math.sqrt(hidden)),
            }

        return ModelSpec(name, (dim + 1) * hidden + (hidden + 1) * n_classes,
                         mlp_logits, xent_loss, init_keys=init_keys)
    if name == "cnn":
        def init_one(key, device=None):
            return init_cnn(key, dim, n_classes, device=device, **hp)

        logits_fn = cnn_logits
    elif name == "mlp_blocks":
        init_one, logits_fn = make_mlp_blocks(dim, n_classes, **hp)
    else:
        init_one, logits_fn = make_tiny_transformer(n_classes, **hp)
    return ModelSpec(name, _flat_dim(init_one(None, device="meta")), logits_fn,
                     xent_loss, init_one=init_one)
