"""Full model assembly (port of ``repro/models/model.py``).

Params tree, the reference's pytree as plain dicts of tensors:
  {"embed": {...}, "stages": [stage0, stage1, ...], "final_norm": {...},
   "head": {...}, "mtp": {...}?}

Each stage corresponds to one (cycle, repeat) entry of cfg.layer_plan and is
a dict {block_name_i: stacked_params} with leading axis ``repeat``; a stage
runs as a Python loop over ``range(repeat)`` on views of the stacked leaves
(the reference's ``lax.scan``).

Batch dict: ``tokens`` (B, S) integer ids (the text part for a vision
model), for ``loss_fn`` ``targets`` (B, S) ids and an optional fp32
``loss_mask`` (B, S), and for a model with a modality frontend
``frontend`` (B, T, dim) fp32, the stub's embeddings: a vision model's T
patches are a prefix before the text (prefix-LM attention, logits over the
text only); an audio model's frames are the whole sequence (its tokens are
not read).  ``loss_fn`` adds the MoE router's aux loss and deepseek-v3's
MTP loss (one extra block predicting token t+2) as the reference does.
Under autograd with ``cfg.remat`` each layer of a
stage runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` around its scan body): its activations are recomputed
in the backward pass instead of kept.  A layer's first forward under remat
is still a forward under autograd, so the sLSTM and selective-scan kernels'
saving variants run in it too (what they save is dropped with the rest of
the layer's activations): two saving launches and one backward launch a
layer and step.

Over a device mesh (``models/sharding.py``) a rank holds its block of each
leaf: ``init_params(..., shard=...)`` draws each leaf as the one-card init
draws it and keeps the rank's block; under ``sharding.tensor_parallel`` the
forward, the loss and the decode run the tensor-parallel ``attn`` blocks,
the vocab-split embedding and head, ``forward`` and ``decode_step``
gather the logits over the model axis, and ``loss_fn`` takes a
vocab-parallel log-sum-exp instead (qwen2-72b's fp32 logits at S=8192 are
5.0 GB a sequence whole).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import prng, resolve_device
from repro_torch.models import blocks
from repro_torch.models import sharding as S
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import (apply_head, apply_norm, dense_init,
                                       embed_tokens, head_split, init_embed,
                                       init_head, init_norm, is_key, split_keys,
                                       torch_dtype)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                device="cuda", *, shard=None) -> dict:
    """Random parameters drawn from ``generator`` (on its own device) into
    tensors on ``device``.  A stage's stacked leaves are filled one layer
    slice at a time, so no draw is larger than one layer's biggest weight.
    On the ``meta`` device nothing is drawn or allocated.

    ``shard``: ``(path, tensor) -> this rank's block`` (``sharding.
    layer_slicer``).  Each leaf is then drawn whole as above, in the same
    order from the same generator, its block kept and the rest freed: the
    blocks of the one-card weights, with at most one layer's leaf whole at
    a time.

    ``generator`` may instead be a ``repro_torch.prng`` key: the draws are
    then the reference's ``init_params(cfg, key)``, bit for bit."""
    if generator is not None and is_key(generator):
        if shard is not None:
            raise ValueError("init_params takes shard= with a torch.Generator only")
        return _init_params_key(cfg, generator, resolve_device(device))
    dtype = _dtype(cfg)
    meta = torch.device(device).type == "meta"
    if not meta:
        device = resolve_device(device)
        if generator is None:
            raise ValueError("init_params draws from a torch.Generator; pass one")
    if shard is None:
        def keep(_, t):
            return t
    else:
        keep = shard

    def whole(name: str, tree):
        return S.tree_map_with_path(keep, tree, name)

    params: dict[str, Any] = {
        "embed": whole("embed", init_embed(cfg, generator, dtype, device)),
        "final_norm": whole("final_norm", init_norm(cfg, cfg.d_model, dtype, device)),
        "head": whole("head", init_head(cfg, generator, dtype, device)),
        "stages": [],
    }
    for si, (cycle, repeat) in enumerate(cfg.layer_plan):
        stage = {}
        for bi, bt in enumerate(cycle):
            name = f"stages/{si}/{bi}_{bt}"
            shapes = S.tree_map_with_path(keep, blocks.init_block(cfg, bt, None, dtype, "meta"),
                                          name)
            stacked = tree_map(lambda t: torch.empty((repeat, *t.shape), dtype=t.dtype,
                                                     device=device), shapes)
            for r in range(0 if meta else repeat):
                layer = S.tree_map_with_path(
                    keep, blocks.init_block(cfg, bt, generator, dtype, device), name)
                tree_map(lambda dst, src: dst[r].copy_(src), stacked, layer)
                del layer
            stage[f"{bi}_{bt}"] = stacked
        params["stages"].append(stage)
    if cfg.mtp:
        params["mtp"] = whole("mtp", _init_mtp(cfg, generator, generator, dtype, device))
    return params


def _init_mtp(cfg: ArchConfig, k_proj, k_block, dtype, device) -> dict:
    """deepseek-v3's MTP head: the projection of [h_t; e_{t+1}], its two
    norms and one ``attn`` block."""
    d = cfg.d_model
    return {
        "proj": dense_init(k_proj, (2 * d, d), 2 * d, dtype, device),
        "norm_h": init_norm(cfg, d, dtype, device),
        "norm_e": init_norm(cfg, d, dtype, device),
        "block": blocks.init_block(cfg, "attn", k_block, dtype, device),
    }


def _init_params_key(cfg: ArchConfig, key: torch.Tensor, device) -> dict:
    """The reference's key stream: ``split(key, 4)`` into the embedding,
    head, stage and MTP keys, and for block ``bi`` of stage ``si`` one key
    per layer, ``split(fold_in(k_stage, si * 97 + bi), repeat)`` (the
    reference vmaps the block init over them; layer by layer here), and
    ``split(k_mtp)`` into the MTP projection's and block's keys."""
    dtype = _dtype(cfg)
    k_embed, k_head, k_stage, k_mtp = split_keys(key, 4)
    params: dict[str, Any] = {
        "embed": init_embed(cfg, k_embed, dtype, device),
        "final_norm": init_norm(cfg, cfg.d_model, dtype, device),
        "head": init_head(cfg, k_head, dtype, device),
        "stages": [],
    }
    for si, (cycle, repeat) in enumerate(cfg.layer_plan):
        stage = {}
        for bi, bt in enumerate(cycle):
            keys = prng.split(prng.fold_in(k_stage, si * 97 + bi), repeat)
            layers = [blocks.init_block(cfg, bt, keys[r], dtype, device)
                      for r in range(repeat)]
            stage[f"{bi}_{bt}"] = tree_map(lambda *ts: torch.stack(ts), *layers)
        params["stages"].append(stage)
    if cfg.mtp:
        params["mtp"] = _init_mtp(cfg, *split_keys(k_mtp, 2), dtype, device)
    return params


# ---------------------------------------------------------------------------
# backbone (sequence form)
# ---------------------------------------------------------------------------

def _layers(stage_params, repeat: int) -> list:
    """The stage's stacked trees as ``repeat`` per-layer trees of views, the
    leaves split once (``unbind``): under autograd a leaf's gradient then
    comes back as one stack, where indexing it layer by layer would add a
    zero-padded copy of the whole stack per layer."""
    leaves = tree_leaves(stage_params)
    split = [t.unbind(0) for t in leaves]
    return [tree_unflatten(stage_params, [s[r] for s in split]) for r in range(repeat)]


def _stage_seq(cfg: ArchConfig, cycle, repeat, stage_params, x, positions,
               prefix_len):
    def layer(x, p):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for bi, bt in enumerate(cycle):
            x, a = blocks.block_seq(cfg, bt, p[f"{bi}_{bt}"], x, positions,
                                    prefix_len=prefix_len)
            aux = aux + a
        return x, aux

    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in _layers(stage_params, repeat):
        x, a = checkpoint(layer, x, p, use_reentrant=False) if remat else layer(x, p)
        aux = aux + a
    return x, aux


def backbone_seq(cfg: ArchConfig, params, x, positions, prefix_len=None):
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for (cycle, repeat), stage_params in zip(cfg.layer_plan, params["stages"]):
        x, aux = _stage_seq(cfg, cycle, repeat, stage_params, x, positions,
                            prefix_len)
        aux_total = aux_total + aux
    return apply_norm(cfg, params["final_norm"], x), aux_total


def _embed_inputs(cfg: ArchConfig, params, batch):
    """Returns (x (B,S,D), positions (S,), prefix_len or None).  The
    frontend's embeddings are projected in fp32 (jax promotes the fp32
    stub embeddings @ a bf16 projection to fp32), then cast to the model's
    dtype."""
    if cfg.frontend is not None and "frontend" in batch:
        proj = params["embed"]["frontend_proj"]
        fe = (batch["frontend"].float() @ proj.float()).to(_dtype(cfg))
        if cfg.frontend.kind == "vision":
            # image patches prefix + text suffix; tokens hold the text part
            x = torch.cat([fe, embed_tokens(params["embed"], batch["tokens"], cfg.vocab)],
                          dim=1)
            return x, torch.arange(x.shape[1], device=x.device), cfg.frontend.tokens
        # audio: frames *are* the sequence
        return fe, torch.arange(fe.shape[1], device=fe.device), None
    x = embed_tokens(params["embed"], batch["tokens"], cfg.vocab)
    return x, torch.arange(x.shape[1], device=x.device), None


def _forward(cfg: ArchConfig, params, batch):
    """(logits (B,S,V), aux_loss, the backbone's output h, positions); a
    vision model's logits cover the text suffix only.  With the head's
    vocab split over the model axis, this rank's block of the logits."""
    x, positions, prefix_len = _embed_inputs(cfg, params, batch)
    h, aux = backbone_seq(cfg, params, x, positions, prefix_len)
    h_text = h
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        h_text = h[:, cfg.frontend.tokens:]  # logits over the text suffix only
    logits = apply_head(cfg, params["head"], params["embed"], h_text)
    return logits, aux, h, positions


def _whole_logits(cfg: ArchConfig, params, logits):
    """The logits whole: a rank's vocab block gathered over the model axis."""
    if head_split(cfg, params["head"], params["embed"]):
        return S.gather_along(logits, -1, S.model_axis())
    return logits


def forward(cfg: ArchConfig, params, batch) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B,S,V), aux_loss)."""
    logits, aux, _, _ = _forward(cfg, params, batch)
    return _whole_logits(cfg, params, logits), aux


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _xent(logits, targets, mask, split: bool = False):
    """Mean cross-entropy of the unmasked positions; with ``split`` the
    logits are this rank's vocab block, and the log-sum-exp and the
    targets' logits are summed over the model axis (the max by which the
    exponents are shifted is taken over it too, out of the gradient: it
    cancels)."""
    if not split:
        logp = F.log_softmax(logits.float(), dim=-1)
        ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
        return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    ax = S.model_axis()
    z = logits.float()
    z = z - ax.max(z.detach().amax(-1))[..., None]
    lse = torch.log(S.reduce_from_model(torch.exp(z).sum(-1), ax))
    local = targets.long() - ax.index * z.shape[-1]
    inside = (local >= 0) & (local < z.shape[-1])
    picked = torch.gather(z, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    picked = S.reduce_from_model(torch.where(inside, picked, 0.0), ax)
    ll = picked - lse
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(cfg: ArchConfig, params, batch) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy over the unmasked positions, plus
    ``router_aux_weight * aux`` with a MoE and ``mtp_weight * mtp`` with
    the MTP head -> (loss, {"ce", "aux", "mtp"?, "loss"}).  The backbone
    runs once: the reference's MTP loss runs it again on the same inputs,
    which gives the same values."""
    logits, aux, h, positions = _forward(cfg, params, batch)
    targets = batch["targets"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
    split = head_split(cfg, params["head"], params["embed"])
    loss = _xent(logits, targets, mask, split)
    metrics = {"ce": loss, "aux": aux}
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
    if cfg.mtp:
        mtp_loss = _mtp_loss(cfg, params, batch, h, positions, mask)
        metrics["mtp"] = mtp_loss
        loss = loss + cfg.mtp_weight * mtp_loss
    metrics["loss"] = loss
    return loss, metrics


def _mtp_loss(cfg: ArchConfig, params, batch, h, positions, mask):
    """Deepseek-v3 MTP: depth-1 extra head predicting token t+2 from the
    backbone state at t combined with the embedding of token t+1."""
    tokens, targets = batch["tokens"], batch["targets"]
    p = params["mtp"]
    h_t = apply_norm(cfg, p["norm_h"], h[:, :-1])
    e_next = apply_norm(cfg, p["norm_e"], embed_tokens(params["embed"], tokens[:, 1:],
                                                       cfg.vocab))
    z = torch.cat([h_t, e_next], dim=-1) @ p["proj"]
    z, _ = blocks.block_seq(cfg, "attn", p["block"], z, positions[:-1])
    logits = apply_head(cfg, params["head"], params["embed"], z)
    # predict targets shifted one further (t+2 = targets[t+1])
    return _xent(logits[:, :-1], targets[:, 2:], mask[:, 2:],
                 head_split(cfg, params["head"], params["embed"]))


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, cache_len: int, device="cuda", *,
               mesh=None):
    """Empty KV (or MLA latent) caches, Mamba caches for hybrid blocks and
    xLSTM states for mLSTM and sLSTM blocks, one stacked (repeat, ...) tree
    per stage.  On the ``meta`` device, the shapes alone.  With ``mesh``,
    this rank's block of the caches of a ``batch``-row decode
    (``sharding.local_cache_specs``: the batch over the data axes, the KV
    heads over ``model``)."""
    meta = torch.device(device).type == "meta"
    if not meta:
        device = resolve_device(device)
    dtype = _dtype(cfg)
    if mesh is not None:
        shapes = init_cache(cfg, batch, cache_len, "meta")
        local = S.shard_tree(shapes, S.local_cache_specs(shapes, mesh), mesh)
        # each leaf starts at one value (0, -1 or -1e30): a one-slot cache's
        fill = tree_leaves(init_cache(cfg, 1, 1, "cpu"))
        return tree_unflatten(local, [
            torch.full(t.shape, f.reshape(-1)[0].item(), dtype=t.dtype, device=device)
            for t, f in zip(tree_leaves(local), fill, strict=True)])
    caches = []
    for (cycle, repeat) in cfg.layer_plan:
        stage = {}
        for bi, bt in enumerate(cycle):
            one = blocks.init_block_cache(cfg, bt, batch, cache_len, dtype, device)
            stage[f"{bi}_{bt}"] = tree_map(
                lambda c: c[None].repeat(repeat, *([1] * c.dim())) if not meta
                else c[None].expand(repeat, *c.shape), one)
        caches.append(stage)
    return caches


def decode_step(cfg: ArchConfig, params, caches, token_t: torch.Tensor, t: int):
    """One-token decode.  token_t (B,) ids; t the absolute position.
    Returns (logits (B,V), caches); the caches are updated in place and
    returned."""
    x = embed_tokens(params["embed"], token_t[:, None], cfg.vocab)
    for (cycle, repeat), stage_params, stage_cache in zip(
            cfg.layer_plan, params["stages"], caches):
        for r in range(repeat):
            for bi, bt in enumerate(cycle):
                name = f"{bi}_{bt}"
                layer_p = tree_map(lambda a: a[r], stage_params[name])
                layer_c = tree_map(lambda a: a[r], stage_cache[name])
                x, _ = blocks.block_decode(cfg, bt, layer_p, x, layer_c, t)
    h = apply_norm(cfg, params["final_norm"], x)
    logits = apply_head(cfg, params["head"], params["embed"], h)[:, 0]
    return _whole_logits(cfg, params, logits), caches


def prefill(cfg: ArchConfig, params, batch):
    """Prompt-processing forward (the `prefill_32k` shape): full-sequence
    logits.  A decode cache is built by replaying ``decode_step`` over the
    prompt."""
    logits, _ = forward(cfg, params, batch)
    return logits


# ---------------------------------------------------------------------------
# analytic parameter count
# ---------------------------------------------------------------------------

def count_params_analytic(cfg: ArchConfig, active_only: bool = False) -> int:
    d, h, g, dh, ff, v = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.vocab
    total = v * d  # embed
    if not cfg.tie_embeddings:
        total += d * v
    if cfg.frontend is not None:
        total += cfg.frontend.dim * d

    def block_params(bt: str) -> int:
        n = 0
        if bt in ("mlstm", "slstm"):
            di = cfg.ssm_expand * d
            if bt == "mlstm":
                n += 2 * d * di + 3 * di * di + di * 2 * h + di * d + di
            else:
                dhh = d // h
                n += d * 4 * d + 4 * h * dhh * dhh + 4 * d + d
                n += 2 * d * ((4 * d) // 3) + ((4 * d) // 3) * d
            return n + d  # norm
        if bt in ("mla", "mla_moe"):
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            n += d * m.q_lora_rank + m.q_lora_rank * h * qk
            n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            n += m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
            n += h * m.v_head_dim * d
        elif bt in ("attn", "attn_g", "moe", "hybrid", "hybrid_g"):
            n += d * h * dh + 2 * d * g * dh + h * dh * d
        if bt in ("hybrid", "hybrid_g", "mamba"):
            di = cfg.ssm_expand * d
            dt_rank = max(d // 16, 1)
            n += 2 * d * di + cfg.ssm_conv * di + di * 2 * cfg.ssm_state
            n += di * dt_rank + dt_rank * di + di * cfg.ssm_state + 2 * di + di * d
        if bt in ("moe", "mla_moe"):
            m = cfg.moe
            gated = 3 if cfg.act in ("swiglu", "geglu") else 2
            per_expert = gated * d * m.d_expert
            experts = m.top_k if active_only else m.n_experts
            n += d * m.n_experts + experts * per_expert + m.n_shared * per_expert
            n += 2 * d  # two norms
        elif bt in ("attn", "attn_g", "mla", "hybrid", "hybrid_g") and ff > 0:
            gated = 3 if cfg.act in ("swiglu", "geglu") else 2
            n += gated * d * ff + 2 * d
        else:
            n += d
        return n

    for cycle, repeat in cfg.layer_plan:
        total += repeat * sum(block_params(bt) for bt in cycle)
    if cfg.mtp:
        total += 2 * d * d + block_params("attn")
    return int(total)
