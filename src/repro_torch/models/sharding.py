"""Logical-axis sharding rules for the device meshes, and the collectives
that carry a model laid over them (port of ``repro/models/sharding.py``).

Mesh axes:   ("data", "model")            single pod, 16 x 16
             ("pod", "data", "model")     two pods,   2 x 16 x 16

Two parallelism modes per arch (the reference's DESIGN.md sec. 3):

* ``replica`` (fl_m == |data|): each data slice is one FL device with its own
  full parameter set -> params carry a leading ``fl`` axis sharded over
  ("pod","data"); inner dims shard over "model" only.
* ``fsdp`` (fl_m == 1 per pod): one FL device per pod; params shard over
  ("data" [zero-style], "model" [tensor]) with a leading fl axis over "pod"
  in the multi-pod mesh.

A spec is a plain tuple with one entry a dim: an axis name, a tuple of
axis names, or None (whole).  The spec functions read only ``mesh.shape``
(axis -> size) and ``mesh.axis_names``, so any object with those serves,
and they give the reference's specs entry for entry.

What XLA does for the reference from the specs alone, the port does by
hand:

* ``shard_leaf`` / ``shard_tree`` take this rank's block of each leaf
  (placing an array with ``NamedSharding``); ``gather_leaf`` /
  ``gather_tree`` put the blocks back together;
* ``AxisGroup`` is one mesh axis (or a tuple of them) seen from a rank:
  its gather, and its sums and maxima, which gather every rank's partial
  and reduce them in the axis's order on every rank, so a result has the
  same bits on every rank of the group and from run to run, on gloo and
  NCCL alike;
* ``copy_to_model`` (identity forward, gradients summed over ``model``),
  ``reduce_from_model`` (summed forward, identity backward),
  ``sum_scatter`` (summed forward keeping this rank's block of a dim, one
  all-to-all; backward gathers) and ``gather_along`` (the blocks of a dim
  concatenated; backward keeps this rank's block) are the tensor-parallel
  collectives as autograd functions;
* ``tensor_parallel(axis)`` makes ``axis`` the ``model`` axis the model
  code shards over (``model_axis()``); outside it, and on a ``model`` axis
  of size 1, the model runs whole.

``constrain`` only tells XLA where to place an activation.  Where
``backbone_seq`` calls it (the reference's ``models/model.py:88, 91``),
the sequence is left whole over ``model``: each rank of a model group holds
the same residual stream, and the collectives above sit at the edges of the
tensor-parallel blocks instead.  The port has no ``constrain``.
"""
from __future__ import annotations

import contextlib
import re
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

# the ROADMAP item that ports the model-parallel forms not laid out yet
ITEM_19B = "ROADMAP Queue 1 item 19b"


def fl_axes(mesh, mode: str) -> tuple[str, ...]:
    """Mesh axes that enumerate FL devices."""
    has_pod = "pod" in mesh.axis_names
    if mode == "replica":
        return ("pod", "data") if has_pod else ("data",)
    return ("pod",) if has_pod else ()


def fl_count(mesh, mode: str) -> int:
    axes = fl_axes(mesh, mode)
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


# ---------------------------------------------------------------------------
# Per-leaf param specs, matched on the param path ("stages/0/0_attn/attn/wq")
# ---------------------------------------------------------------------------

# (regex, spec for the *param dims* (no fl/stage axes)) - first match wins.
_PARAM_RULES: list[tuple[str, tuple[Optional[str], ...]]] = [
    (r"embed/tok$", ("vocab", "embed")),
    (r"embed/frontend_proj$", (None, "embed")),
    (r"head/w$", ("embed", "vocab")),
    (r"attn/wq$", ("embed", "heads", None)),
    (r"attn/wk$", ("embed", "kv_heads", None)),
    (r"attn/wv$", ("embed", "kv_heads", None)),
    (r"attn/wo$", ("heads", None, "embed")),
    (r"attn/b[qkv]$", ("heads", None)),
    (r"attn/wq_a$", ("embed", None)),
    (r"attn/wq_b$", (None, "heads", None)),
    (r"attn/wkv_a$", ("embed", None)),
    (r"attn/wk_b$", (None, "heads", None)),
    (r"attn/wv_b$", (None, "heads", None)),
    (r"ffn/router$", ("embed", None)),
    (r"ffn/w_(in|gate)$", ("expert", "embed", None)),
    (r"ffn/w_out$", ("expert", None, "embed")),
    (r"ffn/shared_(in|gate)$", ("embed", "mlp")),
    (r"ffn/shared_out$", ("mlp", "embed")),
    (r"(ffn|block/ffn)/w_(in|gate)$", ("embed", "mlp")),
    (r"(ffn|block/ffn)/w_out$", ("mlp", "embed")),
    (r"(mamba|core)/w_(in|gate|up)$", ("embed", "mlp")),
    (r"(mamba|core)/w_(out|down)$", ("mlp", "embed")),
    (r"(mamba|core)/wq$", ("mlp", "mlp2")),
    (r"(mamba|core)/wk$", ("mlp", "mlp2")),
    (r"(mamba|core)/wv$", ("mlp", "mlp2")),
    (r"(mamba|core)/w_if$", ("mlp", None)),
    (r"(mamba|core)/w_bc$", ("mlp", None)),
    (r"(mamba|core)/w_dt1$", ("mlp", None)),
    (r"(mamba|core)/w_dt2$", (None, "mlp")),
    (r"(mamba|core)/conv$", (None, "mlp")),
    (r"(mamba|core)/a_log$", ("mlp", None)),
    (r"(mamba|core)/(d_skip|gn_scale)$", ("mlp",)),
    (r"core/w_gates$", ("embed", None, "heads", None)),
    (r"core/r_gates$", (None, "heads", None, None)),
    (r"core/b_gates$", (None, "heads", None)),
    (r"mtp/proj$", (None, "embed")),
]


def _logical_to_mesh(mode: str, mesh) -> dict[str, Any]:
    """Map logical axis names -> mesh axes for param dims."""
    fsdp = mode == "fsdp"
    return {
        "embed": "data" if fsdp else None,  # zero-style shard of d_model dim
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "mlp2": None,
        "expert": "model",
    }


def _spec_for_path(path: str, n_prefix_axes: int, mapping: dict) -> tuple:
    for pat, dims in _PARAM_RULES:
        if re.search(pat, path):
            mapped = tuple(mapping.get(d) if d else None for d in dims)
            return (None,) * n_prefix_axes + mapped
    # norms / scalars: replicated over param dims
    return ()


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over nested dicts, lists and (named) tuples, the
    path the reference's ``_path_str`` of the leaf ("stages/0/0_attn/attn/wq";
    a named tuple's fields by name)."""
    def join(key) -> str:
        return f"{path}/{key}" if path else str(key)

    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, join(f))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, join(i)) for i, v in enumerate(tree))
    return fn(path, tree)


def _axis_size(mesh, ax) -> int:
    if isinstance(ax, str):
        return int(mesh.shape[ax])
    return int(np.prod([mesh.shape[a] for a in ax]))


def _in_stage(path: str) -> bool:
    return "/stages/" in f"/{path}/" or path.startswith("stages/")


def leaf_spec(path: str, shape, mesh, mode: str) -> tuple:
    """The spec of one per-replica leaf at ``path`` (``param_specs``'s rule
    for a leaf)."""
    mapping = _logical_to_mesh(mode, mesh)
    n_prefix = 1 if _in_stage(path) else 0  # stage scan axis is unsharded
    spec = _spec_for_path(path, n_prefix, mapping)
    nd = len(shape)
    tup = (tuple(spec) + (None,) * (nd - len(spec)))[:nd]
    # drop shardings on dims not divisible by the mesh axis size
    return tuple(None if ax is None or dim % _axis_size(mesh, ax) else ax
                 for dim, ax in zip(shape, tup))


def param_specs(cfg, params_shape, mesh, mode: str):
    """The spec tree matching ``params_shape`` (a tree of tensors, meta
    tensors included, or anything with ``.shape``): the *per-replica*
    params, prefix axes = [stage scan axis] where applicable."""
    return tree_map_with_path(lambda p, leaf: leaf_spec(p, tuple(leaf.shape), mesh, mode),
                              params_shape)


def _lead(axes: tuple[str, ...]):
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def add_fl_axis(specs, mesh, mode: str):
    """Prepend the fl sharding axis to every param spec (params are stacked
    with a leading fl axis by the trainer)."""
    lead = _lead(fl_axes(mesh, mode))
    return _map_specs(lambda spec: (lead, *spec), specs)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) or (isinstance(a, tuple) and all(
            isinstance(b, str) for b in a)) for a in x)


def _map_specs(fn, specs):
    if _is_spec(specs):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if hasattr(specs, "_fields"):
        return type(specs)(*(_map_specs(fn, v) for v in specs))
    return type(specs)(_map_specs(fn, v) for v in specs)


# ---------------------------------------------------------------------------
# activation/batch specs
# ---------------------------------------------------------------------------

def batch_spec(mesh, mode: str, *, with_fl_axis: bool) -> tuple:
    """Spec for (fl?, B, S) token batches."""
    lead = _lead(fl_axes(mesh, mode))
    if with_fl_axis:
        batch_dim = "data" if mode == "fsdp" else None
        return (lead, batch_dim, None)
    return ("data", None)


def data_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _fit(mesh, dim: int, candidates: list):
    """First candidate axis (or tuple) that divides dim."""
    for ax in candidates:
        if ax is None:
            continue
        if dim % _axis_size(mesh, ax) == 0:
            return ax
    return None


def _flatten_axes(used) -> set:
    out = set()
    for u in used:
        if isinstance(u, str):
            out.add(u)
        elif u:
            out.update(u)
    return out


def cache_specs(cache_shapes, mesh, *, length: bool = True):
    """Specs for decode caches (leaves carry a leading layer-stack axis).
    Priority: batch -> data axes; heads/state dims -> model; cache length
    absorbs whatever axes remain (long_500k has batch 1).  ``length=False``
    keeps the cache length whole (``local_cache_specs``)."""
    da = data_axes(mesh)
    da_flat = da if len(da) > 1 else da[0]

    def spec_one(path, leaf):
        shape = tuple(leaf.shape)
        if re.search(r"/pos$", path) or len(shape) <= 2:
            return ()
        used: list = []
        dims: list = [None] * len(shape)  # dim 0 = layer stack, unsharded
        if re.search(r"kv/(k|v)$", path) or re.search(r"mla/(c_kv|k_rope)$", path):
            # (layer, B, L, G, dh) or (layer, B, L, R)
            b, n_len = shape[1], shape[2]
            bax = _fit(mesh, b, [da_flat, "data"])
            dims[1] = bax
            if bax is not None:
                used.append(bax)
            head_dim_idx = 3 if len(shape) >= 4 else None
            remaining = [a for a in ("model",) + tuple(da) if a not in _flatten_axes(used)]
            if head_dim_idx is not None and len(shape) >= 5:
                hax = _fit(mesh, shape[3], ["model"]) if "model" in remaining else None
                if hax:
                    dims[3] = hax
                    remaining.remove("model")
            rem = list(remaining)
            if length:
                dims[2] = _fit(mesh, n_len, [tuple(rem) if len(rem) > 1
                                             else (rem[0] if rem else None), "model", "data"])
            return tuple(dims)
        if re.search(r"(mamba/(conv|ssm)|mlstm/(c|n|m)|slstm/(c|n|h|m))$", path):
            dims[1] = _fit(mesh, shape[1], [da_flat, "data"])
            # shard the big inner dim (d_inner or heads) over model
            if len(shape) >= 3:
                dims[2] = _fit(mesh, shape[2], ["model"])
            return tuple(dims)
        return ()

    return tree_map_with_path(spec_one, cache_shapes)


def local_cache_specs(cache_shapes, mesh):
    """The blocks the port's decode holds: ``cache_specs`` with the cache
    length whole.  Where the reference puts the length over ``model`` (KV
    heads that do not divide it) each rank of a model group holds every
    slot of every KV head; the attention of its own q heads reads them."""
    return cache_specs(cache_shapes, mesh, length=False)


def token_batch_specs(batch_shapes, mesh, *, fl_axis: bool, mode: str):
    """Specs for batch dicts.  With fl_axis: leaves are (m, B, ...) - m over
    the fl axes; inner B over 'data' only in fsdp mode.  Without: (B, ...)
    over the data axes."""
    if fl_axis:
        lead = _lead(fl_axes(mesh, mode))
        inner = "data" if mode == "fsdp" else None

        def spec_one(_, leaf):
            shape = tuple(leaf.shape)
            dims = [lead] + [None] * (len(shape) - 1)
            if len(shape) >= 2 and inner is not None and shape[1] % mesh.shape[inner] == 0:
                dims[1] = inner
            return tuple(dims)
    else:
        da = data_axes(mesh)
        da_flat = da if len(da) > 1 else da[0]

        def spec_one(_, leaf):
            shape = tuple(leaf.shape)
            dims = [None] * len(shape)
            if shape and shape[0] % _axis_size(mesh, da_flat) == 0:
                dims[0] = da_flat
            elif shape and shape[0] % mesh.shape["data"] == 0:
                dims[0] = "data"
            return tuple(dims)

    return tree_map_with_path(spec_one, batch_shapes)


def activation_mapping(mode: str) -> dict[str, Any]:
    """Logical activation axes -> mesh axes per mode (the reference's
    ``constrain`` targets; the port keeps activations whole over
    ``model`` between its tensor-parallel blocks)."""
    return {
        "batch": "data" if mode in ("fsdp", "serve") else None,
        "seq": "model",  # sequence parallelism at layer boundaries
        "embed": None,
        "heads": "model",
        "vocab": "model",
        "expert": "model",
    }


# ---------------------------------------------------------------------------
# a rank's blocks of a leaf
# ---------------------------------------------------------------------------

def block_index(mesh, ax) -> tuple[int, int]:
    """(this rank's block, the number of blocks) of a dim split over ``ax``
    (an axis or a tuple of them, row-major: ("pod", "data") counts pods
    first); ``mesh.coords`` holds the rank's coordinate on each axis."""
    axes = (ax,) if isinstance(ax, str) else tuple(ax)
    idx = 0
    for a in axes:
        idx = idx * int(mesh.shape[a]) + int(mesh.coords[a])
    return idx, _axis_size(mesh, axes)


def shard_leaf(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``: a contiguous copy (so the
    whole leaf can be freed)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        idx, n = block_index(mesh, ax)
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not split {n} ways ({ax})")
        x = x.narrow(dim, idx * (size // n), size // n)
    return x if x.device.type == "meta" else x.contiguous().clone()


def shard_tree(tree, specs, mesh):
    """``shard_leaf`` over a tree and its spec tree."""
    from repro_torch.tree import tree_leaves, tree_unflatten

    return tree_unflatten(tree, [shard_leaf(x, s, mesh) for x, s in
                                 zip(tree_leaves(tree), spec_leaves(specs), strict=True)])


def spec_leaves(specs) -> list:
    """The specs in ``tree_leaves`` order (a dict's keys sorted)."""
    if _is_spec(specs):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for item in specs for s in spec_leaves(item)]


def gather_leaf(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from every rank's blocks (on every rank)."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            x = mesh.axis(ax).cat(x, dim)
    return x


def gather_tree(tree, specs, mesh):
    from repro_torch.tree import tree_leaves, tree_unflatten

    return tree_unflatten(tree, [gather_leaf(x, s, mesh) for x, s in
                                 zip(tree_leaves(tree), spec_leaves(specs), strict=True)])


def layer_slicer(mesh, mode: str):
    """``(path, tensor) -> this rank's block`` for one leaf as the model's
    init draws it: a stage leaf one layer at a time (without the stacked
    layer axis), any other leaf whole."""
    def take(path: str, t: torch.Tensor) -> torch.Tensor:
        if _in_stage(path):
            spec = leaf_spec(path, (1, *t.shape), mesh, mode)[1:]
        else:
            spec = leaf_spec(path, tuple(t.shape), mesh, mode)
        return shard_leaf(t, spec, mesh)

    return take


def whole_over_model(spec: tuple) -> bool:
    """Whether a leaf of ``spec`` is the same on every rank of a model
    group (no dim split over ``model``)."""
    return not any(ax == "model" or (isinstance(ax, tuple) and "model" in ax)
                   for ax in spec)


# ---------------------------------------------------------------------------
# collectives over one mesh axis
# ---------------------------------------------------------------------------

class AxisGroup(NamedTuple):
    """A mesh axis (or a tuple of axes, flattened row-major) seen from one
    rank: its size, the rank's index along it and the process group of the
    ranks that differ from this one only along it (None when the axis has
    one rank, or without ``torch.distributed``)."""
    size: int
    index: int
    group: Any = None

    def stack(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (same shape and dtype) stacked in axis order,
        (size, ...): one all-gather into one buffer."""
        if self.group is None:
            return x[None]
        import torch.distributed as dist

        src = x.contiguous().reshape(1, -1)
        wire = src.view(torch.uint8) if src.dtype == torch.bool else src
        out = torch.empty((self.size, wire.shape[1]), dtype=wire.dtype, device=wire.device)
        # the concatenated form (gloo takes no other); all_gather_single
        # where torch has it (the name all_gather_into_tensor is deprecated)
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, wire, group=self.group)
        out = out.view(torch.bool) if src.dtype == torch.bool else out
        return out.view(self.size, *x.shape)

    def gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``x``, in axis order."""
        return list(self.stack(x).unbind(0))

    def cat(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks concatenated along ``dim`` (along dim 0 the
        gather's own buffer)."""
        if self.group is None:
            return x
        if dim % max(x.dim(), 1) == 0:
            return self.stack(x).flatten(0, 1)
        return torch.cat(self.gather(x), dim=dim)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' partials added in axis order (fp32 for a bf16 one,
        rounded once), the same bits on every rank."""
        parts = self.gather(x)
        if len(parts) == 1:
            return x
        acc = parts[0].float() if x.dtype == torch.bfloat16 else parts[0].clone()
        for p in parts[1:]:
            acc += p
        return acc.to(x.dtype)

    def sum_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``dim`` of the ranks' partials' sum: each
        rank sends every other its block (one all-to-all) and adds the
        blocks it gets in axis order (``sum``'s bits, a block of them)."""
        if self.group is None:
            return x
        import torch.distributed as dist

        src = x.movedim(dim, 0)
        n = src.shape[0] // self.size
        src = src.reshape(self.size, n, *src.shape[1:]).contiguous()
        parts = torch.empty_like(src)
        dist.all_to_all_single(parts, src, group=self.group)
        acc = parts[0].float() if x.dtype == torch.bfloat16 else parts[0].clone()
        for p in parts[1:]:
            acc += p
        return acc.to(x.dtype).movedim(0, dim)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        parts = self.gather(x)
        out = parts[0]
        for p in parts[1:]:
            out = torch.maximum(out, p)
        return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.sum(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return axis.sum_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.cat(g.contiguous(), ctx.dim), None, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.n = dim, axis, x.shape[dim]
        return axis.cat(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None


def copy_to_model(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """Identity forward; the gradient summed over ``axis`` (a replicated
    input whose uses are split over the model ranks)."""
    return _CopyToModel.apply(x, axis) if axis.size > 1 else x


def reduce_from_model(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """The ranks' partials summed; the gradient passed through as is."""
    return _ReduceFromModel.apply(x, axis) if axis.size > 1 else x


def sum_scatter(x: torch.Tensor, dim: int, axis: AxisGroup) -> torch.Tensor:
    """The ranks' partials summed, this rank's block of ``dim`` kept; the
    gradient's blocks gathered back."""
    return _SumScatter.apply(x, dim, axis) if axis.size > 1 else x


def take_block(x: torch.Tensor, dim: int, axis: AxisGroup) -> torch.Tensor:
    """This rank's block of ``dim`` of a replicated ``x`` (its gradient
    summed over the axis: each rank's block fills its part)."""
    n = x.shape[dim] // axis.size
    return copy_to_model(x, axis).narrow(dim, axis.index * n, n)


def gather_along(x: torch.Tensor, dim: int, axis: AxisGroup) -> torch.Tensor:
    """The ranks' blocks of ``dim`` concatenated; the gradient's own block
    comes back."""
    return _GatherAlong.apply(x, dim, axis) if axis.size > 1 else x


# ---------------------------------------------------------------------------
# the model axis the model code shards over
# ---------------------------------------------------------------------------

# a module global, not a thread-local: autograd runs a backward (and remat's
# recompute of a layer) on a thread of its own, inside the same step
_MODEL: list[Optional[AxisGroup]] = [None]


@contextlib.contextmanager
def tensor_parallel(axis: Optional[AxisGroup]):
    """Run the model with its tensor-parallel leaves split over ``axis``."""
    prev = _MODEL[0]
    _MODEL[0] = axis if axis is not None and axis.size > 1 else None
    try:
        yield
    finally:
        _MODEL[0] = prev


def model_axis() -> Optional[AxisGroup]:
    """The model axis of the running step, None when the model runs whole."""
    return _MODEL[0]


def refuse(what: str) -> None:
    """Raise for a block type whose tensor-parallel form is not ported."""
    raise NotImplementedError(
        f"{what} over a mesh 'model' axis of size {_MODEL[0].size}: its tensor-parallel "
        f"form is {ITEM_19B}; run it with model = 1 (replica mode)")
