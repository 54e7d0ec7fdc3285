"""``repro_torch.models.sharding``'s specs against the reference's
(``repro.models.sharding``), compared as tuples, in process.

For every one of the ten full configurations: the parameter specs
(``param_specs``, and with ``add_fl_axis``) of the parameter tree's shapes
(the port's on the meta device, the reference's from ``jax.eval_shape``)
and the decode caches' (``cache_specs``, at decode_32k's and long_500k's
batch and length), on the meshes (16, 16), (2, 2), (1, 4), (4, 1) and
(2, 2, 2) with pods, in ``replica``, ``fsdp`` and ``serve`` modes; and on
each mesh and mode ``fl_axes``, ``fl_count``, ``batch_spec``,
``token_batch_specs`` and ``activation_mapping``.  The reference's
functions read only ``mesh.shape`` and ``mesh.axis_names``, so a stand-in
object serves as the mesh on both sides.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jconfig  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import sharding as JS  # noqa: E402
from repro_torch.configs import get_config as tconfig  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import sharding as TS  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

MESHES = {"16x16": (16, 16), "2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1),
          "pods2x2x2": (2, 2, 2)}
MODES = ("replica", "fsdp", "serve")
CACHES = ((128, 32768), (1, 524288))  # decode_32k, long_500k: batch, length


class _Mesh:
    def __init__(self, shape):
        self.axis_names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))


def _tuples(spec_tree) -> list:
    """The reference's PartitionSpecs as tuples, in leaf order."""
    leaves = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, JS.P))
    return [tuple(s) for s in leaves]


@functools.lru_cache(maxsize=None)
def _param_shapes(arch: str):
    jshapes = jax.eval_shape(lambda k: JM.init_params(jconfig(arch), k),
                             jax.random.PRNGKey(0))
    return jshapes, TM.init_params(tconfig(arch), None, "meta")


@functools.lru_cache(maxsize=None)
def _cache_shapes(arch: str, batch: int, length: int):
    jshapes = jax.eval_shape(lambda: JM.init_cache(jconfig(arch), batch, length))
    return jshapes, TM.init_cache(tconfig(arch), batch, length, "meta")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh, mode):
    jshapes, tshapes = _param_shapes(arch)
    assert [tuple(s.shape) for s in jax.tree.leaves(jshapes)] == \
        [tuple(t.shape) for t in tree_leaves(tshapes)]
    jm, tm = _Mesh(MESHES[mesh]), _Mesh(MESHES[mesh])
    jspecs = JS.param_specs(jconfig(arch), jshapes, jm, mode)
    tspecs = TS.param_specs(tconfig(arch), tshapes, tm, mode)
    assert TS.spec_leaves(tspecs) == _tuples(jspecs)
    assert TS.spec_leaves(TS.add_fl_axis(tspecs, tm, mode)) == \
        _tuples(JS.add_fl_axis(jspecs, jm, mode))
    # each rank's block: a leaf splits evenly over the axes of its spec
    for spec, t in zip(TS.spec_leaves(tspecs), tree_leaves(tshapes)):
        for dim, ax in zip(t.shape, spec):
            assert ax is None or dim % TS._axis_size(tm, ax) == 0


@pytest.mark.parametrize("batch,length", CACHES, ids=["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, mesh, batch, length):
    jshapes, tshapes = _cache_shapes(arch, batch, length)
    assert [tuple(s.shape) for s in jax.tree.leaves(jshapes)] == \
        [tuple(t.shape) for t in tree_leaves(tshapes)]
    tm = _Mesh(MESHES[mesh])
    got = TS.spec_leaves(TS.cache_specs(tshapes, tm))
    assert got == _tuples(JS.cache_specs(jshapes, _Mesh(MESHES[mesh])))
    # the port's decode keeps a KV (or latent) cache's length whole, else
    # the same
    local = TS.spec_leaves(TS.local_cache_specs(tshapes, tm))
    paths = tree_leaves(TS.tree_map_with_path(lambda path, _: path, tshapes))
    for path, full, mine in zip(paths, got, local, strict=True):
        if path.endswith(("kv/k", "kv/v", "mla/c_kv", "mla/k_rope")):
            assert mine[:2] + mine[3:] == full[:2] + full[3:] and mine[2] is None, path
        else:
            assert mine == full, path


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES)
def test_batch_and_fl_specs_equal_reference(mesh, mode):
    jm, tm = _Mesh(MESHES[mesh]), _Mesh(MESHES[mesh])
    assert TS.fl_axes(tm, mode) == JS.fl_axes(jm, mode)
    assert TS.fl_count(tm, mode) == JS.fl_count(jm, mode)
    assert TS.data_axes(tm) == JS.data_axes(jm)
    assert TS.activation_mapping(mode) == JS.activation_mapping(mode)
    for with_fl in (False, True):
        assert TS.batch_spec(tm, mode, with_fl_axis=with_fl) == \
            tuple(JS.batch_spec(jm, mode, with_fl_axis=with_fl))
    m = max(TS.fl_count(tm, mode), 1)
    for batch in (1, 2, 8, 12, 256):
        shapes = {"tokens": np.zeros((batch, 16), np.int32),
                  "frontend": np.zeros((batch, 4, 8), np.float32)}
        stacked = {k: np.zeros((m, *v.shape), v.dtype) for k, v in shapes.items()}
        for fl_axis, tree in ((False, shapes), (True, stacked)):
            want = JS.token_batch_specs({k: jnp.asarray(v) for k, v in tree.items()}, jm,
                                        fl_axis=fl_axis, mode=mode)
            got = TS.token_batch_specs({k: torch.as_tensor(v) for k, v in tree.items()}, tm,
                                       fl_axis=fl_axis, mode=mode)
            assert {k: tuple(v) for k, v in want.items()} == got, (batch, fl_axis)
