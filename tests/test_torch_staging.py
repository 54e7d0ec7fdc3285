"""Host staging and graph realization of repro_torch against the JAX
package: the data copies must be array-equal, every edge builder must
emit the same canonical edge list, and the per-iteration graphs G^(k)
(dense and ELL) must be equal for every time-varying kind -- including
the two-word edge-dropout stream above m = 46340."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import topology as jtopo  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.data import loader as tloader  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

CPU = torch.device("cpu")


# ------------------------------------------------------------------ data ---

@pytest.mark.parametrize("kw", [dict(n=300, dim=24, seed=0),
                                dict(n=257, dim=64, n_classes=7, seed=3),
                                dict(n=200, dim=49, seed=1, smooth=1)])
def test_image_dataset_equal(kw):
    n = kw.pop("n")
    xj, yj = jsyn.image_dataset(n, **kw)
    xt, yt = tsyn.image_dataset(n, **kw)
    assert np.array_equal(xj, xt) and np.array_equal(yj, yt)
    assert xt.dtype == xj.dtype and yt.dtype == yj.dtype


@pytest.mark.parametrize("m,per", [(8, 3), (10, 1), (33, 2)])
def test_by_labels_equal(m, per):
    _, y = jsyn.image_dataset(600, dim=8, seed=0)
    for a, b in zip(jpart.by_labels(y, m, per), tpart.by_labels(y, m, per)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("m,alpha,seed", [(8, 0.3, 0), (16, 1.0, 4)])
def test_dirichlet_equal(m, alpha, seed):
    _, y = jsyn.image_dataset(800, dim=8, seed=2)
    got = tpart.dirichlet(y, m, alpha, seed=seed)
    want = jpart.dirichlet(y, m, alpha, seed=seed)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert np.array_equal(a, b)


def test_stage_and_next_equal():
    x, y = jsyn.image_dataset(400, dim=8, seed=0)
    parts = jpart.by_labels(y, 6, 2)
    jb = jloader.FederatedBatches(x, y, parts, 5, seed=2)
    tb = tloader.FederatedBatches(x, y, parts, 5, seed=2)
    assert np.array_equal(jb.stage(7), tb.stage(7))
    for a, b in zip(jb.next(), tb.next()):
        assert np.array_equal(a, b)


# ----------------------------------------------------------------- edges ---

BUILDERS = [
    ("rgg", dict(radius=0.4)), ("rgg", dict(radius=0.15)),
    ("er", dict(er_p=0.3)), ("ring", {}), ("complete", {}),
    ("scale_free", dict(m_attach=2)), ("clustered", {}),
]


@pytest.mark.parametrize("m", [9, 64])
@pytest.mark.parametrize("topology,kw", BUILDERS)
def test_edge_builders_equal(topology, kw, m):
    gj = jtopo.make_process(m, topology, seed=3, **kw)
    gt = ttopo.make_process(m, topology, seed=3, **kw)
    assert gt.edges.m == gj.edges.m and gt.seed == gj.seed
    assert np.array_equal(gt.edges.u, gj.edges.u)
    assert np.array_equal(gt.edges.v, gj.edges.v)
    assert gt.edges.u.dtype == gj.edges.u.dtype
    nj, nt = gj.neighbors(), gt.neighbors()
    assert np.array_equal(nj.idx, nt.idx) and np.array_equal(nj.mask, nt.mask)


@pytest.mark.parametrize("kind", ["static", "edge_dropout", "partition_cycle"])
@pytest.mark.parametrize("topology,m", [("rgg", 16), ("ring", 12),
                                        ("scale_free", 20)])
def test_adjacency_dense_and_ell_equal(kind, topology, m):
    gj = jtopo.make_process(m, topology, time_varying=kind, drop=0.4,
                            cycle_len=3, seed=1)
    gt = ttopo.make_process(m, topology, time_varying=kind, drop=0.4,
                            cycle_len=3, seed=1)
    nl_t = ttopo.StagedNeighbors.from_host(gt.neighbors(), CPU)
    nl_j = gj.neighbors()
    with jax.threefry_partitionable(False):
        for k in (0, 1, 2, 5, 17):
            a_j = np.asarray(gj.adjacency(k))
            e_j = np.asarray(gj.adjacency_ell(k, nl_j))
            assert np.array_equal(gt.adjacency(k, CPU).numpy(), a_j), k
            # k as a device tensor, the engine's form
            k_t = torch.tensor(k, dtype=torch.int64)
            assert np.array_equal(gt.adjacency_ell(k_t, nl_t).numpy(), e_j), k
            # the two layouts are one graph
            assert np.array_equal(
                ttopo.scatter_ell(nl_t.idx, gt.adjacency_ell(k_t, nl_t)).numpy(),
                a_j)


def test_two_word_dropout_stream_above_int32_cap():
    """m = 46341 > 46340: the edge ids lo * m + hi overflow int32, so both
    packages switch to fold_in(fold_in(key, lo), hi).  ELL layout only: a
    dense (m, m) matrix would take 2 GB."""
    m = 46341
    edges = jtopo.ring_edges(m)
    gj = jtopo.GraphProcess(edges, kind="edge_dropout", drop=0.5, seed=9)
    gt = ttopo.GraphProcess(ttopo.ring_edges(m), kind="edge_dropout",
                            drop=0.5, seed=9)
    nl_j = gj.neighbors()
    nl_t = ttopo.StagedNeighbors.from_host(gt.neighbors(), CPU)
    with jax.threefry_partitionable(False):
        for k in (0, 3):
            want = np.asarray(gj.adjacency_ell(k, nl_j))
            got = gt.adjacency_ell(torch.tensor(k), nl_t).numpy()
            assert np.array_equal(got, want)
            assert 0.3 < want[nl_j.mask].mean() < 0.7  # a real draw
    # the single-word stream would give another realization here
    key = ttopo.prng.fold_in(ttopo.prng.PRNGKey(9), 0)
    lo = torch.minimum(torch.arange(m)[:, None], nl_t.idx)
    hi = torch.maximum(torch.arange(m)[:, None], nl_t.idx)
    one_word = ttopo._edge_uniforms(key, lo * m + hi) >= 0.5
    assert not torch.equal(one_word & nl_t.mask,
                           gt.adjacency_ell(torch.tensor(0), nl_t))


def test_fleet_radius_equal():
    for m in (8, 64, 65, 256, 257, 4096, 100000):
        assert ttopo.fleet_radius(m) == jtopo.fleet_radius(m)


def test_scatter_ell_matches_reference():
    g = jtopo.make_process(24, "rgg", radius=0.3, seed=5)
    nl = g.neighbors()
    vals = np.random.default_rng(0).uniform(size=nl.idx.shape).astype(np.float32)
    vals = np.where(nl.mask, vals, 0.0).astype(np.float32)
    want = np.asarray(jtopo.scatter_ell(nl.idx, vals))
    got = ttopo.scatter_ell(torch.as_tensor(nl.idx, dtype=torch.int64),
                            torch.as_tensor(vals)).numpy()
    assert np.array_equal(got, want)
