"""The gather-mix kernel's row-group plan and the dense kernel's split-TF32
arithmetic, on the CPU.

``kernels/mixing/plan.py`` cuts the rows of a neighbor list into groups
whose union of read rows fits the kernel's shared memory; the tests hold
its tables to their definition on the real m=4096 fleet fabric, on random
tables with no locality, on a ring and on a dense fabric whose rows do not
fit (the direct kernel's rows), and replay the two kernels' use of the
plan in numpy (zero-weight slots skipped on a finite slab) bit for bit
against the plain version.  ``mix_ref_3xtf32`` (the dense kernel's
arithmetic) is held against the JAX package's ``mix_pallas`` (interpret
mode) and ``mix_ref`` at atol 1e-5, the kernel's limit on the card, and
against ``mix_ref`` on inf and NaN inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mixing import ops as jmix  # noqa: E402
from repro_torch.core import mixing as tmixing  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.kernels.mixing import ops as tmix  # noqa: E402
from repro_torch.kernels.mixing import plan as tplan  # noqa: E402
from repro_torch.kernels.mixing.ref import (  # noqa: E402
    mix_ref, mix_ref_3xtf32, mix_sparse_ref, split_tf32)


def _ell(rng, m, d_max):
    """A random ELL table with padded slots: pads self-index, zero weight
    (the tables of ``test_torch_cuda_kernels.py``)."""
    idx = np.tile(np.arange(m, dtype=np.int64)[:, None], (1, d_max))
    mask = np.zeros((m, d_max), bool)
    for i in range(m):
        nb = rng.choice(m, size=min(int(rng.integers(0, d_max + 1)), m),
                        replace=False)
        idx[i, :nb.size] = np.sort(nb)
        mask[i, :nb.size] = True
    p_off = np.where(mask, rng.uniform(0, 0.2, (m, d_max)), 0).astype(np.float32)
    return idx, (1.0 - p_off.sum(1)).astype(np.float32), p_off


def _fabric(m, radius, seed=0):
    g = ttopo.make_process(m, "rgg", radius=radius, time_varying="edge_dropout",
                           drop=0.3, seed=seed)
    return g, ttopo.StagedNeighbors.from_host(g.neighbors(), "cpu")


def _table(case):
    if case == "fleet":  # the fleet cell's fabric
        return _fabric(4096, ttopo.fleet_radius(4096))[1].idx
    if case == "random":
        return torch.as_tensor(_ell(np.random.default_rng(5), 300, 6)[0])
    if case == "ring":
        return torch.as_tensor(ttopo.neighbor_list_from_edges(
            ttopo.ring_edges(200)).idx, dtype=torch.int64)
    # rgg at the paper's radius: ~500 neighbours, most rows do not fit
    return _fabric(600, 0.4)[1].idx


@pytest.mark.parametrize("case", ["fleet", "random", "ring", "dense"])
def test_plan_tables_cover_every_slot_within_budget(case):
    idx = _table(case)
    m, d_max = idx.shape
    plan = tplan.build_plan(idx)
    rows = plan.rows.numpy()
    row_ptr, union_ptr = plan.row_ptr.numpy(), plan.union_ptr.numpy()
    union = plan.union.numpy()
    slot_pos, self_pos = plan.slot_pos.numpy(), plan.self_pos.numpy()
    assert row_ptr[0] == 0 and row_ptr[-1] == rows.size and np.all(np.diff(row_ptr) > 0)
    rows_cap, union_cap = tplan.limits(d_max)
    assert plan.smem_bytes <= tplan.SMEM_BUDGET
    # every row in exactly one group or in the direct kernel's list, which
    # holds the rows whose own reads would not fit a slab
    direct = plan.direct.numpy()
    assert np.array_equal(np.sort(np.concatenate([rows, direct])), np.arange(m))
    assert all(np.unique(np.append(idx[i].numpy(), i)).size > union_cap
               for i in direct)
    assert (direct.size > 0) == (case == "dense")
    for g in range(plan.n_groups):
        grp = rows[row_ptr[g]:row_ptr[g + 1]]
        uni = union[union_ptr[g]:union_ptr[g + 1]]
        reads = np.unique(np.concatenate([grp, idx[grp].numpy().ravel()]))
        # the union is exactly the sorted rows the group reads, within budget
        assert np.array_equal(uni, reads)
        assert grp.size <= min(plan.max_rows, rows_cap)
        assert uni.size <= min(plan.max_union, union_cap)
        assert np.array_equal(uni[slot_pos[grp]], idx[grp].numpy())
        assert np.array_equal(uni[self_pos[grp]], grp)
    if case == "fleet":  # neighbouring rows share their reads
        assert plan.union.numel() < 3 * m
    again = tplan.build_plan(idx)  # deterministic
    tables = ("rows", "row_ptr", "union", "union_ptr", "slot_pos", "self_pos", "direct")
    assert all(torch.equal(getattr(plan, t), getattr(again, t)) for t in tables)


def _replay(plan, idx, p_diag, p_off, w):
    """The kernels' use of the plan in numpy fp32: per (group, 128-column
    chunk) the union staged, zero-weight slots left out where the staged
    slab is finite, slots summed in order; the direct rows from w itself,
    every slot taken."""
    idx, p_diag, p_off, w = (t.numpy() for t in (idx, p_diag, p_off, w))
    out = np.empty_like(w)
    rows, row_ptr = plan.rows.numpy(), plan.row_ptr.numpy()
    union, union_ptr = plan.union.numpy(), plan.union_ptr.numpy()
    slot_pos, self_pos = plan.slot_pos.numpy(), plan.self_pos.numpy()
    with np.errstate(invalid="ignore", over="ignore"):
        groups = [(rows[row_ptr[g]:row_ptr[g + 1]], union[union_ptr[g]:union_ptr[g + 1]])
                  for g in range(plan.n_groups)]
        for grp, uni in groups + [(plan.direct.numpy(), None)]:
            for c0 in range(0, w.shape[1], tplan.CHUNK):
                cols = slice(c0, c0 + tplan.CHUNK)
                src, pos, me = ((w[uni, cols], slot_pos, self_pos) if uni is not None
                                else (w[:, cols], idx, np.arange(len(w))))
                skip = uni is not None and bool(np.isfinite(src).all())
                for i in grp:
                    acc = p_diag[i] * src[me[i]]
                    for s in range(idx.shape[1]):
                        if not (skip and p_off[i, s] == 0):
                            acc = acc + p_off[i, s] * src[pos[i, s]]
                    out[i, cols] = acc
    return torch.as_tensor(out)


def silent_around(nl, rows, seed):
    """Half the devices broadcast, except ``rows`` and their neighbours:
    every slot that reads one of ``rows`` then carries zero weight."""
    v = np.random.default_rng(seed).uniform(size=nl.idx.shape[0]) < 0.5
    for j in rows:
        v[j] = False
        v[nl.idx[j].numpy()] = False
    return torch.as_tensor(v)


def test_plan_replay_bit_equal_to_plain_and_nan_for_nan():
    g, nl = _fabric(512, ttopo.fleet_radius(512), seed=3)
    adj_ell = g.adjacency_ell(0, nl)
    v = silent_around(nl, (17, 301), seed=1)
    comm_ell = adj_ell & (v[:, None] | v[nl.idx])
    p_diag, p_off = tmixing.build_p_ell(nl.idx, adj_ell, comm_ell)
    assert (p_off == 0).any() and (p_off != 0).any()
    w = torch.as_tensor(np.random.default_rng(2).normal(size=(512, 300)),
                        dtype=torch.float32)
    plan = tplan.build_plan(nl.idx)
    assert torch.equal(_replay(plan, nl.idx, p_diag, p_off, w),
                       mix_sparse_ref(nl.idx, p_diag, p_off, w))
    # inf and NaN in rows that other rows reach only through zero weights
    for j in (17, 301):
        reads = nl.idx == j
        assert (reads & (torch.arange(512)[:, None] != j)).any()
        assert not (reads & (p_off != 0)).any()
    w[17, 5] = float("inf")
    w[301, 140:142] = float("nan")
    want = mix_sparse_ref(nl.idx, p_diag, p_off, w)
    assert not torch.isfinite(want).all()
    torch.testing.assert_close(_replay(plan, nl.idx, p_diag, p_off, w), want,
                               atol=0, rtol=0, equal_nan=True)


def test_plan_replay_with_direct_rows_bit_equal_to_plain():
    """A dense fabric: most rows read more rows than a slab holds and go to
    the direct kernel, the rest are staged."""
    g, nl = _fabric(600, 0.4)
    adj_ell = g.adjacency_ell(0, nl)
    v = torch.as_tensor(np.random.default_rng(3).uniform(size=600) < 0.5)
    p_diag, p_off = tmixing.build_p_ell(nl.idx, adj_ell, adj_ell & (v[:, None] | v[nl.idx]))
    w = torch.as_tensor(np.random.default_rng(6).normal(size=(600, 130)),
                        dtype=torch.float32)
    plan = tplan.build_plan(nl.idx)
    assert 0 < plan.n_direct < 600 and plan.n_groups > 0
    assert torch.equal(_replay(plan, nl.idx, p_diag, p_off, w),
                       mix_sparse_ref(nl.idx, p_diag, p_off, w))


@pytest.mark.parametrize("case", ["fleet_512", "random"])
def test_cpu_mix_sparse_ignores_the_plan(case):
    """The CPU path takes no plan (``prepare_plan`` gives none there) and
    launches nothing."""
    if case == "random":
        idx, p_diag, p_off = (torch.as_tensor(a) for a in
                              _ell(np.random.default_rng(9), 97, 5))
    else:
        g, nl = _fabric(512, ttopo.fleet_radius(512))
        idx = nl.idx
        adj_ell = g.adjacency_ell(1, nl)
        p_diag, p_off = tmixing.build_p_ell(idx, adj_ell, adj_ell)
    w = torch.as_tensor(np.random.default_rng(4).normal(size=(idx.shape[0], 257)),
                        dtype=torch.float32)
    before = dict(tmix.LAUNCHES)
    assert tmix.prepare_plan(idx) is None
    assert torch.equal(tmix.mix_sparse(idx, p_diag, p_off, w),
                       mix_sparse_ref(idx, p_diag, p_off, w))
    assert dict(tmix.LAUNCHES) == before


def _stochastic(rng, m):
    p = rng.uniform(size=(m, m)).astype(np.float32)
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("m,n", [(1, 130), (8, 1000), (33, 130), (33, 1000),
                                 (300, 257)])
def test_3xtf32_matches_pallas_and_fp32(m, n):
    """The dense kernel's split-TF32 arithmetic against the Pallas kernel
    (interpret) and the fp32 product, at the card's limit atol 1e-5; the
    term it drops (lo * lo) is ~2^-22 of the products, well inside it."""
    rng = np.random.default_rng([m, n, 14])
    p = _stochastic(rng, m)
    w = rng.normal(size=(m, n)).astype(np.float32)
    got = mix_ref_3xtf32(torch.as_tensor(p), torch.as_tensor(w))
    want = np.asarray(jmix.mix(jnp.asarray(p), jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    fp32 = mix_ref(torch.as_tensor(p), torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), fp32.numpy(), rtol=0, atol=1e-5)
    # the dropped term, against the products' scale
    p_hi, p_lo = split_tf32(torch.as_tensor(p))
    w_hi, w_lo = split_tf32(torch.as_tensor(w))
    assert bool(((p_hi + p_lo) - torch.as_tensor(p)).abs().max() <= 2.0 ** -22)
    scale = torch.as_tensor(np.abs(p)) @ torch.as_tensor(np.abs(w))
    dropped = (p_lo @ w_lo).abs()
    assert bool((dropped <= 2.0 ** -21 * scale).all())
    assert float(dropped.max()) < 1e-7
    # plain TF32 (hi * hi alone) is what the split repairs
    assert float((p_hi @ w_hi - fp32).abs().max()) > float((got - fp32).abs().max())


@pytest.mark.parametrize("where", ["w", "p", "both"])
def test_3xtf32_nonfinite_as_fp32(where):
    """inf and NaN in W or P, two infinities in one product included: the
    split leaves NaN wherever such a value (or a finite one that TF32
    rounding carries past FLT_MAX) takes part, and those outputs are the
    fp32 product's, so the output has inf and NaN where and as the fp32
    product has them and the near-FLT_MAX value's column stays finite."""
    rng = np.random.default_rng(11)
    p = torch.as_tensor(_stochastic(rng, 40))
    w = torch.as_tensor(rng.normal(size=(40, 70)).astype(np.float32))
    p[7, 3] = 0.0  # 0 * inf in row 7
    if where in ("w", "both"):
        w[3, 10], w[5, 11], w[20, 30:33] = float("inf"), float("-inf"), float("nan")
    if where in ("p", "both"):
        p[30, 12], p[31, 13] = float("-inf"), float("nan")
    if where == "both":
        p[35, 3] = float("inf")  # times w[3, 10] = inf
    w[25, 40] = float(np.nextafter(np.float32(3.4028235e38), np.float32(0)))
    want = mix_ref(p, w)
    assert not torch.isfinite(want).all() and torch.isfinite(want[:30, 40]).all()
    torch.testing.assert_close(mix_ref_3xtf32(p, w), want, rtol=1e-5, atol=1e-5,
                               equal_nan=True)
