"""The gather-mix kernels' row-group plan and the dense kernel's split-TF32
arithmetic, on the CPU.

``kernels/mixing/plan.py`` cuts the rows of a neighbor list into groups
whose union of read rows fits a staged kernel's shared memory; the tests
hold its tables to their definition on the real m=4096 fleet fabric (the
128-column tier, tables as the first version of the plan built them), on
random tables with no locality, on a ring, on a dense fabric (the wide
tier, every row staged) and on a denser one whose rows partly read more
rows than a wide slab holds (the direct kernel's rows), and replay the
three kernels' use of the plan in numpy (zero-weight slots skipped on a
finite slab, and in the direct kernel where the row read is finite) bit
for bit and NaN for NaN against the plain version.  ``mix_ref_3xtf32`` (the dense kernel's
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


# the denser fabric: rgg r=0.7 at m=2048 (d_max 2047), whose rows partly
# read more rows than a wide slab holds
DENSER = (2048, 0.7)


def _table(case):
    if case == "fleet":  # the fleet cell's fabric
        return _fabric(4096, ttopo.fleet_radius(4096))[1].idx
    if case == "random":
        return torch.as_tensor(_ell(np.random.default_rng(5), 300, 6)[0])
    if case == "ring":
        return torch.as_tensor(ttopo.neighbor_list_from_edges(
            ttopo.ring_edges(200)).idx, dtype=torch.int64)
    if case == "denser":
        return _fabric(*DENSER)[1].idx
    # rgg at the paper's radius: ~300 neighbours, every row in a wide group
    return _fabric(600, 0.4)[1].idx


def _groups_first_plan(idx):
    """The grouping of the first version of the plan (one tier, 128
    columns, union rows as lists): BFS-grown balls within
    ``plan.limits(d_max)``."""
    m, d_max = idx.shape
    rows_cap, union_cap = tplan.limits(d_max)
    reads = [sorted(set([i] + r)) for i, r in enumerate(idx.tolist())]
    nbrs = [[j for j in r if j != i] for i, r in enumerate(reads)]
    order, seen = [], [False] * m
    for start in sorted(range(m), key=lambda i: (len(nbrs[i]), i)):
        if not seen[start]:
            seen[start], queue = True, [start]
            while queue:
                i = queue.pop(0)
                order.append(i)
                for j in nbrs[i]:
                    if not seen[j]:
                        seen[j] = True
                        queue.append(j)
    assigned, groups = [len(r) > union_cap for r in reads], []
    for seed in order:
        if assigned[seed]:
            continue
        assigned[seed], grp, uni, queue = True, [seed], set(reads[seed]), [seed]
        while queue and len(grp) < rows_cap:
            for j in nbrs[queue.pop(0)]:
                if assigned[j] or len(uni | set(reads[j])) > union_cap:
                    continue
                assigned[j] = True
                grp.append(j)
                uni |= set(reads[j])
                queue.append(j)
                if len(grp) == rows_cap:
                    break
        groups.append((grp, sorted(uni)))
    return groups


@pytest.mark.parametrize("case", ["fleet", "random", "ring", "dense", "denser"])
def test_plan_tables_cover_every_slot_within_budget(case):
    idx = _table(case)
    m, d_max = idx.shape
    plan = tplan.build_plan(idx)
    rows = plan.rows.numpy()
    row_ptr, union_ptr = plan.row_ptr.numpy(), plan.union_ptr.numpy()
    union = plan.union.numpy()
    slot_pos, self_pos = plan.slot_pos.numpy(), plan.self_pos.numpy()
    assert row_ptr[0] == 0 and row_ptr[-1] == rows.size and np.all(np.diff(row_ptr) > 0)
    # the dense tables take the wide tier, within its own limits
    assert plan.wide == (case in ("dense", "denser"))
    if plan.wide:
        assert plan.chunk in tplan.WIDE_CHUNKS
        rows_cap, union_cap = tplan.WIDE_ROWS_MAX, tplan.wide_union_cap(plan.chunk)
        assert plan.smem_bytes <= tplan.WIDE_BUDGET
    else:
        assert plan.chunk == tplan.CHUNK
        rows_cap, union_cap = tplan.limits(d_max)
        assert plan.smem_bytes <= tplan.SMEM_BUDGET
    # every row in exactly one group or in the direct kernel's list, which
    # holds the rows whose own reads would not fit a slab: only the denser
    # fabric has such rows
    direct = plan.direct.numpy()
    assert np.array_equal(np.sort(np.concatenate([rows, direct])), np.arange(m))
    assert all(np.unique(np.append(idx[i].numpy(), i)).size > union_cap
               for i in direct)
    assert (direct.size > 0) == (case == "denser")
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
        # the first version's tables, bit for bit
        first = _groups_first_plan(idx.numpy())
        assert plan.n_groups == len(first) == 69
        assert np.array_equal(rows, np.concatenate([g for g, _ in first]))
        assert np.array_equal(union, np.concatenate([u for _, u in first]))
    if case == "dense":  # every row staged, a few staged rows per output row
        assert plan.staged_per_row < 6
    again = tplan.build_plan(idx)  # deterministic
    tables = ("rows", "row_ptr", "union", "union_ptr", "slot_pos", "self_pos", "direct")
    assert all(torch.equal(getattr(plan, t), getattr(again, t)) for t in tables)


@pytest.mark.parametrize("m,radius,chunk", [(600, 0.4, 64), (4096, 0.2, 32),
                                            (4096, 0.4, 64)])
def test_wide_chunk_follows_the_staging(m, radius, chunk):
    """A wide table takes 64 columns unless they stage more than twice the
    rows per output row of 32: rgg r=0.4 at m=600 stages alike at both
    widths; rgg r=0.2 at m=4096 splits its groups at 64 columns' smaller
    unions; rgg r=0.4 at m=4096 sends more rows direct at 64 columns but
    stages alike."""
    nbr_idx = _fabric(m, radius)[1].idx
    plan = tplan.build_plan(nbr_idx)
    assert plan.wide and plan.chunk == chunk
    at = {c: tplan.group_rows(nbr_idx.numpy(), tplan.WIDE_ROWS_MAX, tplan.wide_union_cap(c))
          for c in tplan.WIDE_CHUNKS}
    staged = {c: sum(map(len, u)) / max(1, sum(map(len, g))) for c, (g, u, _) in at.items()}
    assert (staged[64] > 2 * staged[32]) == (chunk == 32)
    # the chosen cut's tables
    again = tplan.plan_of(nbr_idx, chunk, at[chunk])
    tables = ("rows", "row_ptr", "union", "union_ptr", "slot_pos", "self_pos", "direct")
    assert all(torch.equal(getattr(plan, t), getattr(again, t)) for t in tables)
    if radius == 0.4 and m == 4096:
        assert len(at[64][2]) > len(at[32][2]) > 0


def _replay(plan, idx, p_diag, p_off, w):
    """The kernels' use of the plan in numpy fp32, every row at once: a
    staged row reads its rows through its group's union (``slot_pos``,
    ``self_pos``) and per ``plan.chunk``-column chunk leaves out its
    zero-weight slots where the group's staged slab is finite; a direct
    row reads ``w`` itself and leaves out a zero-weight slot where the row
    it reads is finite; slots summed in order."""
    idx, p_diag, p_off, w = (t.numpy() for t in (idx, p_diag, p_off, w))
    m, d_max = idx.shape
    n_chunks = -(-w.shape[1] // plan.chunk)
    rows, row_ptr = plan.rows.numpy(), plan.row_ptr.numpy()
    union, union_ptr = plan.union.numpy(), plan.union_ptr.numpy()
    src, me = idx.copy(), np.arange(m)
    skip = np.zeros((m, d_max, n_chunks), bool)
    zero = p_off == 0
    for g in range(plan.n_groups):
        grp = rows[row_ptr[g]:row_ptr[g + 1]]
        uni = union[union_ptr[g]:union_ptr[g + 1]]
        src[grp] = uni[plan.slot_pos.numpy()[grp]]
        me[grp] = uni[plan.self_pos.numpy()[grp]]
        finite = [np.isfinite(w[uni, c * plan.chunk:(c + 1) * plan.chunk]).all()
                  for c in range(n_chunks)]
        skip[grp] = zero[grp][:, :, None] & np.asarray(finite)[None, None, :]
    direct = plan.direct.numpy()
    row_finite = np.isfinite(w).all(1)
    skip[direct] = (zero[direct] & row_finite[idx[direct]])[:, :, None]
    with np.errstate(invalid="ignore", over="ignore"):
        acc = p_diag[:, None] * w[me]
        for s in range(d_max):
            take = ~np.repeat(skip[:, s], plan.chunk, axis=1)[:, :w.shape[1]]
            acc = np.where(take, acc + p_off[:, s:s + 1] * w[src[:, s]], acc)
    return torch.as_tensor(acc)


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
    """The denser fabric: rows that read more rows than a wide slab holds
    go to the direct kernel, the rest are staged in wide groups."""
    m = DENSER[0]
    g, nl = _fabric(*DENSER)
    adj_ell = g.adjacency_ell(0, nl)
    v = torch.as_tensor(np.random.default_rng(3).uniform(size=m) < 0.5)
    p_diag, p_off = tmixing.build_p_ell(nl.idx, adj_ell, adj_ell & (v[:, None] | v[nl.idx]))
    w = torch.as_tensor(np.random.default_rng(6).normal(size=(m, 70)),
                        dtype=torch.float32)
    plan = tplan.build_plan(nl.idx)
    assert 0 < plan.n_direct < m and plan.n_groups > 0 and plan.wide
    assert torch.equal(_replay(plan, nl.idx, p_diag, p_off, w),
                       mix_sparse_ref(nl.idx, p_diag, p_off, w))


@pytest.mark.parametrize("case", ["dense", "denser"])
def test_plan_replay_nan_for_nan_on_dense_fabrics(case):
    """inf and NaN in the two rows of least degree, which every other row
    reaches only through zero weights: the wide kernel takes every slot on
    a slab holding them, and the direct kernel the zero-weight slots into
    them, so 0 * inf gives NaN where the plain version's does; zero-weight
    slots into finite rows are left out."""
    m, radius = (600, 0.4) if case == "dense" else DENSER
    g, nl = _fabric(m, radius)
    silent = [int(j) for j in np.argsort((nl.idx != torch.arange(m)[:, None]).sum(1).numpy(),
                                         kind="stable")[:2]]
    adj_ell = g.adjacency_ell(0, nl)
    v = silent_around(nl, silent, seed=4)
    p_diag, p_off = tmixing.build_p_ell(nl.idx, adj_ell, adj_ell & (v[:, None] | v[nl.idx]))
    assert (p_off != 0).any()
    for j in silent:
        reads = nl.idx == j
        assert (reads & (torch.arange(m)[:, None] != j)).any()
        assert not (reads & (p_off != 0)).any()
    w = torch.as_tensor(np.random.default_rng(8).normal(size=(m, 70)),
                        dtype=torch.float32)
    w[silent[0], 5] = float("inf")
    w[silent[1], 40:42] = float("nan")
    plan = tplan.build_plan(nl.idx)
    assert plan.wide and (plan.n_direct > 0) == (case == "denser")
    if case == "denser":  # direct rows read the silent rows
        assert bool(torch.isin(nl.idx[plan.direct.long()],
                               torch.as_tensor(silent)).any())
    want = mix_sparse_ref(nl.idx, p_diag, p_off, w)
    assert not torch.isfinite(want).all() and torch.isfinite(want).any()
    torch.testing.assert_close(_replay(plan, nl.idx, p_diag, p_off, w), want,
                               atol=0, rtol=0, equal_nan=True)


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
