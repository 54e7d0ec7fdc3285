"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips where torch finds none (the
batched launches of the sweep's cell axis included); the
file imports nothing of jax, so it runs on a GPU machine as

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import mixing as tmixing  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.kernels.mixing import ops as tmix  # noqa: E402
from repro_torch.kernels.mixing import plan as tplan  # noqa: E402
from repro_torch.kernels.mixing.ref import mix_ref, mix_sparse_ref  # noqa: E402
from repro_torch.kernels.swa import ops as tswa  # noqa: E402
from repro_torch.kernels.swa.ref import swa_ref  # noqa: E402
from repro_torch.kernels.trigger import ops as ttrig  # noqa: E402
from repro_torch.kernels.trigger.ref import trigger_sq_ref  # noqa: E402


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ell(rng, m, d_max):
    """A random ELL table with padded slots: pads self-index, zero weight."""
    idx = np.tile(np.arange(m, dtype=np.int64)[:, None], (1, d_max))
    mask = np.zeros((m, d_max), bool)
    for i in range(m):
        nb = rng.choice(m, size=min(int(rng.integers(0, d_max + 1)), m),
                        replace=False)
        idx[i, :nb.size] = np.sort(nb)
        mask[i, :nb.size] = True
    p_off = np.where(mask, rng.uniform(0, 0.2, (m, d_max)), 0).astype(np.float32)
    return idx, (1.0 - p_off.sum(1)).astype(np.float32), p_off


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(1, 7), (33, 130), (1024, 50890), (4096, 7850)])
def test_trigger_sq_kernel_matches_plain(cuda, m, n):
    g = torch.Generator(device=cuda).manual_seed(m + n)
    w = torch.randn((m, n), generator=g, device=cuda)
    h = w + 0.01 * torch.randn((m, n), generator=g, device=cuda)
    before = ttrig.LAUNCHES["trigger_sq"]
    got = ttrig.trigger_sq(w, h)
    assert ttrig.LAUNCHES["trigger_sq"] == before + 1
    torch.testing.assert_close(got, trigger_sq_ref(w, h), rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
# the split-TF32 kernel: 16-, 8- and 4-byte copies (m and D multiples of 4,
# of 2, odd), m and D off the 128 x 128 tile, and the paper path's shape
@pytest.mark.parametrize("m,n", [(1, 7), (33, 130), (130, 1000), (1024, 50890),
                                 (256, 4096), (1000, 2050), (130, 1001),
                                 (77, 333)])
def test_mix_kernel_matches_plain(cuda, m, n):
    g = torch.Generator(device=cuda).manual_seed(m + n)
    p = torch.softmax(torch.randn((m, m), generator=g, device=cuda), -1)
    w = torch.randn((m, n), generator=g, device=cuda)
    before = tmix.LAUNCHES["mix"]
    got = tmix.mix(p, w)
    assert tmix.LAUNCHES["mix"] == before + 1
    torch.testing.assert_close(got, mix_ref(p, w), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_mix_kernel_nonfinite_where_plain_is(cuda):
    """inf and NaN in W or P, two infinities in one product included: inf
    and NaN come out where and as the fp32 product has them (the epilogue
    recomputes every output the split leaves NaN), and a finite value that
    TF32 rounding would carry past FLT_MAX leaves its column finite."""
    g = torch.Generator(device=cuda).manual_seed(3)
    p = torch.softmax(torch.randn((200, 200), generator=g, device=cuda), -1)
    p[7, 3] = 0.0
    w = torch.randn((200, 999), generator=g, device=cuda)
    w[3, 10], w[4, 11], w[50, 500:503] = float("inf"), float("-inf"), float("nan")
    p[90, 12], p[91, 13], p[95, 3] = float("-inf"), float("nan"), float("inf")
    w[60, 40] = float(np.nextafter(np.float32(3.4028235e38), np.float32(0)))
    got, want = tmix.mix(p, w), mix_ref(p, w)
    assert not torch.isfinite(want).all() and torch.isfinite(want[:90, 40]).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(1, 7), (33, 130), (300, 1025)])
def test_mix_sparse_kernel_bit_equal_to_plain(cuda, m, n):
    idx, p_diag, p_off = _ell(np.random.default_rng([m, n]), m, d_max=6)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=cuda)
    p_diag = torch.as_tensor(p_diag, device=cuda)
    p_off = torch.as_tensor(p_off, device=cuda)
    w = torch.randn((m, n), device=cuda)
    want = mix_sparse_ref(idx, p_diag, p_off, w)
    assert torch.equal(tmix.mix_sparse(idx, p_diag, p_off, w), want)  # builds the plan
    assert torch.equal(tmix.mix_sparse(idx, p_diag, p_off, w), want)  # reuses it


def _fabric_p(cuda, m, radius, silent=(), cells=None):
    """The ELL P of an rgg fabric with edge dropout, half the devices
    broadcasting except ``silent`` and their neighbours (every slot that
    reads a silent row then carries zero weight); with ``cells``, each
    cell its own broadcasting devices over the shared table."""
    g = ttopo.make_process(m, "rgg", radius=radius, time_varying="edge_dropout",
                           drop=0.3, seed=0)
    nl = ttopo.StagedNeighbors.from_host(g.neighbors(), cuda)
    v = np.random.default_rng(m).uniform(size=m if cells is None else (cells, m)) < 0.5
    for j in silent:
        v[..., j] = False
        v[..., nl.idx[j].cpu().numpy()] = False
    v = torch.as_tensor(v, device=cuda)
    adj_ell = g.adjacency_ell(0, nl)
    comm_ell = adj_ell & (v[..., :, None] | v[..., nl.idx])
    p_diag, p_off = tmixing.build_p_ell(nl.idx, adj_ell, comm_ell)
    return nl, p_diag, p_off


@pytest.mark.gpu
# the fleet cell's fabric at its width and at an odd one (4-byte copies):
# the 128-column tier; the paper radius at m=1024: the wide tier (64
# columns), every row staged, at D 1000, 7850 and an odd 7851; rgg r=0.2
# at m=4096: the wide tier at 32 columns, every row staged; and at r=0.4,
# m=4096 (d_max 2090): the wide tier (64 columns) beside the direct
# kernel's rows, which read more rows than a wide slab holds
@pytest.mark.parametrize("m,radius,n", [(4096, None, 7850), (4096, None, 7851),
                                        (1024, 0.4, 1000), (1024, 0.4, 7850),
                                        (1024, 0.4, 7851), (4096, 0.2, 7851),
                                        (4096, 0.4, 7850)])
def test_mix_sparse_kernel_bit_equal_on_rgg_fabric(cuda, m, radius, n):
    nl, p_diag, p_off = _fabric_p(cuda, m, radius or ttopo.fleet_radius(m))
    plan = tmix.prepare_plan(nl.idx)
    assert plan.chunk == {None: tplan.CHUNK, 0.2: 32, 0.4: 64}[radius]
    assert (plan.n_direct > 0) == (radius == 0.4 and m == 4096)
    w = torch.randn((m, n), generator=torch.Generator(device=cuda).manual_seed(n),
                    device=cuda)
    before = dict(tmix.LAUNCHES)
    got = tmix.mix_sparse(nl.idx, p_diag, p_off, w)
    staged = "mix_sparse_wide" if plan.wide else "mix_sparse"
    assert {k: tmix.LAUNCHES[k] - before[k] for k in before} == {
        "mix": 0, "mix_sparse": 0, "mix_sparse_wide": 0, "mix_sparse_direct": 0,
        staged: 1, **({"mix_sparse_direct": 1} if plan.n_direct else {})}
    assert torch.equal(got, mix_sparse_ref(nl.idx, p_diag, p_off, w))


@pytest.mark.gpu
@pytest.mark.parametrize("m,radius", [(4096, None), (1024, 0.4), (4096, 0.4)])
def test_mix_sparse_kernel_nan_for_nan(cuda, m, radius):
    """inf and NaN in rows that the others reach only through zero-weight
    slots: the staged kernels may skip zero weights only on a finite slab
    and the direct kernel only into a finite row, so 0 * inf gives NaN
    exactly where the plain version's does."""
    silent = (17, m // 2 + 5)
    nl, p_diag, p_off = _fabric_p(cuda, m, radius or ttopo.fleet_radius(m), silent)
    for j in silent:
        assert not ((nl.idx == j) & (p_off != 0)).any()
    w = torch.randn((m, 1000), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    w[silent[0], 5] = float("inf")
    w[silent[1], 140:142] = float("nan")
    want = mix_sparse_ref(nl.idx, p_diag, p_off, w)
    assert not torch.isfinite(want).all()
    torch.testing.assert_close(tmix.mix_sparse(nl.idx, p_diag, p_off, w),
                               want, atol=0, rtol=0, equal_nan=True)


@pytest.mark.gpu
# a shard table over the stacked [own; halo] buffer (the sharded engine's
# layout): the fleet fabric at S = 8 (128-column tier, odd width too) and
# S = 1 (one junk halo row), rgg r=0.4 at m=1024 on 4 shards (wide tier),
# at m=4096 on 8 (wide and direct), and two cells a launch
@pytest.mark.parametrize("m,radius,S,n,cells", [
    (4096, None, 8, 7850, None), (4096, None, 8, 7851, None), (4096, None, 1, 1000, None),
    (1024, 0.4, 4, 7850, None), (4096, 0.4, 8, 1000, None), (4096, None, 8, 1000, 2)])
def test_mix_sparse_kernel_rectangular_source_bit_equal(cuda, m, radius, S, n, cells):
    """Output rows m, source rows n_src = m + S H_max: every route gives the
    plain version's bits, and the plan's inf/NaN rule holds on a halo row
    that its readers weight zero."""
    from repro_torch.core import efhc as tefhc

    nl, p_diag, p_off = _fabric_p(cuda, m, radius or ttopo.fleet_radius(m), cells=cells)
    g = ttopo.make_process(m, "rgg", radius=radius or ttopo.fleet_radius(m),
                           time_varying="edge_dropout", drop=0.3, seed=0)
    plan = ttopo.shard_plan(g.edges, S, coords=g.coords)
    ctx = tefhc.ShardCtx.of(plan, range(S), cuda)
    own = ctx.owned
    p_diag, p_off = p_diag[..., own].contiguous(), p_off[..., own, :].contiguous()
    n_src = m + S * plan.h_max
    lead = () if cells is None else (cells,)
    w = torch.randn(lead + (n_src, n), generator=torch.Generator(device=cuda).manual_seed(n),
                    device=cuda)
    pl = tmix.prepare_plan(ctx.nbr_loc)
    assert pl.n_src == int(ctx.nbr_loc.max()) + 1 <= n_src
    before = dict(tmix.LAUNCHES)
    got = tmix.mix_sparse(ctx.nbr_loc, p_diag, p_off, w)
    staged = "mix_sparse_wide" if pl.wide else "mix_sparse"
    assert {k: tmix.LAUNCHES[k] - before[k] for k in before} == {
        "mix": 0, "mix_sparse": 0, "mix_sparse_wide": 0, "mix_sparse_direct": 0,
        staged: 1, **({"mix_sparse_direct": 1} if pl.n_direct else {})}
    assert tuple(got.shape) == lead + (m, n)
    assert torch.equal(got, mix_sparse_ref(ctx.nbr_loc, p_diag, p_off, w))
    if S > 1:
        halo = int(ctx.nbr_loc[ctx.nbr_loc >= m][0])  # a halo row some slot reads
        p_off = torch.where(ctx.nbr_loc == halo, 0.0, p_off)
        w[..., halo, 3] = float("inf")
        w[..., halo, 7:9] = float("nan")
        want = mix_sparse_ref(ctx.nbr_loc, p_diag, p_off, w)
        assert not torch.isfinite(want).all()
        torch.testing.assert_close(tmix.mix_sparse(ctx.nbr_loc, p_diag, p_off, w), want,
                                   atol=0, rtol=0, equal_nan=True)


@pytest.mark.gpu
def test_mix_sparse_plan_follows_the_table(cuda):
    """The wrapper's plan is rebuilt for another table and after an
    in-place change of the same one."""
    idx, p_diag, p_off = (torch.as_tensor(a, device=cuda) for a in
                          _ell(np.random.default_rng(0), 40, 4))
    w = torch.randn((40, 9), device=cuda)
    first = tmix.prepare_plan(idx)
    assert tmix.prepare_plan(idx) is first
    other = idx.clone()
    assert tmix.prepare_plan(other) is not first
    idx[0, 0] = 39  # a self-indexed pad now reads row 39
    assert torch.equal(tmix.mix_sparse(idx, p_diag, p_off, w),
                       mix_sparse_ref(idx, p_diag, p_off, w))
    assert tmix.prepare_plan(idx).version == idx._version


@pytest.mark.gpu
# (atol, rtol, relative L2): fp32 (split-TF32 kernel) sums the fp32 products
# (three TF32 products each) in another order; bf16 (tensor-core kernel)
# also rounds P to bf16 before P V, and both sides round the output once to
# bf16, so they differ by about one bf16 step
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (2e-5, 2e-5, None)),
                                       (torch.bfloat16, (5e-3, 1e-2, 1e-2))])
@pytest.mark.parametrize("shape", [
    # (B, S, H, G, dh, window): the shapes of tests/test_kernels.py, then
    # ragged S and window, a window past S, and starcoder2's heads
    (1, 256, 4, 2, 64, 64), (2, 128, 2, 2, 32, 128), (1, 512, 4, 1, 64, 128),
    (1, 128, 8, 4, 128, 32), (1, 200, 4, 2, 128, 48), (2, 100, 2, 1, 32, 500),
    (1, 1024, 48, 4, 128, 256),
    # the tensor-core kernel's tile edges: S not a multiple of 128, windows
    # below a tile and at starcoder2's 4096 over S=8192, G=H, G=1, B=2 (a
    # K/V tile past S reads the next batch's rows), dh 32 and 64
    (1, 1000, 8, 2, 128, 256), (1, 4100, 4, 2, 128, 4096),
    (1, 8192, 8, 2, 128, 100), (1, 8192, 8, 2, 128, 4096),
    (2, 640, 4, 4, 64, 200), (2, 777, 6, 1, 32, 300), (2, 1000, 4, 1, 64, 4096),
    (1, 300, 4, 2, 32, 64),
])
def test_swa_kernel_matches_plain(cuda, shape, dtype, tol):
    b, s, h, g, dh, win = shape
    gen = torch.Generator(device=cuda).manual_seed(s + h)
    q, k, v = (torch.randn((b, s, n, dh), generator=gen, device=cuda).to(dtype)
               for n in (h, g, g))
    route = "swa_attention_tc" if dtype == torch.bfloat16 else "swa_attention_tf32"
    before = dict(tswa.LAUNCHES)
    got = tswa.swa_attention(q, k, v, window=win)
    assert tswa.LAUNCHES == {**before, route: before[route] + 1}
    want = swa_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   window=win).transpose(1, 2)
    assert got.dtype == dtype
    atol, rtol, rel_max = tol
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    if rel_max is not None:
        norm = torch.linalg.vector_norm
        assert norm(got - want) <= rel_max * norm(want)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["q_nan", "q_inf", "k_inf", "v_inf", "k_huge"])
def test_swa_tf32_kernel_nonfinite_where_plain_is(cuda, where):
    """A non-finite q, k or v value: the split-TF32 kernel's output is finite
    exactly where the plain version's is (its epilogue recomputes the
    outputs the split leaves NaN in fp32), and equal to it there.  V's inf
    sits at key 0 with S <= window, where every row attends to it (the
    plain version's dense P V multiplies every masked key's V by 0 too); a
    finite k that TF32 rounding carries past FLT_MAX leaves its rows finite."""
    b, s, h, g, dh, win = 1, 200, 4, 2, 64, 256
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn((b, s, n, dh), generator=gen, device=cuda)
               for n in (h, g, g))
    if where == "q_nan":
        q[0, 20, 1, 3] = float("nan")
    elif where == "q_inf":
        q[0, 140, 2, 7] = float("inf")
    elif where == "k_inf":
        k[0, 10, 1, 5] = float("inf")
    elif where == "v_inf":
        v[0, 0, 0, 9] = float("-inf")
    else:
        k[0, 30, 0, 2] = 3.4028e38  # rounds to inf in TF32
        q[0, 30:, :2, 2] = 1e-38  # the scores stay finite
    got = tswa.swa_attention(q, k, v, window=win)
    want = swa_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   window=win).transpose(1, 2)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert where == "k_huge" or not bool(fin.all())
    torch.testing.assert_close(got[fin], want[fin], rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    w = torch.zeros((4, 10), device=cuda)
    with pytest.raises(TypeError):
        ttrig.trigger_sq(w.double(), w.double())
    with pytest.raises(ValueError):
        tmix.mix(torch.eye(4, device=cuda), torch.zeros((10, 4), device=cuda).t())
    q = torch.zeros((1, 64, 4, 64), device=cuda)
    with pytest.raises(TypeError):
        tswa.swa_attention(q.half(), q.half(), q.half(), window=16)
    with pytest.raises(ValueError):  # dh 48 has no kernel
        tswa.swa_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                           q[..., :48].contiguous(), window=16)
    with pytest.raises(ValueError):  # not contiguous
        qt = q.transpose(1, 2).contiguous().transpose(1, 2)
        tswa.swa_attention(qt, qt, qt, window=16)
    with pytest.raises(ValueError):  # bf16 not 16-byte aligned: no tensor map
        flat = torch.zeros(q.numel() + 1, device=cuda, dtype=torch.bfloat16)
        qu = flat[1:].view(q.shape)
        tswa.swa_attention(qu, qu, qu, window=16)
    with pytest.raises(ValueError):  # fp32 not 16-byte aligned: no 16-byte copies
        flat = torch.zeros(q.numel() + 1, device=cuda)
        qu = flat[1:].view(q.shape)
        tswa.swa_attention(qu, q, q, window=16)


# ---- the cell axis: C cells in one launch ----------------------------------

@pytest.mark.gpu
# 16-, 8- and 4-byte copies, m and D off the tile, the paper sweep's shape
@pytest.mark.parametrize("cells,m,n", [(3, 33, 130), (2, 256, 4096), (3, 130, 1001),
                                       (8, 1024, 50890)])
def test_mix_kernel_cells_bit_equal_to_solo_launches(cuda, cells, m, n):
    """One launch for C cells gives each cell the bits of a launch on that
    cell alone, NaN and inf included (a non-finite value in one cell)."""
    g = torch.Generator(device=cuda).manual_seed(cells + m + n)
    p = torch.softmax(torch.randn((cells, m, m), generator=g, device=cuda), -1)
    w = torch.randn((cells, m, n), generator=g, device=cuda)
    w[cells - 1, 3 % m, 10] = float("inf")
    p[0, m // 2, 1] = float("nan")
    before = tmix.LAUNCHES["mix"]
    got = tmix.mix(p, w)
    assert tmix.LAUNCHES["mix"] == before + 1
    for c in range(cells):
        torch.testing.assert_close(got[c], tmix.mix(p[c], w[c]), atol=0, rtol=0,
                                   equal_nan=True)
    torch.testing.assert_close(got, mix_ref(p, w), rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.gpu
# every route: the 128-column tier (fleet fabric, D even and odd), the wide
# tier at 64 and 32 columns, and the wide tier beside the direct kernel
@pytest.mark.parametrize("cells,m,radius,n", [(4, 4096, None, 7850), (3, 4096, None, 7851),
                                              (8, 1024, 0.4, 7850), (3, 1024, 0.4, 1001),
                                              (2, 4096, 0.2, 7851), (3, 4096, 0.4, 7850)])
def test_mix_sparse_kernel_cells_bit_equal_to_solo_launches(cuda, cells, m, radius, n):
    """One plan and one launch per route for C cells: each cell's rows are
    the bits of a launch on that cell alone and of the plain slot loop,
    NaN for NaN (one cell's W holds inf and NaN)."""
    nl, p_diag, p_off = _fabric_p(cuda, m, radius or ttopo.fleet_radius(m), cells=cells)
    plan = tmix.prepare_plan(nl.idx)
    w = torch.randn((cells, m, n), generator=torch.Generator(device=cuda).manual_seed(n),
                    device=cuda)
    w[cells - 1, 17, 5] = float("inf")
    w[cells - 1, m // 2, 140:142] = float("nan")
    before = dict(tmix.LAUNCHES)
    got = tmix.mix_sparse(nl.idx, p_diag, p_off, w)
    staged = "mix_sparse_wide" if plan.wide else "mix_sparse"
    assert {k: tmix.LAUNCHES[k] - before[k] for k in before} == {
        "mix": 0, "mix_sparse": 0, "mix_sparse_wide": 0, "mix_sparse_direct": 0,
        staged: 1, **({"mix_sparse_direct": 1} if plan.n_direct else {})}
    assert tmix.prepare_plan(nl.idx) is plan  # one plan for any number of cells
    torch.testing.assert_close(got, mix_sparse_ref(nl.idx, p_diag, p_off, w),
                               atol=0, rtol=0, equal_nan=True)
    for c in range(cells):
        torch.testing.assert_close(got[c], tmix.mix_sparse(nl.idx, p_diag[c], p_off[c], w[c]),
                                   atol=0, rtol=0, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("mix_impl", ["pallas", "sparse_pallas"])
def test_sweep_on_the_card_launches_once_per_iteration(cuda, mix_impl):
    """A seeds x policies grid on the card: each kernel of the path
    launches once per iteration for all 8 cells, and the cells' integer
    channels equal the same sweep on the CPU (plain versions)."""
    from repro_torch import api

    spec = api.ScenarioSpec(m=16, dim=48, n_train=600, n_test=80, iters=10,
                            eval_every=5, mix_impl=mix_impl, trace="full",
                            labels_per_device=2)
    before = {**ttrig.LAUNCHES, **tmix.LAUNCHES}
    card = api.sweep(spec, seeds=(0, 1), device=cuda)
    moved = {k: v - before[k] for k, v in {**ttrig.LAUNCHES, **tmix.LAUNCHES}.items()}
    want = ({"trigger_sq": 10, "mix": 10} if mix_impl == "pallas" else {"mix_sparse": 10})
    assert {k: n for k, n in moved.items() if n} == want
    cpu = api.sweep(spec, seeds=(0, 1), device="cpu")
    for f in ("v", "comm_count", "deg"):
        assert np.array_equal(getattr(card, f), getattr(cpu, f)), f
    assert np.array_equal(card.comm, cpu.comm) and np.array_equal(card.adj, cpu.adj)
    for f in ("loss", "tx_time", "util", "consensus_err", "acc"):
        np.testing.assert_allclose(getattr(card, f), getattr(cpu, f), rtol=2e-4,
                                   atol=2e-5, err_msg=f)
