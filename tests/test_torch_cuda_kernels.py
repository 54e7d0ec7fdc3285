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
from repro_torch.kernels.scan import ops as tscan  # noqa: E402
from repro_torch.kernels.scan.ref import selective_scan_bwd_ref, selective_scan_ref  # noqa: E402
from repro_torch.kernels.slstm import ops as tslstm  # noqa: E402
from repro_torch.kernels.slstm.ref import slstm_scan_ref  # noqa: E402
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
# few long rows (many slabs, the second pass), rows misaligned against 16
# bytes (D % 4 != 0), the cells' rows, and m past 65535
@pytest.mark.parametrize("m,n", [(1, 7), (33, 130), (1024, 50890), (4096, 7850),
                                 (4, 1572864), (1, 1 << 20), (3, 4099), (5, 50890),
                                 (8192, 50890), (70000, 8)])
def test_trigger_sq_kernel_matches_plain(cuda, m, n):
    g = torch.Generator(device=cuda).manual_seed(m + n)
    w = torch.randn((m, n), generator=g, device=cuda)
    h = w + 0.01 * torch.randn((m, n), generator=g, device=cuda)
    before = ttrig.LAUNCHES["trigger_sq"]
    got = ttrig.trigger_sq(w, h)
    assert ttrig.LAUNCHES["trigger_sq"] == before + 1
    assert torch.equal(got, ttrig.trigger_sq(w, h))  # a fixed order: run to run
    torch.testing.assert_close(got, trigger_sq_ref(w, h), rtol=1e-5, atol=1e-6)


def _offset_rows(cuda, m, n, off, dtype, seed):
    """(m, n) contiguous rows starting ``off`` elements into a buffer, so
    that the base sits off a 16-byte line."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    buf = torch.randn(off + m * n, generator=g, device=cuda).to(dtype)
    return buf[off:].view(m, n)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# both bases off their line by the same amount (16-byte loads after a
# head), and by different amounts (element loads)
@pytest.mark.parametrize("off_w,off_h", [(1, 1), (3, 0), (0, 2)])
def test_trigger_sq_kernel_on_offset_bases(cuda, dtype, off_w, off_h):
    w = _offset_rows(cuda, 5, 50890, off_w, dtype, 0)
    h = _offset_rows(cuda, 5, 50890, off_h, dtype, 1)
    got = ttrig.trigger_sq(w, h)
    assert torch.equal(got, ttrig.trigger_sq(w, h))
    torch.testing.assert_close(got, trigger_sq_ref(w, h), rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", [(6, 50890), (1030, 4099)])
def test_trigger_sq_kernel_nonfinite_where_plain_is(cuda, dtype, m, n):
    """inf and NaN in a row's head, body, slab edges and tail, inf - inf
    included: the kernel's NaN and inf land where the plain version's do,
    and the finite rows agree."""
    g = torch.Generator(device=cuda).manual_seed(m)
    w = torch.randn((m, n), generator=g, device=cuda).to(dtype)
    h = (w.float() + 0.01 * torch.randn((m, n), generator=g, device=cuda)).to(dtype)
    inf, nan = float("inf"), float("nan")
    w[1, 1] = inf  # in the head
    h[2, n - 1] = -inf  # in the tail
    w[3, n // 2] = nan
    w[4, 7], h[4, 7] = inf, inf  # inf - inf
    cols, _ = ttrig.slab_plan(m, n, w.element_size(),
                              torch.cuda.get_device_properties(cuda).multi_processor_count)
    w[5, min(cols, n - 1)], h[5, n - 2] = -inf, inf  # at the first slab edge and past it
    want = trigger_sq_ref(w, h)
    got = ttrig.trigger_sq(w, h)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert not torch.isfinite(want[1:6]).any() and torch.isfinite(want[0])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)


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
        "mix_bf16": 0, "mix_sparse_bf16": 0,
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
        "mix_bf16": 0, "mix_sparse_bf16": 0,
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
    # hymba-1.5b's heads: 25 query heads over 5 KV heads (a GQA ratio of 5)
    (1, 4096, 25, 5, 64, 1024),
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
        "mix_bf16": 0, "mix_sparse_bf16": 0,
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


# ---------------------------------------------------------------------------
# the bf16 entries (the train step's Events 2 and 3 on parameter leaves)
# ---------------------------------------------------------------------------

def _bf16_rows(cuda, m, n, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn((m, n), generator=g, device=cuda).to(torch.bfloat16)


@pytest.mark.gpu
# 16-byte loads (n % 8 == 0) and 2-byte ones; one slab and several
@pytest.mark.parametrize("m,n", [(1, 7), (4, 130), (4, 98304), (3, 100001)])
def test_trigger_sq_bf16_entry_matches_plain(cuda, m, n):
    w = _bf16_rows(cuda, m, n, m + n)
    h = (w.float() + 0.01 * _bf16_rows(cuda, m, n, 1).float()).to(torch.bfloat16)
    before = ttrig.LAUNCHES["trigger_sq_bf16"]
    got = ttrig.trigger_sq(w, h)
    assert ttrig.LAUNCHES["trigger_sq_bf16"] == before + 1
    assert torch.equal(got, ttrig.trigger_sq(w, h))  # a fixed order: run to run
    torch.testing.assert_close(got, trigger_sq_ref(w, h), rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
# m up to and past one tile of 8 output rows; aligned and ragged D
@pytest.mark.parametrize("m,n", [(1, 9), (4, 2048), (4, 1001), (12, 4104)])
def test_mix_bf16_entry_bit_equal_to_plain(cuda, m, n):
    from repro_torch.kernels.mixing.ref import mix_ordered_ref
    w = _bf16_rows(cuda, m, n, m * n)
    w[0, 3] = float("inf")  # 0 * inf and inf - inf: NaN where the plain sum has it
    p = torch.rand((m, m), generator=torch.Generator(device=cuda).manual_seed(m), device=cuda)
    before = tmix.LAUNCHES["mix_bf16"]
    got = tmix.mix(p, w)
    assert tmix.LAUNCHES["mix_bf16"] == before + 1 and got.dtype == torch.bfloat16
    want = mix_ordered_ref(p, w)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.gpu
@pytest.mark.parametrize("m,d_max,n", [(4, 3, 2048), (4, 3, 1001), (37, 5, 4096)])
def test_mix_sparse_bf16_entry_bit_equal_to_plain(cuda, m, d_max, n):
    rng = np.random.default_rng(m + n)
    idx, p_diag, p_off = (torch.as_tensor(a, device=cuda) for a in _ell(rng, m, d_max))
    w = _bf16_rows(cuda, m, n, n)
    w[1, 5] = float("nan")
    before = tmix.LAUNCHES["mix_sparse_bf16"]
    got = tmix.mix_sparse(idx, p_diag, p_off, w)
    assert tmix.LAUNCHES["mix_sparse_bf16"] == before + 1 and got.dtype == torch.bfloat16
    want = mix_sparse_ref(idx, p_diag, p_off, w)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [4, -1])
def test_mix_sparse_bf16_entry_refuses_rows_outside_w(cuda, bad):
    idx = torch.tensor([[1, 3], [0, 2], [1, 3], [2, 0]], device=cuda)
    p_off = torch.full((4, 2), 0.25, device=cuda)
    p_diag = torch.full((4,), 0.5, device=cuda)
    w = _bf16_rows(cuda, 4, 64, 0)
    assert torch.equal(tmix.mix_sparse(idx, p_diag, p_off, w),
                       mix_sparse_ref(idx, p_diag, p_off, w))
    idx[3, 1] = bad  # in place: a new version of the table, checked anew
    before = tmix.LAUNCHES["mix_sparse_bf16"]
    with pytest.raises(ValueError, match="nbr_idx reads rows"):
        tmix.mix_sparse(idx, p_diag, p_off, w)
    assert tmix.LAUNCHES["mix_sparse_bf16"] == before


@pytest.mark.gpu
def test_bf16_wrappers_reject_other_dtypes(cuda):
    w = torch.zeros((4, 8), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        ttrig.trigger_sq(w, w)
    with pytest.raises(TypeError):
        tmix.mix(torch.eye(4, device=cuda), w)
    with pytest.raises(ValueError, match="one cell"):
        tmix.mix(torch.eye(4, device=cuda).expand(2, 4, 4).contiguous(),
                 torch.zeros((2, 4, 8), dtype=torch.bfloat16, device=cuda))


# ---- the selective scan (hybrid blocks' Mamba heads) ------------------------

# (B, S, di, n): one step, several batch rows, n = 8, hymba's channels with
# S off the 32-step tile; B = 8 (more recurrences than the card holds lanes
# at once), n = 5 (odd: a lane's second state empty), di off the blocks'
# 4-channel units (a last unit of one channel; rows off 16-byte bounds, so
# the wrapper pads them for the TMA), and B = 5 and 16 at hymba's channels
# (the plan's widest blocks: 7 warps in fp32, 8 in bf16)
SCAN_SHAPES = [(1, 1, 8, 16), (2, 300, 96, 16), (3, 1000, 200, 8), (1, 4097, 3200, 16),
               (8, 300, 3200, 16), (2, 500, 64, 5), (1, 700, 1001, 16), (5, 64, 3200, 16),
               (16, 40, 3200, 16)]


def _scan_inputs(cuda, shape, dtype, seed: int):
    """x, dt (softplus of a normal, as the model's), b, c and a_log (the
    model's log(1..n) plus noise) on the card in ``dtype``."""
    bsz, s, di, n = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((bsz, s, di), generator=g, device=cuda)
    dt = torch.nn.functional.softplus(torch.randn((bsz, s, di), generator=g, device=cuda) - 1)
    b, c = torch.randn((2, bsz, s, n), generator=g, device=cuda)
    a_log = torch.log(torch.arange(1, n + 1, device=cuda, dtype=torch.float32)).repeat(di, 1)
    a_log = a_log + 0.1 * torch.randn((di, n), generator=g, device=cuda)
    return [t.to(dtype).contiguous() for t in (x, dt, b, c, a_log)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_selective_scan_kernel_matches_plain(cuda, shape, dtype):
    """Within rtol 1e-4 and 1e-5 of the output's scale (the kernel's exps
    are MUFU.EX2's of dt a log2(e), its products fused and its sums in
    another order than the plain loop's), and the same bits from two
    calls."""
    ins = _scan_inputs(cuda, shape, dtype, sum(shape))
    before = tscan.LAUNCHES["selective_scan"]
    got = tscan.selective_scan(*ins)
    assert tscan.LAUNCHES["selective_scan"] == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:3]
    assert torch.equal(got, tscan.selective_scan(*ins))
    want = selective_scan_ref(*ins)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_selective_scan_kernel_nan_where_plain_is(cuda, shape, dtype):
    """A NaN in dt at one (t, d) of the last batch row: NaN from t on in
    channel d there, as in the plain loop, and nowhere else."""
    bsz, s, di, _ = shape
    x, dt, b, c, a_log = _scan_inputs(cuda, shape, dtype, 7)
    dt[bsz - 1, s // 2, di // 3] = float("nan")
    got = tscan.selective_scan(x, dt, b, c, a_log)
    want = selective_scan_ref(x, dt, b, c, a_log)
    assert int(want.isnan().sum()) == s - s // 2
    assert torch.equal(got.isnan(), want.isnan())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 300, 96, 16), (2, 500, 64, 5)])
def test_selective_scan_kernel_non_finite_where_plain_is(cuda, shape, dtype):
    """An inf in x at one (t, d) of the last batch row, and a dt there at
    the next step whose decays lie below 2^-126 for the smallest |a|: the
    outputs are non-finite where the plain loop's are (from t on in channel
    d), and equal within the kernel's tolerance elsewhere.  The kernel
    flushes those decays to 0, so an inf state there turns NaN where the
    plain loop may keep it inf."""
    bsz, s, di, _ = shape
    x, dt, b, c, a_log = _scan_inputs(cuda, shape, dtype, 9)
    x[bsz - 1, s // 2, di // 3] = float("inf")
    dt[bsz - 1, s // 2 + 1, di // 3] = 95.0
    got = tscan.selective_scan(x, dt, b, c, a_log)
    want = selective_scan_ref(x, dt, b, c, a_log)
    assert int((~want.isfinite()).sum()) == s - s // 2
    assert torch.equal(got.isfinite(), want.isfinite())
    fin = want.isfinite()
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4,
                               atol=1e-5 * float(want[fin].abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_rows_off_16_byte_bounds(cuda, dtype):
    """x and dt starting one element past a 16-byte bound (contiguous views
    into a larger buffer): the wrapper copies them into rows the TMA takes,
    and the output has the same bits as from aligned copies."""
    shape = (2, 300, 96, 16)
    ins = _scan_inputs(cuda, shape, dtype, 3)
    off = []
    for t in ins[:2]:
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        off.append(view)
    got = tscan.selective_scan(*off, *ins[2:])
    assert torch.equal(got, tscan.selective_scan(*ins))


@pytest.mark.gpu
def test_selective_scan_wrapper_refuses_autograd_and_wide_states(cuda):
    """States past n = 16 and non-contiguous inputs raise, with or without
    autograd (the backward kernel lifted the refusal of autograd)."""
    wide = _scan_inputs(cuda, (1, 64, 32, 17), torch.float32, 0)
    with pytest.raises(ValueError, match="n <= 16"):
        tscan.selective_scan(*wide)
    wide[1].requires_grad_()
    with pytest.raises(ValueError, match="n <= 16"):
        tscan.selective_scan(*wide)
    x, dt, b, c, a_log = _scan_inputs(cuda, (1, 64, 32, 16), torch.float32, 0)
    with pytest.raises(ValueError, match="contiguous"):
        tscan.selective_scan(x, dt, torch.zeros((1, 64, 32), device=cuda)[..., ::2], c, a_log)


# ---- the selective scan's backward (hymba training) -------------------------

# the backward kernel against the plain backward: fp32 each gradient within
# rtol and atol x its largest value (the exps are MUFU.EX2's, the products
# fused, the sums over lanes, channels, blocks and time in other orders);
# bf16 within one bf16 ulp and 2^-7 of the largest value (du and the decay's
# part of ddt round to bf16 before their products and sum, so a sum on the
# other side of a rounding moves a value by an ulp of its terms); against an
# fp64 backward within 2 x the plain backward's error, or 1e-6 of the scale
SCAN_BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2.0 ** -7, 2.0 ** -7)}
SCAN_BWD_NAMES = ("dx", "ddt", "db", "dc", "da_log")
# one step, a tile's worth, n = 8 and 5, di off the 4-channel units (rows
# off 16-byte bounds), the plan's 7-warp blocks at hymba's channels, and
# hymba's train shape; then S off the tile and off the walk's 8-step groups
# with di off the units and off the 7-warp blocks' 28 channels, n = 12 and
# 3, and B = 3
SCAN_BWD_SHAPES = [(1, 1, 8, 16), (2, 32, 24, 16), (2, 300, 96, 16), (3, 1000, 200, 8),
                   (2, 500, 64, 5), (1, 700, 1001, 16), (5, 64, 3200, 16), (2, 2048, 3200, 16),
                   (3, 45, 30, 16), (3, 77, 58, 12), (3, 101, 113, 3)]


def _scan_grads(ins, dy):
    """y and the gradients of every input through the wrapper's Function."""
    leaves = [t.detach().requires_grad_() for t in ins]
    y = tscan.selective_scan(*leaves)
    return y, torch.autograd.grad(y, leaves, dy)


def _bwd_close(got, want, dtype, label=""):
    rtol, atol = SCAN_BWD_TOL[dtype]
    for name, g, w in zip(SCAN_BWD_NAMES, got, want):
        assert g.dtype == w.dtype == dtype, name
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol * float(w.float().abs().max()),
                                   msg=f"{label} {name}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SCAN_BWD_SHAPES)
def test_selective_scan_bwd_kernel_matches_plain(cuda, shape, dtype):
    """Under autograd: one saving forward launch (y bit-equal to the no-grad
    launch's) and one backward launch; the gradients against the plain
    backward within SCAN_BWD_TOL and against fp64 within 2 x its error, the
    same bits from two calls."""
    ins = _scan_inputs(cuda, shape, dtype, sum(shape))
    dy = torch.randn(shape[:3], device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(1))
    before = dict(tscan.LAUNCHES)
    y, got = _scan_grads(ins, dy)
    assert tscan.LAUNCHES["selective_scan"] == before["selective_scan"] + 1
    assert tscan.LAUNCHES["selective_scan_bwd"] == before["selective_scan_bwd"] + 1
    with torch.no_grad():
        assert torch.equal(y, tscan.selective_scan(*ins))
    _, again = _scan_grads(ins, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = selective_scan_bwd_ref(*ins, dy)
    _bwd_close(got, want, dtype, str(shape))
    exact = selective_scan_bwd_ref(*ins, dy, acc=torch.float64)
    for name, g, w, e in zip(SCAN_BWD_NAMES, got, want, exact):
        err_k, err_p = (float((t.double() - e).abs().max()) for t in (g, w))
        assert err_k <= max(2 * err_p, 1e-6 * float(e.abs().max())), (name, err_k, err_p)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 300, 96, 16), (2, 500, 64, 5), (1, 700, 1001, 16)])
def test_selective_scan_bwd_kernel_nan_where_plain_is(cuda, shape, dtype):
    """A NaN in dt at one (t, d) of the last batch row: each gradient NaN
    exactly where the plain backward's is (h from t on, g before t, the
    sums over channels and time that take them)."""
    bsz, s, di, _ = shape
    x, dt, b, c, a_log = _scan_inputs(cuda, shape, dtype, 7)
    dt[bsz - 1, s // 2, di // 3] = float("nan")
    dy = torch.randn(shape[:3], device=cuda)
    _, got = _scan_grads([x, dt, b, c, a_log], dy)
    want = selective_scan_bwd_ref(x, dt, b, c, a_log, dy)
    for name, g, w in zip(SCAN_BWD_NAMES, got, want):
        assert bool(w.isnan().any()), name
        assert torch.equal(g.isnan(), w.isnan()), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 300, 96, 16), (2, 500, 64, 5)])
def test_selective_scan_bwd_kernel_non_finite_where_plain_is(cuda, shape, dtype):
    """An inf in x at one (t, d) of the last batch row and a dt at the next
    step whose decays flush to 0 in the kernel: each gradient non-finite
    exactly where the plain backward's is (an inf there may read NaN), and
    within tolerance elsewhere."""
    bsz, s, di, _ = shape
    x, dt, b, c, a_log = _scan_inputs(cuda, shape, dtype, 9)
    x[bsz - 1, s // 2, di // 3] = float("inf")
    dt[bsz - 1, s // 2 + 1, di // 3] = 95.0
    dy = torch.randn(shape[:3], device=cuda)
    _, got = _scan_grads([x, dt, b, c, a_log], dy)
    want = selective_scan_bwd_ref(x, dt, b, c, a_log, dy)
    rtol, atol = SCAN_BWD_TOL[dtype]
    assert not all(bool(w.isfinite().all()) for w in want)
    for name, g, w in zip(SCAN_BWD_NAMES, got, want):
        fin = w.isfinite()
        assert torch.equal(g.isfinite(), fin), name
        torch.testing.assert_close(g[fin].float(), w[fin].float(), rtol=rtol,
                                   atol=atol * float(w[fin].float().abs().max()), msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_bwd_kernel_rows_off_16_byte_bounds(cuda, dtype):
    """x, dt and dy starting one element past a 16-byte bound (contiguous
    views into a larger buffer): the wrapper copies them into rows the TMA
    takes, and the gradients have the same bits as from aligned copies."""
    shape = (2, 300, 96, 16)
    ins = _scan_inputs(cuda, shape, dtype, 3)
    dy = torch.randn(shape[:3], device=cuda)

    def off(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view

    _, want = _scan_grads(ins, dy)
    _, got = _scan_grads([off(ins[0]), off(ins[1]), *ins[2:]], off(dy))
    assert all(torch.equal(a, b) for a, b in zip(got, want))



@pytest.mark.gpu
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("warps", range(1, tscan.BWD_MAX_WARPS + 1))
def test_selective_scan_bwd_kernel_layout_is_its_host_mirror(cuda, warps, itemsize):
    """The built backward's layout (a block's shared memory, ring stages and
    most consumer warps: ``repro_selective_scan_bwd_layout``) is the one
    ``ops.bwd_layout`` mirrors for ``scan_plan`` at every block width."""
    assert tscan.built_bwd_layout(warps, itemsize) == tscan.bwd_layout(warps, itemsize)


@pytest.mark.gpu
@pytest.mark.parametrize("itemsize", [4, 2])
def test_selective_scan_bwd_kernel_two_blocks_an_sm(cuda, itemsize):
    """The walk's widest blocks (BWD_MAX_WARPS consumer warps and the
    producer) are resident BWD_BLOCKS_PER_SM to an SM (the CUDA occupancy
    API: registers and shared memory both fit), as ``scan_plan`` counts."""
    got = tscan.bwd_blocks_per_sm(tscan.BWD_MAX_WARPS, itemsize)
    assert got >= tscan.BWD_BLOCKS_PER_SM, got

# ---- the sLSTM recurrence (xLSTM's sLSTM blocks) -----------------------------

def _slstm_inputs(cuda, b, s, h, dh, dtype, seed: int, zero_state: bool = False):
    """pre_x (B, S, 4, H, dh), r (4, H, dh, dh) of the model's 1/sqrt(dh)
    scale, a small bias, in ``dtype``, and an fp32 state (c, n, h, m):
    nonzero (n > 0), or the model's initial one (zeros, m = -1e30)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    pre = torch.randn((b, s, 4, h, dh), generator=g, device=cuda)
    r = torch.randn((4, h, dh, dh), generator=g, device=cuda) / dh ** 0.5
    bias = 0.1 * torch.randn((4, h, dh), generator=g, device=cuda)
    if zero_state:
        z = torch.zeros((b, h, dh), device=cuda)
        st = (z, z.clone(), z.clone(), torch.full((b, h, dh), -1e30, device=cuda))
    else:
        st = (torch.randn((b, h, dh), generator=g, device=cuda),
              0.5 + torch.rand((b, h, dh), generator=g, device=cuda),
              0.5 * torch.randn((b, h, dh), generator=g, device=cuda),
              torch.randn((b, h, dh), generator=g, device=cuda))
    return [t.to(dtype).contiguous() for t in (pre, r, bias)], st


def _slstm_max_err(got, want):
    hs, st = got
    whs, wst = want
    return max(float((a - w).abs().max()) for a, w in zip((hs, *st), (whs, *wst)))


# S on either side of a pre_x ring tile and past a whole ring (the kernel
# stages TILE steps a stage, STAGES stages)
SLSTM_RING_STEPS = [(1, tslstm.TILE - 1), (4, tslstm.TILE + 1),
                    (2, tslstm.STAGES * tslstm.TILE + 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(1, 1), (4, 1), (1, 257), (4, 257), (1, 4096), (4, 4096),
                                 *SLSTM_RING_STEPS])
@pytest.mark.parametrize("dh", [192, 64, 32, 128])
def test_slstm_kernel_matches_plain(cuda, dh, b, s, dtype):
    """xlstm-125m's 4 heads of dh 192 (a cluster of 8 CTAs a head), 128
    (8), 64 (4) and 32 (2), from a nonzero state, S on either side of
    the pre_x ring's tile and past the whole ring: one launch, the same bits
    from two calls; fp32 within 1e-4 of the plain loop (hs and the final
    state, the recurrent sums in another order); bf16 (where a sum that
    rounds the other way stays in the state) no farther from the fp32 plain
    loop than 2 x the bf16 plain loop's distance from it, and 1e-3."""
    h = 4
    (pre, r, bias), st = _slstm_inputs(cuda, b, s, h, dh, dtype, dh + b + s)
    before = tslstm.LAUNCHES["slstm"]
    got = tslstm.slstm_scan(pre, r, bias, st)
    assert tslstm.LAUNCHES["slstm"] == before + 1
    hs, out = got
    assert hs.dtype == torch.float32 and tuple(hs.shape) == (b, s, h, dh)
    again = tslstm.slstm_scan(pre, r, bias, st)
    assert all(torch.equal(x, y) for x, y in zip((hs, *out), (again[0], *again[1])))
    plain = slstm_scan_ref(pre, r, bias, st)
    if dtype == torch.float32:
        assert _slstm_max_err(got, plain) <= 1e-4, _slstm_max_err(got, plain)
    else:
        exact = slstm_scan_ref(pre.float(), r.float(), bias.float(), st)
        limit = max(2 * _slstm_max_err(plain, exact), 1e-3)
        assert _slstm_max_err(got, exact) <= limit, (_slstm_max_err(got, exact), limit)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_kernel_from_the_model_state_at_dh_128(cuda, dtype):
    """dh 128 (a cluster of 8 CTAs) from the model's initial state (zeros,
    m = -1e30), 300 steps."""
    (pre, r, bias), st = _slstm_inputs(cuda, 2, 300, 3, 128, dtype, 5, zero_state=True)
    got = tslstm.slstm_scan(pre, r, bias, st)
    exact = slstm_scan_ref(pre.float(), r.float(), bias.float(), st)
    plain = slstm_scan_ref(pre, r, bias, st)
    limit = 1e-4 if dtype == torch.float32 else max(2 * _slstm_max_err(plain, exact), 1e-3)
    assert _slstm_max_err(got, exact if dtype != torch.float32 else plain) <= limit


@pytest.mark.gpu
def test_slstm_kernel_pre_x_off_a_16_byte_bound(cuda):
    """pre_x whose data starts one element past a 16-byte bound (its rows
    arrive by 16-byte bulk copies): the same bits as an aligned copy, one
    launch each."""
    (pre, r, bias), st = _slstm_inputs(cuda, 2, 70, 4, 192, torch.bfloat16, 3)
    off = torch.empty(pre.numel() + 1, dtype=pre.dtype, device=cuda)[1:].view(pre.shape)
    off.copy_(pre)
    assert off.is_contiguous() and off.data_ptr() % 16
    before = tslstm.LAUNCHES["slstm"]
    got, want = tslstm.slstm_scan(off, r, bias, st), tslstm.slstm_scan(pre, r, bias, st)
    assert tslstm.LAUNCHES["slstm"] == before + 2
    assert all(torch.equal(x, y) for x, y in zip((got[0], *got[1]), (want[0], *want[1])))


@pytest.mark.gpu
@pytest.mark.parametrize("dh", tslstm.SUPPORTED_DH)
def test_slstm_kernel_layout_is_its_host_mirror(cuda, dh):
    """The built kernel's layout (cluster, consumer warps, lanes a unit, ring
    tile and stages: ``repro_slstm_layout``) is the one ``ops`` mirrors for
    the CPU model of its protocol, the ring-edge cases above and
    chip_smoke.py's design floor."""
    assert tslstm.built_layout(dh) == tslstm.layout(dh)


@pytest.mark.gpu
def test_slstm_kernel_nan_where_plain_is(cuda):
    """A NaN in one forget pre-activation: NaN in that unit from its step,
    in its whole head from the next, and nowhere else, as in the plain
    loop."""
    (pre, r, bias), st = _slstm_inputs(cuda, 2, 40, 4, 192, torch.float32, 9)
    pre[1, 20, 1, 2, 7] = float("nan")
    got, _ = tslstm.slstm_scan(pre, r, bias, st)
    want, _ = slstm_scan_ref(pre, r, bias, st)
    assert int(want.isnan().sum()) == 1 + 19 * 192
    assert torch.equal(got.isnan(), want.isnan())


@pytest.mark.gpu
def test_slstm_wrapper_refuses_on_the_card(cuda):
    """Autograd on the card: the saving forward launch (one ``slstm``),
    then on backward the backward kernel (one ``slstm_bwd``); without grad
    the serving launch; and the refusals of a head width, a stride, a dtype
    mix and a device mix."""
    (pre, r, bias), st = _slstm_inputs(cuda, 1, 8, 4, 64, torch.float32, 0)
    r.requires_grad_()
    before = dict(tslstm.LAUNCHES)
    hs, _ = tslstm.slstm_scan(pre, r, bias, st)
    assert tslstm.LAUNCHES == {"slstm": before["slstm"] + 1, "slstm_bwd": before["slstm_bwd"]}
    hs.sum().backward()
    assert tslstm.LAUNCHES == {"slstm": before["slstm"] + 1,
                               "slstm_bwd": before["slstm_bwd"] + 1}
    assert r.grad is not None and bool(torch.isfinite(r.grad).all())
    with torch.no_grad():
        tslstm.slstm_scan(pre, r, bias, st)
    assert tslstm.LAUNCHES["slstm"] == before["slstm"] + 2
    (pre, r, bias), st = _slstm_inputs(cuda, 1, 8, 4, 48, torch.float32, 0)
    with pytest.raises(ValueError, match="dh in"):
        tslstm.slstm_scan(pre, r, bias, st)
    (pre, r, bias), st = _slstm_inputs(cuda, 1, 8, 4, 64, torch.float32, 0)
    with pytest.raises(ValueError, match="contiguous"):
        tslstm.slstm_scan(pre, r.transpose(2, 3), bias, st)
    with pytest.raises(TypeError, match="one dtype"):
        tslstm.slstm_scan(pre, r.bfloat16(), bias, st)
    with pytest.raises(ValueError, match="lie on different|all on one"):
        tslstm.slstm_scan(pre, r, bias, tuple(t.cpu() for t in st))


# ---- the sLSTM recurrence's gradient ------------------------------------------

SLSTM_BWD_NAMES = ("d pre_x", "dR", "db", "dc0", "dn0", "dh0", "dm0")
# the backward kernel against its plain version on the same inputs, the
# walk over the saving forward's rows (chip_smoke.py's SLSTM_BWD_TOL): each
# gradient within rtol and atol x its largest value; the whole path against
# fp64 (fp32: largest error) or the fp32 backward (bf16: relative L2
# distance) within 2 x the plain path's, or 1e-6 (of the scale in fp32)
SLSTM_BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2.0 ** -6, 2.0 ** -6)}
# bf16 also: each gradient's largest error from the fp32 backward within
# this multiple of the plain bf16 path's (chip_smoke.py's
# SLSTM_BWD_MAX_VS_PLAIN; the readings in PERF.md §6)
SLSTM_BWD_MAX_VS_PLAIN = 4.0


def _slstm_grads(ins, st, dhs, dfinal):
    """hs, the final state and every input's gradient through the wrapper's
    Function."""
    leaves = [t.detach().clone().requires_grad_() for t in (*ins, *st)]
    hs, out = tslstm.slstm_scan(leaves[0], leaves[1], leaves[2], tuple(leaves[3:]))
    return hs, out, torch.autograd.grad([hs, *out], leaves, [dhs, *dfinal])


def _flat(grads):
    dpx, dr, db, d0 = grads
    return (dpx, dr, db, *d0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(1, 1), (2, 40), (4, tslstm.STAGES * tslstm.TILE + 1),
                                 (2, 300)])
@pytest.mark.parametrize("dh", tslstm.SUPPORTED_DH)
def test_slstm_bwd_kernel_matches_plain(cuda, dh, b, s, dtype):
    """Under autograd, from a nonzero state with the final state's gradients
    too: one saving forward launch (hs and state bit-equal to the serving
    launch's, and to the saving wrapper's own) and one backward launch, the
    same bits from two calls; the gradients against the plain walk over the
    saving forward's rows within SLSTM_BWD_TOL, and the path against fp64
    (fp32: largest error) or the fp32 backward on the same values (bf16:
    relative L2) within 2 x the plain path's distance, bf16's largest error
    within SLSTM_BWD_MAX_VS_PLAIN x the plain path's."""
    from repro_torch.kernels.slstm.ref import slstm_bwd_walk_ref, slstm_scan_bwd_ref

    h = 3
    (pre, r, bias), st = _slstm_inputs(cuda, b, s, h, dh, dtype, dh + b + s)
    g = torch.Generator(device=cuda).manual_seed(s)
    dhs = torch.randn((b, s, h, dh), generator=g, device=cuda)
    dfinal = tuple(0.3 * torch.randn((b, h, dh), generator=g, device=cuda) for _ in range(4))
    before = dict(tslstm.LAUNCHES)
    hs, out, got = _slstm_grads((pre, r, bias), st, dhs, dfinal)
    assert tslstm.LAUNCHES == {"slstm": before["slstm"] + 1,
                               "slstm_bwd": before["slstm_bwd"] + 1}
    with torch.no_grad():
        serve = tslstm.slstm_scan(pre, r, bias, st)
    assert torch.equal(hs, serve[0]) and all(torch.equal(x, y) for x, y in zip(out, serve[1]))
    again = _slstm_grads((pre, r, bias), st, dhs, dfinal)[2]
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    hs_s, _, saved = tslstm._launch(pre, r, bias, st, save=True)
    assert torch.equal(hs_s, hs)
    same_in = _flat(slstm_bwd_walk_ref(r, st[2], saved, hs_s, dhs, dfinal, dtype))
    plain = _flat(slstm_scan_bwd_ref(pre, r, bias, st, dhs, dfinal))
    if dtype == torch.float32:
        exact = _flat(slstm_scan_bwd_ref(pre, r, bias, st, dhs, dfinal, acc=torch.float64))
    else:
        exact = _flat(slstm_scan_bwd_ref(pre.float(), r.float(), bias.float(), st, dhs, dfinal))

    def largest(t, e):
        return float((t.double() - e.double()).abs().max())

    def l2(t, e):
        t, e = t.double(), e.double()
        return float((t - e).norm() / e.norm().clamp(min=1e-300))

    rtol, atol = SLSTM_BWD_TOL[dtype]
    for name, k, w, p, e in zip(SLSTM_BWD_NAMES, got, same_in, plain, exact):
        assert k.dtype == w.dtype and k.shape == w.shape, name
        scale = float(w.float().abs().max())
        torch.testing.assert_close(k.float(), w.float(), rtol=rtol, atol=atol * scale,
                                   msg=lambda m: f"{name} {(b, s, h, dh)}: {m}")
        if dtype == torch.float32:
            floor = 1e-6 * float(e.double().abs().max())
            err_k, err_p = largest(k, e), largest(p, e)
            assert err_k <= max(2 * err_p, floor), (name, err_k, err_p)
            continue
        err_k, err_p = l2(k, e), l2(p, e)
        assert err_k <= max(2 * err_p, 1e-6), (name, "L2", err_k, err_p)
        err_k, err_p = largest(k, e), largest(p, e)
        assert err_k <= max(SLSTM_BWD_MAX_VS_PLAIN * err_p, 1e-6 * scale), (name, err_k, err_p)


# the edge points against the plain walk, element by element: rtol and
# atol x the gradient's largest value (the gates on ex2.approx / rcp.approx;
# bf16 one ulp of d pre)
SLSTM_EDGE_TOL = {torch.float32: (1e-4, 1e-6), torch.bfloat16: (2.0 ** -6, 2.0 ** -12)}


def _slstm_edge(cuda, case: str, dtype):
    """The CPU tests' edge points (``test_torch_slstm_grad._edge_case``) on
    the card: R = 0 and a zero bias, so a step's pre-activations are its
    pre_x; step 0 holds the point in the even units of head 0 (``max_tie``:
    log_f + m == pre_i; ``n_at_floor``: n' = 1e-6 exactly), steps 1-2 are
    normal.  -> (pre, r, bias) in ``dtype``, the fp32 state, d hs, the
    units."""
    b, s, h, dh = 1, 3, 2, 32
    g = torch.Generator(device=cuda).manual_seed(31 + len(case))
    pre = torch.randn((b, s, 4, h, dh), generator=g, device=cuda)
    dhs = torch.randn((b, s, h, dh), generator=g, device=cuda)
    st = [torch.full((b, h, dh), v, device=cuda) for v in (0.5, 1.0, 0.0, 0.0)]
    u = torch.arange(0, dh, 2, device=cuda)
    if case == "max_tie":  # log_f = -softplus(-100) ~ -4e-44, absorbed by m = 1
        st[3][0, 0, u] = 1.0
        pre[0, 0, 1, 0, u] = 100.0
        pre[0, 0, 0, 0, u] = 1.0
    else:  # n' = 1 x 1e-6 + exp(-200)
        st[1][0, 0, u] = 1e-6
        pre[0, 0, 1, 0, u] = 100.0
        pre[0, 0, 0, 0, u] = -200.0
    r = torch.zeros((4, h, dh, dh), device=cuda)
    bias = torch.zeros((4, h, dh), device=cuda)
    return [t.to(dtype) for t in (pre, r, bias)], tuple(st), dhs, u


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["max_tie", "n_at_floor"])
def test_slstm_bwd_kernel_splits_a_tie_as_the_plain_walk(cuda, case, dtype, monkeypatch):
    """At each point of ``_slstm_edge``, which the saving forward meets
    (its rows: m' = pre_i = 1 at the tie, n' = 1e-6 at the floor), every
    gradient within SLSTM_EDGE_TOL of the plain walk over those rows, which
    halves a tie's gradient as ``jax.grad`` does.  At the floor the walk
    that gives the whole of it to n' (clamp_min's) parts from the kernel;
    at the max tie the stabilizer cancels out of h (n' >= i' = 1 there), so
    its gradient, the share's factor, is rounding residue and no share
    parts visibly."""
    from repro_torch.kernels.slstm import ref as tref

    (pre, r, bias), st, dhs, u = _slstm_edge(cuda, case, dtype)
    zeros = tuple(torch.zeros_like(st[0]) for _ in range(4))
    _, _, got = _slstm_grads((pre, r, bias), st, dhs, zeros)
    hs, _, saved = tslstm._launch(pre, r, bias, st, save=True)
    after = saved[0, 1, :, 0, u]  # the state after step 0
    if case == "max_tie":
        assert bool((saved[0, 0, 0, 0, u] == 1.0).all() and (after[6] == 1.0).all())
    else:
        assert bool((after[5] == 1e-6).all())
    rtol, atol = SLSTM_EDGE_TOL[dtype]

    def close(want):
        return [torch.allclose(k.float(), w.float(), rtol=rtol,
                               atol=atol * float(w.float().abs().max()))
                for k, w in zip(got, _flat(want))]

    assert all(close(tref.slstm_bwd_walk_ref(r, st[2], saved, hs, dhs, None, dtype))), case
    if case == "n_at_floor":
        monkeypatch.setattr(tref, "_share", lambda x, z, y: (x == z).to(z.dtype))
        assert not all(close(tref.slstm_bwd_walk_ref(r, st[2], saved, hs, dhs, None, dtype)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_bwd_kernel_nan_where_plain_is(cuda, dtype):
    """A NaN in one forget pre-activation at step 20 of 40 (dh 192): every
    gradient NaN exactly where the plain backward's is."""
    from repro_torch.kernels.slstm.ref import slstm_scan_bwd_ref

    (pre, r, bias), st = _slstm_inputs(cuda, 2, 40, 4, 192, dtype, 9, zero_state=True)
    pre[1, 20, 1, 2, 7] = float("nan")
    dhs = torch.randn((2, 40, 4, 192), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(2))
    zeros = tuple(torch.zeros_like(st[0]) for _ in range(4))
    _, _, got = _slstm_grads((pre, r, bias), st, dhs, zeros)
    want = _flat(slstm_scan_bwd_ref(pre, r, bias, st, dhs))
    for name, k, w in zip(SLSTM_BWD_NAMES, got, want):
        assert torch.equal(k.isnan(), w.isnan()), name
    assert bool(got[0][1, :21, :, 2].isnan().all()) and not got[0][0].isnan().any()


def _slstm_bwd_quotients(cuda, num, den, dtype):
    """dc0 of the backward kernel at S = 1 with R = 0, pre_i = -200 and pre_f
    = pre_o = 100 (i' = 0, f' = o = 1 exactly) and c = m = 0, where n' is the
    state's n and dc0 is d hs / max(n, 1e-6) itself: the kernel's quotient
    of each num (fp32, +0 for a zero: gh = d hs + (+0)) by each den, as many
    (row, head) of H = 4, dh = 192 as they need; dc0 = 0 + the quotient, so
    a -0 quotient reads +0."""
    h, dh = 4, 192
    k = num.size
    b = -(-k // (h * dh))
    pad = b * h * dh - k
    num = np.concatenate([num, np.ones(pad, np.float32)]).reshape(b, 1, h, dh)
    den = np.concatenate([den, np.ones(pad, np.float32)]).reshape(b, h, dh)
    pre = torch.zeros((b, 1, 4, h, dh), device=cuda)
    pre[:, :, 0], pre[:, :, 1], pre[:, :, 3] = -200.0, 100.0, 100.0
    zero = torch.zeros((b, h, dh), device=cuda)
    st = (zero, torch.from_numpy(den).to(cuda), zero.clone(), zero.clone())
    r = torch.zeros((4, h, dh, dh), device=cuda, dtype=dtype)
    bias = torch.zeros((4, h, dh), device=cuda, dtype=dtype)
    _, _, saved = tslstm._launch(pre.to(dtype), r, bias, st, save=True)
    _, d0 = tslstm._launch_bwd(r, saved, torch.from_numpy(num).to(cuda),
                               tuple(torch.zeros_like(zero) for _ in range(4)), dtype)
    return d0[0].cpu().numpy().reshape(-1)[:k]


@pytest.mark.gpu
@pytest.mark.parametrize("case,dtype", [("ranges", torch.float32), ("ranges", torch.bfloat16),
                                        ("every_mantissa", torch.float32)])
def test_slstm_bwd_kernel_divides_as_ieee(cuda, case, dtype):
    """The one division on a step's chain, gh / N (N = max(n', 1e-6)), bit
    for bit IEEE's (numpy's fp32 division) through the kernel
    (``_slstm_bwd_quotients``).  ``ranges``: outside the range the kernel's
    reciprocal sequence keeps as well as inside it: divisors at the 1e-6
    floor under numerators near the fp32 limit (an inf quotient), subnormal
    numerators, subnormal quotients, zeros, and quotients over ~70 binades.
    ``every_mantissa``: inside it, each of the 2^23 divisor mantissas under
    a power of two and under a random mantissa, where a reciprocal rounded
    the wrong way would show (CPU:
    ``test_torch_slstm_grad.py::test_backward_division_sequence_rounds_as_ieee_inside_its_guard``)."""
    rng = np.random.default_rng(17)
    if case == "ranges":
        k = 4 * 4 * 192
        den = np.exp(rng.uniform(-20, 20, k)).astype(np.float32)
        num = (rng.normal(size=k) * np.exp(rng.uniform(-30, 30, k))).astype(np.float32)
        den[:256], den[256:512] = 1e-6, 0.0
        num[:128] = 3.3e38 * np.sign(rng.normal(size=128))
        num[128:256] = rng.normal(size=128) * 1e-38
        num[512:640] = (rng.normal(size=128) * 1e-39).astype(np.float32)  # subnormal
        den[640:768], num[640:768] = 1e10, rng.normal(size=128) * 1e-30  # subnormal quotients
        num[768:800] = 0.0
        num[num == 0] = 0.0
        with np.errstate(over="ignore"):
            want = np.float32(0) + num / np.maximum(den, np.float32(1e-6))
        assert np.isinf(want[:128]).all() and (np.abs(want[640:768]) < 2.0 ** -126).all()
        got = _slstm_bwd_quotients(cuda, num, den, dtype)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        return
    mant = np.arange(1 << 23, dtype=np.int32)
    # above the 1e-6 floor (2^-19.93) and inside the guard's [2^-21, 2^40)
    den = ((mant | ((rng.integers(-19, 40, mant.size) + 127) << 23)).astype(np.int32)
           .view(np.float32))
    for top in (np.zeros_like(mant), rng.integers(0, 1 << 23, mant.size, dtype=np.int32)):
        sign = rng.integers(0, 2, mant.size).astype(np.int32) << 31
        num = ((sign | top | ((rng.integers(-60, 61, mant.size) + 127) << 23)).astype(np.int32)
               .view(np.float32))
        got = _slstm_bwd_quotients(cuda, num, den, dtype)
        want = np.float32(0) + num / den
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("dh", tslstm.SUPPORTED_DH)
def test_slstm_bwd_kernel_layout_is_its_host_mirror(cuda, dh):
    """The built backward kernel's layout (cluster, consumer warps, lanes a
    unit, ring tile and stages, rows a step, shared memory:
    ``repro_slstm_bwd_layout``) is the one ``ops`` mirrors for the CPU
    model of its sums and protocol."""
    assert tslstm.built_bwd_layout(dh) == tslstm.bwd_layout(dh)
