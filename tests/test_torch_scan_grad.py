"""The gradient of repro_torch's selective scan, on the CPU.

The plain backward (``kernels/scan/ref.py::selective_scan_bwd_ref``, an
explicit reverse recurrence) against ``torch.autograd`` of the plain
forward and against its own fp64 mode; the wrapper's
``torch.autograd.Function`` on CPU tensors (the plain forward and backward,
no launch counted); ``mamba_seq``'s gradients (every leaf and x_in)
against ``jax.grad`` of the reference's ``mamba_seq`` in fp32; the backward
kernel's host plan (its shared memory, its cover); and a numpy replay of
the backward kernel's arithmetic (``_bwd_replay``: the forward kernel's
tile checkpoints, each tile's states recomputed from its checkpoint, the
reverse walk with g carried, du and the decay's part of ddt summed over a
lane's states then pairwise over a channel's 8 lanes, the db and dc parts
summed pairwise over a block's channels and the blocks' partials in block
order, compensated, da over each tile's steps, the tiles compensated, then
over the batch rows in order) against the plain backward
within the kernel's tolerance on the card and against fp64.  The
reference runs inside ``jax.threefry_partitionable(False)``.

Tolerances: ``mamba_seq``'s gradients the golden rtol 2e-4 / atol 2e-5;
the plain backward against autograd rtol 1e-5 and 1e-6 of each gradient's
scale in fp32 (the same products; the sums may group differently), one
bf16 ulp (rtol 2^-7) in bf16; the replay against the plain backward as
``chip_smoke.py`` holds the kernel (SCAN_BWD_RTOL / SCAN_BWD_ATOL below).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.scan import ops as tscan  # noqa: E402
from repro_torch.kernels.scan import ref as tref  # noqa: E402
from repro_torch.kernels.scan.ref import selective_scan_bwd_ref, selective_scan_ref  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
BF16_RTOL = 2.0 ** -7
# the backward kernel (and its replay) against the plain backward in fp32:
# each gradient within rtol and atol x its largest value (the exps are
# MUFU.EX2's of dt a log2(e), the products fused, the sums over lanes,
# channels, blocks and time in other orders)
SCAN_BWD_RTOL, SCAN_BWD_ATOL = 1e-4, 1e-5
NAMES = ("dx", "ddt", "db", "dc", "da_log")
f32 = np.float32


def _rng(*seed):
    return np.random.default_rng(list(seed))


def _scan_inputs(shape, dtype, seed: int):
    """x, dt (softplus of a normal: positive, as the model's), b, c, a_log
    (the model's log(1..n) plus noise) and dy of (B, S, di, n)."""
    bsz, s, di, n = shape
    rng = _rng(seed, *shape)
    x = rng.normal(size=(bsz, s, di))
    dt = np.log1p(np.exp(rng.normal(-1.0, 1.0, size=(bsz, s, di))))
    b, c = rng.normal(size=(2, bsz, s, n))
    a_log = np.tile(np.log(np.arange(1, n + 1)), (di, 1)) + rng.normal(0, 0.1, (di, n))
    dy = torch.as_tensor(rng.normal(size=(bsz, s, di)), dtype=torch.float32)
    ins = [torch.as_tensor(a, dtype=torch.float32).to(dtype) for a in (x, dt, b, c, a_log)]
    return ins, dy


def _autograd(ins, dy):
    leaves = [t.detach().clone().requires_grad_() for t in ins]
    return torch.autograd.grad(selective_scan_ref(*leaves), leaves, dy)


SHAPES = [(1, 1, 8, 16), (2, 50, 24, 16), (3, 70, 12, 8), (1, 45, 10, 5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_autograd_of_the_plain_forward(shape, dtype, monkeypatch):
    """Over several time blocks (TIME_BLOCK cut to 16): each gradient in its
    input's dtype, against autograd of ``selective_scan_ref``."""
    monkeypatch.setattr(tref, "TIME_BLOCK", 16)
    ins, dy = _scan_inputs(shape, dtype, 0)
    got = selective_scan_bwd_ref(*ins, dy)
    want = _autograd(ins, dy)
    for name, g, w, t in zip(NAMES, got, want, ins):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        scale = float(w.float().abs().max())
        if dtype == torch.bfloat16:
            torch.testing.assert_close(g.float(), w.float(), rtol=BF16_RTOL, atol=1e-6 * scale,
                                       msg=name)
        else:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * scale, msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_fp64(shape, monkeypatch):
    """fp32 within 1e-5 of each gradient's scale from the fp64 mode
    (``acc=torch.float64``), which itself matches autograd of an fp64
    recurrence within rtol 1e-6 and 1e-7 of the scale (the mode rounds u =
    dt x to the inputs' fp32, as the contract does; the recurrence here
    keeps it in fp64)."""
    monkeypatch.setattr(tref, "TIME_BLOCK", 16)
    ins, dy = _scan_inputs(shape, torch.float32, 1)
    got = selective_scan_bwd_ref(*ins, dy)
    exact = selective_scan_bwd_ref(*ins, dy, acc=torch.float64)
    leaves = [t.double().requires_grad_() for t in ins]
    a = -torch.exp(leaves[4])
    h = torch.zeros((shape[0], shape[2], shape[3]), dtype=torch.float64)
    ys = []
    for t in range(shape[1]):
        h = torch.exp(leaves[1][:, t, :, None] * a) * h \
            + (leaves[1][:, t] * leaves[0][:, t])[..., None] * leaves[2][:, t, None, :]
        ys.append((h * leaves[3][:, t, None, :]).sum(-1))
    auto = torch.autograd.grad(torch.stack(ys, 1), leaves, dy.double())
    for name, g, e, w in zip(NAMES, got, exact, auto):
        assert e.dtype == torch.float64
        scale = float(e.abs().max())
        torch.testing.assert_close(e, w, rtol=1e-6, atol=1e-7 * scale, msg=name)
        assert float((g.double() - e).abs().max()) <= 1e-5 * scale, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_under_autograd_runs_the_plain_function_on_the_cpu(dtype):
    """CPU tensors that require grad: the ``SelectiveScan`` Function (its
    grad_fn), y equal to the plain forward's, the gradients the plain
    backward's, and no launch counted; without grad, no Function."""
    ins, dy = _scan_inputs((2, 40, 16, 16), dtype, 2)
    before = dict(tscan.LAUNCHES)
    leaves = [t.clone().requires_grad_() for t in ins]
    y = tscan.selective_scan(*leaves)
    assert type(y.grad_fn).__name__ == "SelectiveScanBackward"
    assert torch.equal(y.detach(), selective_scan_ref(*ins))
    got = torch.autograd.grad(y, leaves, dy)
    for name, g, w in zip(NAMES, got, selective_scan_bwd_ref(*ins, dy)):
        assert torch.equal(g, w), name
    only_x = [ins[0].clone().requires_grad_(), *ins[1:]]
    (gx,) = torch.autograd.grad(tscan.selective_scan(*only_x), only_x[:1], dy)
    assert torch.equal(gx, got[0])
    with torch.no_grad():
        assert tscan.selective_scan(*leaves).grad_fn is None
    assert tscan.LAUNCHES == before


# ---------------------------------------------------------------------------
# mamba_seq's gradients against jax.grad of the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [37, 96])
def test_mamba_seq_gradients_match_reference(s):
    """Every leaf of the Mamba branch and x_in, fp32, against ``jax.grad``
    of the reference's ``mamba_seq`` (its associative scan transposed by
    XLA) for a random cotangent."""
    jcfg, tcfg = (mod.smoke_config("hymba-1.5b") for mod in (jconfigs, tconfigs))
    with jax.threefry_partitionable(False):
        jp = jax.device_get(JS.init_mamba(jcfg, jax.random.PRNGKey(3), jnp.float32))
    rng = _rng(4, s)
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(f32)
    cot = rng.normal(size=(2, s, jcfg.d_model)).astype(f32)

    def jloss(p, xi):
        return jnp.sum(JS.mamba_seq(jcfg, p, xi) * cot)

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, jp),
                                                     jnp.asarray(x))
    tp = convert.arch_params_from_jax(jp, "cpu")
    leaves = tree_leaves(tp)
    tx = torch.as_tensor(x).requires_grad_()
    for t in leaves:
        t.requires_grad_(True)
    out = TS.mamba_seq(tcfg, tp, tx)
    got = torch.autograd.grad((out * torch.as_tensor(cot)).sum(), [*leaves, tx])
    jl = jax.tree.leaves(want_p)
    assert len(jl) == len(leaves)
    for i, (g, w) in enumerate(zip(got, [*jl, want_x])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=f"leaf {i}")


# ---------------------------------------------------------------------------
# the backward kernel's plan and a numpy replay of its arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("b,di", [(1, 3200), (2, 3200), (16, 3200), (3, 200), (1, 28)])
def test_backward_plan_fits_shared_memory_and_covers(b, di, itemsize):
    """The backward's blocks (as ``bwd_layout`` lays them out) fit two to an
    H100 SM, 228 KiB less 1 KiB reserved a block, at BWD_MAX_WARPS = 7
    warps in either dtype, so its plan takes the widest blocks; every
    channel lies in one block; of one and two blocks an SM the plan takes
    the one whose busiest SM holds the fewest units (warps).  At hymba's
    train shape (2, 2048, 3200): 132 blocks a row of 6-7 warps, two blocks'
    worth of work an SM.  At b = 1 its 800 units are 6.06 an SM: two blocks
    an SM would be 264 of 3-4 and put 8 units on the busiest SMs, in place
    of 7 with one block an SM (measured on the H100 at (1, 8192, 3200, 16):
    1.15x slower), so the plan keeps 132 blocks of 6-7."""
    share = tscan.SM_SMEM // tscan.BWD_BLOCKS_PER_SM - tscan.BLOCK_RESERVED
    assert tscan.BWD_BLOCKS_PER_SM == 2 and share == 115712
    assert tscan.bwd_smem_bytes(tscan.BWD_MAX_WARPS, 4) == 115136 <= share
    assert tscan.bwd_smem_bytes(tscan.BWD_MAX_WARPS, 2) == 97728
    sms = 132
    plan = tscan.scan_plan(b, di, itemsize, sms, tscan.bwd_smem_bytes, tscan.BWD_MAX_WARPS,
                           tscan.BWD_BLOCKS_PER_SM)
    units = -(-di // tscan.CHANNELS)
    assert 1 <= plan.warps <= tscan.BWD_MAX_WARPS and 1 <= plan.groups <= units
    ubounds = np.array([g * units // plan.groups for g in range(plan.groups + 1)])
    assert ubounds[0] == 0 and ubounds[-1] == units and np.diff(ubounds).max() == plan.warps

    def busiest(groups):
        return -(-b * groups // sms) * -(-units // groups)

    for slots in (sms, 2 * sms):  # the plan of one, and of two blocks an SM
        least = -(-units // tscan.BWD_MAX_WARPS)
        other = max(least, min(units, -(-b * least // slots) * slots // b))
        assert busiest(plan.groups) <= busiest(other)
    if (b, di) == (2, 3200):
        assert plan == (132, 7) and b * plan.groups == 2 * sms
    if (b, di) == (1, 3200):
        assert plan == (132, 7) and busiest(264) == 8 > busiest(plan.groups) == 7


@pytest.mark.parametrize("busy,channels", [(7, 28), (6, 24), (7, 26), (1, 4), (1, 1), (3, 10),
                                           (5, 17)])
def test_block_sums_by_warps_are_the_channel_pairwise_sum(busy, channels):
    """The walk sums a step's db and dc parts over a warp's 4 channels by
    shuffles, ((c0 + c1) + (c2 + c3)) (xor 8, then xor 16, each lane
    keeping one value of two), and the block over its warps pairwise in
    warp order over 8 leaves: the same bits as one pairwise sum over the
    block's channels in channel order over 32 leaves (the parts of
    channels past the block's, in its last warp, are zeros), emulated lane
    by lane in fp32."""
    rng = _rng(11, busy, channels)
    parts = np.zeros((busy * tscan.CHANNELS, 2, 2), f32)  # (channel, db | dc, state of the pair)
    parts[:channels] = rng.normal(size=(channels, 2, 2)) * 10.0 ** rng.integers(-4, 5, (channels,
                                                                                       2, 2))
    want = _pairwise([parts[d] for d in range(busy * tscan.CHANNELS)])
    warp_sums = []
    for w in range(busy):
        lanes = parts[w * tscan.CHANNELS:(w + 1) * tscan.CHANNELS]  # lane c of the 4 channels
        odd = np.arange(tscan.CHANNELS) % 2 == 1
        keep = np.where(odd[:, None], lanes[:, 1], lanes[:, 0])  # dc (odd) or db (even)
        send = np.where(odd[:, None], lanes[:, 0], lanes[:, 1])
        v = (keep + send[[1, 0, 3, 2]]).astype(f32)  # xor 8: channel c ^ 1
        hi = np.arange(tscan.CHANNELS) >= 2
        keep2 = np.where(hi, v[:, 1], v[:, 0])  # state l M (c < 2) or l M + 1
        send2 = np.where(hi, v[:, 0], v[:, 1])
        got = (keep2 + send2[[2, 3, 0, 1]]).astype(f32)  # xor 16: channel c ^ 2
        sums = np.empty((2, 2), f32)
        for c in range(tscan.CHANNELS):
            sums[c % 2, c // 2] = got[c]
        warp_sums.append(sums)
    got = _pairwise(warp_sums, leaves=8)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_lane_scatter_is_the_lane_pairwise_sum():
    """du and the decay's part of ddt of a group's GROUP = 8 steps, over a
    channel's 8 lanes by shuffles xor 1, 2 and 4, each lane keeping half of
    what it holds (at level k the steps whose bit k is the lane's): lane l
    ends with step l's sum, bit for bit the pairwise sum in lane order
    ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)) that the first
    design's butterflies gave lane 0, emulated in fp32."""
    rng = _rng(12)
    group = tscan.GROUP
    assert group == tscan.LANES
    parts = (rng.normal(size=(tscan.LANES, 2, group))
             * 10.0 ** rng.integers(-4, 5, (tscan.LANES, 2, group))).astype(f32)
    held = [parts[l] for l in range(tscan.LANES)]  # lane l's (du, dd) of each step
    lane = np.arange(tscan.LANES)
    for width in (1, 2, 4):
        nxt = []
        for l in lane:
            v, pv = held[l], held[l ^ width]
            hi = bool(l & width)
            keep = v[:, 1::2] if hi else v[:, 0::2]
            psend = pv[:, 1::2] if hi else pv[:, 0::2]  # the partner sends what l keeps
            nxt.append((keep + psend).astype(f32))
        held = nxt
    for l in lane:
        want = _pairwise([parts[q][:, l] for q in range(tscan.LANES)], leaves=tscan.LANES)
        assert held[l].shape == (2, 1)
        assert np.array_equal(held[l][:, 0].view(np.uint32), want.view(np.uint32)), l


def _fma(p, q, r):
    return (p.astype(np.float64) * q.astype(np.float64) + r).astype(f32)


def _ex2(v):
    out = np.exp2(v.astype(np.float64)).astype(f32)
    out[out < 2.0 ** -126] = 0.0  # ex2.approx.ftz
    return out


def _kahan(terms):
    """fp32 terms summed in order, compensated as the kernel sums them."""
    acc, comp = terms[0].astype(f32), np.zeros_like(terms[0], dtype=f32)
    for v in terms[1:]:
        y = (v - comp).astype(f32)
        t = (acc + y).astype(f32)
        comp, acc = ((t - acc).astype(f32) - y).astype(f32), t
    return acc


def _pairwise(terms, leaves: int = 32):
    """fp32 terms summed pairwise in order over ``leaves`` leaves (zeros
    past the terms)."""
    v = list(terms) + [np.zeros_like(terms[0])] * (leaves - len(terms))
    while len(v) > 1:
        v = [(v[i] + v[i + 1]).astype(f32) for i in range(0, len(v), 2)]
    return v[0]


def _round(v, dtype):
    return torch.as_tensor(v).to(dtype).float().numpy()


def _bwd_replay(x, dt, b, c, a_log, dy, groups: int):
    """The backward kernel's arithmetic in numpy (csrc/selective_scan_bwd.cu),
    with the forward kernel's checkpoints, for blocks of the plan's
    ``groups`` channel ranges a batch row.  The kernel walks a tile's four
    8-step groups, each recomputed from the tile's checkpoint with the
    forward's instructions (the states here, taken once), and sums du and
    ddt's part over a channel's lanes, and db and dc over a warp's channels
    and then the block's warps, by shuffles and shared memory in the same
    pairwise orders as the first design's butterflies and block sums
    (``test_lane_scatter_is_the_lane_pairwise_sum``,
    ``test_block_sums_by_warps_are_the_channel_pairwise_sum``): this replay
    of those orders holds unchanged."""
    dtype = x.dtype
    lanes, tile = tscan.LANES, tscan.TILE
    slots = tscan.MAX_STATE // lanes
    bsz, s, di = x.shape
    n = b.shape[2]
    m = lanes * slots
    pad = ((0, 0), (0, m - n))
    a = np.pad(-np.exp(a_log.float().numpy()), pad)
    a2 = (a * f32(np.log2(np.e))).astype(f32)
    dtf, xf = dt.float().numpy(), x.float().numpy()
    u = _round(dtf * xf, dtype)
    bp, cp = (np.pad(t.float().numpy(), ((0, 0), (0, 0), (0, m - n))) for t in (b, c))
    dyf = dy.numpy()
    tiles = -(-s // tile)
    # the forward: each tile's starting state
    ckpt = np.zeros((bsz, tiles, di, m), f32)
    h = np.zeros((bsz, di, m), f32)
    for t in range(s):
        if t % tile == 0:
            ckpt[:, t // tile] = h
        h = _fma(_ex2(dtf[:, t, :, None] * a2), h, u[:, t, :, None] * bp[:, t, None, :])
    du = np.zeros((bsz, s, di), f32)
    dd = np.zeros((bsz, s, di), f32)
    pb = np.zeros((bsz, s, di, m), f32)
    pc = np.zeros((bsz, s, di, m), f32)
    da_tiles = []  # each tile's sum over its steps, in reverse order
    carry = np.zeros((bsz, di, m), f32)
    for i in reversed(range(tiles)):
        t0 = i * tile
        steps = min(tile, s - t0)
        hs, dec = [ckpt[:, i]], []
        for ss in range(steps):  # the tile again (past S h holds: no step)
            t = t0 + ss
            dec.append(_ex2(dtf[:, t, :, None] * a2))
            hs.append(_fma(dec[-1], hs[-1], u[:, t, :, None] * bp[:, t, None, :]))
        dat = np.zeros((bsz, di, m), f32)
        for ss in reversed(range(steps)):
            t = t0 + ss
            g = _fma(dyf[:, t, :, None], cp[:, t, None, :], carry)
            q = ((g * hs[ss]).astype(f32) * dec[ss]).astype(f32)  # g h[t-1] decay
            lg, lb = g.reshape(bsz, di, lanes, slots), bp[:, t, None, :].reshape(bsz, 1, lanes, slots)
            lq, la = q.reshape(lg.shape), a.reshape(1, di, lanes, slots)
            pdu, pdd = lg[..., 0] * lb[..., 0], lq[..., 0] * la[..., 0]
            for k in range(1, slots):
                pdu, pdd = _fma(lg[..., k], lb[..., k], pdu), _fma(lq[..., k], la[..., k], pdd)
            while pdu.shape[-1] > 1:  # pairwise in lane order
                pdu = pdu[..., 0::2] + pdu[..., 1::2]
                pdd = pdd[..., 0::2] + pdd[..., 1::2]
            du[:, t], dd[:, t] = pdu[..., 0], pdd[..., 0]
            dat = _fma(q, dtf[:, t, :, None], dat)
            carry = (dec[ss] * g).astype(f32)
            pb[:, t] = g * u[:, t, :, None]
            pc[:, t] = dyf[:, t, :, None] * hs[ss + 1]
        da_tiles.append(dat)
    da = _kahan(da_tiles)
    # db and dc: a block's channels pairwise, then the blocks compensated
    units = -(-di // tscan.CHANNELS)
    bounds = [min(g * units // groups * tscan.CHANNELS, di) for g in range(groups + 1)]
    sums = []
    for part in (pb, pc):
        blocks = [_pairwise([part[:, :, d] for d in range(lo, hi)])
                  for lo, hi in zip(bounds[:-1], bounds[1:])]
        sums.append(_kahan(blocks)[..., :n])
    dsum = da[0]
    for r in range(1, bsz):
        dsum = dsum + da[r]
    du_r = _round(du, dtype)
    dx = _round(du_r * dtf, dtype)
    ddt = _round(_round(du_r * xf, dtype) + _round(dd, dtype), dtype)
    return (dx, ddt, _round(sums[0], dtype), _round(sums[1], dtype),
            _round((dsum * a)[:, :n], dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [((2, 70, 24, 16), 3), ((3, 40, 12, 8), 1),
                                          ((1, 45, 10, 5), 2), ((2, 33, 6, 12), 2)])
def test_backward_lane_arithmetic_replays_the_recurrence(shape, groups, dtype):
    """The kernel's arithmetic, replayed in numpy, against the plain
    backward within the kernel's tolerance on the card (fp32: SCAN_BWD_RTOL
    and SCAN_BWD_ATOL of each gradient's scale; bf16: one bf16 ulp and
    2^-7 of the scale, where a sum rounded in bf16 lands on the other side
    of a rounding), and in fp32 no farther from the fp64 gradient than 2 x
    the plain backward or 1e-6 of the scale (the card's fp64 gate)."""
    ins, dy = _scan_inputs(shape, dtype, 5)
    got = _bwd_replay(*ins, dy, groups)
    want = selective_scan_bwd_ref(*ins, dy)
    exact = selective_scan_bwd_ref(*ins, dy, acc=torch.float64)
    for name, g, w, e in zip(NAMES, got, want, exact):
        w, e = w.float().numpy(), e.numpy()
        scale = np.abs(w).max()
        if dtype == torch.bfloat16:
            np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=BF16_RTOL * scale,
                                       err_msg=name)
            continue
        np.testing.assert_allclose(g, w, rtol=SCAN_BWD_RTOL, atol=SCAN_BWD_ATOL * scale,
                                   err_msg=name)
        limit = max(2 * np.abs(w - e).max(), 1e-6 * np.abs(e).max())
        assert np.abs(g - e).max() <= limit, name
