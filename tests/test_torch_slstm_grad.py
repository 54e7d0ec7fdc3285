"""The gradient of repro_torch's sLSTM recurrence, on the CPU.

    PYTHONPATH=src python -m pytest -q tests/test_torch_slstm_grad.py

The plain backward (``kernels/slstm/ref.py::slstm_scan_bwd_ref``: a saving
forward, then a hand-derived reverse loop over time) against
``torch.autograd`` of the plain loop and against its own fp64 mode (itself
against autograd of an fp64 recurrence); the points where the reference's
``jax.grad`` and autograd of the plain loop part, each forced and held
against ``jax.grad`` of the reference's ``lax.scan`` of ``_slstm_cell``: a
tie of the stabilizer's max, n' at 1e-6, a forget pre-activation of 0, and
a NaN; the wrapper's ``torch.autograd.Function`` on CPU tensors (the plain
forward and backward, no launch counted); ``slstm_seq``'s gradients (every
leaf and x_in) against ``jax.grad`` of the reference's ``slstm_seq`` at
xlstm-125m's smoke configuration; and, without the card, a model of the
backward kernel (``csrc/slstm_bwd.cu``): its lanes' share of the transposed
recurrent product and the fixed order of its sum, its layout as ``ops``
mirrors it, and its exchange protocol under random interleavings.  The
reference runs inside ``jax.threefry_partitionable(False)``.

Tolerances: fp32 the golden rtol 2e-4 / atol 2e-5; bf16 d pre_x and the
state's gradients one bf16 ulp (rtol 2^-7, and 2^-7 of each gradient's
largest value), dR and db within 2^-5 of theirs: autograd of the loop adds
each step's part to them in bf16, where the walk sums over (b, t) in fp32
and rounds once.
"""
import functools
import random
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.slstm import ops as tslstm  # noqa: E402
from repro_torch.kernels.slstm import ref as tref  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_xlstm import _Mbarrier, _SlstmProtocol  # noqa: E402

# the walks are loops of small ops: one thread keeps the file's time low
# under pytest -n 6
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
BF16_ULP = 2.0 ** -7
BF16_SUM = 2.0 ** -5
NAMES = ("d pre_x", "dR", "db", "dc0", "dn0", "dh0", "dm0")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
f32 = np.float32


def _rng(*seed):
    return np.random.default_rng(list(seed))


def _inputs(b, s, h, dh, seed: int):
    """pre_x (B, S, 4, H, dh) normal, R of the model's 1/sqrt(dh) scale, a
    small bias, a nonzero state (c, n > 0, h, m) and d hs, fp32 numpy."""
    rng = _rng(seed, b, s, h, dh)
    pre = rng.normal(size=(b, s, 4, h, dh)).astype(f32)
    r = (rng.normal(size=(4, h, dh, dh)) / np.sqrt(dh)).astype(f32)
    bias = (0.1 * rng.normal(size=(4, h, dh))).astype(f32)
    st = (rng.normal(size=(b, h, dh)).astype(f32), rng.uniform(0.5, 2.0, (b, h, dh)).astype(f32),
          (0.5 * rng.normal(size=(b, h, dh))).astype(f32), rng.normal(size=(b, h, dh)).astype(f32))
    dhs = rng.normal(size=(b, s, h, dh)).astype(f32)
    return pre, r, bias, st, dhs


def _torch(pre, r, bias, st, dhs, dtype=torch.float32):
    return ([torch.as_tensor(a).to(dtype) for a in (pre, r, bias)],
            tuple(torch.as_tensor(a) for a in st), torch.as_tensor(dhs))


def _flat(grads):
    dpx, dr, db, d0 = grads
    return (dpx, dr, db, *d0)


def _autograd(ins, st, dhs):
    """autograd of the plain loop: the gradients of every input, in order."""
    leaves = [t.detach().clone().requires_grad_() for t in (*ins, *st)]
    hs, _ = tref.slstm_scan_ref(leaves[0], leaves[1], leaves[2], tuple(leaves[3:]))
    return torch.autograd.grad(hs, leaves, dhs)


_SOFTPLUS = tref._softplus


def _softplus_jax_grad(x):
    """``ref._softplus``'s values with the derivative ``jax.grad`` takes,
    sigmoid (1/2 at 0, where autograd of the op-by-op form gives 1)."""
    smooth = torch.nn.functional.softplus(x)
    return _SOFTPLUS(x).detach() + (smooth - smooth.detach())


def _jgrads(pre, r, bias, st, dhs):
    """``jax.grad`` of the reference's sLSTM scan (``_slstm_cell`` over time)
    for the cotangent dhs, fp32: the gradients of pre_x, R, b and (c, n, h,
    m), as numpy."""
    def loss(pre_x, rr, bb, c, n, h, m):
        p = {"r_gates": rr, "b_gates": bb}

        def body(carry, pre_t):
            carry = JS._slstm_cell(p, None, carry, pre_x=pre_t)
            return carry, carry.h

        _, hs = jax.lax.scan(body, JS.SLSTMState(c, n, h, m), pre_x.transpose(1, 0, 2, 3, 4))
        return jnp.sum(hs.transpose(1, 0, 2, 3) * dhs)

    args = [jnp.asarray(a) for a in (pre, r, bias, *st)]
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(7)))(*args)]


def _close32(got, want, label=""):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(np.asarray(g, dtype=np.float64), np.asarray(w, np.float64),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{label} {name}")


# ---------------------------------------------------------------------------
# the plain backward against autograd, fp64 and jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [32, 64])
def test_plain_backward_matches_autograd_of_the_plain_loop(dh, dtype, monkeypatch):
    """B=2, S=40 (past one 32-step tile), H=2, from a nonzero state: every
    gradient (d pre_x, dR, db and the initial state's) against autograd of
    ``slstm_scan_ref``, in the inputs' dtypes.  The loop's softplus keeps its
    values but takes jax's derivative (``_softplus_jax_grad``): bf16
    pre-activations land on 0 (here 4 of 40960 at dh 64), where autograd of
    its op-by-op form doubles the forget gate's gradient."""
    pre, r, bias, st, dhs = _inputs(2, 40, 2, dh, 1)
    ins, tst, tdhs = _torch(pre, r, bias, st, dhs, DTYPES[dtype])
    got = _flat(tref.slstm_scan_bwd_ref(*ins, tst, tdhs))
    monkeypatch.setattr(tref, "_softplus", _softplus_jax_grad)
    want = _autograd(ins, tst, tdhs)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if dtype == "float32":
            torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, msg=name)
            continue
        scale = float(w.float().abs().max())
        tol = BF16_SUM if name in ("dR", "db") else BF16_ULP
        torch.testing.assert_close(g.float(), w.float(), rtol=BF16_ULP, atol=tol * scale,
                                   msg=name)


@pytest.mark.parametrize("dh", [32, 64])
def test_plain_backward_matches_fp64(dh):
    """The fp32 walk within 1e-5 of each gradient's largest value from the
    fp64 mode (``acc=torch.float64``), which itself matches autograd of the
    fp64 saving forward within rtol 1e-9 and 1e-11 of the scale."""
    pre, r, bias, st, dhs = _inputs(2, 40, 2, dh, 2)
    ins, tst, tdhs = _torch(pre, r, bias, st, dhs)
    got = _flat(tref.slstm_scan_bwd_ref(*ins, tst, tdhs))
    exact = _flat(tref.slstm_scan_bwd_ref(*ins, tst, tdhs, acc=torch.float64))
    leaves = [t.detach().double().requires_grad_() for t in (*ins, *tst)]
    hs, _, _ = tref.slstm_scan_save_ref(leaves[0], leaves[1], leaves[2], tuple(leaves[3:]),
                                        acc=torch.float64)
    auto = torch.autograd.grad(hs, leaves, tdhs.double())
    for name, g, e, w in zip(NAMES, got, exact, auto):
        assert e.dtype == torch.float64, name
        scale = float(e.abs().max())
        torch.testing.assert_close(e, w, rtol=1e-9, atol=1e-11 * scale, msg=name)
        assert float((g.double() - e).abs().max()) <= 1e-5 * scale, name


def _edge_state(b, h, dh, c=0.5, n=1.0, hh=0.0, m=0.0):
    return tuple(np.full((b, h, dh), v, f32) for v in (c, n, hh, m))


def _edge_case(case: str):
    """Inputs that force one point where jax.grad and autograd of the plain
    loop part: R = 0 and a zero bias, so a step's pre-activations are its
    pre_x exactly in both frameworks; step 0 holds the point in half the
    units of head 0, steps 1-2 are normal."""
    b, s, h, dh = 1, 3, 2, 32
    rng = _rng(31, len(case))
    pre = rng.normal(size=(b, s, 4, h, dh)).astype(f32)
    r = np.zeros((4, h, dh, dh), f32)
    bias = np.zeros((4, h, dh), f32)
    st = _edge_state(b, h, dh)
    dhs = rng.normal(size=(b, s, h, dh)).astype(f32)
    u = np.arange(0, dh, 2)
    if case == "max_tie":  # log_f + m == pre_i: log_f = -softplus(-100) ~ -4e-44 absorbed by m = 1
        st[3][0, 0, u] = 1.0
        pre[0, 0, 1, 0, u] = 100.0
        pre[0, 0, 0, 0, u] = 1.0
    elif case == "n_at_floor":  # n' = 1 x 1e-6 + exp(-200) = 1e-6, the floor exactly
        st[1][0, 0, u] = f32(1e-6)
        st[3][0, 0, u] = 0.0
        pre[0, 0, 1, 0, u] = 100.0
        pre[0, 0, 0, 0, u] = -200.0
    elif case == "f_zero":  # the forget gate's pre-activation 0
        pre[0, 0, 1, 0, u] = 0.0
    return pre, r, bias, st, dhs


@pytest.mark.parametrize("case", ["max_tie", "n_at_floor", "f_zero"])
def test_plain_backward_takes_jax_grad_at_its_edges(case):
    """Each point forced (``_edge_case``): the walk against ``jax.grad`` of
    the reference's scan within the golden tolerance, where autograd of the
    plain loop parts from it (clamp_min gives the tie's whole gradient to
    n', ``_softplus``'s op-by-op derivative at 0 is 1, not 1/2) or not (a
    tie of the stabilizer's max: both halve)."""
    pre, r, bias, st, dhs = _edge_case(case)
    ins, tst, tdhs = _torch(pre, r, bias, st, dhs)
    fwd = tref.slstm_scan_save_ref(*ins, tst)[2][0, 0]
    u = np.arange(0, 32, 2)
    if case == "max_tie":  # the forward really meets the point
        log_f = -tref._softplus(-fwd[1, 0, u])
        assert torch.equal(log_f + fwd[6, 0, u], fwd[0, 0, u])
    elif case == "n_at_floor":
        _, n1, _, _ = tref._cell(fwd[:4][None], *(fwd[k][None] for k in (4, 5, 6)))
        assert bool((n1[0, 0, u] == f32(1e-6)).all())
    got = _flat(tref.slstm_scan_bwd_ref(*ins, tst, tdhs))
    want = _jgrads(pre, r, bias, st, dhs)
    _close32([g.numpy() for g in got], want, case)
    auto = [g.numpy() for g in _autograd(ins, tst, tdhs)]
    parted = any(not np.allclose(a, w, rtol=RTOL, atol=ATOL) for a, w in zip(auto, want))
    assert parted == (case != "max_tie"), case


def test_plain_backward_puts_nan_where_the_plain_loop_does():
    """A NaN in one forget pre-activation at step 20 of 40: every gradient
    NaN exactly where autograd of the plain loop puts NaN, and where
    ``jax.grad`` of the reference does."""
    pre, r, bias, st, dhs = _inputs(2, 40, 2, 32, 3)
    pre[1, 20, 1, 1, 7] = np.nan
    ins, tst, tdhs = _torch(pre, r, bias, st, dhs)
    got = _flat(tref.slstm_scan_bwd_ref(*ins, tst, tdhs))
    want = _autograd(ins, tst, tdhs)
    jwant = _jgrads(pre, r, bias, st, dhs)
    for name, g, w, j in zip(NAMES, got, want, jwant):
        assert torch.equal(g.isnan(), w.isnan()), name
        np.testing.assert_array_equal(g.isnan().numpy(), np.isnan(j), err_msg=name)
    assert bool(got[0][1, :21, :, 1].isnan().all()) and not got[0][0].isnan().any()


# ---------------------------------------------------------------------------
# the wrapper's Function and slstm_seq against jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_wrapper_under_autograd_runs_the_plain_function_on_the_cpu(dtype):
    """CPU tensors that require grad: the ``SLSTMScan`` Function (its
    grad_fn), hs and the final state equal to the plain loop's, the
    gradients the plain backward's bit for bit (the final state's too), and
    no launch counted; an input that needs none gets None; without grad, no
    Function."""
    pre, r, bias, st, dhs = _inputs(2, 40, 2, 32, 4)
    ins, tst, tdhs = _torch(pre, r, bias, st, dhs, DTYPES[dtype])
    before = dict(tslstm.LAUNCHES)
    leaves = [t.clone().requires_grad_() for t in (*ins, *tst)]
    hs, out = tslstm.slstm_scan(leaves[0], leaves[1], leaves[2], tuple(leaves[3:]))
    assert type(hs.grad_fn).__name__ == "SLSTMScanBackward"
    want_hs, want_out = tref.slstm_scan_ref(*ins, tst)
    assert torch.equal(hs.detach(), want_hs)
    assert all(torch.equal(a.detach(), b) for a, b in zip(out, want_out))
    dfinal = tuple(torch.as_tensor(_rng(5, k).normal(size=st[0].shape).astype(f32))
                   for k in range(4))
    got = torch.autograd.grad([hs, *out], leaves, [tdhs, *dfinal])
    want = _flat(tref.slstm_scan_bwd_ref(*ins, tst, tdhs, dfinal))
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name
    only_r = [ins[0], ins[1].clone().requires_grad_(), *ins[2:]]
    hs_r, _ = tslstm.slstm_scan(*only_r, tst)
    (gr,) = torch.autograd.grad(hs_r, only_r[1:2], tdhs)
    assert torch.equal(gr, _flat(tref.slstm_scan_bwd_ref(*ins, tst, tdhs))[1])
    with torch.no_grad():
        assert tslstm.slstm_scan(leaves[0], leaves[1], leaves[2], tuple(leaves[3:]))[0] \
            .grad_fn is None
    assert tslstm.LAUNCHES == before


@pytest.mark.parametrize("s", [13, 40])
def test_slstm_seq_gradients_match_reference(s):
    """Every leaf of the sLSTM block's core (w_gates, r_gates, b_gates, the
    norm and the FFN) and x_in, fp32, at xlstm-125m's smoke configuration,
    against ``jax.grad`` of the reference's ``slstm_seq`` (its lax.scan
    transposed by XLA) for a random cotangent."""
    jcfg, tcfg = (mod.smoke_config("xlstm-125m") for mod in (jconfigs, tconfigs))
    with jax.threefry_partitionable(False):
        jp = jax.device_get(JS.init_slstm(jcfg, jax.random.PRNGKey(3), jnp.float32))
    rng = _rng(6, s)
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(f32)
    cot = rng.normal(size=(2, s, jcfg.d_model)).astype(f32)
    jp = {**jp, "b_gates": (0.1 * rng.normal(size=jp["b_gates"].shape)).astype(f32)}

    def jloss(p, xi):
        return jnp.sum(JS.slstm_seq(jcfg, p, xi) * cot)

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, jp),
                                                     jnp.asarray(x))
    tp = convert.arch_params_from_jax(jp, "cpu")
    leaves = tree_leaves(tp)
    tx = torch.as_tensor(x).requires_grad_()
    for t in leaves:
        t.requires_grad_(True)
    before = dict(tslstm.LAUNCHES)
    out = TS.slstm_seq(tcfg, tp, tx)
    got = torch.autograd.grad((out * torch.as_tensor(cot)).sum(), [*leaves, tx])
    assert tslstm.LAUNCHES == before
    jl = jax.tree.leaves(want_p)
    assert len(jl) == len(leaves)
    for i, (g, w) in enumerate(zip(got, [*jl, want_x])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=f"leaf {i}")


# ---------------------------------------------------------------------------
# the backward kernel, modelled: its product's lanes and sums, its layout,
# its exchange protocol
# ---------------------------------------------------------------------------

def _lane_units(dh: int, lane: int) -> list[int]:
    """The units j whose four gates' R[g, k, j] lane ``lane`` of a warp keeps
    for each of the warp's 4 units k, in the order the kernel's sum of
    ``d pre . R^T`` takes them (``slstm_bwd.cu``: j = lane, lane + 32, ...)."""
    return list(range(lane, dh, 32))


def _lane_sums(dpre, r_t, dh, k0):
    """The kernel's transposed product for a warp's units k0 .. k0 + 3, lane
    by lane in numpy fp32: lane L takes the units j of ``_lane_units(dh, L)``
    in order, each j's four gates in order by fma into one partial sum a
    unit; then the warp's lanes add theirs in the tree of xor 16, 8, 4, 2, 1,
    scattering the units: after xor 16 lanes of bit 4 keep units 2 and 3
    (else 0 and 1), after xor 8 those of bit 3 the second of the two.  dpre
    (4, dh) and r_t (4, dh, dh) = R[g, k, j] of one head -> (32,) fp32, lane
    L holding the sum of unit k0 + L // 8."""
    lanes = np.arange(32)
    a = np.zeros((32, 4), f32)
    for lane in lanes:
        for j in _lane_units(dh, lane):
            for g in range(4):  # fma: one rounding of the exact product plus the sum
                a[lane] = (np.float64(dpre[g, j]) * r_t[g, k0:k0 + 4, j].astype(np.float64)
                           + a[lane]).astype(f32)
    pair = 2 * ((lanes >> 4) & 1)
    k = np.stack([a[lanes, pair] + a[lanes ^ 16, pair],
                  a[lanes, pair + 1] + a[lanes ^ 16, pair + 1]], 1)
    odd = (lanes >> 3) & 1
    s = k[lanes, odd] + k[lanes ^ 8, odd]
    for step in (4, 2, 1):
        s = s + s[lanes ^ step]
    return s, a


@pytest.mark.parametrize("dh", tslstm.SUPPORTED_DH)
def test_backward_product_lanes_cover_and_sum_in_a_fixed_order(dh):
    """Each (gate, j) of the contraction falls to exactly one lane of a
    warp, for each of its 4 units; the 8 lanes of each unit end with the
    same bits, the pairwise tree over the 32 lanes' sums p_L of that unit
    (p_L + p_{L^16}, then ^8, ^4, ^2, ^1); and the sum lies within 4 dh fp32
    roundings of the fp64 product."""
    seen = sorted(j for lane in range(32) for j in _lane_units(dh, lane))
    assert seen == list(range(dh))
    rng = _rng(8, dh)
    dpre = rng.normal(size=(4, dh)).astype(f32)
    r_t = (rng.normal(size=(4, dh, dh)) / np.sqrt(dh)).astype(f32)
    exact = np.einsum("gj,gkj->k", dpre.astype(np.float64), r_t.astype(np.float64))
    bound = 4 * dh * np.finfo(f32).eps * np.einsum("gj,gkj->k", np.abs(dpre), np.abs(r_t))
    for k0 in range(0, dh, 4):
        lanes, p = _lane_sums(dpre, r_t, dh, k0)
        for v in range(4):
            got = lanes[8 * v:8 * v + 8]
            assert (got == got[0]).all()
            t = p[:, v]
            for step in (16, 8, 4, 2, 1):
                t = t[:step] + t[step:2 * step]
            np.testing.assert_array_equal(got[0], t[0])
            assert abs(got[0] - exact[k0 + v]) <= bound[k0 + v]


def _rn32(x: Fraction) -> Fraction:
    """x rounded to the nearest fp32, ties to even (normal range)."""
    if x == 0:
        return Fraction(0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    d = x.numerator.bit_length() - x.denominator.bit_length()
    ulp = Fraction(2) ** ((d if x >= Fraction(2) ** d else d - 1) - 23)
    return sign * round(x / ulp) * ulp


def _div_rn(a: Fraction, b: Fraction, y: Fraction) -> Fraction:
    """``slstm_bwd.cu``'s div_rn inside its guard from the reciprocal y, every
    fp32 op rounded once (fma: the exact x y + z): q = a y, then two
    corrections q + y (a - b q)."""
    q = _rn32(a * y)
    for _ in range(2):
        q = _rn32(_rn32(-b * q + a) * y + q)
    return q


@functools.lru_cache(maxsize=None)
def _hard_divisors(count: int) -> list[Fraction]:
    """The divisors in [1, 2) whose reciprocals lie nearest a rounding
    midpoint of fp32 (its ulp in (1/2, 1] is 2^-24), found over all 2^23
    mantissas in fp64: where a reciprocal rounded the wrong way would show."""
    mant = np.arange(1 << 23, dtype=np.float64)
    frac = (2.0 ** 24 / (1 + mant / 2.0 ** 23)) % 1.0
    return [1 + Fraction(int(m), 1 << 23) for m in np.argsort(np.abs(frac - 0.5))[:count]]


@pytest.mark.parametrize("kind", ["random", "hard", "corners"])
def test_backward_division_sequence_rounds_as_ieee_inside_its_guard(kind):
    """The kernel's gh / N from the reciprocal y = rcp(N) taken off the chain
    gives the correctly rounded quotient (IEEE division's, __fdiv_rn's)
    wherever its guard lets it run, |gh| in [2^-80, 2^80) and N in [2^-21,
    2^40), given y correctly rounded (rcp's rcp.approx and Newton step give
    that for every mantissa: the card's
    ``test_slstm_bwd_kernel_divides_as_ieee[every_mantissa]`` shows the
    quotients it makes), in exact rational arithmetic: random pairs; the
    divisors whose reciprocals lie nearest a midpoint under numerators of
    one, of all-ones and of random mantissas; and the guard's corners."""
    rng = np.random.default_rng(41)
    full = 1 + Fraction((1 << 23) - 1, 1 << 23)

    def scaled(m, lo, hi):
        return m * Fraction(2) ** int(rng.integers(lo, hi))

    def mant():
        return 1 + Fraction(int(rng.integers(0, 1 << 23)), 1 << 23)

    if kind == "random":
        pairs = [(scaled(mant(), -80, 80), scaled(mant(), -21, 40)) for _ in range(2000)]
    elif kind == "hard":
        pairs = [(scaled(a, -80, 80), scaled(b, -21, 40)) for b in _hard_divisors(40)
                 for a in (Fraction(1), Fraction(3, 2), full, mant(), mant())]
    else:
        top, bot = Fraction(2) ** 80, Fraction(2) ** -80
        pairs = [(a, b) for a in (bot, bot * full, top * full / 2, top / 2)
                 for b in (Fraction(2) ** -21, Fraction(2) ** -21 * full, Fraction(2) ** 39 * full,
                           Fraction(2) ** 39 * _hard_divisors(40)[0])]
    for i, (a, b) in enumerate(pairs):
        a = -a if i % 2 else a
        assert _div_rn(a, b, _rn32(1 / b)) == _rn32(a / b), (a, b)


@pytest.mark.parametrize("dh", tslstm.SUPPORTED_DH)
def test_backward_layout_mirror_fits_the_card(dh):
    """``ops.bwd_layout``: the forward's cluster and warps (whole units a
    warp, every unit of the head on one lane group), 8 lanes a unit, the
    ring's tile and stages, 8 rows a step, a staged row whole 16-byte
    chunks, the shared memory within a CTA's 227 KB, and a lane's R^T as
    many registers as the forward's R."""
    nc, warps, parts, tile, stages, rows, smem = tslstm.bwd_layout(dh)
    assert (nc, warps, parts, tile, stages) == tslstm.layout(dh)
    assert nc * warps * tslstm.UNITS_A_WARP == dh and rows == tref.SAVE_ROWS + 1 == 8
    assert (dh // nc * 4) % 16 == 0 and smem <= 232448
    assert 4 * tslstm.UNITS_A_WARP * len(_lane_units(dh, 0)) == 4 * dh // parts


class _BwdProtocol(_SlstmProtocol):
    """The forward's protocol model (``test_torch_xlstm._SlstmProtocol``)
    with the backward kernel's walk: ``steps`` ring steps staged from the
    last tile, ``steps`` + 1 exchange steps (a send at each of the first
    ``steps``, a wait and product at each but the first), 16 bytes a unit
    (its four gates) into every CTA a send.  The ring is the producer's
    alone: it reads each landed tile and writes the tile's terms into one of
    two buffers, ``ready`` to the consumer warps, which release it by
    ``freed``.  ``fault`` "no_empty_wait": the producer rewrites a terms
    buffer without waiting for its release."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.h_bytes *= 4
        for cta in self.ctas:  # both buffers' first phase for 16 bytes a unit; no h0
            for bar in cta["full"]:
                bar.tx += self.h_bytes * 3 // 4
            cta["slot_step"][0] = [None] * (self.nc * self.warps)
            cta["ready"] = [_Mbarrier(1) for _ in range(2)]
            cta["freed"] = [_Mbarrier(self.warps) for _ in range(2)]
            cta["terms_tile"], cta["terms_released"] = [None, None], [self.warps] * 2

    def _tile_steps(self, i):
        return min(self.tile, self.steps - (self.tiles - 1 - i) * self.tile)

    def consumer(self, rank, warp):
        cta, slot = self.ctas[rank], rank * self.warps + warp
        exch = self.steps + 1
        u = 0

        def exchange(u):
            cur = u % self.nbuf
            if u > 0:
                yield from self._wait(cta["full"][cur], ((u - 1) // self.nbuf) & 1,
                                      (u - 1) // self.nbuf + 1)
                if warp == 0 and u + self.nbuf < exch:
                    cta["full"][cur].arrive(self.h_bytes)
                    yield
                held = cta["slot_step"][cur]
                assert held.count(u) == len(held), f"step {u} read dpre of steps {set(held)}"
                cta["reads"][cur] += 1
                yield

        for i in range(self.tiles):
            tb = i % 2
            yield from self._wait(cta["ready"][tb], (i // 2) & 1, i // 2 + 1)
            assert cta["terms_tile"][tb] == i, "terms handed out before they were written"
            for _ in range(self._tile_steps(i)):
                assert cta["terms_tile"][tb] == i, "terms rewritten while they are read"
                yield from exchange(u)
                self.events += [(q, slot, u + 1) for q in range(self.nc)]
                yield
                u += 1
            cta["terms_released"][tb] += 1
            cta["freed"][tb].arrive()
            yield
        yield from exchange(u)

    def producer(self, rank):
        cta = self.ctas[rank]

        def stage(i):
            s, rows = i % self.stages, 4 * self._tile_steps(i)
            cta["ring_tile"][s], cta["ring_rows"][s] = i, 0
            cta["landed"][s].arrive(rows * 16)
            yield
            for _ in range(rows):
                self.events.append((rank, None, s))
                yield

        for i in range(min(self.tiles, self.stages)):
            yield from stage(i)
        for i in range(self.tiles):
            s, tb = i % self.stages, i % 2
            yield from self._wait(cta["landed"][s], (i // self.stages) & 1,
                                  i // self.stages + 1)
            assert cta["ring_tile"][s] == i and cta["ring_rows"][s] == 4 * self._tile_steps(i), (
                "a stage read before it is full")
            if i >= 2 and self.fault != "no_empty_wait":
                yield from self._wait(cta["freed"][tb], (i // 2 - 1) & 1, i // 2)
            assert cta["terms_released"][tb] == self.warps, (
                "a terms buffer refilled before its release")
            cta["terms_tile"][tb], cta["terms_released"][tb] = i, 0
            yield
            cta["ready"][tb].arrive()
            yield
            if i + self.stages < self.tiles:
                yield from stage(i + self.stages)

    def _land_h(self, q, slot, step):
        cta = self.ctas[q]
        b = step % self.nbuf
        if cta["slot_step"][b][slot] is not None:
            assert cta["reads"][b] - cta["slot_base"][b][slot] == self.warps, (
                f"dpre_{step} overwrote dpre_{cta['slot_step'][b][slot]} before every warp "
                f"read it")
        cta["slot_step"][b][slot], cta["slot_base"][b][slot] = step, cta["reads"][b]
        cta["full"][b].complete_tx(16 * self.units)


@pytest.mark.parametrize("dh", tslstm.SUPPORTED_DH)
def test_backward_protocol_holds_under_random_interleavings(dh):
    """The backward kernel's exchange and ring at its layout for ``dh``, 5
    steps (6 exchange steps) through a ring of 2 stages of 2 steps, under
    seeded random interleavings: no dpre slot overwritten before every warp
    of its CTA read it, no wait past its phase, no ring stage read before it
    is full, no terms buffer handed out before it is written or rewritten
    before its release, no deadlock; and at the kernel's own ring past one
    whole ring at dh 192."""
    nc, warps = tslstm.CLUSTER[dh], tslstm.consumer_warps(dh)
    for seed in range(100):
        _BwdProtocol(nc, warps, steps=5, tile=2, stages=2).run(random.Random(seed))
    if dh == 192:
        _BwdProtocol(nc, warps, steps=tslstm.STAGES * tslstm.TILE + 1, tile=tslstm.TILE,
                     stages=tslstm.STAGES).run(random.Random(0))


@pytest.mark.parametrize("fault,match", [("one_h_buffer", "overwrote"),
                                         ("no_empty_wait", "refilled before")])
def test_backward_protocol_model_catches_a_planted_fault(fault, match):
    """The backward model's checks are live: one dpre buffer, or a producer
    that rewrites a terms buffer without waiting for its release, fails at
    dh 192 within a few interleavings.  6 steps, three whole tiles of 2: a
    first tile of one step (5 steps) is released before the rewrite in all
    but a few interleavings."""
    nc, warps = tslstm.CLUSTER[192], tslstm.consumer_warps(192)
    with pytest.raises(AssertionError, match=match):
        for seed in range(20):
            _BwdProtocol(nc, warps, steps=6, tile=2, stages=2, fault=fault).run(
                random.Random(seed))
