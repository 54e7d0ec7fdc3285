"""repro_torch's xLSTM blocks (mLSTM, sLSTM) against the JAX package's, on the
CPU.

``models/ssm.py``'s xLSTM half piece by piece: ``init_mlstm`` and
``init_slstm`` bit for bit from one key; ``mlstm_seq`` (the chunkwise form:
several chunks, one chunk, S < chunk) and ``mlstm_decode`` step by step;
``slstm_seq``, ``slstm_decode`` and the sLSTM kernel wrapper's plain
version against the reference's ``lax.scan`` of ``_slstm_cell`` from a
nonzero state; the wrapper's card path reached with ``on_cpu`` patched
(autograd to the saving launch, refusals of head widths and strides);
the block types ``mlstm`` and ``slstm``; then xlstm-125m's smoke
configuration end to end: ``forward``, ``decode_step`` replayed over a
prompt (fp32, and bf16 against the reference's bf16 decode), ``loss_fn``'s
gradients against ``jax.grad``, and the full parameter tree's shapes with
nothing allocated; and, without the card, a model of the sLSTM kernel's
step protocol (its h double buffer, mbarrier phases and pre_x ring) under
random interleavings.  The reference runs inside
``jax.threefry_partitionable(False)``.

Tolerances: fp32 the golden rtol 2e-4 / atol 2e-5 (the same products,
summed in another order); bf16 layer outputs rtol 2^-7 (one bf16 ulp)
beside an absolute 2e-2, as ``tests/test_torch_ssm.py`` holds hymba's.
"""
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.kernels.slstm import ops as tslstm  # noqa: E402
from repro_torch.kernels.slstm.ref import slstm_scan_ref, slstm_step  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# the recurrences are loops of small ops: one thread keeps the file's time
# low under pytest -n 6
torch.set_num_threads(1)

ARCH = "xlstm-125m"
RTOL, ATOL = 2e-4, 2e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
XLSTM_TYPES = ("mlstm", "slstm")


def _cfgs(**kw):
    return tuple(dataclasses.replace(mod.smoke_config(ARCH), **kw)
                 for mod in (jconfigs, tconfigs))


def _rng(*seed):
    return np.random.default_rng(list(seed))


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t32(t) -> np.ndarray:
    return t.detach().float().numpy()


def _close(got, want, dtype="float32", err_msg=""):
    if dtype == "bfloat16":
        np.testing.assert_allclose(_t32(got), _f32(want), rtol=BF16_RTOL, atol=BF16_ATOL,
                                   err_msg=err_msg)
    else:
        np.testing.assert_allclose(_t32(got), _f32(want), rtol=RTOL, atol=ATOL,
                                   err_msg=err_msg)


def _jinit(fn, *args):
    with jax.threefry_partitionable(False):
        return jax.device_get(fn(*args))


def _bits_equal(got: dict, want: dict, dtype: str, path: str = "") -> None:
    assert sorted(got) == sorted(want), path
    for name, w in want.items():
        g, label = got[name], f"{path}/{name}"
        if isinstance(w, dict):
            _bits_equal(g, w, dtype, label)
            continue
        assert g.dtype == DTYPES[dtype][1] and tuple(g.shape) == w.shape, label
        np.testing.assert_array_equal(_t32(g), _f32(w), err_msg=label)


def _inputs(shape, dtype: str, *seed, scale: float = 1.0):
    a = (_rng(*seed).normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(a).astype(DTYPES[dtype][0]), torch.as_tensor(a).to(DTYPES[dtype][1])


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("core", ["mlstm", "slstm"])
def test_init_core_bits_match_reference(core, dtype):
    """``init_mlstm`` (``split(key, 7)``, b_if zeros then 3.0) and
    ``init_slstm`` (``split(key, 4)``, w_down from ``fold_in(ks[3], 7)``)."""
    jcfg, tcfg = _cfgs()
    want = _jinit(getattr(JS, f"init_{core}"), jcfg, jax.random.PRNGKey(3), DTYPES[dtype][0])
    got = getattr(TS, f"init_{core}")(tcfg, prng.PRNGKey(3), DTYPES[dtype][1], "cpu")
    _bits_equal(got, want, dtype)
    if core == "mlstm":
        h = tcfg.n_heads
        assert _t32(got["b_if"]).tolist() == [0.0] * h + [3.0] * h
    else:
        assert tuple(got["w_gates"].shape) == (128, 4, 4, 32)
        assert tuple(got["r_gates"].shape) == (4, 4, 32, 32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bt", XLSTM_TYPES)
def test_init_block_bits_match_reference(bt, dtype):
    """norm1 and the core from ks[0]; no norm2, no FFN."""
    jcfg, tcfg = _cfgs()
    want = _jinit(JB.init_block, jcfg, bt, jax.random.PRNGKey(5), DTYPES[dtype][0])
    got = TB.init_block(tcfg, bt, prng.PRNGKey(5), DTYPES[dtype][1], "cpu")
    assert sorted(got) == ["core", "norm1"]
    _bits_equal(got, want, dtype)


def test_init_params_bits_match_reference():
    jcfg, tcfg = _cfgs()
    want = _jinit(JM.init_params, jcfg, jax.random.PRNGKey(0))
    got = TM.init_params(tcfg, prng.PRNGKey(0), "cpu")
    assert sorted(got["stages"][0]) == sorted(want["stages"][0]) == ["0_mlstm", "1_slstm"]
    _bits_equal(got["stages"][0], want["stages"][0], "float32")
    _bits_equal({k: v for k, v in got.items() if k != "stages"},
                {k: v for k, v in want.items() if k != "stages"}, "float32")


def test_full_param_tree_matches_reference_shapes_unallocated():
    want = jax.eval_shape(lambda k: JM.init_params(jconfigs.get_config(ARCH), k),
                          jax.random.PRNGKey(0))
    got = TM.init_params(tconfigs.get_config(ARCH), None, "meta")
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree_util.tree_leaves_with_path(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert [jax.tree_util.keystr(p) for p, _ in got_leaves] == \
        [jax.tree_util.keystr(p) for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.device.type == "meta", jax.tree_util.keystr(path)
        assert tuple(g.shape) == tuple(w.shape), jax.tree_util.keystr(path)
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
    n = sum(int(np.prod(w.shape)) for _, w in want_leaves)
    assert n == 183581248  # 0.37 GB in bf16


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _core_params(jcfg, core: str, dtype: str, seed: int = 3):
    jp = _jinit(getattr(JS, f"init_{core}"), jcfg, jax.random.PRNGKey(seed), DTYPES[dtype][0])
    return jax.tree.map(jnp.asarray, jp), convert.arch_params_from_jax(jp, "cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [5, 8, 24, 32])
def test_mlstm_seq_matches_reference(dtype, s):
    """chunk 8: S < chunk (one chunk of S), one chunk, and three and four
    chunks carrying their states."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _core_params(jcfg, "mlstm", dtype)
    jx, tx = _inputs((2, s, jcfg.d_model), dtype, 3, s)
    got = TS.mlstm_seq(tcfg, tp, tx)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (2, s, jcfg.d_model)
    _close(got, JS.mlstm_seq(jcfg, jp, jx), dtype)


def test_mlstm_seq_refuses_a_length_off_the_chunk():
    _, tcfg = _cfgs()
    _, tp = _core_params(_cfgs()[0], "mlstm", "float32")
    with pytest.raises(ValueError, match="divisible by mlstm_chunk"):
        TS.mlstm_seq(tcfg, tp, torch.zeros((1, 12, tcfg.d_model)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_decode_matches_reference_step_by_step(dtype):
    """12 one-token steps from an empty reference cache carried across; the
    port writes the new (c, n, m) into the same cache tensors."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _core_params(jcfg, "mlstm", dtype)
    jcache = JS.init_mlstm_cache(jcfg, 2, DTYPES[dtype][0])
    tcache = convert.mlstm_cache_from_jax(jax.device_get(jcache), "cpu")
    assert [t.dtype for t in tcache] == [torch.float32] * 3
    held = tuple(tcache)
    step = jax.jit(JS.mlstm_decode, static_argnums=0)  # one compile, not 12 eager steps
    for t in range(12):
        jx, tx = _inputs((2, 1, jcfg.d_model), dtype, 5, t)
        want, jcache = step(jcfg, jp, jx, jcache)
        got, tcache = TS.mlstm_decode(tcfg, tp, tx, tcache)
        assert all(a is b for a, b in zip(tcache, held))  # in place
        _close(got, want, dtype, f"step {t}")
        for name, a, b in zip("cnm", tcache, jcache):
            np.testing.assert_allclose(_t32(a), _f32(b), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name}, step {t}")


# ---------------------------------------------------------------------------
# sLSTM: the wrapper's plain version, the sequence form and decode
# ---------------------------------------------------------------------------

def _slstm_state(shape, seed: int):
    """A nonzero fp32 state (c, n > 0, h, m) of ``shape`` as numpy."""
    rng = _rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.uniform(0.5, 2.0, size=shape).astype(np.float32),
            (0.5 * rng.normal(size=shape)).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _jscan(pre_x, r, b, st):
    """The reference's sLSTM time loop (``slstm_seq``'s scan) from ``st``."""
    p = {"r_gates": r, "b_gates": b}

    def body(st, pre_t):
        st = JS._slstm_cell(p, None, st, pre_x=pre_t)
        return st, st.h

    st, hs = jax.lax.scan(body, st, pre_x.transpose(1, 0, 2, 3, 4))
    return hs.transpose(1, 0, 2, 3), st


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 17])
def test_plain_slstm_scan_matches_reference_scan(dtype, s):
    """``ops.slstm_scan`` on CPU tensors (the plain loop) against the
    reference's ``lax.scan`` of ``_slstm_cell``, from a nonzero state: hs
    and the final state."""
    bsz, h, dh = 2, 4, 32
    rng = _rng(11, s)
    pre = rng.normal(size=(bsz, s, 4, h, dh)).astype(np.float32)
    r = (rng.normal(size=(4, h, dh, dh)) / np.sqrt(dh)).astype(np.float32)
    b = (0.1 * rng.normal(size=(4, h, dh))).astype(np.float32)
    st = _slstm_state((bsz, h, dh), 12)
    jd, td = DTYPES[dtype]
    want_hs, want_st = _jscan(jnp.asarray(pre).astype(jd), jnp.asarray(r).astype(jd),
                              jnp.asarray(b).astype(jd),
                              JS.SLSTMState(*(jnp.asarray(a) for a in st)))
    before = dict(tslstm.LAUNCHES)
    got_hs, got_st = tslstm.slstm_scan(torch.as_tensor(pre).to(td), torch.as_tensor(r).to(td),
                                       torch.as_tensor(b).to(td),
                                       tuple(torch.as_tensor(a) for a in st))
    assert tslstm.LAUNCHES == before  # CPU: the plain version, no launch
    assert got_hs.dtype == torch.float32 and tuple(got_hs.shape) == (bsz, s, h, dh)
    _close(got_hs, want_hs, dtype, "hs")
    for name, a, w in zip("cnhm", got_st, want_st):
        _close(a, w, dtype, name)


def test_plain_slstm_scan_is_the_step_loop_and_passes_nan_on():
    """The plain loop equals ``ref.slstm_step`` applied step by step, bit
    for bit; a NaN in one pre-activation reaches that unit's h from its
    step on (and, through the recurrent product, every unit of its head a
    step later), and no other head."""
    rng = _rng(13)
    pre = torch.as_tensor(rng.normal(size=(1, 6, 4, 2, 32)).astype(np.float32))
    r = torch.as_tensor((rng.normal(size=(4, 2, 32, 32)) / 6).astype(np.float32))
    b = torch.zeros((4, 2, 32))
    st = TS.SLSTMState(*(torch.as_tensor(a) for a in _slstm_state((1, 2, 32), 14)))
    hs, _ = slstm_scan_ref(pre, r, b, tuple(st))
    cur = st
    for t in range(6):
        cur = TS.SLSTMState(*slstm_step(pre[:, t], r, b, *cur))
        assert torch.equal(hs[:, t], cur.h)
    pre[0, 2, 1, 0, 5] = float("nan")
    hs, _ = slstm_scan_ref(pre, r, b, tuple(st))
    nan = hs.isnan()
    assert not nan[:, :2].any() and not nan[:, :, 1].any()
    assert bool(nan[0, 2, 0, 5]) and int(nan[0, 2].sum()) == 1 and bool(nan[0, 3:, 0].all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 13, 32])
def test_slstm_seq_matches_reference(dtype, s):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _core_params(jcfg, "slstm", dtype)
    jx, tx = _inputs((2, s, jcfg.d_model), dtype, 6, s)
    got = TS.slstm_seq(tcfg, tp, tx)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (2, s, jcfg.d_model)
    _close(got, JS.slstm_seq(jcfg, jp, jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_decode_matches_reference_step_by_step(dtype):
    """12 one-token steps from a nonzero reference state carried across;
    the new state is written into the same tensors."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _core_params(jcfg, "slstm", dtype)
    shape = (2, jcfg.n_heads, jcfg.d_model // jcfg.n_heads)
    jst = JS.SLSTMState(*(jnp.asarray(a) for a in _slstm_state(shape, 15)))
    tst = convert.slstm_state_from_jax(jax.device_get(jst), "cpu")
    held = tuple(tst)
    step = jax.jit(JS.slstm_decode, static_argnums=0)
    for t in range(12):
        jx, tx = _inputs((2, 1, jcfg.d_model), dtype, 16, t)
        want, jst = step(jcfg, jp, jx, jst)
        got, tst = TS.slstm_decode(tcfg, tp, tx, tst)
        assert all(a is b for a, b in zip(tst, held))  # in place
        _close(got, want, dtype, f"step {t}")
        for name, a, w in zip("cnhm", tst, jst):
            _close(a, w, dtype, f"{name}, step {t}")


def _wrapper_args(dtype=torch.float32, dh=32, s=4):
    pre = torch.zeros((1, s, 4, 2, dh), dtype=dtype)
    return (pre, torch.zeros((4, 2, dh, dh), dtype=dtype), torch.zeros((4, 2, dh), dtype=dtype),
            tuple(torch.zeros((1, 2, dh)) for _ in range(4)))


def test_slstm_wrapper_refuses_mixed_dtypes_and_shapes():
    pre, r, b, st = _wrapper_args()
    with pytest.raises(TypeError, match="one dtype"):
        tslstm.slstm_scan(pre, r.bfloat16(), b, st)
    with pytest.raises(TypeError, match="float32 state"):
        tslstm.slstm_scan(pre, r, b, (st[0].double(), *st[1:]))
    with pytest.raises(TypeError, match="one dtype"):
        tslstm.slstm_scan(pre.double(), r.double(), b.double(), st)
    with pytest.raises(ValueError, match="r_gates must have shape"):
        tslstm.slstm_scan(pre, r[:, :, :16], b, st)
    with pytest.raises(ValueError, match="pre_x"):
        tslstm.slstm_scan(pre[:, :, :3], r, b, st)
    with pytest.raises(ValueError, match="h must have shape"):
        tslstm.slstm_scan(pre, r, b, (st[0], st[1], st[2][:, :1], st[3]))


def test_slstm_wrapper_card_path_refuses_autograd_widths_and_strides(monkeypatch):
    """The wrapper's card path, reached with ``on_cpu`` patched and the
    library's entry point stubbed: under autograd it goes through the
    ``SLSTMScan`` Function to the saving launch (the entry given the saved
    rows' buffer, one ``slstm`` launch counted, no backward yet); then the
    checks that run before any build or launch refuse a head width the
    kernel is not built for and a non-contiguous input."""
    monkeypatch.setattr(tslstm, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(tslstm, "stream_handle", lambda device: 0)
    calls = []

    class _Lib:
        @staticmethod
        def repro_slstm_f32(*args):
            calls.append(args)
            return 0

    monkeypatch.setattr(tslstm.build, "library", lambda: _Lib)
    monkeypatch.setitem(tslstm.LAUNCHES, "slstm", 0)
    monkeypatch.setitem(tslstm.LAUNCHES, "slstm_bwd", 0)
    pre, r, b, st = _wrapper_args()
    r.requires_grad_(True)
    hs, _ = tslstm.slstm_scan(pre, r, b, st)
    assert type(hs.grad_fn).__name__ == "SLSTMScanBackward"
    assert len(calls) == 1 and calls[0][12] is not None  # the saved rows: the saving variant
    assert tslstm.LAUNCHES == {"slstm": 1, "slstm_bwd": 0}
    with torch.no_grad(), pytest.raises(ValueError, match="dh in"):
        tslstm.slstm_scan(*_wrapper_args(dh=48))
    pre, r, b, st = _wrapper_args(dh=64)
    with pytest.raises(ValueError, match="contiguous"):
        tslstm.slstm_scan(pre, r.transpose(2, 3), b, st)
    assert tslstm.LAUNCHES["slstm"] == 1 and len(calls) == 1
    assert set(tslstm.SUPPORTED_DH) == set(tslstm.CLUSTER)
    for dh, nc in tslstm.CLUSTER.items():  # a cluster's CTAs split the units
        assert dh % nc == 0 and nc in (1, 2, 4, 8)


# ---- the sLSTM kernel's step protocol (csrc/slstm.cu), modelled ----------


class _Mbarrier:
    """An mbarrier: a phase completes when all its arrivals are in and its
    transaction count is back to 0 (bytes may land before the arrival that
    expects them); ``done(parity)`` is try_wait.parity."""

    def __init__(self, count: int):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, expect: int = 0):
        self.tx += expect
        self.pending -= 1
        self._complete()

    def complete_tx(self, nbytes: int):
        self.tx -= nbytes
        self._complete()

    def _complete(self):
        assert self.pending >= 0, "more arrivals than the phase takes"
        if self.pending == 0 and self.tx == 0:
            self.phase, self.pending = self.phase + 1, self.count

    def done(self, parity: int) -> bool:
        return (self.phase & 1) != parity


class _SlstmProtocol:
    """The kernel's synchronisation for one (row, head) cluster, its
    arithmetic left out: ``nc`` CTAs of ``warps`` consumer warps (each of
    ``units`` units, whose h goes, 4 bytes a unit, into every CTA) and one
    producer warp, ``steps`` steps, a pre_x ring of ``stages`` stages of
    ``tile`` steps.  Each actor is a generator yielding after every action
    on shared state; st.async stores and bulk copies are events that land
    later, in any order (a warp's stores into one CTA, one instruction's
    lanes there, land as one event; every (warp, CTA) pair apart).  ``run``
    interleaves them at random and asserts: no h slot is overwritten before
    every warp of its CTA has read the step it holds, every wait sees the
    phase it waits for and not one past it, and a ring stage is read only
    whole and refilled only after every consumer has released it.
    ``fault`` plants a break: "one_h_buffer" (every step's h into one
    buffer) or "no_empty_wait" (the producer refills without waiting)."""

    def __init__(self, nc, warps, steps, tile, stages, fault=None,
                 units=tslstm.UNITS_A_WARP):
        self.nc, self.warps, self.units, self.steps = nc, warps, units, steps
        self.tile, self.stages, self.fault = tile, stages, fault
        self.tiles = -(-steps // tile)
        self.nbuf = 1 if fault == "one_h_buffer" else 2
        self.h_bytes = 4 * nc * warps * units  # a step's h into one CTA
        self.ctas = []
        for _ in range(nc):
            cta = {"full": [_Mbarrier(1) for _ in range(self.nbuf)],
                   "landed": [_Mbarrier(1) for _ in range(stages)],
                   "empty": [_Mbarrier(warps) for _ in range(stages)],
                   # per buffer and sending warp (rank, warp): the step of
                   # h its units' slots hold, and the buffer's reads (by
                   # any warp of the CTA) before it landed
                   "slot_step": [[0 if b == 0 else None] * (nc * warps)
                                 for b in range(self.nbuf)],
                   "slot_base": [[0] * (nc * warps) for _ in range(self.nbuf)],
                   "reads": [0] * self.nbuf,
                   "ring_tile": [None] * stages, "ring_rows": [0] * stages,
                   "released": [warps] * stages}
            for b in range(self.nbuf):  # the first phase of each buffer, armed
                cta["full"][b].arrive(self.h_bytes)
            self.ctas.append(cta)
        self.events = []  # landings: (cta, sender slot, step) or (cta, None, stage)

    def _wait(self, bar, parity, expect_phase):
        if not bar.done(parity):
            yield bar, parity  # blocked until the phase completes
        assert bar.phase == expect_phase, (
            f"a wait for phase {expect_phase - 1} saw {bar.phase - 1} complete")

    def consumer(self, rank, warp):
        cta, slot = self.ctas[rank], rank * self.warps + warp
        for i in range(self.tiles):
            s = i % self.stages
            yield from self._wait(cta["landed"][s], (i // self.stages) & 1,
                                  i // self.stages + 1)
            assert cta["ring_tile"][s] == i and cta["ring_rows"][s] == 4 * min(
                self.tile, self.steps - i * self.tile), "a stage handed out before it is full"
            for t in range(i * self.tile, min((i + 1) * self.tile, self.steps)):
                assert cta["ring_tile"][s] == i, "a stage refilled while it is read"
                yield
                cur = t % self.nbuf
                if t > 0:
                    yield from self._wait(cta["full"][cur], ((t - 1) // self.nbuf) & 1,
                                          (t - 1) // self.nbuf + 1)
                    if warp == 0 and t + self.nbuf < self.steps:
                        cta["full"][cur].arrive(self.h_bytes)
                        yield
                held = cta["slot_step"][cur]
                assert held.count(t) == len(held), f"step {t} read h of steps {set(held)}"
                cta["reads"][cur] += 1  # the product reads all of h_t
                yield
                if t + 1 < self.steps:
                    self.events += [(q, slot, t + 1) for q in range(self.nc)]
                    yield
            cta["released"][s] += 1
            cta["empty"][s].arrive()
            yield

    def _land_h(self, q, slot, step):
        cta = self.ctas[q]
        b = step % self.nbuf
        if cta["slot_step"][b][slot] is not None:
            assert cta["reads"][b] - cta["slot_base"][b][slot] == self.warps, (
                f"h_{step} overwrote h_{cta['slot_step'][b][slot]} before every warp read it")
        cta["slot_step"][b][slot], cta["slot_base"][b][slot] = step, cta["reads"][b]
        cta["full"][b].complete_tx(4 * self.units)

    def producer(self, rank):
        cta = self.ctas[rank]
        for i in range(self.tiles):
            s = i % self.stages
            if i >= self.stages and self.fault != "no_empty_wait":
                yield from self._wait(cta["empty"][s], (i // self.stages - 1) & 1,
                                      i // self.stages)
            assert cta["released"][s] == self.warps, "a stage refilled before its release"
            rows = 4 * min(self.tile, self.steps - i * self.tile)
            cta["released"][s], cta["ring_tile"][s], cta["ring_rows"][s] = 0, i, 0
            cta["landed"][s].arrive(rows * 16)
            yield
            for _ in range(rows):
                self.events.append((rank, None, s))
                yield

    def _land_row(self, rank, s):
        cta = self.ctas[rank]
        cta["ring_rows"][s] += 1
        cta["landed"][s].complete_tx(16)

    def run(self, rng: random.Random, max_picks: int = 1_000_000):
        actors = [self.consumer(q, w) for q in range(self.nc) for w in range(self.warps)]
        actors += [self.producer(q) for q in range(self.nc)]
        blocked = [None] * len(actors)  # (mbarrier, parity) an actor waits on
        events, pick = self.events, rng.random
        for _ in range(max_picks):
            n = len(actors)
            if not (n or events):
                return
            k = int(pick() * (n + len(events)))
            if k >= n:
                q, slot, x = events.pop(k - n)
                if slot is None:
                    self._land_row(q, x)
                else:
                    self._land_h(q, slot, x)
                continue
            if blocked[k] is not None and not blocked[k][0].done(blocked[k][1]):
                continue
            try:
                blocked[k] = next(actors[k])
            except StopIteration:
                actors.pop(k)
                blocked.pop(k)
        raise AssertionError("no progress: a wait that never completes")


# interleavings a layout: a few hundred, the most at xlstm-125m's (dh 192)
# and the other cluster of 8 (dh 128)
_PROTOCOL_RUNS = {32: 200, 64: 200, 128: 300, 192: 300}


@pytest.mark.parametrize("dh", tslstm.SUPPORTED_DH)
def test_slstm_kernel_protocol_holds_under_random_interleavings(dh):
    """The kernel's step protocol at its cluster and warp layout for ``dh``
    (``ops.CLUSTER``, ``ops.consumer_warps``), 5 steps through a ring of 2
    stages of 2 steps (so the h buffers and the ring both wrap, and each h
    buffer's mbarrier is re-armed), under seeded random interleavings of the
    warps and of the stores' and copies' landings: no h slot overwritten
    before every reader of its step has read it, no wait past its phase, no
    stage handed out before it is full or refilled before every consumer
    released it, and no deadlock."""
    nc, warps = tslstm.CLUSTER[dh], tslstm.consumer_warps(dh)
    assert nc * warps * tslstm.UNITS_A_WARP == dh  # every unit on one warp
    for seed in range(_PROTOCOL_RUNS[dh]):
        _SlstmProtocol(nc, warps, steps=5, tile=2, stages=2).run(random.Random(seed))


def test_slstm_kernel_protocol_holds_at_the_kernels_ring():
    """The same at the kernel's own ring (ops.TILE steps, ops.STAGES stages)
    past one whole ring, at dh 32's layout and at xlstm-125m's (dh 192)."""
    steps = tslstm.STAGES * tslstm.TILE + 1
    for dh, seeds in ((32, 3), (192, 2)):
        for seed in range(seeds):
            _SlstmProtocol(tslstm.CLUSTER[dh], tslstm.consumer_warps(dh), steps=steps,
                           tile=tslstm.TILE, stages=tslstm.STAGES).run(random.Random(seed))


@pytest.mark.parametrize("fault,match", [("one_h_buffer", "overwrote"),
                                         ("no_empty_wait", "refilled before")])
def test_slstm_kernel_protocol_model_catches_a_planted_fault(fault, match):
    """The model's checks are live: one h buffer in place of two, or a
    producer that refills a stage without waiting for its release, fails
    at xlstm-125m's layout (dh 192) within a few interleavings."""
    nc, warps = tslstm.CLUSTER[192], tslstm.consumer_warps(192)
    with pytest.raises(AssertionError, match=match):
        for seed in range(20):
            _SlstmProtocol(nc, warps, steps=5, tile=2, stages=2, fault=fault).run(
                random.Random(seed))


def test_plain_slstm_scan_has_gradients_on_the_cpu():
    rng = _rng(17)
    pre = torch.as_tensor(rng.normal(size=(1, 5, 4, 2, 32)).astype(np.float32),
                          ).requires_grad_(True)
    r = torch.as_tensor((rng.normal(size=(4, 2, 32, 32)) / 6).astype(np.float32)
                        ).requires_grad_(True)
    st = tuple(torch.as_tensor(a) for a in _slstm_state((1, 2, 32), 18))
    hs, _ = tslstm.slstm_scan(pre, r, torch.zeros((4, 2, 32)), st)
    gp, gr = torch.autograd.grad(hs.sum(), (pre, r))
    assert bool(torch.isfinite(gp).all()) and bool(gr.abs().sum() > 0)


# ---------------------------------------------------------------------------
# the block types
# ---------------------------------------------------------------------------

def _block_params(jcfg, bt, dtype):
    jp = _jinit(JB.init_block, jcfg, bt, jax.random.PRNGKey(5), DTYPES[dtype][0])
    return jax.tree.map(jnp.asarray, jp), convert.arch_params_from_jax(jp, "cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bt", XLSTM_TYPES)
def test_block_seq_matches_reference(bt, dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _block_params(jcfg, bt, dtype)
    jx, tx = _inputs((2, 24, jcfg.d_model), dtype, 7)
    pos = np.arange(24)
    want, _ = JB.block_seq(jcfg, bt, jp, jx, jnp.asarray(pos))
    got, aux = TB.block_seq(tcfg, bt, tp, tx, torch.as_tensor(pos))
    assert float(aux) == 0.0
    _close(got, want, dtype)


@pytest.mark.parametrize("bt", XLSTM_TYPES)
def test_block_decode_matches_reference(bt):
    """10 one-token steps from empty states, updated in place."""
    jcfg, tcfg = _cfgs()
    jp, tp = _block_params(jcfg, bt, "float32")
    jc = JB.init_block_cache(jcfg, bt, 2, 8, jnp.float32)
    tc = TB.init_block_cache(tcfg, bt, 2, 8, torch.float32)
    assert sorted(tc) == sorted(jc) == [bt]
    held = tuple(tc[bt])
    step = jax.jit(JB.block_decode, static_argnums=(0, 1))
    for t in range(10):
        jx, tx = _inputs((2, 1, jcfg.d_model), "float32", 8, t)
        want, jc = step(jcfg, bt, jp, jx, jc, jnp.asarray(t, jnp.int32))
        got, tc = TB.block_decode(tcfg, bt, tp, tx, tc, t)
        assert all(a is b for a, b in zip(tc[bt], held))
        _close(got, want, err_msg=f"step {t}")
    for a, w in zip(tc[bt], jc[bt]):
        _close(a, w)


# ---------------------------------------------------------------------------
# the smoke model end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = _cfgs()
    jp = _jinit(JM.init_params, jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, convert.arch_params_from_jax(jp, "cpu")


def _tokens(vocab, shape, seed):
    return _rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def test_smoke_forward_matches_reference(smoke):
    jcfg, tcfg, jp, tp = smoke
    tok = _tokens(jcfg.vocab, (2, 64), 9)
    want, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(tok)})
    before = dict(tslstm.LAUNCHES)
    got = tsteps.make_prefill_step(tcfg)(tp, {"tokens": torch.as_tensor(tok, dtype=torch.int64)})
    assert tslstm.LAUNCHES == before  # CPU: the plain version
    assert tuple(got.shape) == (2, 64, jcfg.vocab)
    _close(got, want)


def test_smoke_prefill_reaches_the_slstm_wrapper_once_per_layer(smoke, monkeypatch):
    _, tcfg, _, tp = smoke
    seen = []
    real = tslstm.slstm_scan
    monkeypatch.setattr(tslstm, "slstm_scan",
                        lambda *a: seen.append(tuple(a[0].shape)) or real(*a))
    TM.forward(tcfg, tp, {"tokens": torch.zeros((1, 16), dtype=torch.int64)})
    assert seen == [(1, 16, 4, 4, 32)]


def test_smoke_decode_matches_reference(smoke):
    """24 one-token steps of the smoke model against the reference's."""
    jcfg, tcfg, jp, tp = smoke
    tok = _tokens(jcfg.vocab, (24, 3), 10)
    jc = JM.init_cache(jcfg, 3, 32)
    tc = TM.init_cache(tcfg, 3, 32, device="cpu")
    serve = tsteps.make_serve_step(tcfg)
    step = jax.jit(JM.decode_step, static_argnums=0)  # one compile, not 24 eager steps
    for t in range(24):
        want, jc = step(jcfg, jp, jc, jnp.asarray(tok[t]), jnp.asarray(t, jnp.int32))
        got, tc = serve(tp, tc, torch.as_tensor(tok[t], dtype=torch.int64), t)
        _close(got, want, err_msg=f"step {t}")


def test_decode_replays_the_forward_and_updates_the_stacked_states(smoke):
    """``init_cache`` stacks the mLSTM and sLSTM states per stage; each
    decode step writes into them through the layers' views, and the
    replayed logits equal ``forward``'s at every position."""
    _, tcfg, _, tp = smoke
    caches = TM.init_cache(tcfg, 2, 32, device="cpu")
    assert [sorted(s) for s in caches] == [["0_mlstm", "1_slstm"]]
    c = caches[0]["0_mlstm"]["mlstm"].c
    h = caches[0]["1_slstm"]["slstm"].h
    assert tuple(c.shape) == (1, 2, 4, 64, 64) and tuple(h.shape) == (1, 2, 4, 32)
    tok = torch.as_tensor(_rng(12).integers(0, tcfg.vocab, size=(2, 40)))
    full, _ = TM.forward(tcfg, tp, {"tokens": tok})
    for t in range(40):
        logits, out = TM.decode_step(tcfg, tp, caches, tok[:, t], t)
        assert out is caches
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), rtol=RTOL, atol=ATOL)
    assert bool((c != 0).any()) and bool((h != 0).any())


@pytest.fixture(scope="module")
def smoke_bf16():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jp = _jinit(JM.init_params, jcfg, jax.random.PRNGKey(0))
    tp = convert.arch_params_from_jax(jp, "cpu")
    tok = _tokens(jcfg.vocab, (3, 24), 10)
    jfwd = _f32(JM.forward(jcfg, jp, {"tokens": jnp.asarray(tok)})[0])
    tfwd = tsteps.make_prefill_step(tcfg)(tp, {"tokens": torch.as_tensor(tok, dtype=torch.int64)})
    return jcfg, tcfg, jp, tp, tok, jfwd, tfwd


def _rel_l2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Each request's relative L2 distance over its (positions, vocab)."""
    return np.linalg.norm((a - b).reshape(len(b), -1), axis=1) / \
        np.linalg.norm(b.reshape(len(b), -1), axis=1)


def test_smoke_bf16_forward_matches_reference(smoke_bf16):
    """bf16 logits: each request within relative L2 2e-2 of the
    reference's and every logit within 2^-4 (one bf16 ulp at 8; the logits
    reach ~4).  A bf16 value that rounds the other way in XLA's and torch's
    products stays in the recurrent states, so a few logits move by more
    than the layer tolerance (measured: relative L2 0.0078-0.0081, 163 of
    36864 logits beyond rtol 2^-7 / atol 2e-2, at most 0.043 apart)."""
    _, _, _, _, _, jfwd, tfwd = smoke_bf16
    np.testing.assert_allclose(_t32(tfwd), jfwd, rtol=0, atol=2.0 ** -4)
    assert np.all(_rel_l2(_t32(tfwd), jfwd) <= 2e-2)


def test_smoke_bf16_decode_matches_reference(smoke_bf16):
    """bf16: the port's 24 ``decode_step``s against the reference's: each
    request's decode distance within 1.1 x its forward distance and 2e-2,
    and each package's decode within 1e-2 of its own forward."""
    jcfg, tcfg, jp, tp, tok, jfwd, tfwd = smoke_bf16
    jc = JM.init_cache(jcfg, 3, 32)
    step = jax.jit(JM.decode_step, static_argnums=0)
    jdec = []
    for t in range(tok.shape[1]):
        lg, jc = step(jcfg, jp, jc, jnp.asarray(tok[:, t]), jnp.asarray(t, jnp.int32))
        jdec.append(_f32(lg))
    jdec = np.stack(jdec, 1)
    serve = tsteps.make_serve_step(tcfg)
    cache = TM.init_cache(tcfg, 3, 32, device="cpu")
    fed = torch.as_tensor(tok, dtype=torch.int64)
    tdec = _t32(torch.stack([serve(tp, cache, fed[:, t], t)[0]
                             for t in range(fed.shape[1])], 1))
    fwd_gap, dec_gap = _rel_l2(_t32(tfwd), jfwd), _rel_l2(tdec, jdec)
    assert np.all(dec_gap <= np.maximum(1.1 * fwd_gap, 2e-2)), (dec_gap, fwd_gap)
    assert np.all(dec_gap <= 2e-2), dec_gap
    assert np.all(_rel_l2(jdec, jfwd) <= 1e-2) and np.all(_rel_l2(tdec, _t32(tfwd)) <= 1e-2)


def test_loss_and_grads_match_reference(smoke):
    """``loss_fn`` and every leaf's gradient on the CPU, through the plain
    sLSTM loop and the chunkwise mLSTM, against ``jax.grad``."""
    jcfg, tcfg, jp, _ = smoke
    tok = _tokens(jcfg.vocab, (2, 17), 19)
    jb = {"tokens": jnp.asarray(tok[:, :-1]), "targets": jnp.asarray(tok[:, 1:])}
    tb = {k: torch.as_tensor(np.array(v), dtype=torch.int64) for k, v in jb.items()}
    (jloss, jmet), jgrad = jax.jit(jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, jb),
                                                      has_aux=True))(jax.tree.map(jnp.asarray, jp))
    tp = convert.arch_params_from_jax(jp, "cpu")
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tloss, tmet = TM.loss_fn(tcfg, tp, tb)
    grads = torch.autograd.grad(tloss, leaves)
    assert sorted(tmet) == sorted(jmet) == ["aux", "ce", "loss"]
    _close(tloss, jloss)
    for a, g in zip(jax.tree.leaves(jgrad), grads, strict=True):
        _close(g, a)
