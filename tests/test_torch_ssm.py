"""repro_torch's Mamba SSM and hybrid blocks against the JAX package's, on the
CPU.

``models/ssm.py`` piece by piece: ``init_mamba``'s bits from one key,
``_mamba_inner`` (the conv output bit-equal in bf16), ``mamba_seq`` and
``mamba_decode`` (step by step from a reference cache carried across); the
selective-scan wrapper's plain version against an fp64 recurrence, its NaN
propagation, its refusals, the kernel's launch plan (every channel and
state on one lane of one block) and a numpy replay of the kernel's lane
arithmetic (exps of dt a log2(e), fused products, y summed over a lane's
states, then pairwise over the lanes); the block types ``hybrid``, ``hybrid_g`` and
``mamba`` (init bits, ``block_seq``, ``block_decode``); then hymba-1.5b's
smoke configuration end to end with ``attn_impl="pallas_swa"`` (the
reference's Pallas kernel in interpret mode, the port's plain versions):
``forward`` and 24 ``decode_step``s (in bf16 too, beside
``chip_smoke.py``'s bf16 decode gate with and without a planted fault),
and the full parameter tree's shapes with nothing allocated.  The reference runs inside
``jax.threefry_partitionable(False)``.

Tolerances: fp32 TOL 1e-4 (logits and layer outputs: the same products,
summed in another order, and the scan's associative order against a
sequential one); bf16 layer outputs rtol 2^-7 (one bf16 ulp) beside an
absolute 2e-2, as ``tests/test_torch_moe.py`` holds its bf16 layers (the
outputs reach ~8, where a bf16 ulp is 2^-4; measured at most 0.0039 apart).
Init bits are equal but for one value: XLA's fp32 ``log(7)`` on the CPU
(jax 0.9.0) is 0x3FF91396, one ulp above the correctly rounded 0x3FF91395
that torch gives, so ``a_log[:, 6]`` may differ by exactly that ulp in
fp32 (bf16 rounds both alike).
"""
import dataclasses

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
from repro_torch.kernels.scan import ops as tscan  # noqa: E402
from repro_torch.kernels.scan.ref import selective_scan_ref  # noqa: E402
from repro_torch.kernels.swa import ops as tswa  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

# the plain scan is many small ops: one thread keeps the file's time low
# under pytest -n 6
torch.set_num_threads(1)

ARCH = "hymba-1.5b"
TOL = 1e-4
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LOG7_COL = 6  # a_log[:, 6] = log(7), one fp32 ulp apart (module docstring)
HYBRID_TYPES = ("hybrid", "hybrid_g", "mamba")


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
        np.testing.assert_allclose(_t32(got), _f32(want), rtol=TOL, atol=TOL,
                                   err_msg=err_msg)


def _jinit(fn, *args):
    with jax.threefry_partitionable(False):
        return jax.device_get(fn(*args))


def _bits_equal(got: dict, want: dict, dtype: str, path: str = "") -> None:
    """Every leaf of the two trees bit for bit, but for the log(7) ulp of
    an fp32 ``a_log``."""
    assert sorted(got) == sorted(want), path
    for name, w in want.items():
        g, label = got[name], f"{path}/{name}"
        if isinstance(w, dict):
            _bits_equal(g, w, dtype, label)
            continue
        assert g.dtype == DTYPES[dtype][1], label
        gf, wf = _t32(g), _f32(w)
        if name == "a_log" and dtype == "float32":
            ulps = wf.view(np.int32).astype(np.int64) - gf.view(np.int32)
            assert np.all(np.delete(ulps, LOG7_COL, axis=-1) == 0), label
            assert set(np.unique(ulps[..., LOG7_COL])) <= {0, 1}, label
            continue
        np.testing.assert_array_equal(gf, wf, err_msg=label)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_init_mamba_bits_match_reference(dtype):
    jcfg, tcfg = _cfgs()
    want = _jinit(JS.init_mamba, jcfg, jax.random.PRNGKey(3), DTYPES[dtype][0])
    got = TS.init_mamba(tcfg, prng.PRNGKey(3), DTYPES[dtype][1], "cpu")
    _bits_equal(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bt", HYBRID_TYPES)
def test_init_block_bits_match_reference(bt, dtype):
    """The block's key split: attention from ks[0], the Mamba branch from
    ks[1], the MLP from ks[2]; a ``mamba`` block has neither attention nor
    MLP."""
    jcfg, tcfg = _cfgs()
    want = _jinit(JB.init_block, jcfg, bt, jax.random.PRNGKey(5), DTYPES[dtype][0])
    got = TB.init_block(tcfg, bt, prng.PRNGKey(5), DTYPES[dtype][1], "cpu")
    assert ("attn" in got) == (bt != "mamba") and ("ffn" in got) == (bt != "mamba")
    _bits_equal(got, want, dtype)


def test_init_params_bits_match_reference():
    jcfg, tcfg = _cfgs()
    want = _jinit(JM.init_params, jcfg, jax.random.PRNGKey(0))
    got = TM.init_params(tcfg, prng.PRNGKey(0), "cpu")
    assert len(got["stages"]) == len(want["stages"]) == 2
    for g, w in zip(got["stages"], want["stages"]):
        _bits_equal(g, w, "float32")
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
    assert n == 1661956800  # 3.32 GB in bf16


# ---------------------------------------------------------------------------
# the Mamba branch
# ---------------------------------------------------------------------------

def _mamba_params(jcfg, dtype: str, seed: int = 3):
    jp = _jinit(JS.init_mamba, jcfg, jax.random.PRNGKey(seed), DTYPES[dtype][0])
    return jax.tree.map(jnp.asarray, jp), convert.arch_params_from_jax(jp, "cpu")


def _inputs(shape, dtype: str, *seed, scale: float = 1.0):
    a = (_rng(*seed).normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(a).astype(DTYPES[dtype][0]), torch.as_tensor(a).to(DTYPES[dtype][1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [False, True])
def test_mamba_inner_matches_reference(dtype, window):
    """The sequence form (zero padding) and the decode form (a carried conv
    window); the conv output bit-equal in bf16, where the reference rounds
    each tap's product and sum."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mamba_params(jcfg, dtype)
    di, kw = jp["w_in"].shape[1], jcfg.ssm_conv
    s = 1 if window else 64
    ju, tu = _inputs((2, s, di), dtype, 1, s)
    jstate = tstate = None
    if window:
        jstate, tstate = _inputs((2, kw - 1, di), dtype, 2)
    want = JS._mamba_inner(jp, ju, conv_state=jstate)
    got = TS._mamba_inner(tp, tu, conv_state=tstate)
    for name, g, w in zip(("x", "b", "c", "dt", "conv window"), got, want):
        assert g.dtype == DTYPES[dtype][1] and tuple(g.shape) == w.shape, name
        if dtype == "bfloat16" and name in ("x", "conv window"):
            np.testing.assert_array_equal(_t32(g), _f32(w), err_msg=name)
        else:
            _close(g, w, dtype, name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 37, 128])
def test_mamba_seq_matches_reference(dtype, s):
    jcfg, tcfg = _cfgs()
    jp, tp = _mamba_params(jcfg, dtype)
    jx, tx = _inputs((2, s, jcfg.d_model), dtype, 3, s)
    got = TS.mamba_seq(tcfg, tp, tx)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (2, s, jcfg.d_model)
    _close(got, JS.mamba_seq(jcfg, jp, jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_decode_matches_reference_step_by_step(dtype):
    """12 one-token steps from a nonzero reference cache carried across; the
    port writes the new window and state into the same cache tensors."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mamba_params(jcfg, dtype)
    di, kw, n = jp["w_in"].shape[1], jcfg.ssm_conv, jcfg.ssm_state
    rng = _rng(4)
    jcache = JS.MambaCache(
        conv=jnp.asarray(rng.normal(size=(2, kw - 1, di)).astype(np.float32)).astype(
            DTYPES[dtype][0]),
        ssm=jnp.asarray(rng.normal(size=(2, di, n)).astype(np.float32)))
    tcache = convert.mamba_cache_from_jax(jax.device_get(jcache), "cpu")
    assert tcache.conv.dtype == DTYPES[dtype][1] and tcache.ssm.dtype == torch.float32
    conv, state = tcache.conv, tcache.ssm
    for t in range(12):
        jx, tx = _inputs((2, 1, jcfg.d_model), dtype, 5, t)
        want, jcache = JS.mamba_decode(jcfg, jp, jx, jcache)
        got, tcache = TS.mamba_decode(tcfg, tp, tx, tcache)
        assert tcache.conv is conv and tcache.ssm is state  # in place
        _close(got, want, dtype, f"step {t}")
        _close(tcache.conv, jcache.conv, dtype, f"conv window, step {t}")
        np.testing.assert_allclose(_t32(tcache.ssm), _f32(jcache.ssm), rtol=TOL, atol=TOL,
                                   err_msg=f"ssm state, step {t}")


# ---------------------------------------------------------------------------
# the selective-scan wrapper's plain version and the kernel's plan
# ---------------------------------------------------------------------------

def _scan_inputs(shape, dtype, seed: int):
    """x, dt (softplus of a normal: positive, as the model's), b, c, a_log
    (the model's log(1..n)) of (B, S, di, n) in ``dtype``."""
    bsz, s, di, n = shape
    rng = _rng(seed, *shape)
    x = rng.normal(size=(bsz, s, di))
    dt = np.log1p(np.exp(rng.normal(-1.0, 1.0, size=(bsz, s, di))))
    b, c = rng.normal(size=(2, bsz, s, n))
    a_log = np.tile(np.log(np.arange(1, n + 1)), (di, 1)) + rng.normal(0, 0.1, (di, n))
    return [torch.as_tensor(a, dtype=torch.float32).to(dtype) for a in (x, dt, b, c, a_log)]


def _scan_fp64(x, dt, b, c, a_log) -> np.ndarray:
    """The recurrence in fp64 on the inputs' values (dt * x rounded in
    their dtype first, as the contract rounds it)."""
    x64 = lambda t: t.double().numpy()  # noqa: E731
    dtx, dt, b, c = x64(dt * x), x64(dt), x64(b), x64(c)
    a = -np.exp(x64(a_log))
    h = np.zeros((x.shape[0], x.shape[2], a.shape[1]))
    y = np.zeros(x.shape)
    for t in range(x.shape[1]):
        h = np.exp(dt[:, t, :, None] * a) * h + dtx[:, t, :, None] * b[:, t, None, :]
        y[:, t] = (h * c[:, t, None, :]).sum(-1)
    return y


SCAN_SHAPES = [(1, 1, 8, 16), (2, 50, 24, 16), (3, 128, 40, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_plain_scan_matches_fp64_recurrence(shape, dtype):
    ins = _scan_inputs(shape, dtype, 0)
    got = selective_scan_ref(*ins)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:3]
    want = _scan_fp64(*ins)
    scale = np.abs(want).max()
    assert np.abs(got.double().numpy() - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_wrapper_on_the_cpu_is_the_plain_version(dtype):
    ins = _scan_inputs((2, 40, 16, 16), dtype, 1)
    before = dict(tscan.LAUNCHES)
    got = tscan.selective_scan(*ins)
    assert tscan.LAUNCHES == before  # no kernel launched on the CPU
    assert torch.equal(got, selective_scan_ref(*ins))


def test_plain_scan_nan_in_dt_reaches_its_channel_from_then_on():
    x, dt, b, c, a_log = _scan_inputs((2, 30, 8, 16), torch.float32, 2)
    dt[1, 11, 5] = float("nan")
    y = selective_scan_ref(x, dt, b, c, a_log)
    want = torch.zeros(y.shape, dtype=torch.bool)
    want[1, 11:, 5] = True
    assert torch.equal(torch.isnan(y), want)


def test_scan_wrapper_refuses_what_it_does_not_take():
    x, dt, b, c, a_log = _scan_inputs((1, 8, 4, 4), torch.float32, 3)
    with pytest.raises(TypeError, match="one dtype"):
        tscan.selective_scan(x.half(), dt.half(), b.half(), c.half(), a_log.half())
    with pytest.raises(TypeError, match="one dtype"):
        tscan.selective_scan(x, dt.bfloat16(), b, c, a_log)
    with pytest.raises(ValueError, match="takes x, dt"):
        tscan.selective_scan(x, dt, b, c, a_log.T.contiguous()[:3])
    with pytest.raises(ValueError, match="takes x, dt"):
        tscan.selective_scan(x, dt[:, :4], b, c, a_log)


def test_plain_scan_has_gradients_on_the_cpu():
    """Training a hybrid model on the CPU differentiates the plain version
    (the wrapper's Function: the plain forward and the plain backward)."""
    ins = [t.requires_grad_() for t in _scan_inputs((1, 12, 6, 4), torch.float32, 4)]
    tscan.selective_scan(*ins).square().sum().backward()
    for t in ins:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())


PLAN_SHAPES = [(1, 1, 8), (2, 300, 96), (3, 1000, 200), (1, 4097, 3200), (1, 32768, 3200),
               (4, 16, 3200), (1, 65, 128), (64, 100000, 32)]


@pytest.mark.parametrize("b,s,di", PLAN_SHAPES)
def test_scan_plan_covers_every_state_once(b, s, di):
    """The kernel's grid on 132 SMs, for fp32 and bf16 inputs: each batch
    row's channels cut into contiguous ranges of whole units of CHANNELS
    (but the last) that each fit a block and fill its warps, a warp a unit,
    within the shared memory a block may take; a channel's states on LANES
    lanes of one warp (a lane holds MAX_STATE // LANES consecutive ones),
    LANES dividing a warp; the grid within its limits; at hymba's prefill
    one block an SM, of 6 or 7 units (24 or 28 channels)."""
    assert 32 % tscan.LANES == 0 and tscan.CHANNELS * tscan.LANES == 32
    units = -(-di // tscan.CHANNELS)
    slots = tscan.MAX_STATE // tscan.LANES
    for itemsize in (4, 2):
        plan = tscan.scan_plan(b, di, itemsize, 132)
        assert 1 <= plan.warps <= tscan.MAX_WARPS
        assert tscan.smem_bytes(plan.warps, itemsize) <= tscan.SMEM_LIMIT
        assert 1 <= plan.groups <= min(units, 2 ** 31 - 1) and b <= 65535
        ubounds = np.array([g * units // plan.groups for g in range(plan.groups + 1)])
        bounds = np.minimum(ubounds * tscan.CHANNELS, di)  # channels
        sizes = np.diff(ubounds)
        assert bounds[0] == 0 and bounds[-1] == di and np.diff(bounds).min() >= 1
        assert sizes.max() == plan.warps  # the widest block's units fill its warps
        if (b, s, di) == (1, 32768, 3200):
            assert plan.groups == 132 and set(np.diff(bounds).tolist()) == {24, 28}
    for n in (1, 5, 8, 9, 16):
        owner = [(j // slots, j % slots) for j in range(n)]  # (lane, slot)
        assert len(set(owner)) == n and max(lane for lane, _ in owner) < tscan.LANES


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("b,di", [(5, 3200), (16, 3200), (1024, 28), (1024, 3200)])
def test_scan_plan_fits_shared_memory(b, di, itemsize):
    """Shapes whose plan takes the widest blocks: their shared memory (as
    the kernel lays it out) within the H100's 227 KiB a block.  In fp32 a
    block of MAX_WARPS warps would not fit (235776 bytes), so fp32 blocks
    stop at 7 warps and bf16 ones at 8."""
    plan = tscan.scan_plan(b, di, itemsize, 132)
    widest = 7 if itemsize == 4 else 8
    assert plan.warps == min(widest, -(-di // tscan.CHANNELS))
    assert tscan.smem_bytes(plan.warps, itemsize) <= tscan.SMEM_LIMIT
    assert tscan.smem_bytes(tscan.MAX_WARPS, 4) == 235776 > tscan.SMEM_LIMIT
    assert tscan.smem_bytes(tscan.MAX_WARPS, 2) == 170240


def _fma(p, q, r) -> np.ndarray:
    """fma(p, q, r) on fp32 values: the fp64 product and sum, rounded once
    to fp32."""
    return (p.astype(np.float64) * q.astype(np.float64) + r).astype(np.float32)


def _lane_replay(x, dt, b, c, a_log) -> np.ndarray:
    """The kernel's arithmetic in numpy: a2 = fp32(a log2(e)); the decay is
    2^fp32(dt a2) (exp2 rounded to fp32, flushed to 0 below 2^-126 as
    ex2.approx.ftz flushes); h = fma(decay, h, fp32(dt x b)); each lane's
    part of y sums its MAX_STATE // LANES consecutive states in order (fma after
    the first product), and the LANES parts of a channel sum pairwise in
    lane order."""
    f32 = np.float32
    dtx, dtf = (dt * x).float().numpy(), dt.float().numpy()
    a = -np.exp(a_log.float().numpy())
    bsz, s, di = x.shape
    n = a.shape[1]
    slots = tscan.MAX_STATE // tscan.LANES
    pad = ((0, 0), (0, 0), (0, tscan.LANES * slots - n))
    a2 = np.pad((a * f32(np.log2(np.e))).astype(f32)[None], pad)[0]
    bp, cp = (np.pad(t.float().numpy(), pad) for t in (b, c))
    h = np.zeros((bsz, di, tscan.LANES * slots), f32)
    y = np.empty((bsz, s, di), f32)
    for t in range(s):
        decay = np.exp2((dtf[:, t, :, None] * a2).astype(np.float64)).astype(f32)
        decay[decay < 2.0 ** -126] = 0.0
        h = _fma(decay, h, dtx[:, t, :, None] * bp[:, t, None, :])
        hl = h.reshape(bsz, di, tscan.LANES, slots)
        cl = np.broadcast_to(cp[:, t, None, :], h.shape).reshape(hl.shape)
        part = hl[..., 0] * cl[..., 0]
        for k in range(1, slots):
            part = _fma(cl[..., k], hl[..., k], part)
        while part.shape[-1] > 1:  # pairwise in lane order
            part = part[..., 0::2] + part[..., 1::2]
        y[:, t] = part[..., 0]
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 70, 24, 16), (3, 40, 12, 8), (1, 45, 10, 5),
                                   (2, 33, 6, 12)])
def test_lane_arithmetic_replays_the_recurrence(shape, dtype):
    """The kernel's arithmetic, replayed in numpy, against the sequential
    plain version within the kernel's tolerance on the card (rtol 1e-4 and
    1e-5 of the output's scale: the exps are of dt a log2(e), the products
    fused, the sums in another order), and no farther from an fp64
    recurrence than 2 x the plain version or 1e-6 of the scale (the card's
    fp64 gate)."""
    ins = _scan_inputs(shape, dtype, 5)
    got = _lane_replay(*ins)
    want = selective_scan_ref(*ins).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    exact = _scan_fp64(*ins)
    limit = max(2 * np.abs(want - exact).max(), 1e-6 * np.abs(exact).max())
    assert np.abs(got - exact).max() <= limit


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _block_params(jcfg, bt, dtype, seed=6):
    jp = _jinit(JB.init_block, jcfg, bt, jax.random.PRNGKey(seed), DTYPES[dtype][0])
    return jax.tree.map(jnp.asarray, jp), convert.arch_params_from_jax(jp, "cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bt", HYBRID_TYPES)
def test_block_seq_matches_reference(bt, dtype):
    """S=64 over window 32: ``hybrid`` attends in the window, ``hybrid_g``
    globally, each beside its Mamba branch."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _block_params(jcfg, bt, dtype)
    jx, tx = _inputs((2, 64, jcfg.d_model), dtype, 7)
    pos = np.arange(64)
    want, _ = JB.block_seq(jcfg, bt, jp, jx, jnp.asarray(pos))
    got, aux = TB.block_seq(tcfg, bt, tp, tx, torch.as_tensor(pos))
    assert float(aux) == 0.0
    _close(got, want, dtype)


@pytest.mark.parametrize("bt", HYBRID_TYPES)
def test_block_decode_matches_reference(bt):
    """10 one-token steps from empty caches (an 8-slot ring for the
    windowed attention); both caches updated in place."""
    jcfg, tcfg = _cfgs()
    jp, tp = _block_params(jcfg, bt, "float32")
    jc = JB.init_block_cache(jcfg, bt, 2, 8, jnp.float32)
    tc = TB.init_block_cache(tcfg, bt, 2, 8, torch.float32)
    assert sorted(tc) == sorted(jc) == (["mamba"] if bt == "mamba" else ["kv", "mamba"])
    state = tc["mamba"].ssm
    for t in range(10):
        jx, tx = _inputs((2, 1, jcfg.d_model), "float32", 8, t)
        want, jc = JB.block_decode(jcfg, bt, jp, jx, jc, jnp.asarray(t, jnp.int32))
        got, tc = TB.block_decode(tcfg, bt, tp, tx, tc, t)
        assert tc["mamba"].ssm is state
        _close(got, want, err_msg=f"step {t}")
    _close(tc["mamba"].ssm, jc["mamba"].ssm)


# ---------------------------------------------------------------------------
# the smoke model end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = _cfgs(attn_impl="pallas_swa")
    jp = _jinit(JM.init_params, jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, convert.arch_params_from_jax(jp, "cpu")


def test_smoke_forward_pallas_swa_matches_reference(smoke):
    jcfg, tcfg, jp, tp = smoke
    tok = _rng(9).integers(0, jcfg.vocab, size=(2, 128)).astype(np.int32)
    want, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(tok)})
    before = (dict(tswa.LAUNCHES), dict(tscan.LAUNCHES))
    got = tsteps.make_prefill_step(tcfg)(tp, {"tokens": torch.as_tensor(tok, dtype=torch.int64)})
    assert (tswa.LAUNCHES, tscan.LAUNCHES) == before  # CPU: the plain versions
    assert tuple(got.shape) == (2, 128, jcfg.vocab)
    _close(got, want)


def test_smoke_prefill_reaches_the_swa_and_scan_wrappers(smoke, monkeypatch):
    """S=128 > window 32: the windowed ``hybrid`` layer calls the SWA wrapper
    once, the global ``hybrid_g`` layer takes the plain attention path, and
    both call the scan wrapper."""
    _, tcfg, _, tp = smoke
    swa, scan = [], []
    real_swa, real_scan = tswa.swa_attention, tscan.selective_scan
    monkeypatch.setattr(tswa, "swa_attention",
                        lambda *a, **kw: swa.append(kw["window"]) or real_swa(*a, **kw))
    monkeypatch.setattr(tscan, "selective_scan",
                        lambda *a: scan.append(a[0].shape) or real_scan(*a))
    TM.forward(tcfg, tp, {"tokens": torch.zeros((1, 128), dtype=torch.int64)})
    assert swa == [32] and scan == [(1, 128, 256)] * 2


@pytest.mark.parametrize("cache_len", [16, 64])
def test_smoke_decode_matches_reference(smoke, cache_len):
    """24 one-token steps of the smoke model; with cache_len 16 the
    windowed layer's ring buffer (16 slots, window 32) wraps."""
    jcfg, tcfg, jp, tp = smoke
    tok = _rng(10).integers(0, jcfg.vocab, size=(24, 3)).astype(np.int32)
    jc = JM.init_cache(jcfg, 3, cache_len)
    tc = TM.init_cache(tcfg, 3, cache_len, device="cpu")
    serve = tsteps.make_serve_step(tcfg)
    step = jax.jit(JM.decode_step, static_argnums=0)  # one compile, not 24 eager steps
    for t in range(24):
        want, jc = step(jcfg, jp, jc, jnp.asarray(tok[t]), jnp.asarray(t, jnp.int32))
        got, tc = serve(tp, tc, torch.as_tensor(tok[t], dtype=torch.int64), t)
        _close(got, want, err_msg=f"step {t}")


@pytest.fixture(scope="module")
def smoke_bf16():
    """The smoke model in bf16 (the reference's draw, carried across), 24
    tokens for 3 requests, and the reference's and the port's forward
    logits on them."""
    jcfg, tcfg = _cfgs(attn_impl="pallas_swa", dtype="bfloat16")
    jp = _jinit(JM.init_params, jcfg, jax.random.PRNGKey(0))
    tp = convert.arch_params_from_jax(jp, "cpu")
    tok = _rng(10).integers(0, jcfg.vocab, size=(3, 24)).astype(np.int32)
    jfwd = _f32(JM.forward(jcfg, jp, {"tokens": jnp.asarray(tok)})[0])
    fed = torch.as_tensor(tok, dtype=torch.int64)
    tfwd = tsteps.make_prefill_step(tcfg)(tp, {"tokens": fed})
    return jcfg, tcfg, jp, tp, tok, jfwd, tfwd


def _rel_l2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Each request's relative L2 distance over its (positions, vocab)."""
    return np.linalg.norm((a - b).reshape(len(b), -1), axis=1) / \
        np.linalg.norm(b.reshape(len(b), -1), axis=1)


def _port_decode(tcfg, tp, fed: torch.Tensor, cache_len: int = 64) -> torch.Tensor:
    serve = tsteps.make_serve_step(tcfg)
    cache = TM.init_cache(tcfg, fed.shape[0], cache_len, device="cpu")
    return torch.stack([serve(tp, cache, fed[:, t], t)[0] for t in range(fed.shape[1])], 1)


def test_smoke_bf16_decode_matches_reference(smoke_bf16):
    """bf16: the port's 24 ``decode_step``s against the reference's.  The
    two decodes differ by the rounding that already separates the two
    forwards (XLA's and torch's bf16 products: relative L2 0.0115-0.0126
    a request, measured), and by no more: each request's decode distance
    within 1.1 x its forward distance and 2e-2.  Each package's own bf16
    decode against its own bf16 forward: the reference's 0, 0, 0.0006,
    the port's 0, 0, 0.0043 (one bf16 value of request 2 rounds the other
    way at step 12 and stays in the caches), held within 1e-2."""
    jcfg, tcfg, jp, tp, tok, jfwd, tfwd = smoke_bf16
    jc = JM.init_cache(jcfg, 3, 64)
    step = jax.jit(JM.decode_step, static_argnums=0)
    jdec = []
    for t in range(tok.shape[1]):
        lg, jc = step(jcfg, jp, jc, jnp.asarray(tok[:, t]), jnp.asarray(t, jnp.int32))
        jdec.append(_f32(lg))
    jdec = np.stack(jdec, 1)
    tdec = _t32(_port_decode(tcfg, tp, torch.as_tensor(tok, dtype=torch.int64)))
    fwd_gap, dec_gap = _rel_l2(_t32(tfwd), jfwd), _rel_l2(tdec, jdec)
    assert np.all(dec_gap <= np.minimum(1.1 * fwd_gap, 2e-2)), (dec_gap, fwd_gap)
    assert np.all(_rel_l2(jdec, jfwd) <= 1e-2) and np.all(_rel_l2(tdec, _t32(tfwd)) <= 1e-2)


def _chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports numpy only)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("planted", [None, 2.0 ** -5])
def test_chip_decode_gate_on_the_smoke_model(smoke_bf16, monkeypatch, planted):
    """``chip_smoke.py``'s decode check of a bf16 model (``_decode_fp32_twin``:
    the fp32 twin's decode within 5e-2 of its forward, and the bf16
    decode's distance from the fp32 forward within DECODE_VS_FORWARD x the
    bf16 forward's) passes on the smoke model and fails on a planted
    bf16-only fault: the Mamba branch's decode output scaled by 1 + 2^-5
    where the model runs in bf16 (the ratio reads 1.014 without it and
    1.59-1.84 with it, measured)."""
    smoke_mod = _chip_smoke()
    _, tcfg, _, tp, tok, _, tfwd = smoke_bf16
    if planted is not None:
        real = TS.mamba_decode

        def faulty(cfg, p, x_t, cache):
            out, cache = real(cfg, p, x_t, cache)
            return (out * (1 + planted) if out.dtype == torch.bfloat16 else out), cache

        monkeypatch.setattr(TS, "mamba_decode", faulty)
    fed = torch.as_tensor(tok, dtype=torch.int64)
    dec = _port_decode(tcfg, tp, fed).float()
    args = (torch, "cpu", tcfg, tp, fed, 64, dec, tfwd.float())
    if planted is None:
        smoke_mod._decode_fp32_twin(*args)
    else:
        with pytest.raises(smoke_mod.SmokeFailure, match="DECODE_VS_FORWARD|x the bf16"):
            smoke_mod._decode_fp32_twin(*args)


def test_decode_updates_the_stacked_caches_in_place(smoke):
    """``init_cache`` stacks the KV and Mamba caches per stage; each decode
    step writes into those stacked tensors through the layers' views."""
    _, tcfg, _, tp = smoke
    caches = TM.init_cache(tcfg, 2, 64, device="cpu")
    assert [sorted(s) for s in caches] == [["0_hybrid_g"], ["0_hybrid"]]
    assert [sorted(s[name]) for s, name in zip(caches, ("0_hybrid_g", "0_hybrid"))] == \
        [["kv", "mamba"]] * 2
    ssm = caches[1]["0_hybrid"]["mamba"].ssm
    assert tuple(ssm.shape) == (1, 2, 2 * tcfg.d_model, tcfg.ssm_state)
    tok = torch.as_tensor(_rng(12).integers(0, tcfg.vocab, size=(2, 40)))
    full, _ = TM.forward(tcfg, tp, {"tokens": tok})
    for t in range(40):
        logits, out = TM.decode_step(tcfg, tp, caches, tok[:, t], t)
        assert out is caches and out[1]["0_hybrid"]["mamba"].ssm is ssm
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), atol=TOL, rtol=TOL)
    assert bool((ssm != 0).any())
