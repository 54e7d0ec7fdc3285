"""repro_torch's MLA attention, the MTP head and deepseek-v3-671b's smoke
configuration against the JAX package's, on the CPU.

``init_mla``'s bits and the whole smoke tree's, the ``mtp`` subtree
included, from one key; ``mla_seq`` in its naive form (fp32 and bf16, with
a prefix mask) and chunked (S=5120 over ``attn_chunk`` 1024, taken when
S > 4096), and the port's chunked form against its naive one on the same
inputs; ``mla_decode`` step by step with the absorbed ``wk_b`` / ``wv_b``,
past the cache's end (the reference's clamp to the last slot), and its
logits against the naive forward's; then ``forward``, ``loss_fn`` with
its aux and MTP terms and every gradient, and ``decode_step``, through
the dense oracle and through the scatter.  The reference runs inside
``jax.threefry_partitionable(False)``.

Tolerances: fp32 rtol 2e-4 / atol 2e-5 (the golden ones); bf16 rtol 2^-7
(one bf16 ulp) with an absolute floor of 2^-7 of the output's scale for
products summed in another order.  The chunked against the naive form,
and the absorbed decode against the naive forward, are different
arithmetic: rtol 1e-4 / atol 1e-5 in fp32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# many small ops: one thread keeps the file's time low under pytest -n 6
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
BF16_RTOL = 2.0 ** -7
ARCH = "deepseek-v3-671b"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(**kw):
    return (dataclasses.replace(jconfigs.smoke_config(ARCH), **kw),
            dataclasses.replace(tconfigs.smoke_config(ARCH), **kw))


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t32(t) -> np.ndarray:
    return t.detach().float().numpy()


def _close(got, want, dtype="float32", rtol=RTOL, atol=ATOL):
    want = _f32(want)
    if dtype == "bfloat16":
        rtol, atol = BF16_RTOL, BF16_RTOL * float(np.abs(want).max())
    np.testing.assert_allclose(_t32(got), want, rtol=rtol, atol=atol)


def _jinit(fn, *args):
    with jax.threefry_partitionable(False):
        return jax.device_get(fn(*args))


def _mla(jcfg, seed: int, dtype: str = "float32"):
    """``init_mla``'s weights from the reference, with norm scales other
    than 1 (numpy leaves)."""
    p = _jinit(JA.init_mla, jcfg, jax.random.PRNGKey(seed), DTYPES[dtype][0])
    rng = np.random.default_rng(seed)
    for name in ("q_norm", "kv_norm"):
        p[name] = np.asarray(jnp.asarray(rng.normal(1.0, 0.2, size=p[name].shape),
                                         DTYPES[dtype][0]))
    return p


def _x(jcfg, b: int, s: int, seed: int, dtype: str = "float32"):
    x = np.random.default_rng(seed).normal(size=(b, s, jcfg.d_model))
    jx = jnp.asarray(x, DTYPES[dtype][0])
    return jx, convert.arch_params_from_jax(jax.device_get(jx), "cpu")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_init_mla_bits_match_reference(dtype):
    jcfg, tcfg = _cfgs()
    want = _jinit(JA.init_mla, jcfg, jax.random.PRNGKey(2), DTYPES[dtype][0])
    got = TA.init_mla(tcfg, prng.PRNGKey(2), DTYPES[dtype][1], "cpu")
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        assert got[name].dtype == DTYPES[dtype][1], name
        np.testing.assert_array_equal(_t32(got[name]), _f32(a), err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_params_bits_match_reference(dtype):
    """The whole smoke tree from one key, the MTP head's ``split(k_mtp)``
    into its projection and its ``attn`` block included."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    want = _jinit(JM.init_params, jcfg, jax.random.PRNGKey(5))
    got = TM.init_params(tcfg, prng.PRNGKey(5), "cpu")
    assert sorted(got["mtp"]) == ["block", "norm_e", "norm_h", "proj"]
    assert tuple(got["mtp"]["proj"].shape) == (2 * tcfg.d_model, tcfg.d_model)
    jl = jax.tree_util.tree_leaves_with_path(want)
    for (path, a), t in zip(jl, tree_leaves(got), strict=True):
        name = jax.tree_util.keystr(path)
        assert str(t.dtype).split(".")[-1] == str(a.dtype), name
        np.testing.assert_array_equal(_t32(t), _f32(a), err_msg=name)


# ---------------------------------------------------------------------------
# mla_seq
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix", [None, 5])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_seq_matches_reference(dtype, prefix):
    jcfg, tcfg = _cfgs()
    p = _mla(jcfg, 3, dtype)
    jx, tx = _x(jcfg, 2, 24, 3, dtype)
    pos = np.arange(24)
    want = JA.mla_seq(jcfg, jax.tree.map(jnp.asarray, p), jx, jnp.asarray(pos),
                      prefix_len=None if prefix is None else jnp.asarray(prefix))
    got = TA.mla_seq(tcfg, convert.arch_params_from_jax(p, "cpu"), tx,
                     torch.as_tensor(pos), prefix_len=prefix)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, dtype)


@pytest.fixture(scope="module")
def long_seq():
    """S=5120 > 4096 with attn_chunk 1024: the chunked form, five chunks."""
    jcfg, tcfg = _cfgs(attn_chunk=1024)
    p = _mla(jcfg, 4)
    jx, tx = _x(jcfg, 1, 5120, 4)
    return jcfg, tcfg, p, jx, tx


def test_mla_chunked_matches_reference(long_seq):
    jcfg, tcfg, p, jx, tx = long_seq
    pos = np.arange(5120)
    want = JA.mla_seq(jcfg, jax.tree.map(jnp.asarray, p), jx, jnp.asarray(pos))
    got = TA.mla_seq(tcfg, convert.arch_params_from_jax(p, "cpu"), tx, torch.as_tensor(pos))
    _close(got, want)


def test_mla_chunked_equals_naive(long_seq, monkeypatch):
    """The port's online softmax over chunks against its one-pass softmax
    on the same inputs (attn_chunk 1000 does not divide 5120: naive)."""
    _, tcfg, p, _, tx = long_seq
    tp, pos = convert.arch_params_from_jax(p, "cpu"), torch.arange(5120)
    calls = []
    real = TA._mla_chunked
    monkeypatch.setattr(TA, "_mla_chunked", lambda *a: calls.append(1) or real(*a))
    chunked = TA.mla_seq(tcfg, tp, tx, pos)
    naive = TA.mla_seq(dataclasses.replace(tcfg, attn_chunk=1000), tp, tx, pos)
    assert calls == [1]
    np.testing.assert_allclose(chunked.numpy(), naive.numpy(), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# mla_decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_len", [8, 32])
def test_mla_decode_matches_reference(cache_len):
    """14 one-token steps; with 8 slots the steps from t=8 on write the last
    slot again (the reference's clamp) and attend every stored position."""
    jcfg, tcfg = _cfgs()
    p = _mla(jcfg, 6)
    jp, tp = jax.tree.map(jnp.asarray, p), convert.arch_params_from_jax(p, "cpu")
    jc = JA.init_mla_cache(jcfg, 2, cache_len, jnp.float32)
    tc = TA.init_mla_cache(tcfg, 2, cache_len, torch.float32)
    xs = np.random.default_rng(6).normal(size=(14, 2, 1, jcfg.d_model)).astype(np.float32)
    for t in range(14):
        want, jc = JA.mla_decode(jcfg, jp, jnp.asarray(xs[t]), jc, jnp.asarray(t, jnp.int32))
        got, tc = TA.mla_decode(tcfg, tp, torch.as_tensor(xs[t]), tc, t)
        _close(got, want)
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
        _close(tc.c_kv, jc.c_kv)
        _close(tc.k_rope, jc.k_rope)
    assert int(tc.pos[-1]) == (13 if cache_len == 8 else -1)


def test_absorbed_decode_replays_the_naive_forward():
    """The absorbed decode's outputs over 20 tokens against ``mla_seq``'s on
    the same tokens (the decompressed K / V)."""
    jcfg, tcfg = _cfgs()
    tp = convert.arch_params_from_jax(_mla(jcfg, 7), "cpu")
    _, tx = _x(jcfg, 2, 20, 7)
    full = TA.mla_seq(tcfg, tp, tx, torch.arange(20))
    cache = TA.init_mla_cache(tcfg, 2, 32, torch.float32)
    for t in range(20):
        y, cache = TA.mla_decode(tcfg, tp, tx[:, t:t + 1], cache, t)
        np.testing.assert_allclose(y[:, 0].numpy(), full[:, t].numpy(), rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the smoke model end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg, _ = _cfgs()
    return _jinit(JM.init_params, jcfg, jax.random.PRNGKey(0))


def _impl(impl: str):
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(c.moe, impl=impl))
                 for c in _cfgs(attn_chunk=16))


@pytest.mark.parametrize("impl", ["dense", "scatter"])
def test_forward_matches_reference(smoke, impl):
    jcfg, tcfg = _impl(impl)
    tok = np.random.default_rng(8).integers(0, jcfg.vocab, size=(2, 40)).astype(np.int32)
    want, jaux = JM.forward(jcfg, jax.tree.map(jnp.asarray, smoke), {"tokens": jnp.asarray(tok)})
    tp, tb = convert.arch_params_from_jax(smoke, "cpu"), {"tokens": torch.as_tensor(tok)}
    got = tsteps.make_prefill_step(tcfg)(tp, tb)
    _, taux = TM.forward(tcfg, tp, tb)
    _close(got, want)
    _close(taux, jaux)


@pytest.mark.parametrize("impl", ["dense", "scatter"])
def test_loss_and_grads_match_reference(smoke, impl):
    """``loss_fn`` = ce + router_aux_weight aux + mtp_weight mtp, each term
    and every leaf's gradient (the MTP head's included)."""
    jcfg, tcfg = _impl(impl)
    rng = np.random.default_rng(9)
    tok = rng.integers(0, jcfg.vocab, size=(2, 24)).astype(np.int32)
    tgt = rng.integers(0, jcfg.vocab, size=(2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) < 0.8).astype(np.float32)
    jb = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt), "loss_mask": jnp.asarray(mask)}
    (jloss, jmet), jgrad = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, jb),
                                              has_aux=True)(jax.tree.map(jnp.asarray, smoke))
    tp = convert.arch_params_from_jax(smoke, "cpu")
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tloss, tmet = TM.loss_fn(tcfg, tp, {"tokens": torch.as_tensor(tok, dtype=torch.int64),
                                        "targets": torch.as_tensor(tgt, dtype=torch.int64),
                                        "loss_mask": torch.as_tensor(mask)})
    grads = torch.autograd.grad(tloss, leaves)
    assert sorted(tmet) == sorted(jmet) == ["aux", "ce", "loss", "mtp"]
    for name in jmet:
        _close(tmet[name], jmet[name])
    terms = {name: float(x.detach()) for name, x in tmet.items()}
    want = (terms["ce"] + jcfg.moe.router_aux_weight * terms["aux"]
            + jcfg.mtp_weight * terms["mtp"])
    assert terms["loss"] == pytest.approx(want, rel=1e-6)
    mtp_grads = 0
    for (path, a), g in zip(jax.tree_util.tree_leaves_with_path(jgrad), grads, strict=True):
        np.testing.assert_allclose(_t32(g), _f32(a), rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))
        mtp_grads += "'mtp'" in jax.tree_util.keystr(path) and bool(g.abs().max() > 0)
    assert mtp_grads >= 4  # the MTP loss reaches its head


@pytest.mark.parametrize("impl", ["dense", "scatter"])
def test_decode_matches_reference(smoke, impl):
    """12 one-token steps at B=3, past a 10-slot cache's end."""
    jcfg, tcfg = _impl(impl)
    tp = convert.arch_params_from_jax(smoke, "cpu")
    tok = np.random.default_rng(10).integers(0, jcfg.vocab, size=(12, 3)).astype(np.int32)
    jc = JM.init_cache(jcfg, 3, 10)
    tc = TM.init_cache(tcfg, 3, 10, device="cpu")
    serve = tsteps.make_serve_step(tcfg)
    for t in range(12):
        want, jc = JM.decode_step(jcfg, jax.tree.map(jnp.asarray, smoke), jc,
                                  jnp.asarray(tok[t]), jnp.asarray(t, jnp.int32))
        got, tc = serve(tp, tc, torch.as_tensor(tok[t], dtype=torch.int64), t)
        _close(got, want)
