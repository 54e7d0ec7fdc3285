"""The port's sliding-window attention against the JAX package's.

On the CPU ``repro_torch.kernels.swa.ops.swa_attention`` runs its plain
version (``ref.py``); it is held against the Pallas kernel in interpret
mode and against the reference's dense oracle ``swa_ref`` over the shapes
of ``tests/test_kernels.py``, at fp32 atol=rtol 2e-5 and bf16 3e-2 (the
reference's own tolerances).  The bf16 tensor-core kernel's rounding (P
to bf16 before P V) is emulated by ``ref.swa_ref_bf16_p`` and the fp32
kernel's split TF32 by ``ref.swa_ref_3xtf32``; each is held to the card's
limit for its dtype here, before any card run.  ``test_torch_cuda_kernels.py``
holds the CUDA kernels against the plain version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.swa.ops import swa_attention as j_swa  # noqa: E402
from repro.kernels.swa.ref import swa_ref as j_swa_ref  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels.swa import ops as tswa  # noqa: E402
from repro_torch.kernels.swa.ref import swa_ref as t_swa_ref  # noqa: E402
from repro_torch.kernels.swa.ref import swa_ref_3xtf32, swa_ref_bf16_p  # noqa: E402
from repro_torch.kernels.mixing.ref import tf32_rna  # noqa: E402

SHAPES = [
    # (B, S, H, G, dh, window, bq, bk), as tests/test_kernels.py
    (1, 256, 4, 2, 64, 64, 64, 32),
    (2, 128, 2, 2, 32, 128, 32, 32),
    (1, 512, 4, 1, 64, 128, 128, 64),
    (1, 128, 8, 4, 128, 32, 32, 32),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _qkv(shape, jdt):
    b, s, h, g, dh = shape[:5]
    rng = np.random.default_rng(list(shape))
    return [jnp.asarray(rng.normal(size=(b, s, n, dh)).astype(np.float32)).astype(jdt)
            for n in (h, g, g)]


def _np32(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_swa_matches_pallas_and_oracle(shape, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    win, bq, bk = shape[5:]
    q, k, v = _qkv(shape, jdt)
    pallas = j_swa(q, k, v, window=win, block_q=bq, block_k=bk, interpret=True)
    oracle = j_swa_ref(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                       v.transpose(0, 2, 1, 3), window=win).transpose(0, 2, 1, 3)
    tq, tk, tv = (tensor_from_numpy(x) for x in (q, k, v))
    got = tswa.swa_attention(tq, tk, tv, window=win)
    assert got.dtype == tdt and tuple(got.shape) == tuple(q.shape)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np32(got), _np32(want), atol=tol, rtol=tol)
    # the plain version alone, in the (B, H, S, dh) layout of ref.py
    direct = t_swa_ref(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
                       window=win).transpose(1, 2)
    assert torch.equal(direct, got)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_p_rounding_fits_the_card_limit(shape):
    """The tensor-core kernel's one numerical change, P rounded to bf16 before
    P V with l summed from the fp32 P, emulated densely on bf16 inputs, lies
    within the limit the card holds the kernel to (atol 5e-3, rtol 1e-2,
    relative L2 1e-2) of the Pallas kernel in interpret mode and of the JAX
    oracle."""
    win, bq, bk = shape[5:]
    q, k, v = _qkv(shape, jnp.bfloat16)
    pallas = j_swa(q, k, v, window=win, block_q=bq, block_k=bk, interpret=True)
    oracle = j_swa_ref(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                       v.transpose(0, 2, 1, 3), window=win).transpose(0, 2, 1, 3)
    tq, tk, tv = (tensor_from_numpy(x).transpose(1, 2) for x in (q, k, v))
    got = swa_ref_bf16_p(tq, tk, tv, window=win).transpose(1, 2)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(q.shape)
    got = _np32(got)
    for want in (_np32(pallas), _np32(oracle)):
        np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-2)
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)
    # the rounding is visible: P in bf16 is not the fp32 plain version
    plain = _np32(t_swa_ref(tq, tk, tv, window=win))
    assert not np.array_equal(got, plain.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_3xtf32_split_fits_the_card_limit(shape):
    """The fp32 kernel's split TF32 (k-step sums of lo*hi + hi*lo + hi*hi for
    Q K^T and for P V, V^T's keys permuted within each 8-key step), emulated
    densely, lies within the card's fp32 limit (atol=rtol 2e-5) of the
    Pallas kernel in interpret mode and of the JAX oracle; plain TF32 (hi*hi
    alone) lies farther from the oracle than the split."""
    b, s, h, g, dh = shape[:5]
    win, bq, bk = shape[5:]
    q, k, v = _qkv(shape, jnp.float32)
    pallas = j_swa(q, k, v, window=win, block_q=bq, block_k=bk, interpret=True)
    oracle = j_swa_ref(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                       v.transpose(0, 2, 1, 3), window=win).transpose(0, 2, 1, 3)
    tq, tk, tv = (tensor_from_numpy(x).transpose(1, 2) for x in (q, k, v))
    got = swa_ref_3xtf32(tq, tk, tv, window=win).transpose(1, 2)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(q.shape)
    got = _np32(got)
    for want in (_np32(pallas), _np32(oracle)):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    one_pass = _np32(t_swa_ref(*(tf32_rna(x) for x in (tq, tk, tv)),
                               window=win)).transpose(0, 2, 1, 3)
    err = np.abs(got - _np32(oracle)).max()
    assert err < np.abs(one_pass - _np32(oracle)).max()


@pytest.mark.parametrize("where", ["q_nan", "q_inf", "k_inf", "v_inf"])
def test_3xtf32_split_nonfinite_where_plain_is(where):
    """A split of +-inf is (inf, NaN), so the split leaves NaN in every output
    a non-finite value takes part in; the kernel's epilogue (emulated by
    swa_ref_3xtf32) recomputes those in fp32, so an output is finite exactly
    where the plain version's is: an inf key whose score is -inf drops out,
    one whose score is +inf makes its rows NaN.  V's inf sits at key 0 with
    S <= window, where every row attends to it (the plain version's dense
    P V multiplies every masked key's V by 0 too)."""
    b, s, h, g, dh, win = 1, 64, 4, 2, 32, 64
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rng.normal(size=(b, n, s, dh)).astype(np.float32))
               for n in (h, g, g))
    if where == "q_nan":
        q[0, 1, 20, 3] = float("nan")
    elif where == "q_inf":
        q[0, 2, 40, 7] = float("inf")
    elif where == "k_inf":
        k[0, 1, 10, 5] = float("inf")
    else:
        v[0, 0, 0, 9] = float("-inf")
    got = swa_ref_3xtf32(q, k, v, window=win)
    plain = t_swa_ref(q, k, v, window=win)
    assert torch.equal(torch.isfinite(got), torch.isfinite(plain))
    assert not bool(torch.isfinite(plain).all())
    fin = torch.isfinite(plain)
    torch.testing.assert_close(got[fin], plain[fin], atol=2e-5, rtol=2e-5)
    if where == "k_inf":  # some rows drop the key, others turn NaN
        rows = torch.isfinite(plain[0, 2:4, 10:]).all(-1)
        assert bool(rows.any()) and not bool(rows.all())


def test_plain_swa_never_attends_outside_window():
    b, s, h, g, dh, win = 1, 128, 2, 2, 32, 32
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.normal(size=(b, s, n, dh)).astype(np.float32))
               for n in (h, g, g))
    v2 = v.clone()
    v2[:, 0] += 100.0  # perturb token 0's value
    y1 = tswa.swa_attention(q, k, v, window=win)
    y2 = tswa.swa_attention(q, k, v2, window=win)
    np.testing.assert_allclose(y1[:, win:].numpy(), y2[:, win:].numpy(), atol=1e-5)
    assert (y1[:, 0] - y2[:, 0]).abs().max() > 1.0


def test_plain_swa_counts_no_launch_and_rejects_bad_shapes():
    q = torch.zeros((1, 8, 4, 32))
    kv = torch.zeros((1, 8, 3, 32))
    before = dict(tswa.LAUNCHES)
    assert set(before) == {"swa_attention_tc", "swa_attention_tf32"}
    with pytest.raises(ValueError):
        tswa.swa_attention(q, kv, kv, window=4)  # H % G != 0
    with pytest.raises(ValueError):
        tswa.swa_attention(q, q, q, window=4, causal=False)
    tswa.swa_attention(q, q, q, window=4)
    # bf16 on the CPU runs the plain version too: no kernel launches
    qb = q.bfloat16()
    assert tswa.swa_attention(qb, qb, qb, window=4).dtype == torch.bfloat16
    assert tswa.LAUNCHES == before
