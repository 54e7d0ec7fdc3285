"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips where torch finds none; the
file imports nothing of jax, so it runs on a GPU machine as

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mixing import ops as tmix  # noqa: E402
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
@pytest.mark.parametrize("m,n", [(1, 7), (33, 130), (130, 1000), (1024, 50890)])
def test_mix_kernel_matches_plain(cuda, m, n):
    g = torch.Generator(device=cuda).manual_seed(m + n)
    p = torch.softmax(torch.randn((m, m), generator=g, device=cuda), -1)
    w = torch.randn((m, n), generator=g, device=cuda)
    torch.testing.assert_close(tmix.mix(p, w), mix_ref(p, w), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(1, 7), (33, 130), (300, 1025)])
def test_mix_sparse_kernel_bit_equal_to_plain(cuda, m, n):
    idx, p_diag, p_off = _ell(np.random.default_rng([m, n]), m, d_max=6)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=cuda)
    p_diag = torch.as_tensor(p_diag, device=cuda)
    p_off = torch.as_tensor(p_off, device=cuda)
    w = torch.randn((m, n), device=cuda)
    assert torch.equal(tmix.mix_sparse(idx, p_diag, p_off, w),
                       mix_sparse_ref(idx, p_diag, p_off, w))


@pytest.mark.gpu
# (atol, rtol, relative L2): fp32 (SIMT kernel) sums the same fp32 products
# in another order; bf16 (tensor-core kernel) also rounds P to bf16 before
# P V, and both sides round the output once to bf16, so they differ by
# about one bf16 step
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
    route = "swa_attention_tc" if dtype == torch.bfloat16 else "swa_attention"
    other = "swa_attention" if dtype == torch.bfloat16 else "swa_attention_tc"
    before = dict(tswa.LAUNCHES)
    got = tswa.swa_attention(q, k, v, window=win)
    assert tswa.LAUNCHES[route] == before[route] + 1
    assert tswa.LAUNCHES[other] == before[other]
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
