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
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    w = torch.zeros((4, 10), device=cuda)
    with pytest.raises(TypeError):
        ttrig.trigger_sq(w.double(), w.double())
    with pytest.raises(ValueError):
        tmix.mix(torch.eye(4, device=cuda), torch.zeros((10, 4), device=cuda).t())
