"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held
against ``repro.kernels.*.ops`` in interpret mode at fp32 rtol 1e-5 /
atol 1e-6, over ragged widths (D not a multiple of 128), m in {1, 8, 33}
and ELL rows with padded slots.  ``test_torch_cuda_kernels.py`` holds
each CUDA kernel against its plain version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import topology as jtopo  # noqa: E402
from repro.kernels.mixing import ops as jmix  # noqa: E402
from repro.kernels.trigger import ops as jtrig  # noqa: E402
from repro_torch.core import mixing as tmixing  # noqa: E402
from repro_torch.core import triggers as ttriggers  # noqa: E402
from repro_torch.kernels.mixing import ops as tmix  # noqa: E402
from repro_torch.kernels.trigger import ops as ttrig  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
MS = (1, 8, 33)
DS = (130, 1000)


def _rng(*seed):
    return np.random.default_rng(list(seed))


def _stochastic(rng, m):
    p = rng.uniform(size=(m, m)).astype(np.float32)
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


def _ell(rng, m, d_max):
    """A random ELL table with padded slots: pads self-index, zero weight."""
    idx = np.tile(np.arange(m, dtype=np.int32)[:, None], (1, d_max))
    mask = np.zeros((m, d_max), bool)
    for i in range(m):
        deg = int(rng.integers(0, d_max + 1))
        nb = rng.choice(m, size=min(deg, m), replace=False)
        idx[i, :nb.size] = np.sort(nb)
        mask[i, :nb.size] = True
    p_off = np.where(mask, rng.uniform(0, 0.2, (m, d_max)), 0).astype(np.float32)
    p_diag = (1.0 - p_off.sum(1)).astype(np.float32)
    return idx, mask, p_diag, p_off


@pytest.mark.parametrize("n", DS)
@pytest.mark.parametrize("m", MS)
def test_trigger_sq_plain_matches_pallas(m, n):
    rng = _rng(m, n)
    w = rng.normal(size=(m, n)).astype(np.float32)
    h = (w + 0.1 * rng.normal(size=(m, n))).astype(np.float32)
    want = np.asarray(jtrig.trigger_sq(jnp.asarray(w), jnp.asarray(h),
                                       interpret=True))
    got = ttrig.trigger_sq(torch.as_tensor(w), torch.as_tensor(h))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_trigger_events_strict_like_pallas():
    """The kernel's deviation through the port's EF-HC policy fires where
    the Pallas ``events`` fires: strictly above the threshold."""
    rng = _rng(7)
    m, n = 8, 300
    w = rng.normal(size=(m, n)).astype(np.float32)
    h = w.copy()
    h[::2] += 0.01  # half the rows deviate; the rest sit exactly at zero
    bw = np.linspace(500.0, 2000.0, m).astype(np.float32)
    want = np.asarray(jtrig.events(jnp.asarray(w), jnp.asarray(h), n_model=n,
                                   r=0.0, rho=1.0 / jnp.asarray(bw),
                                   gamma_k=jnp.asarray(0.01), interpret=True))
    dev = torch.sqrt(ttrig.trigger_sq(torch.as_tensor(w), torch.as_tensor(h)) / n)
    got = ttriggers.broadcast_events(
        ttriggers.TriggerConfig(policy="efhc", r=0.0), dev=dev,
        bandwidths=torch.as_tensor(bw), gamma_k=torch.tensor(0.01), key=None)
    assert np.array_equal(got.numpy(), want)
    assert not want[1::2].any()  # dev == threshold == 0 never fires


@pytest.mark.parametrize("n", DS)
@pytest.mark.parametrize("m", MS)
def test_mix_plain_matches_pallas(m, n):
    rng = _rng(m, n, 1)
    p = _stochastic(rng, m)
    w = rng.normal(size=(m, n)).astype(np.float32)
    want = np.asarray(jmix.mix(jnp.asarray(p), jnp.asarray(w), interpret=True))
    got = tmix.mix(torch.as_tensor(p), torch.as_tensor(w))
    assert tuple(got.shape) == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", DS)
@pytest.mark.parametrize("m", MS)
def test_mix_sparse_plain_matches_pallas(m, n):
    rng = _rng(m, n, 2)
    idx, mask, p_diag, p_off = _ell(rng, m, d_max=5)
    w = rng.normal(size=(m, n)).astype(np.float32)
    want = np.asarray(jmix.mix_sparse(jnp.asarray(idx), jnp.asarray(p_diag),
                                      jnp.asarray(p_off), jnp.asarray(w),
                                      interpret=True))
    got = tmix.mix_sparse(torch.as_tensor(idx, dtype=torch.int64),
                          torch.as_tensor(p_diag), torch.as_tensor(p_off),
                          torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_mix_sparse_on_real_fabric_matches_dense_mix():
    """ELL P of a real rgg fabric, scattered dense: both wrappers agree."""
    g = jtopo.make_process(40, "rgg", radius=0.3, seed=2)
    nl = g.neighbors()
    idx = torch.as_tensor(nl.idx, dtype=torch.int64)
    adj_ell = torch.as_tensor(nl.mask)
    v = torch.arange(40) % 3 == 0  # every third device broadcasts
    comm_ell = adj_ell & (v[:, None] | v[idx])
    p_diag, p_off = tmixing.build_p_ell(idx, adj_ell, comm_ell)
    tmixing.assert_doubly_stochastic_ell(idx, p_diag, p_off)
    p = torch.zeros((40, 40))
    p[torch.arange(40)[:, None].expand_as(idx), idx] = p_off
    p += torch.diag(p_diag)
    tmixing.assert_doubly_stochastic(p)
    w = torch.as_tensor(_rng(3).normal(size=(40, 257)).astype(np.float32))
    np.testing.assert_allclose(tmix.mix_sparse(idx, p_diag, p_off, w).numpy(),
                               tmix.mix(p, w).numpy(), rtol=RTOL, atol=ATOL)


def test_wrappers_reject_bad_shapes_and_mixed_devices():
    w = torch.zeros((4, 10))
    with pytest.raises(ValueError):
        ttrig.trigger_sq(w, torch.zeros((4, 11)))
    with pytest.raises(ValueError):
        tmix.mix(torch.zeros((3, 3)), w)
    with pytest.raises(ValueError):
        tmix.mix_sparse(torch.zeros((4, 2), dtype=torch.int64),
                        torch.zeros(4), torch.zeros((4, 3)), w)
    with pytest.raises(ValueError):
        ttrig.trigger_sq(w, torch.zeros((4, 10), device="meta"))


def test_cpu_path_counts_no_launch():
    before = dict(ttrig.LAUNCHES), dict(tmix.LAUNCHES)
    ttrig.trigger_sq(torch.zeros((2, 5)), torch.ones((2, 5)))
    tmix.mix(torch.eye(2), torch.ones((2, 5)))
    assert (dict(ttrig.LAUNCHES), dict(tmix.LAUNCHES)) == before
