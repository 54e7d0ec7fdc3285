"""The trigger kernel's slab plan (``kernels/trigger/ops.py::slab_plan``).

The kernel (``csrc/trigger_sq.cu``) cuts each (m, D) row into column
slabs: slab k > 0 starts at head + k cols, head being the row's elements
before its first 16-byte boundary; slab 0 takes the head, the last slab
runs to D.  ``_edges`` restates those edges; the plan must cover every
column once, start every slab but the first on a 16-byte line for the row
offsets a contiguous array gives, stay within CUDA's grid, and keep one
slab where the rows alone fill the card.  The slab sums in the kernel's
order are held against the JAX package's Pallas kernel in interpret mode
at a few-row, long shape.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.trigger import ops as jtrig  # noqa: E402
from repro_torch.kernels.trigger import ops as ttrig  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
H100_SMS = 132
GRID_X_MAX = 2 ** 31 - 1

# the paths' shapes: router rows, few long rows, misaligned rows, the
# cells' rows, m past 65535, the paper / cnn / fleet rows (fp32); the
# train cells' largest bf16 leaves
SHAPES = [(4, 1572864, 4), (1, 1 << 20, 4), (3, 4099, 4), (5, 50890, 4),
          (8192, 50890, 4), (70000, 8, 4), (1024, 50890, 4), (1024, 26698, 4),
          (4096, 7850, 4), (1, 7, 4), (33, 130, 4), (4, 301989888, 2),
          (4, 805306368, 2)]


def _edges(n, cols, n_slab, head):
    """[(c0, c1)] of each slab of a row whose first 16-byte boundary is
    ``head`` elements in, as the kernel computes them."""
    head = min(head, n)
    return [(0 if k == 0 else min(head + k * cols, n),
             n if k == n_slab - 1 else min(head + (k + 1) * cols, n))
            for k in range(n_slab)]


def _row_offsets(m, n, itemsize):
    """The distinct byte offsets from a 16-byte line at which the rows of a
    contiguous (m, n) array on a 16-byte aligned base start."""
    return sorted({(r * n * itemsize) % 16 for r in range(min(m, 16))})


@pytest.mark.parametrize("sms", [H100_SMS, 114])
@pytest.mark.parametrize("m,n,itemsize", SHAPES)
def test_slab_plan_covers_each_column_once_on_aligned_slabs(m, n, itemsize, sms):
    cols, n_slab = ttrig.slab_plan(m, n, itemsize, sms)
    assert cols % (16 // itemsize) == 0 and n_slab >= 1
    assert m * n_slab <= GRID_X_MAX  # blocks on gridDim.x
    if n_slab > 1:
        assert ttrig.MIN_SLAB_BYTES <= cols * itemsize <= ttrig.MAX_SLAB_BYTES
    for off in _row_offsets(m, n, itemsize):
        head = ((16 - off) % 16) // itemsize
        edges = _edges(n, cols, n_slab, head)
        assert edges[0][0] == 0 and edges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))  # no gap, no overlap
        assert all(c0 < c1 for c0, c1 in edges)  # no empty slab
        assert all((off + c0 * itemsize) % 16 == 0 for c0, _ in edges[1:])


@pytest.mark.parametrize("m,n,itemsize", SHAPES)
def test_slab_plan_keeps_one_slab_when_rows_fill_the_card(m, n, itemsize):
    cols, n_slab = ttrig.slab_plan(m, n, itemsize, H100_SMS)
    if m >= H100_SMS * ttrig.BLOCKS_PER_SM:
        assert n_slab == 1 and cols >= n
    elif n * itemsize >= 2 * ttrig.MIN_SLAB_BYTES:
        assert n_slab > 1  # few long rows are cut


def test_slab_sums_match_pallas_on_few_long_rows():
    """(4, 1 << 17): the port's trigger_sq on the CPU, and the kernel's
    slab sums (each row's slabs by the plan, summed in slab order), against
    the reference's Pallas kernel in interpret mode."""
    m, n = 4, 1 << 17
    rng = np.random.default_rng([m, n])
    w = rng.normal(size=(m, n)).astype(np.float32)
    h = (w + 0.1 * rng.normal(size=(m, n))).astype(np.float32)
    want = np.asarray(jtrig.trigger_sq(jnp.asarray(w), jnp.asarray(h), interpret=True))
    got = ttrig.trigger_sq(torch.as_tensor(w), torch.as_tensor(h))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    cols, n_slab = ttrig.slab_plan(m, n, 4, H100_SMS)
    assert n_slab > 1
    d = torch.as_tensor(w) - torch.as_tensor(h)
    slabs = [[(d[r, c0:c1] ** 2).sum() for c0, c1 in _edges(n, cols, n_slab, 0)]
             for r in range(m)]
    by_slab = torch.stack([torch.stack(s).sum() for s in slabs])
    np.testing.assert_allclose(by_slab.numpy(), want, rtol=RTOL, atol=ATOL)
