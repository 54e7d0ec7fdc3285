"""repro_torch's deep FL models on the CPU against the reference's
(``repro.fl.modelspec``): ``cnn``, ``mlp_blocks`` and ``tiny_transformer``.

Per model: the flat width D, the leaf order of the parameter tree against
``jax.tree.leaves`` (and the flat rows against the reference's
``_flatten_stack``), ``init_stack`` from one key (bit for bit), the logits
and the per-device loss and gradients on the reference's parameters
carried across (to 1e-5), and one short ``api.simulate``, ``api.sweep``
cell and optimizer run against the reference's (in the non-partitionable
threefry mode).  Then the cnn's square-dim error and its average pool at
an odd side, the golden m=8 ``mlp_blocks`` trajectory under every mix
impl, the chunked evaluation, and svm and mlp keeping their flat order.
Integer channels must be equal; float channels agree at the golden
tolerances (rtol 2e-4, atol 2e-5)."""
import dataclasses
import functools
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import efhc as jefhc  # noqa: E402
from repro.data.partition import by_labels as jby_labels  # noqa: E402
from repro.data.synthetic import token_dataset, token_windows  # noqa: E402
from repro.fl import modelspec as jspec  # noqa: E402
from repro.fl import service as jservice  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import efhc as tefhc  # noqa: E402
from repro_torch.core.topology import make_process  # noqa: E402
from repro_torch.data.loader import FederatedBatches  # noqa: E402
from repro_torch.data.partition import by_labels  # noqa: E402
from repro_torch.data.synthetic import image_dataset  # noqa: E402
from repro_torch.fl import modelspec as tspec  # noqa: E402
from repro_torch.fl import service as tservice  # noqa: E402
from repro_torch.fl.simulator import EvalFn, SimConfig, run  # noqa: E402
from repro_torch.kernels.mixing import ops as tmixing_ops  # noqa: E402
from repro_torch.kernels.mixing.ref import mix_ref_3xtf32  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
INT_FIELDS = ("v", "comm_count", "deg")
FLOAT_FIELDS = ("loss", "acc", "tx_time", "util", "consensus_err")
DEEP = ("cnn", "mlp_blocks", "tiny_transformer")
# (dim, n_classes) per model at the tests' size: a 7x7 image (odd side:
# partial pool windows), 24 features, 8-token windows over 16 tokens
SIZES = {"cnn": (49, 10), "mlp_blocks": (24, 10), "tiny_transformer": (8, 16)}
GOLDEN_BLOCKS = (pathlib.Path(__file__).parent / "golden"
                 / "efhc_m8_mlp_blocks.json")


def _specs(name: str, dim=None, n_classes=None):
    d, c = SIZES[name]
    dim, n_classes = dim or d, n_classes or c
    return (jspec.make_model_spec(name, dim=dim, n_classes=n_classes),
            tspec.make_model_spec(name, dim=dim, n_classes=n_classes))


@functools.lru_cache(maxsize=None)
def _ref_params(name: str, m: int = 3, seed: int = 3):
    js, _ = _specs(name)
    with jax.threefry_partitionable(False):
        return jax.device_get(js.init_stack(jax.random.PRNGKey(seed), m))


def _inputs(name: str, shape, seed: int = 0) -> np.ndarray:
    dim, n_classes = SIZES[name]
    rng = np.random.default_rng(seed)
    if name == "tiny_transformer":
        return rng.integers(0, n_classes, size=(*shape, dim)).astype(np.int32)
    return rng.normal(size=(*shape, dim)).astype(np.float32)


@pytest.mark.parametrize("name,dim,n_classes", [
    ("cnn", 49, 10), ("cnn", 784, 10), ("mlp_blocks", 24, 10),
    ("mlp_blocks", 784, 10), ("tiny_transformer", 8, 16),
    ("tiny_transformer", 32, 64)])
def test_flat_dim_matches_reference(name, dim, n_classes):
    js, ts = _specs(name, dim, n_classes)
    assert ts.flat_dim == js.flat_dim
    if dim == 784:  # the registry's widths at the paper's input
        assert ts.flat_dim == {"cnn": 26698, "mlp_blocks": 37824}[name]


@pytest.mark.parametrize("name", DEEP)
def test_leaf_order_and_flat_rows_match_jax(name):
    jw = _ref_params(name)
    tw = convert.params_from_jax(jw, "cpu")
    jl, tl = jax.tree.leaves(jw), tree_leaves(tw)
    assert [tuple(a.shape) for a in jl] == [tuple(t.shape) for t in tl]
    for a, t in zip(jl, tl):
        assert np.array_equal(np.asarray(a), t.numpy())
    want = np.asarray(jefhc._flatten_stack(jax.tree.map(jnp.asarray, jw)))
    got = tefhc.flatten_stack(tw)
    assert np.array_equal(got.numpy(), want)
    back = tefhc.unflatten_stack(got, tw)
    for a, b in zip(tree_leaves(back), tl):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", DEEP)
def test_init_stack_matches_reference_bits(name):
    _, ts = _specs(name)
    jl = jax.tree.leaves(_ref_params(name))
    tl = tree_leaves(ts.init_stack(prng.PRNGKey(3), 3))
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        assert np.array_equal(np.asarray(a), t.numpy())
    # the common init: every device holds device 0's draw
    for t in tl:
        assert torch.equal(t, t[:1].expand_as(t))


@pytest.mark.parametrize("name", DEEP)
def test_loss_and_grads_match_reference(name):
    js, ts = _specs(name)
    jw = _ref_params(name)
    x = _inputs(name, (3, 4))
    y = np.random.default_rng(1).integers(0, SIZES[name][1], size=(3, 4)).astype(np.int32)
    jloss, jgrad = jax.vmap(lambda w, xx, yy: js.grad_fn(w, None, (xx, yy)))(
        jw, jnp.asarray(x), jnp.asarray(y))
    tloss, tgrad = ts.loss_and_grad(convert.params_from_jax(jw, "cpu"),
                                    (torch.as_tensor(x), torch.as_tensor(y)))
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-5, atol=1e-5)
    for a, t in zip(jax.tree.leaves(jgrad), tree_leaves(tgrad)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shared", [False, True], ids=["per_device", "shared"])
@pytest.mark.parametrize("name", DEEP)
def test_logits_match_reference(name, shared):
    """Per-device inputs (m, B, ...) (training) and one shared test set
    (n, ...) against every device (evaluation)."""
    js, ts = _specs(name)
    jw = _ref_params(name)
    tw = convert.params_from_jax(jw, "cpu")
    if shared:
        x = _inputs(name, (5,))
        want = jax.vmap(lambda w: js.eval_logits(w, jnp.asarray(x)))(jw)
    else:
        x = _inputs(name, (3, 5))
        want = jax.vmap(js.eval_logits)(jw, jnp.asarray(x))
    got = ts.logits(tw, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cnn_needs_a_square_dim_with_the_reference_message():
    with pytest.raises(ValueError) as want:
        jspec.make_model_spec("cnn", dim=50, n_classes=10)
    with pytest.raises(ValueError) as got:
        tspec.make_model_spec("cnn", dim=50, n_classes=10)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("side", [5, 7, 8])
def test_cnn_avgpool_exact_on_partial_windows(side):
    """The pool divides each window by its cells inside the image, as the
    reference's SAME pool with exact counts does at an odd side."""
    x = np.random.default_rng(side).normal(size=(2, side, side, 3)).astype(np.float32)
    want = np.asarray(jspec._avgpool2(jnp.asarray(x)))
    got = tspec._avgpool2(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mix_impl", ["dense", "pallas", "sparse", "sparse_pallas"])
def test_port_reproduces_mlp_blocks_golden(mix_impl):
    """The golden m=8 ``mlp_blocks`` run of tests/test_golden_trajectory.py
    on the port, against its artifact at the golden tolerances."""
    want = json.loads(GOLDEN_BLOCKS.read_text())
    m, T, dim = want["m"], want["iters"], want["dim"]
    x, y = image_dataset(600, seed=0, dim=dim)
    parts = by_labels(y, m, 3)
    graph = make_process(m, "rgg", time_varying="edge_dropout", drop=0.3, seed=0)
    sim = SimConfig(m=m, iters=T, dim=dim, batch=8, r=50.0, seed=0,
                    model="mlp_blocks", mix_impl=mix_impl)
    res = run(sim, graph, FederatedBatches(x, y, parts, sim.batch, seed=2), None,
              eval_every=5, device="cpu")
    assert res.model_dim == want["model_dim"]
    np.testing.assert_allclose(res.bandwidths, want["bandwidths"], rtol=1e-5)
    for f in INT_FIELDS:
        assert np.array_equal(getattr(res, f), np.asarray(want[f])), f
    for f in ("loss", "tx_time", "util", "consensus_err"):
        np.testing.assert_allclose(getattr(res, f), np.asarray(want[f]),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


# ------------------------------------------------------------- end to end --

def _token_data(m: int, seq: int, vocab: int):
    """Next-token windows over a seeded bigram stream, split by label."""
    xw, yw = token_windows(token_dataset(3000, vocab=vocab, seed=0), seq, stride=2)
    xt, yt = token_windows(token_dataset(800, vocab=vocab, seed=1), seq, stride=seq)
    return xw, yw, jby_labels(yw, m, 4), xt, yt


class _Tokens:
    """A token-window provider for both services (one dataset class each)."""

    def __init__(self, dataset_cls, m, seq, vocab):
        self.ds = dataset_cls(*_token_data(m, seq, vocab))

    def __call__(self, spec):
        return self.ds


def _spec_kw(name: str, **over) -> dict:
    dim, n_classes = SIZES[name]
    kw = dict(m=6, model=name, dim=dim, n_classes=n_classes, n_train=400,
              n_test=60, iters=8, eval_every=3, batch=4, r=30.0,
              labels_per_device=2, smooth=1 if name == "cnn" else 0)
    kw.update(over)
    return kw


def _providers(name: str, m: int):
    if name != "tiny_transformer":
        return None, None
    dim, vocab = SIZES[name]
    return (_Tokens(jservice.Dataset, m, dim, vocab),
            _Tokens(tservice.Dataset, m, dim, vocab))


def _assert_channels(got, want, label=""):
    assert got.model_dim == want.model_dim
    for f in INT_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f"{label}: {f}"
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{label}: {f}")
    np.testing.assert_allclose(got.bandwidths, want.bandwidths, rtol=1e-6)


@pytest.mark.parametrize("name,mix_impl,optimizer", [
    ("cnn", "pallas", "sgd"), ("mlp_blocks", "sparse_pallas", "adam"),
    ("tiny_transformer", "dense", "momentum")])
def test_api_simulate_matches_reference(name, mix_impl, optimizer):
    kw = _spec_kw(name, mix_impl=mix_impl, optimizer=optimizer, seeds=(1,))
    jprov, tprov = _providers(name, kw["m"])
    with jax.threefry_partitionable(False):
        want = japi.simulate(japi.ScenarioSpec(**kw), provider=jprov)
    got = tapi.simulate(tapi.ScenarioSpec(**kw), provider=tprov, device="cpu")
    _assert_channels(got, want, name)
    assert np.isfinite(got.loss).all() and 0 < got.v.mean() <= 1


@pytest.mark.parametrize("name", DEEP)
def test_api_sweep_cells_match_solo_runs(name):
    """``api.sweep`` runs the deep models: each cell of the batched grid
    against the port's solo ``api.simulate`` of its (seed, policy)."""
    kw = _spec_kw(name, iters=6, seeds=(0, 2))
    _, tprov = _providers(name, kw["m"])
    spec = tapi.ScenarioSpec(**kw)
    grid = tapi.sweep(spec, policies=("efhc", "gossip"), provider=tprov, device="cpu")
    assert grid.v.shape == (2, 2, 6, kw["m"])
    for s in (0, 2):
        for p in ("efhc", "gossip"):
            solo = tapi.simulate(dataclasses.replace(spec, policy=p), seed=s,
                                 provider=tprov, device="cpu")
            _assert_channels(grid.result(s, p), solo, f"{name} {s}/{p}")


@pytest.mark.parametrize("side", ["reference", "port"])
def test_cnn_runs_under_two_roundings_stay_together_at_small_m(side, monkeypatch):
    """The cnn's whole runs under two mixes that differ only in rounding,
    the reference's ``dense`` and ``delta`` mixes and the port's plain mix
    and its split-TF32 kernel's emulation (``mix_ref_3xtf32``), at the
    registry's widths and a reduced m: v equal and the losses within the
    golden tolerances over 20 iterations.  (At m=1024 on the card such
    runs part after a few iterations, with or without the kernel:
    ``chip_smoke.py`` phase 5d.)  ``-s`` prints the largest loss gap per
    iteration and the final accuracies."""
    kw = dict(m=32, model="cnn", dim=784, n_train=256, n_test=500, iters=20,
              eval_every=10, trace="summary")
    if side == "reference":
        with jax.threefry_partitionable(False):
            a = japi.simulate(japi.ScenarioSpec(**kw))
            b = japi.simulate(japi.ScenarioSpec(**kw, mix_impl="delta"))
    else:
        spec = tapi.ScenarioSpec(**kw, mix_impl="pallas")
        a = tapi.simulate(spec, device="cpu")
        monkeypatch.setattr(tmixing_ops, "mix", mix_ref_3xtf32)
        b = tapi.simulate(spec, device="cpu")
    gap = np.abs(np.asarray(a.loss, np.float64) - np.asarray(b.loss)).max(axis=1)
    print(f"{side} cnn m={kw['m']}: largest loss gap per iteration "
          f"{[float(f'{g:.2g}') for g in gap]}; final acc {float(a.acc[-1]):.4f} / "
          f"{float(b.acc[-1]):.4f}")
    assert np.array_equal(a.v, b.v)
    np.testing.assert_allclose(b.loss, a.loss, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", DEEP)
def test_chunked_evaluation_equals_one_pass(name, monkeypatch):
    """``EvalFn`` over two cells (one forward over the cells' devices)
    gives each cell's accuracy alone, and the cnn's forward on a shared x
    over chunks of the devices (``CNN_EVAL_ROWS`` (device, sample) pairs)
    gives the logits of one pass."""
    _, ts = _specs(name)
    w = convert.params_from_jax(_ref_params(name, m=6, seed=5), "cpu")
    cells = tree_map(lambda t: t.reshape((2, 3) + t.shape[1:]), w)
    x = _inputs(name, (7,), seed=2)
    y = np.random.default_rng(3).integers(0, SIZES[name][1], size=7)
    both = EvalFn(ts.logits, x, y).device(cells)
    alone = [EvalFn(ts.logits, x, y).device(tree_map(lambda t: t[c:c + 1], cells))
             for c in range(2)]
    assert torch.equal(both, torch.cat(alone))
    if name == "cnn":
        xt = torch.as_tensor(x)
        one = ts.logits(w, xt)
        for rows in (7, 14, 28):  # chunks of 1, 2 and 4 of the 6 devices
            monkeypatch.setattr(tspec, "CNN_EVAL_ROWS", rows)
            assert torch.equal(ts.logits(w, xt), one)


@pytest.mark.parametrize("name,order", [
    ("svm", ("b", "w")), ("mlp", ("b1", "b2", "w1", "w2"))])
def test_svm_and_mlp_keep_their_flat_order(name, order):
    """The paper models' flat rows stay ``[b | w]`` and ``[b1 | b2 | w1 |
    w2]``, the reference's (golden m=8)."""
    spec = tspec.make_model_spec(name, dim=6, n_classes=3)
    w = spec.init_stack(prng.PRNGKey(0), 2)
    w = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
         for i, (k, v) in enumerate(w.items())}
    flat = tefhc.flatten_stack(w)
    assert flat.shape == (2, spec.flat_dim)
    want = torch.cat([w[k].reshape(2, -1) for k in order], dim=-1)
    assert torch.equal(flat, want)
    shuffled = {k: w[k] for k in reversed(order)}  # insertion order is ignored
    assert torch.equal(tefhc.flatten_stack(shuffled), want)
