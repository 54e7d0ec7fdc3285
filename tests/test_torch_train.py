"""repro_torch's EF-HC training on the CPU against the reference's
(``repro.launch.steps``, ``repro.models.model.loss_fn``).

The base graph (``ring_adjacency``) and its matching rounds
(``edge_coloring``) must be equal.  ``loss_fn`` and every leaf's gradient
(autograd against ``jax.grad``) on the starcoder2 smoke configuration in
fp32 under the ``xla``, ``chunked`` and ``banded`` attention paths, remat
on and off, and the four pytree wrappers of the trigger and mixing
kernels against the reference's in interpret mode, at fp32 and bf16.
Then the train step at m=4 on a ring with pods=2 (personalized rho), fp32
and bf16, dense and neighbor schedules, 4 steps from k=0 on the
reference's batches (the reference built in-process on a one-device host
mesh with a ``TrainSetup`` made directly): ``v`` and ``trigger_rate``
equal, ``loss``, ``alpha``, the parameters and ``w_hat`` within
tolerance; the m == 1 path; ``pallas_swa`` refusing under autograd; the
train CLI's checkpoint and a resume that continues bit for bit; bf16
checkpoints (a round trip, and the reference's file read without
``ml_dtypes``, its bytes equal to the port's).

Tolerances: fp32 the golden rtol 2e-4 / atol 2e-5.  bf16 outputs of the
kernels' wrappers: one bf16 ulp, rtol 2^-7 (and atol 1e-6 where an fp32
sum cancels to near zero).  bf16 train-step parameters
take rtol 2^-7 and an absolute floor of 4 bf16 ulps of the leaf's largest
value (2^-5 max|leaf|): the model's forward and backward run in bf16 in
both frameworks, which round differently inside it, so the gradients of
leaves near zero (the biases, which start at 0) differ by up to 2.8 such
ulps after 4 steps (measured on this configuration); the loss is within
rtol 2^-7."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.core import consensus as jconsensus  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.data.loader import lm_batches  # noqa: E402
from repro.data.synthetic import token_dataset  # noqa: E402
from repro.kernels.mixing import ops as jmix  # noqa: E402
from repro.kernels.trigger import ops as jtrig  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import msgpack_ckpt as tckpt  # noqa: E402
from repro_torch.configs import smoke_config as tsmoke  # noqa: E402
from repro_torch.core import consensus as tconsensus  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.kernels.mixing import ops as tmix  # noqa: E402
from repro_torch.kernels.trigger import ops as ttrig  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# many small ops: one thread keeps the file's time low under pytest -n 6
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
BF16_RTOL = 2.0 ** -7
BF16_LEAF_ULPS = 4
ARCH = "starcoder2-15b"
M_REPL = 4
SEQ = 32


def _cfgs(**kw):
    return (dataclasses.replace(jsmoke(ARCH), **kw), dataclasses.replace(tsmoke(ARCH), **kw))


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t32(t) -> np.ndarray:
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def ref_params():
    """The reference's smoke starcoder2 weights (fp32), by key."""
    jcfg, _ = _cfgs()
    with jax.threefry_partitionable(False):
        return jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------------
# base graph and its matching rounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", range(1, 13))
def test_ring_adjacency_and_coloring_match_reference(m):
    adj = ttopo.ring_adjacency(m)
    assert np.array_equal(adj, jtopo.ring_adjacency(m))
    assert tconsensus.edge_coloring(adj) == jconsensus.edge_coloring(adj)


@pytest.mark.parametrize("seed", range(4))
def test_edge_coloring_matches_reference_on_random_graphs(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(5, 30))
    upper = np.triu(rng.random((m, m)) < rng.uniform(0.1, 0.6), 1)
    adj = upper | upper.T
    rounds = tconsensus.edge_coloring(adj)
    assert rounds == jconsensus.edge_coloring(adj)
    # the rounds are matchings that partition the edge set
    edges = sorted(e for r in rounds for e in r)
    assert edges == [(i, j) for i in range(m) for j in range(i + 1, m) if adj[i, j]]
    for r in rounds:
        ends = [x for e in r for x in e]
        assert len(ends) == len(set(ends))
    # the edge-list form gives the same rounds
    u, v = np.nonzero(np.triu(adj, 1))
    el = ttopo.EdgeList(u=u.astype(np.int32), v=v.astype(np.int32), m=m)
    assert tconsensus.edge_coloring(el) == rounds


@pytest.mark.parametrize("vocab,seed", [(512, 0), (49152, 0), (16, 3)])
def test_token_stream_and_batches_match_reference(vocab, seed):
    from repro_torch.data.loader import lm_batches as tbatches
    from repro_torch.data.synthetic import token_dataset as ttokens
    stream = ttokens(20000, vocab=vocab, seed=seed)
    assert np.array_equal(stream, token_dataset(20000, vocab=vocab, seed=seed))
    ours, ref = tbatches(stream, 3, 17, seed=seed + 1), lm_batches(stream, 3, 17, seed=seed + 1)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("attn_impl", ["xla", "chunked", "banded"])
def test_loss_and_grads_match_reference(ref_params, attn_impl, remat):
    # attn_chunk 16: the chunked path's online softmax over 4 kv chunks
    jcfg, tcfg = _cfgs(attn_impl=attn_impl, remat=remat, attn_chunk=16)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab, size=(2, 64)).astype(np.int32)
    targets = rng.integers(0, jcfg.vocab, size=(2, 64)).astype(np.int32)
    mask = (rng.random((2, 64)) < 0.8).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets),
              "loss_mask": jnp.asarray(mask)}
    jloss, jgrad = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, jbatch)[0])(
        jax.tree.map(jnp.asarray, ref_params))
    tparams = convert.arch_params_from_jax(ref_params, "cpu")
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    tbatch = {"tokens": torch.as_tensor(tokens, dtype=torch.int64),
              "targets": torch.as_tensor(targets, dtype=torch.int64),
              "loss_mask": torch.as_tensor(mask)}
    tloss, metrics = TM.loss_fn(tcfg, tparams, tbatch)
    grads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=RTOL, atol=ATOL)
    assert metrics["ce"] is tloss
    jl = jax.tree.leaves(jgrad)
    assert len(jl) == len(grads)
    for a, g in zip(jl, grads):
        np.testing.assert_allclose(_t32(g), _f32(a), rtol=RTOL, atol=ATOL)


def test_loss_without_mask_is_the_mean_over_positions(ref_params):
    jcfg, tcfg = _cfgs(attn_impl="xla")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab, size=(2, SEQ)).astype(np.int32)
    targets = rng.integers(0, jcfg.vocab, size=(2, SEQ)).astype(np.int32)
    jloss, _ = JM.loss_fn(jcfg, jax.tree.map(jnp.asarray, ref_params),
                          {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)})
    with torch.no_grad():
        tloss, _ = TM.loss_fn(tcfg, convert.arch_params_from_jax(ref_params, "cpu"),
                              {"tokens": torch.as_tensor(tokens, dtype=torch.int64),
                               "targets": torch.as_tensor(targets, dtype=torch.int64)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL, atol=ATOL)


def test_pallas_swa_refuses_under_autograd(ref_params):
    _, tcfg = _cfgs(attn_impl="pallas_swa")
    params = convert.arch_params_from_jax(ref_params, "cpu")
    batch = {"tokens": torch.zeros((1, 64), dtype=torch.int64),
             "targets": torch.zeros((1, 64), dtype=torch.int64)}
    with torch.no_grad():  # serving: the kernel's plain version on the CPU
        loss, _ = TM.loss_fn(tcfg, params, batch)
    assert torch.isfinite(loss)
    tree_leaves(params)[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        TM.loss_fn(tcfg, params, batch)


# ---------------------------------------------------------------------------
# the kernels' pytree wrappers
# ---------------------------------------------------------------------------

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tree_pair(dtype: str, seed: int, m: int = M_REPL, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (m, 3, 40), "b": [(m, 130), (m, 2, 2, 9)], "c": {"d": (m, 257)}}

    def leaf(shape):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    tree = jax.tree.map(leaf, shapes, is_leaf=lambda x: isinstance(x, tuple))
    jdt, tdt = DTYPES[dtype]
    jt = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
    tt = convert.arch_params_from_jax(jax.device_get(jt), "cpu")
    assert all(t.dtype == tdt for t in tree_leaves(tt))
    return jt, tt


def _close(got, want, dtype: str):
    if dtype == "bfloat16":
        # atol: where the fp32 sum cancels to near zero, its own rounding
        # (2^-23 of terms of size ~1) is the difference
        np.testing.assert_allclose(_t32(got), _f32(want), rtol=BF16_RTOL, atol=1e-6)
    else:
        np.testing.assert_allclose(_t32(got), _f32(want), rtol=RTOL, atol=ATOL)


def _ring_p():
    """The Metropolis P of the m=4 ring with replicas 1 and 3 triggered."""
    from repro.core import mixing as jmixing

    adj = jtopo.ring_adjacency(M_REPL)
    v = np.array([False, True, False, True])
    comm = (v[:, None] | v[None, :]) & adj
    return adj, np.asarray(jmixing.build_p(jnp.asarray(adj), jnp.asarray(comm)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_trigger_tree_and_events_match_reference(dtype):
    jw, tw = _tree_pair(dtype, 0)
    jh, th = _tree_pair(dtype, 1)
    want = jtrig.trigger_sq_tree(jw, jh, interpret=True)
    got = ttrig.trigger_sq_tree(tw, th)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # events on one leaf's rows: thresholds on both sides of the deviations
    jl, tl = jax.tree.leaves(jw)[0], tree_leaves(tw)[0]
    jhl, thl = jax.tree.leaves(jh)[0], tree_leaves(th)[0]
    jw2, tw2 = jl.reshape(M_REPL, -1), tl.reshape(M_REPL, -1)
    jh2, th2 = jhl.reshape(M_REPL, -1), thl.reshape(M_REPL, -1)
    dev = np.sqrt(np.asarray(jtrig.trigger_sq(jw2, jh2, interpret=True)) / jw2.shape[1])
    rho = np.array([0.5, 1.0, 1.5, 3.0], np.float32)
    gamma = float(np.median(dev / rho))
    want_v = jtrig.events(jw2, jh2, n_model=jw2.shape[1], r=1.0, rho=jnp.asarray(rho),
                          gamma_k=jnp.asarray(gamma, jnp.float32), interpret=True)
    got_v = ttrig.events(tw2, th2, n_model=tw2.shape[1], r=1.0, rho=torch.as_tensor(rho),
                         gamma_k=torch.tensor(gamma, dtype=torch.float32))
    assert got_v.tolist() == np.asarray(want_v).tolist()
    assert 0 < sum(got_v.tolist()) < M_REPL


@pytest.mark.parametrize("dtype", DTYPES)
def test_mix_tree_matches_reference(dtype):
    jw, tw = _tree_pair(dtype, 2)
    _, p = _ring_p()
    p = np.array(p)
    want = jmix.mix_tree(jnp.asarray(p), jw, interpret=True)
    got = tmix.mix_tree(torch.as_tensor(p), tw)
    for a, t in zip(jax.tree.leaves(want), tree_leaves(got)):
        assert t.dtype == DTYPES[dtype][1] and tuple(t.shape) == a.shape
        _close(t, a, dtype)
    # written into a tree of the same structure, one leaf at a time
    out = tmix.mix_tree(torch.as_tensor(p), tw, out=tw)
    assert out is not None and all(a is b for a, b in zip(tree_leaves(out), tree_leaves(tw)))
    for a, b in zip(tree_leaves(out), tree_leaves(got)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mix_sparse_tree_matches_reference(dtype):
    jw, tw = _tree_pair(dtype, 3)
    adj, p = _ring_p()
    p = np.array(p)
    slots = tsteps.neighbor_slots(jconsensus.edge_coloring(adj), M_REPL)
    rows = np.arange(M_REPL)[:, None]
    p_off = np.where(slots != rows, p[rows, slots], 0.0).astype(np.float32)
    p_diag = np.diagonal(p).astype(np.float32)
    want = jmix.mix_sparse_tree(jnp.asarray(slots.astype(np.int32)), jnp.asarray(p_diag),
                                jnp.asarray(p_off), jw, interpret=True)
    got = tmix.mix_sparse_tree(torch.as_tensor(slots), torch.as_tensor(p_diag),
                               torch.as_tensor(p_off), tw)
    for a, t in zip(jax.tree.leaves(want), tree_leaves(got)):
        assert t.dtype == DTYPES[dtype][1]
        _close(t, a, dtype)
    # the reference's neighbor schedule is the same function
    perm = jsteps.mix_neighbor_permute(jnp.asarray(p), jw, jconsensus.edge_coloring(adj))
    for a, t in zip(jax.tree.leaves(perm), tree_leaves(got)):
        _close(t, a, dtype)


@pytest.mark.parametrize("schedule", ["dense", "neighbor"])
def test_mix_trees_split_a_wide_fp32_leaf_into_slabs(schedule, monkeypatch):
    """An fp32 leaf wider than ``FP32_SLAB`` columns (cut to 7 here) is
    mixed a slab at a time, into a new tree or in place: the reference's
    values, and the whole leaf's (its bits for the gather-mix, whose sums
    are a column's own; the CPU's dense plain version is a BLAS product,
    whose bits hang on the width)."""
    jw, tw = _tree_pair("float32", 4)
    adj, p = _ring_p()
    p = np.array(p)
    slots = tsteps.neighbor_slots(jconsensus.edge_coloring(adj), M_REPL)
    rows = np.arange(M_REPL)[:, None]
    p_off = torch.as_tensor(np.where(slots != rows, p[rows, slots], 0.0).astype(np.float32))
    p_diag = torch.as_tensor(np.diagonal(p).astype(np.float32))

    def mix(tree, out=None):
        if schedule == "dense":
            return tmix.mix_tree(torch.as_tensor(p), tree, out=out)
        return tmix.mix_sparse_tree(torch.as_tensor(slots), p_diag, p_off, tree, out=out)

    whole = mix(tw)
    monkeypatch.setattr(tmix, "FP32_SLAB", 7)
    widths = [t.reshape(M_REPL, -1).shape[1] for t in tree_leaves(tw)]
    assert any(len(tmix.slabs(t.reshape(M_REPL, -1))) > 1 for t in tree_leaves(tw))
    assert all(sum(c.stop - c.start for c in tmix.slabs(t.reshape(M_REPL, -1))) == n
               for t, n in zip(tree_leaves(tw), widths))
    assert len(tmix.slabs(torch.zeros((M_REPL, 20), dtype=torch.bfloat16))) == 1
    split = mix(tw)
    want = jmix.mix_tree(jnp.asarray(p), jw, interpret=True)
    for a, b, w in zip(tree_leaves(split), tree_leaves(whole), jax.tree.leaves(want)):
        if schedule == "neighbor":
            assert torch.equal(a, b)
        _close(a, b, "float32")
        _close(a, w, "float32")
    out = mix(tw, out=tw)
    assert all(a is b for a, b in zip(tree_leaves(out), tree_leaves(tw)))
    for a, b in zip(tree_leaves(out), tree_leaves(split)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _ref_step(jcfg, setup: tsteps.TrainSetup, n_par: int):
    jset = jsteps.TrainSetup(cfg=jcfg, mode=setup.mode, m=setup.m,
                             adjacency=setup.adjacency, bandwidths=setup.bandwidths,
                             r=setup.r, alpha0=setup.alpha0, mix=setup.mix)
    mesh = make_host_mesh(data=1, model=1)
    make = (jsteps.make_neighbor_train_step if setup.mix == "neighbor"
            else jsteps.make_train_step)
    return jax.jit(make(jset, mesh, n_model_params=n_par))


def _batches(vocab: int, m: int, steps: int):
    stream = token_dataset(8000, vocab=vocab, seed=0)
    iters = [lm_batches(s, 2, SEQ, seed=i) for i, s in enumerate(np.array_split(stream, m))]
    for _ in range(steps):
        per = [next(it) for it in iters]
        yield {k: np.stack([p[k] for p in per]) for k in per[0]}


def _run_both(ref_params, dtype: str, mix: str, m: int, steps: int):
    jcfg, tcfg = _cfgs(dtype=dtype, attn_impl="xla")
    setup = tsteps.make_setup(tcfg, m, mix=mix, pods=2 if m % 2 == 0 else 1)
    n_par = tcfg.n_params
    assert n_par == jcfg.n_params
    jstep = _ref_step(jcfg, setup, n_par)
    make = (tsteps.make_neighbor_train_step if setup.mix == "neighbor"
            else tsteps.make_train_step)
    tstep = make(setup, n_model_params=n_par)
    jdt = DTYPES[dtype][0]
    jp = jax.tree.map(lambda a: jnp.stack([jnp.asarray(a, jdt)] * m), ref_params)
    jh = jax.tree.map(jnp.copy, jp)
    tp = convert.arch_params_from_jax(jax.device_get(jp), "cpu")
    th = convert.arch_params_from_jax(jax.device_get(jh), "cpu")
    out = []
    for k, b in enumerate(_batches(jcfg.vocab, m, steps)):
        jp, jh, jm = jstep(jp, jh, {n: jnp.asarray(x) for n, x in b.items()},
                           jnp.asarray(k, jnp.int32))
        tp, th, tm = tstep(tp, th, {n: torch.as_tensor(x, dtype=torch.int64)
                                    for n, x in b.items()}, k)
        out.append((jax.device_get((jp, jh, jm)), (tp, th, tm)))
        yield setup, out[-1]


def _params_close(want_tree, got_tree, dtype: str, label: str):
    for a, t in zip(jax.tree.leaves(want_tree), tree_leaves(got_tree)):
        want, got = _f32(a), _t32(t)
        if dtype == "bfloat16":
            floor = BF16_LEAF_ULPS * BF16_RTOL * float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=floor, err_msg=label)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=label)


@pytest.mark.parametrize("mix", ["dense", "neighbor"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_train_step_matches_reference(ref_params, dtype, mix):
    fired = 0
    for k, (setup, ((jp, jh, jm), (tp, th, tm))) in enumerate(
            _run_both(ref_params, dtype, mix, M_REPL, 4)):
        assert setup.bandwidths.tolist() == [1000.0, 5000.0, 1000.0, 5000.0]
        assert float(tm["trigger_rate"]) == float(jm["trigger_rate"])
        assert float(tm["alpha"]) == pytest.approx(float(jm["alpha"]), rel=RTOL)
        rtol = BF16_RTOL if dtype == "bfloat16" else RTOL
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=rtol, atol=ATOL)
        _params_close(jp, tp, dtype, f"params after step {k}")
        _params_close(jh, th, dtype, f"w_hat after step {k}")
        fired += float(tm["trigger_rate"]) > 0
    assert fired >= 1  # the personalized trigger fired: P was not the identity


def test_single_replica_path_matches_reference(ref_params):
    """m == 1: no trigger, no mix (``mix="none"``), local SGD alone."""
    for setup, ((jp, jh, jm), (tp, th, tm)) in _run_both(ref_params, "float32", "dense", 1, 2):
        assert setup.mix == "none" and setup.mode == "fsdp"
        assert float(tm["trigger_rate"]) == 0.0 == float(jm["trigger_rate"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL, atol=ATOL)
        _params_close(jp, tp, "float32", "params")
        _params_close(jh, th, "float32", "w_hat")


def test_make_setup_matches_the_reference_rule():
    _, tcfg = _cfgs()
    s = tsteps.make_setup(tcfg, 8, pods=4)
    assert s.bandwidths.tolist() == [1000.0, 5000.0] * 4 and s.mix == "dense"
    assert tsteps.make_setup(tcfg, 8).bandwidths.tolist() == [5000.0] * 8
    two = tsteps.make_setup(tcfg, 2, mix="neighbor")
    assert two.adjacency.tolist() == [[False, True], [True, False]]
    with pytest.raises(ValueError, match="pods"):
        tsteps.make_setup(tcfg, 6, pods=4)


# ---------------------------------------------------------------------------
# the entry point, checkpoints and resume
# ---------------------------------------------------------------------------

def test_train_cli_resume_continues_bit_for_bit(tmp_path, capsys):
    args = ["--arch", ARCH, "--smoke", "--data", "4", "--seq", "16", "--device", "cpu",
            "--log_every", "1", "--ckpt", str(tmp_path)]
    assert ttrain.main(args + ["--steps", "3"]) == 0
    assert ttrain.main(args + ["--steps", "3", "--mix", "neighbor"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:3][0].startswith("step     0 loss ") and "trigger_rate" in lines[0]
    assert f"restored step 3 from {tmp_path}" in lines
    assert lines.count("training done") == 2
    # the same 6 steps without the checkpoint between them
    cfg = tsmoke(ARCH)
    first = ttrain.train(cfg, m=4, steps=3, seq=16, device="cpu", log=lambda s: None)
    whole = ttrain.train(cfg, m=4, steps=3, seq=16, mix="neighbor", device="cpu",
                         state=(first.params, first.w_hat, first.step), log=lambda s: None)
    saved = tckpt.restore(str(tmp_path), 6)
    assert saved["step"] == 6
    for name, tree in (("params", whole.params), ("w_hat", whole.w_hat)):
        for a, t in zip(jax.tree.leaves(saved[name]), tree_leaves(tree)):
            assert np.array_equal(np.asarray(a), t.numpy()), name
    printed = [ln for ln in lines if ln.startswith("step ")]
    assert len(printed) == 6 and printed[3].startswith("step     3 loss ")


def test_train_entry_point_refuses_what_is_not_ported(monkeypatch):
    # a mesh over several ranks needs them (torchrun); one process refuses
    for env in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(env, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        ttrain.main(["--arch", ARCH, "--smoke", "--model", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="torchrun"):
        ttrain.main(["--arch", ARCH, "--smoke", "--devices", "8", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):  # the default device is the card
        ttrain.main(["--arch", ARCH, "--smoke", "--steps", "1"])


def _bf16_tree():
    rng = np.random.default_rng(11)
    return {"w": jnp.asarray(rng.normal(size=(4, 3, 5)), jnp.bfloat16),
            "stages": [{"b": jnp.asarray(rng.normal(size=(7,)), jnp.bfloat16)}],
            "f": jnp.asarray(rng.normal(size=(2, 2)), jnp.float32)}


def test_bf16_checkpoint_round_trip(tmp_path):
    tree = {**convert.arch_params_from_jax(jax.device_get(_bf16_tree()), "cpu"), "step": 3}
    tckpt.save(str(tmp_path), 3, tree)
    back = tckpt.restore(str(tmp_path))
    assert back["w"].dtype == torch.bfloat16 and back["stages"][0]["b"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), tree["w"].view(torch.int16))
    assert torch.equal(back["stages"][0]["b"].view(torch.int16),
                       tree["stages"][0]["b"].view(torch.int16))
    assert np.array_equal(back["f"], tree["f"].numpy()) and back["step"] == 3


def test_reference_bf16_checkpoint_restores_and_bytes_match(tmp_path):
    ref = {**_bf16_tree(), "step": 3}
    jckpt.save(str(tmp_path / "ref"), 3, ref)
    back = tckpt.restore(str(tmp_path / "ref"))
    for name, got in (("w", back["w"]), ("b", back["stages"][0]["b"])):
        want = np.asarray(ref["w"] if name == "w" else ref["stages"][0]["b"])
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16)), name
    port = {**convert.arch_params_from_jax(jax.device_get(_bf16_tree()), "cpu"), "step": 3}
    tckpt.save(str(tmp_path / "port"), 3, port)
    assert ((tmp_path / "port" / "step_3.msgpack").read_bytes()
            == (tmp_path / "ref" / "step_3.msgpack").read_bytes())


def test_checkpoint_splits_an_array_past_one_bin(tmp_path, monkeypatch):
    """An array of more bytes than a msgpack bin holds is written as a list
    of bins and restores bit for bit; one that fits stays a single bin (the
    reference's encoding).  The bin's size is cut to a few bytes here."""
    monkeypatch.setattr(tckpt, "BIN_MAX", 40)
    monkeypatch.setattr(tckpt, "BIN_CHUNK", 16)
    rng = np.random.default_rng(12)
    tree = {"big16": torch.from_numpy(rng.normal(size=(3, 7)).astype(np.float32))
            .to(torch.bfloat16),
            "big32": torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)),
            "np": rng.normal(size=(11,)),
            "small": torch.from_numpy(rng.normal(size=(10,)).astype(np.float32))}
    tckpt.save(str(tmp_path), 1, tree)
    raw = tckpt.unpackb((tmp_path / "step_1.msgpack").read_bytes())
    for name in ("big16", "big32", "np"):
        chunks = raw[name]["data"]
        assert isinstance(chunks, list) and len(chunks) > 1, name
        assert all(0 < len(c) <= 16 for c in chunks), name
    assert isinstance(raw["small"]["data"], bytes) and len(raw["small"]["data"]) == 40
    back = tckpt.restore(str(tmp_path), 1)
    assert back["big16"].dtype == torch.bfloat16
    assert torch.equal(back["big16"].view(torch.int16), tree["big16"].view(torch.int16))
    assert np.array_equal(back["big32"], tree["big32"].numpy())
    assert np.array_equal(back["np"], tree["np"])
    assert np.array_equal(back["small"], tree["small"].numpy())
