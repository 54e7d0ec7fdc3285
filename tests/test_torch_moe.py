"""repro_torch's MoE FFN and the MoE architectures against the JAX package's,
on the CPU.

``models/moe.py`` piece by piece: ``init_moe``'s bits from one key (the
router fp32 in a bf16 model), ``router_probs`` (values, top-k indices and
the aux loss; equal probabilities, where ``torch.topk`` promises no order,
taking the reference's lower index first), ``_dispatch_group_count`` over a
grid, the queue slots against a plain loop, and ``moe_ffn`` under each
impl (``shard_map`` falls through to ``scatter`` without a mesh) at fp32
and bf16, with a capacity that drops pairs and with several scatter
groups.  Then granite-moe-3b-a800m's smoke configuration end to end:
``forward``, ``loss_fn`` with its aux term, every gradient, ``decode_step``,
two train steps under each schedule at fp32 and bf16 (the fp32 router
among bf16 leaves), the full parameter trees' shapes with nothing
allocated, and ``arch_params_from_jax`` carrying both architectures'
trees.  The reference runs inside ``jax.threefry_partitionable(False)``.

Tolerances: fp32 rtol 2e-4 / atol 2e-5 (the golden ones); bf16 rtol 2^-7
(one bf16 ulp) with the floors ``tests/test_torch_train.py`` states for
sums that cancel and for the train step's parameters (4 bf16 ulps of the
leaf's largest value), which in a bf16 model hold its fp32 router too:
the router's gradient comes through the model's bf16 arithmetic, which
the two frameworks round apart; bf16 ``moe_ffn`` outputs take an
absolute 2e-2 beside rtol 2^-7: the outputs reach 2.5-3.7, where a bf16
ulp is 2^-6, and the two frameworks sum bf16 products in another order
(measured: at most 0.0234 apart); integer outputs (top-k indices, slots, keep masks, v)
exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import consensus as jconsensus  # noqa: E402
from repro.data.loader import lm_batches  # noqa: E402
from repro.data.synthetic import token_dataset  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# many small ops: one thread keeps the file's time low under pytest -n 6
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
BF16_RTOL = 2.0 ** -7
BF16_LEAF_ULPS = 4
GRANITE, DEEPSEEK = "granite-moe-3b-a800m", "deepseek-v3-671b"
ARCHS = (GRANITE, DEEPSEEK)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch=GRANITE, moe=None, **kw):
    """The reference's and the port's smoke configs with ``kw`` (and the
    MoE fields ``moe``) replaced."""
    out = []
    for mod in (jconfigs, tconfigs):
        cfg = dataclasses.replace(mod.smoke_config(arch), **kw)
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        out.append(cfg)
    return tuple(out)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t32(t) -> np.ndarray:
    return t.detach().float().numpy()


def _close(got, want, dtype="float32", atol=None):
    if dtype == "bfloat16":
        np.testing.assert_allclose(_t32(got), _f32(want), rtol=BF16_RTOL,
                                   atol=1e-6 if atol is None else atol)
    else:
        np.testing.assert_allclose(_t32(got), _f32(want), rtol=RTOL,
                                   atol=ATOL if atol is None else atol)


def _jinit(fn, *args):
    with jax.threefry_partitionable(False):
        return jax.device_get(fn(*args))


def _moe_params(jcfg, seed: int, dtype: str):
    """``init_moe``'s weights from the reference (numpy leaves)."""
    return _jinit(JMOE.init_moe, jcfg, jax.random.PRNGKey(seed), DTYPES[dtype][0])


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_bits_match_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch)
    want = _moe_params(jcfg, 3, dtype)
    got = TMOE.init_moe(tcfg, prng.PRNGKey(3), DTYPES[dtype][1], "cpu")
    assert sorted(got) == sorted(want)
    assert ("shared_in" in got) == (arch == DEEPSEEK) and "w_gate" in got
    for name, a in want.items():
        t = got[name]
        want_dt = torch.float32 if name == "router" else DTYPES[dtype][1]
        assert t.dtype == want_dt, name
        np.testing.assert_array_equal(_t32(t), _f32(a), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_param_tree_matches_reference_shapes_unallocated(arch):
    want = jax.eval_shape(lambda k: JM.init_params(jconfigs.get_config(arch), k),
                          jax.random.PRNGKey(0))
    got = TM.init_params(tconfigs.get_config(arch), None, "meta")
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree_util.tree_leaves_with_path(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert [jax.tree_util.keystr(p) for p, _ in got_leaves] == \
        [jax.tree_util.keystr(p) for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        name = jax.tree_util.keystr(path)
        assert g.device.type == "meta" and tuple(g.shape) == tuple(w.shape), name
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        assert (g.dtype == torch.float32) == name.endswith("['router']"), name
    n = sum(int(np.prod(w.shape)) for _, w in want_leaves)
    # the analytic count leaves out the final and the MLA / MTP norms
    assert 0 < n - tconfigs.get_config(arch).n_params < 1e-4 * n
    assert ("['mtp']" in "".join(jax.tree_util.keystr(p) for p, _ in got_leaves)) == \
        (arch == DEEPSEEK)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("arch", ARCHS)
def test_router_probs_match_reference(arch, seed):
    jcfg, tcfg = _cfgs(arch)
    p = _moe_params(jcfg, seed, "float32")
    x = np.random.default_rng(seed).normal(size=(2, 37, jcfg.d_model)).astype(np.float32)
    jv, ji, ja = JMOE.router_probs(jcfg.moe, p, jnp.asarray(x))
    tv, ti, ta = TMOE.router_probs(tcfg.moe, convert.arch_params_from_jax(p, "cpu"),
                                   torch.as_tensor(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tv, jv)
    _close(ta, ja)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_router_ties_take_the_lower_index_first(k):
    """A zero router: every probability ties, and the reference's top-k is
    experts 0..k-1 for every token.  Then rows drawn from three values, full
    of ties: ``_top_k`` gives ``jax.lax.top_k``'s indices and values."""
    jcfg, tcfg = _cfgs(moe=dict(n_experts=6, top_k=k))
    x = np.random.default_rng(k).normal(size=(11, jcfg.d_model)).astype(np.float32)
    router = np.zeros((jcfg.d_model, 6), np.float32)
    jv, ji, ja = JMOE.router_probs(jcfg.moe, {"router": jnp.asarray(router)}, jnp.asarray(x))
    tv, ti, ta = TMOE.router_probs(tcfg.moe, {"router": torch.as_tensor(router)},
                                   torch.as_tensor(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.tolist() == [list(range(k))] * 11
    _close(tv, jv)
    _close(ta, ja)
    probs = np.random.default_rng(k + 9).integers(0, 3, size=(4, 7, 6)).astype(np.float32) / 4
    jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
    tv, ti = TMOE._top_k(torch.as_tensor(probs), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_dispatch_group_count_matches_reference():
    for t in (1, 2, 7, 12, 97, 100, 4096, 8191, 8192, 8193, 12288, 16384, 24576,
              32768, 65536, 65537, 131072):
        for target in (1, 3, 16, 1000, 4096, 8192, 10000):
            assert TMOE._dispatch_group_count(t, target) == \
                JMOE._dispatch_group_count(t, target), (t, target)


@pytest.mark.parametrize("cap", [1, 3, 100])
def test_queue_slots_are_the_queue_order(cap):
    """Each (token, k) pair's slot is the number of earlier pairs, counted
    token-major, that chose its expert; at or past ``cap`` it drops to slot
    ``cap``.  Per group."""
    rng = np.random.default_rng(cap)
    idx = np.stack([np.stack([rng.choice(5, 2, replace=False) for _ in range(9)])
                    for _ in range(3)])  # (G=3, T=9, K=2)
    slot, keep = TMOE._queue_slots(torch.as_tensor(idx), 5, cap)
    for g in range(3):
        seen = np.zeros(5, int)
        for t in range(9):
            for k in range(2):
                e = idx[g, t, k]
                assert keep[g, t, k] == (seen[e] < cap)
                assert slot[g, t, k] == (seen[e] if seen[e] < cap else cap)
                seen[e] += 1


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

def _ffn_both(arch, impl, dtype, cf, tokens, seed=5):
    jcfg, tcfg = _cfgs(arch, moe=dict(impl=impl, capacity_factor=cf))
    p = _moe_params(jcfg, seed, dtype)
    x = np.random.default_rng(seed).normal(size=(2, tokens // 2, jcfg.d_model))
    jx = jnp.asarray(x, DTYPES[dtype][0])
    want, jaux = JMOE.moe_ffn(jcfg, p, jx)
    tx = convert.arch_params_from_jax(jax.device_get(jx), "cpu")
    got, taux = TMOE.moe_ffn(tcfg, convert.arch_params_from_jax(p, "cpu"), tx)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == tuple(want.shape)
    _close(taux, jaux)
    return tcfg, p, tx, got, want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", ["dense", "scatter", "dispatch", "shard_map"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, impl, dtype):
    """48 tokens; capacity_factor 0.5 makes the capacity 24 (scatter and
    dispatch: 48 x 2 x 0.5 / 4, above the floor of 4) for 24 pairs an
    expert on average, so pairs drop."""
    tcfg, p, tx, got, want = _ffn_both(arch, impl, dtype, 0.5, 48)
    _close(got, want, dtype, atol=None if dtype == "float32" else 2e-2)
    if impl != "dense":
        _, idx, _ = TMOE.router_probs(tcfg.moe, convert.arch_params_from_jax(p, "cpu"),
                                      tx.reshape(-1, tcfg.d_model))
        _, keep = TMOE._queue_slots(idx, tcfg.moe.n_experts,
                                    TMOE._capacity(idx.shape[0], tcfg.moe))
        assert 0 < int((~keep).sum()) < keep.numel()  # some pairs drop, not all


@pytest.mark.parametrize("dtype", DTYPES)
def test_scatter_groups_match_reference(dtype, monkeypatch):
    """160 tokens in groups aiming at 16: 10 groups of 16, each with its own
    capacity max(16 x 2 x 1.25 / 4, 4) = 10, as the reference's
    ``REPRO_VARIANT=moe_groups=16``."""
    monkeypatch.setenv("REPRO_VARIANT", "moe_groups=16")
    monkeypatch.setattr(TMOE, "MOE_GROUPS", 16)
    assert TMOE._dispatch_group_count(160, TMOE.MOE_GROUPS) == 10
    for arch in ARCHS:
        _, _, _, got, want = _ffn_both(arch, "scatter", dtype, 1.25, 160)
        _close(got, want, dtype, atol=None if dtype == "float32" else 2e-2)


def test_scatter_equals_dense_without_drops():
    """With a capacity that holds every pair the scatter computes the dense
    oracle's function."""
    _, tcfg = _cfgs(DEEPSEEK, moe=dict(capacity_factor=2.0))  # 4 experts, top-2: cap = t
    p = convert.arch_params_from_jax(_moe_params(_cfgs(DEEPSEEK)[0], 8, "float32"), "cpu")
    x = torch.as_tensor(np.random.default_rng(8).normal(size=(3, 21, tcfg.d_model)),
                        dtype=torch.float32)
    out = {impl: TMOE.moe_ffn(dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, impl=impl)), p, x)[0] for impl in ("dense", "scatter", "dispatch")}
    np.testing.assert_allclose(out["scatter"].numpy(), out["dense"].numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out["dispatch"].numpy(), out["dense"].numpy(), rtol=RTOL,
                               atol=ATOL)


def test_scatter_gradients_match_reference():
    """The scatter's backward (a gather of the buffer's gradient, and the
    gathers' scatter back) against ``jax.grad``, with drops."""
    jcfg, tcfg = _cfgs(GRANITE, moe=dict(impl="scatter", capacity_factor=0.5))
    p = _moe_params(jcfg, 4, "float32")
    x = np.random.default_rng(4).normal(size=(2, 24, jcfg.d_model)).astype(np.float32)

    def jloss(pp, xx):
        out, aux = JMOE.moe_ffn(jcfg, pp, xx)
        return (out * jnp.sin(jnp.arange(out.size).reshape(out.shape))).sum() + aux

    jg = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = convert.arch_params_from_jax(p, "cpu")
    tx = torch.as_tensor(x).requires_grad_(True)
    leaves = [tp[k].requires_grad_(True) for k in sorted(tp)]
    out, aux = TMOE.moe_ffn(tcfg, tp, tx)
    loss = (out * torch.sin(torch.arange(out.numel(), dtype=torch.float32)
                            .reshape(out.shape))).sum() + aux
    grads = torch.autograd.grad(loss, leaves + [tx])
    for g, a in zip(grads, [jg[0][k] for k in sorted(tp)] + [jg[1]]):
        _close(g, a)


# ---------------------------------------------------------------------------
# granite-moe smoke end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    jcfg, tcfg = _cfgs(GRANITE)
    jp = _jinit(JM.init_params, jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp


def _batch(vocab: int, b: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    tgt = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    return ({"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt),
             "loss_mask": jnp.asarray(mask)},
            {"tokens": torch.as_tensor(tok, dtype=torch.int64),
             "targets": torch.as_tensor(tgt, dtype=torch.int64),
             "loss_mask": torch.as_tensor(mask)})


def test_init_params_bits_match_reference(granite):
    jcfg, tcfg, jp = granite
    got = TM.init_params(tcfg, prng.PRNGKey(0), "cpu")
    want = convert.arch_params_from_jax(jp, "cpu")
    for a, t in zip(tree_leaves(want), tree_leaves(got), strict=True):
        assert torch.equal(a, t)


@pytest.mark.parametrize("impl", ["dense", "scatter"])
def test_loss_and_grads_match_reference(granite, impl):
    """``loss_fn`` with the router's aux term and every leaf's gradient,
    through the dense oracle and through the scatter."""
    jcfg, tcfg, jp = granite
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, impl=impl))
                  for c in (jcfg, tcfg))
    jb, tb = _batch(jcfg.vocab, 2, 24, 7)
    (jloss, jmet), jgrad = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, jb),
                                              has_aux=True)(jax.tree.map(jnp.asarray, jp))
    tp = convert.arch_params_from_jax(jp, "cpu")
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tloss, tmet = TM.loss_fn(tcfg, tp, tb)
    grads = torch.autograd.grad(tloss, leaves)
    assert sorted(tmet) == sorted(jmet) == ["aux", "ce", "loss"]
    for name in jmet:
        _close(tmet[name], jmet[name])
    assert float(tmet["aux"].detach()) > 0
    _close(tmet["loss"], jmet["ce"] + jcfg.moe.router_aux_weight * jmet["aux"])
    for a, g in zip(jax.tree.leaves(jgrad), grads, strict=True):
        _close(g, a)


def test_decode_matches_reference(granite):
    """12 one-token steps at B=3 through the scatter (the full config's
    impl), against the reference's ``decode_step``."""
    jcfg, tcfg, jp = granite
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, impl="scatter"))
                  for c in (jcfg, tcfg))
    tp = convert.arch_params_from_jax(jp, "cpu")
    tok = np.random.default_rng(10).integers(0, jcfg.vocab, size=(12, 3)).astype(np.int32)
    jc = JM.init_cache(jcfg, 3, 16)
    tc = TM.init_cache(tcfg, 3, 16, device="cpu")
    serve = tsteps.make_serve_step(tcfg)
    for t in range(12):
        want, jc = JM.decode_step(jcfg, jax.tree.map(jnp.asarray, jp), jc,
                                  jnp.asarray(tok[t]), jnp.asarray(t, jnp.int32))
        got, tc = serve(tp, tc, torch.as_tensor(tok[t], dtype=torch.int64), t)
        _close(got, want)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

M_REPL, SEQ = 4, 16


def _params_close(want_tree, got_tree, dtype: str, label: str):
    for a, t in zip(jax.tree.leaves(want_tree), tree_leaves(got_tree), strict=True):
        assert str(t.dtype).split(".")[-1] == str(a.dtype), label
        want, got = _f32(a), _t32(t)
        # a bf16 model's fp32 router too: its gradient comes through the
        # model's bf16 arithmetic, which the two frameworks round apart
        if dtype == "bfloat16":
            floor = BF16_LEAF_ULPS * BF16_RTOL * float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=floor, err_msg=label)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=label)


@pytest.mark.parametrize("mix", ["dense", "neighbor"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_train_steps_match_reference(granite, dtype, mix):
    """Two EF-HC steps at m=4 on a ring with pods=2 through the scatter,
    against the reference's step jitted on a one-device host mesh: v and
    trigger_rate equal, loss, ce and aux within tolerance, the parameters
    and w_hat too; in bf16 the router leaves stay fp32 and go through the
    fp32 entries of the wrappers."""
    jcfg, tcfg, jp = granite
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype, moe=dataclasses.replace(
        c.moe, impl="scatter")) for c in (jcfg, tcfg))
    setup = tsteps.make_setup(tcfg, M_REPL, mix=mix, pods=2)
    n_par = tcfg.n_params
    jset = jsteps.TrainSetup(cfg=jcfg, mode=setup.mode, m=M_REPL,
                             adjacency=setup.adjacency, bandwidths=setup.bandwidths,
                             r=setup.r, alpha0=setup.alpha0, mix=mix)
    mesh = make_host_mesh(data=1, model=1)
    if mix == "neighbor":
        jstep = jsteps.make_train_step(
            jset, mesh, n_model_params=n_par,
            mix_override=lambda pm, w: jsteps.mix_neighbor_permute(
                pm, w, jconsensus.edge_coloring(setup.adjacency)))
        tstep = tsteps.make_neighbor_train_step(setup, n_model_params=n_par)
    else:
        jstep = jsteps.make_train_step(jset, mesh, n_model_params=n_par)
        tstep = tsteps.make_train_step(setup, n_model_params=n_par)
    jstep = jax.jit(jstep)
    with jax.threefry_partitionable(False):
        base = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    jparams = jax.tree.map(lambda a: jnp.stack([jnp.asarray(a)] * M_REPL), base)
    jh = jax.tree.map(jnp.copy, jparams)
    tp = convert.arch_params_from_jax(jax.device_get(jparams), "cpu")
    th = convert.arch_params_from_jax(jax.device_get(jh), "cpu")
    routers = [tp["stages"][0]["0_moe"]["ffn"]["router"]]
    assert routers[0].dtype == torch.float32
    stream = token_dataset(4000, vocab=jcfg.vocab, seed=0)
    iters = [lm_batches(s, 2, SEQ, seed=i)
             for i, s in enumerate(np.array_split(stream, M_REPL))]
    for k in range(2):
        per = [next(it) for it in iters]
        b = {n: np.stack([q[n] for q in per]) for n in per[0]}
        jparams, jh, jm = jstep(jparams, jh, {n: jnp.asarray(x) for n, x in b.items()},
                                jnp.asarray(k, jnp.int32))
        tp, th, tm = tstep(tp, th, {n: torch.as_tensor(x, dtype=torch.int64)
                                    for n, x in b.items()}, k)
        assert float(tm["trigger_rate"]) == float(jm["trigger_rate"])
        rtol = BF16_RTOL if dtype == "bfloat16" else RTOL
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=rtol, atol=ATOL)
        assert float(tm["aux"]) > 0 and float(tm["ce"]) > 0
        np.testing.assert_allclose(float(tm["loss"]), float(tm["ce"])
                                   + jcfg.moe.router_aux_weight * float(tm["aux"]),
                                   rtol=1e-6)
        _params_close(jparams, tp, dtype, f"params after step {k}")
        _params_close(jh, th, dtype, f"w_hat after step {k}")
    assert tp["stages"][0]["0_moe"]["ffn"]["router"] is routers[0]  # updated in place


# ---------------------------------------------------------------------------
# carrying the reference's trees across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_arch_params_from_jax_round_trips(arch):
    """Both architectures' bf16 smoke trees (3-D and 4-D expert stacks, the
    fp32 router, deepseek's ``mtp`` subtree): every leaf in its dtype,
    shape and bits; a cast to fp32 casts every leaf, one to
    bf16 keeps the routers fp32."""
    jcfg, _ = _cfgs(arch, dtype="bfloat16")
    jp = _jinit(JM.init_params, jcfg, jax.random.PRNGKey(1))
    tp = convert.arch_params_from_jax(jp, "cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    for (path, a), t in zip(jl, tree_leaves(tp), strict=True):
        name = jax.tree_util.keystr(path)
        assert str(t.dtype).split(".")[-1] == str(a.dtype), name
        assert tuple(t.shape) == a.shape, name
        np.testing.assert_array_equal(_t32(t), _f32(a), err_msg=name)
    moe_block = "0_moe" if arch == GRANITE else "0_mla_moe"
    stage = tp["stages"][0 if arch == GRANITE else 1][moe_block]["ffn"]
    assert stage["w_in"].dim() == 4 and stage["router"].dtype == torch.float32
    assert ("mtp" in tp) == (arch == DEEPSEEK)
    for a, t in zip(jax.tree.leaves(jp), tree_leaves(tp), strict=True):  # the bits
        words = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
        np.testing.assert_array_equal(t.view(words).numpy(),
                                      np.asarray(a).view(words == torch.int16 and np.int16
                                                         or np.int32))
    f32 = convert.arch_params_from_jax(jp, "cpu", torch.float32)
    assert all(t.dtype == torch.float32 for t in tree_leaves(f32))
    bf = convert.arch_params_from_jax(_jinit(JM.init_params, _cfgs(arch)[0],
                                             jax.random.PRNGKey(1)), "cpu", torch.bfloat16)
    assert {t.dtype for t in tree_leaves(bf)} == {torch.bfloat16, torch.float32}
    assert all((t.dtype == torch.float32) == (p[-1].key == "router") for (p, _), t in
               zip(jax.tree_util.tree_leaves_with_path(jp), tree_leaves(bf)))
