"""One EF-HC iteration of repro_torch against repro.core.efhc.step from
the same state (carried across with ``convert.state_from_jax``): every
mix impl under the EF-HC policy on svm, and every trigger policy under
``dense`` on mlp (whose flat rows are [b1 | b2 | w1 | w2]).  Integer and
bool outputs must be equal; float outputs agree at the golden tolerances
(rtol 2e-4, atol 2e-5)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import efhc as jefhc  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core import triggers as jtrig  # noqa: E402
from repro.data.partition import by_labels  # noqa: E402
from repro.data.synthetic import image_dataset  # noqa: E402
from repro.fl import modelspec as jspec  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import efhc as tefhc  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core import triggers as ttrig  # noqa: E402
from repro_torch.fl import modelspec as tspec  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

M, DIM, K, BATCH = 8, 24, 3, 8
RTOL, ATOL = 2e-4, 2e-5
CPU = torch.device("cpu")


def _run_both(mix_impl: str, policy: str, model: str):
    x, y = image_dataset(300, dim=DIM, seed=0)
    parts = by_labels(y, M, 3)
    rng = np.random.default_rng(5)
    ix = np.stack([rng.choice(p, BATCH) for p in parts])
    xb, yb = x[ix], y[ix]
    jgraph = jtopo.make_process(M, "rgg", time_varying="edge_dropout",
                                drop=0.3, seed=0)
    tgraph = ttopo.make_process(M, "rgg", time_varying="edge_dropout",
                                drop=0.3, seed=0)
    sparse = mix_impl in jefhc.SPARSE_MIX_IMPLS
    nl = jgraph.neighbors()
    spec = jspec.make_model_spec(model, dim=DIM, n_classes=10)
    alpha = jsched.paper_diminishing(0.1)(K)
    with jax.threefry_partitionable(False):
        k_bw, k_init, k_state = jax.random.split(jax.random.PRNGKey(0), 3)
        bw = jtrig.sample_bandwidths(k_bw, M)
        w_hat = spec.init_stack(k_init, M)
        # per-device deviations on both sides of the thresholds
        scale = np.logspace(-4.5, -1.8, M).astype(np.float32)
        w = {n: l + jnp.asarray(
                 scale.reshape((M,) + (1,) * (l.ndim - 1))
                 * rng.normal(size=l.shape).astype(np.float32))
             for n, l in w_hat.items()}
        prev = (jgraph.adjacency_ell(K - 1, nl) if sparse
                else jgraph.adjacency(K - 1))
        jstate = jefhc.EFHCState(w=w, w_hat=w_hat, k=jnp.asarray(K, jnp.int32),
                                 prev_adj=prev, bandwidths=bw, key=k_state,
                                 opt_state=())
        cfg = jefhc.EFHCConfig(trigger=jtrig.TriggerConfig(policy=policy),
                               mix_impl=mix_impl, interpret=True)
        step = jax.jit(lambda st, b: jefhc.step(
            cfg, jgraph, st, grad_fn=spec.grad_fn, batch=b, alpha_k=alpha,
            model_dim=spec.flat_dim, nl=nl))
        jnew, jaux = jax.device_get(step(jstate, (jnp.asarray(xb),
                                                  jnp.asarray(yb))))

    tstate = convert.state_from_jax(jax.device_get(jstate), CPU, opt_state=())
    tcfg = tefhc.EFHCConfig(trigger=ttrig.TriggerConfig(policy=policy),
                            mix_impl=mix_impl)
    tm = tspec.make_model_spec(model, dim=DIM, n_classes=10)
    tnl = ttopo.StagedNeighbors.from_host(nl, CPU) if sparse else None
    tnew, taux = tefhc.step(
        tcfg, tgraph, tstate, loss_and_grad=tm.loss_and_grad,
        batch=(torch.as_tensor(xb), torch.as_tensor(yb, dtype=torch.int64)),
        alpha_k=torch.tensor(np.asarray(alpha)), model_dim=tm.flat_dim,
        nl=tnl)
    return jnew, jaux, tnew, taux


def _check(jnew, jaux, tnew, taux):
    for f in ("v", "comm", "adj", "comm_count", "deg"):
        assert np.array_equal(getattr(taux, f).numpy(),
                              np.asarray(getattr(jaux, f))), f
    for f in ("p", "loss", "tx_time", "util", "consensus_err"):
        np.testing.assert_allclose(getattr(taux, f).numpy(),
                                   np.asarray(getattr(jaux, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    for tree in ("w", "w_hat"):
        got = convert.params_to_numpy(getattr(tnew, tree))
        want = getattr(jnew, tree)
        assert sorted(got) == sorted(want)
        for n in want:
            np.testing.assert_allclose(got[n], np.asarray(want[n]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{tree}[{n}]")
    assert np.array_equal(tnew.prev_adj.numpy(), np.asarray(jnew.prev_adj))
    assert np.array_equal(tnew.key.numpy(),
                          np.asarray(jnew.key).astype(np.int64))
    assert int(tnew.k) == int(jnew.k) == K + 1


@pytest.mark.parametrize("mix_impl", jefhc.MIX_IMPLS)
def test_step_matches_reference_per_mix_impl(mix_impl):
    jnew, jaux, tnew, taux = _run_both(mix_impl, "efhc", "svm")
    v = np.asarray(jaux.v)
    assert 0 < v.sum() < M  # some devices fire, some do not
    _check(jnew, jaux, tnew, taux)


@pytest.mark.parametrize("policy", jtrig.POLICIES)
def test_step_matches_reference_per_policy(policy):
    _check(*_run_both("dense", policy, "mlp"))


def test_flatten_order_is_sorted_leaf_order():
    w = {"w1": torch.full((2, 3, 2), 4.0), "b2": torch.full((2, 1), 2.0),
         "b1": torch.full((2, 2), 1.0), "w2": torch.full((2, 2, 1), 3.0)}
    flat = tefhc.flatten_stack(w)
    assert flat[0].tolist() == [1, 1, 2] + [4] * 6 + [3, 3]
    back = tefhc.unflatten_stack(flat, w)
    assert all(torch.equal(back[n], w[n]) for n in w)


def test_paper_schedule_matches_reference():
    k = np.arange(2000)
    want = np.asarray(jsched.paper_diminishing(0.1)(jnp.asarray(k)))
    got = tsched.paper_diminishing(0.1)(torch.as_tensor(k)).numpy()
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 1


def test_constant_schedule_matches_reference():
    k = torch.arange(5)
    got = tsched.constant(0.05)(k)
    assert got.dtype == torch.float32 and tuple(got.shape) == (5,)
    assert np.all(got.numpy() == np.asarray(jsched.constant(0.05)(0)))


@pytest.mark.parametrize("name", jopt.OPT_NAMES)
def test_optimizer_updates_match_reference(name):
    """Three Event-4 updates of every optimizer on a stacked dict."""
    rng = np.random.default_rng(1)
    params = {"b": rng.normal(size=(4, 3)).astype(np.float32),
              "w": rng.normal(size=(4, 5, 3)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jo, to = jopt.init_opt(name), topt.init_opt(name)
    jp, tp = dict(params), convert.params_from_jax(params, CPU)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(g, js, jp, jnp.float32(0.05))
        tp, ts = to.update(convert.params_from_jax(g, CPU), ts, tp,
                           torch.tensor(0.05))
    got = convert.params_to_numpy(tp)
    for k in params:
        np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
