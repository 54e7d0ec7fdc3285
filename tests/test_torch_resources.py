"""repro_torch's resource dynamics (churn, stragglers, budgets, the
bandwidth walk) against the JAX package on the CPU: the resource process
step by step on the same keys, the golden m = 8 run with resources on
under every single-device impl, and the seeds x policies sweep, each
cell against the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import resources as jres  # noqa: E402
from repro.core.topology import make_process as jmake_process  # noqa: E402
from repro.data.loader import FederatedBatches as JBatches  # noqa: E402
from repro.data.partition import by_labels as jby_labels  # noqa: E402
from repro.data.synthetic import image_dataset as jimage_dataset  # noqa: E402
from repro.fl import simulator as jsim  # noqa: E402
from repro.fl.sweep import run_sweep as jrun_sweep  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import resources as tres  # noqa: E402
from repro_torch.core.accounting import model_bytes  # noqa: E402
from repro_torch.core.topology import make_process  # noqa: E402
from repro_torch.data.loader import FederatedBatches  # noqa: E402
from repro_torch.data.partition import by_labels  # noqa: E402
from repro_torch.data.synthetic import image_dataset  # noqa: E402
from repro_torch.fl import simulator as tsim  # noqa: E402
from repro_torch.fl.sweep import run_sweep  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
# jax.random.normal is held to 2 ulp (tests/test_torch_prng.py), and the
# walk's log/exp round on top of it: a few fp32 ulp of the bandwidth
BW_RTOL = 2e-6
IMPLS = ("dense", "pallas", "sparse", "sparse_pallas")
INT_CHANNELS = ("v", "comm_count", "deg", "down_count", "exhausted_count",
                "fault_down_count", "stale_max", "window_connected",
                "window_needed")
FLOAT_CHANNELS = ("loss", "acc", "tx_time", "util", "consensus_err")
M, T, DIM = 8, 18, 24  # the golden run's shape
# every resource mechanism at once; the budget runs out within the run
RESOURCES = dict(churn_rate=0.2, recover_rate=0.5, straggle_rate=0.2,
                 bw_walk=0.3, budget_bytes=float(3 * model_bytes(DIM * 10 + 10)))


def assert_same_run(got, want, label=""):
    """Integer channels and link matrices equal, floats within the golden
    tolerances."""
    np.testing.assert_allclose(got.bandwidths, want.bandwidths, rtol=1e-6)
    for f in INT_CHANNELS:
        assert np.array_equal(np.asarray(getattr(got, f)),
                              np.asarray(getattr(want, f))), f"{label}: {f}"
    if got.trace != "summary":
        assert np.array_equal(got.comm, want.comm), f"{label}: comm"
        assert np.array_equal(got.adj, want.adj), f"{label}: adj"
    for f in FLOAT_CHANNELS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{label}: {f}")


def _golden(mod, make, Batches, by, images, **sim_kw):
    x, y = images(600, seed=0, dim=DIM)
    parts = by(y, M, 3)
    graph = make(M, "rgg", time_varying="edge_dropout", drop=0.3, seed=0)
    sim = mod.SimConfig(**{**dict(m=M, iters=T, dim=DIM, batch=8, r=50.0, seed=0),
                           **sim_kw})
    return sim, graph, Batches(x, y, parts, sim.batch, seed=2)


def golden_ref(**sim_kw):
    sim, graph, batches = _golden(jsim, jmake_process, JBatches, jby_labels,
                                  jimage_dataset, **sim_kw)
    with jax.threefry_partitionable(False):
        return jsim.run(sim, graph, batches, None, eval_every=5)


def golden_port(**sim_kw):
    sim, graph, batches = _golden(tsim, make_process, FederatedBatches, by_labels,
                                  image_dataset, **sim_kw)
    return tsim.run(sim, graph, batches, None, eval_every=5, device="cpu")


@pytest.fixture(scope="module")
def ref_runs():
    return {impl: golden_ref(mix_impl=impl, trace="full", **RESOURCES)
            for impl in IMPLS}


@pytest.mark.parametrize("impl", IMPLS)
def test_golden_run_with_resources_matches_reference(ref_runs, impl):
    want = ref_runs[impl]
    got = golden_port(mix_impl=impl, trace="full", **RESOURCES)
    assert_same_run(got, want, impl)
    # every mechanism is at work in this pin
    assert got.down_count.max() > 0 and got.exhausted_count.max() > 0
    assert got.adj.shape == (T, M, M)


def test_packed_trace_under_resources_equals_full(ref_runs):
    got = golden_port(mix_impl="sparse_pallas", trace="packed", **RESOURCES)
    assert got._adj.dtype == np.uint32
    assert_same_run(got, ref_runs["sparse_pallas"], "packed")


@pytest.mark.parametrize("kw", [
    dict(churn_rate=1.5), dict(churn_rate=-0.1), dict(recover_rate=2.0),
    dict(straggle_rate=-1.0), dict(bw_revert=1.5), dict(bw_walk=-0.5),
    dict(budget_bytes=-1.0)])
def test_resource_config_messages_match_reference(kw):
    with pytest.raises(ValueError) as want:
        jres.ResourceConfig(**kw)
    with pytest.raises(ValueError) as got:
        tres.ResourceConfig(**kw)
    assert str(got.value) == str(want.value)


def test_enabled_and_sim_config_knobs_match_reference():
    for kw in ({}, dict(recover_rate=0.9), dict(bw_revert=0.7),
               dict(churn_rate=0.1), dict(straggle_rate=0.1), dict(bw_walk=0.1),
               dict(budget_bytes=1.0)):
        assert tres.ResourceConfig(**kw).enabled == jres.ResourceConfig(**kw).enabled
    knobs = dict(churn_rate=0.1, budget_bytes=5.0)
    assert tsim.SimConfig(**knobs).resources() == tres.ResourceConfig(**knobs)
    assert tsim.SimConfig().resources() is None


def _jkey(seed):
    with jax.threefry_partitionable(False):
        return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_resource_key_matches_reference(seed):
    cfg = jres.ResourceConfig(churn_rate=0.1, seed=seed % 5)
    with jax.threefry_partitionable(False):
        want = np.asarray(jres.resource_key(_jkey(seed), cfg))
    got = tres.resource_key(prng.PRNGKey(seed), tres.ResourceConfig(
        churn_rate=0.1, seed=seed % 5))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    # a batch of roots folds each root alone
    roots = torch.stack([prng.PRNGKey(s) for s in (seed, seed + 1)])
    assert np.array_equal(tres.resource_key(roots, tres.ResourceConfig())[0].numpy(),
                          np.asarray(jres.resource_key(
                              _jkey(seed), jres.ResourceConfig())).astype(np.int64))


@pytest.mark.parametrize("m", [64, 4096])
def test_evolve_matches_reference_over_steps(m):
    """Churn and straggle are uniform draws (bit-equal); the walk's normal
    draws hold to a few ulp.  Eight steps, each from the reference's own
    state so drift cannot build up."""
    kw = dict(churn_rate=0.3, recover_rate=0.4, straggle_rate=0.25, bw_walk=0.5,
              bw_revert=0.2)
    jcfg, tcfg = jres.ResourceConfig(**kw), tres.ResourceConfig(**kw)
    rng = np.random.default_rng(m)
    bw0 = rng.uniform(500.0, 9500.0, m).astype(np.float32)
    up = rng.uniform(size=m) < 0.8
    bw = bw0.copy()
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(m)
        for _ in range(8):
            key, k = jax.random.split(key)
            j_up, j_st, j_bw = jres.evolve(jcfg, k, jnp.asarray(up), jnp.asarray(bw),
                                           jnp.asarray(bw0), m)
            t_up, t_st, t_bw = tres.evolve(
                tcfg, torch.as_tensor(np.array(k), dtype=torch.int64),
                torch.as_tensor(up), torch.as_tensor(bw), torch.as_tensor(bw0), m)
            assert np.array_equal(t_up.numpy(), np.asarray(j_up))
            assert np.array_equal(t_st.numpy(), np.asarray(j_st))
            np.testing.assert_allclose(t_bw.numpy(), np.asarray(j_bw), rtol=BW_RTOL)
            up, bw = np.array(j_up), np.array(j_bw)
    assert (bw >= 1e-3 * bw0 * (1 - 1e-6)).all()  # the walk's floor


def test_evolve_rows_slice_the_fleet_stream():
    cfg = tres.ResourceConfig(churn_rate=0.3, straggle_rate=0.3, bw_walk=0.2)
    m = 40
    key = prng.PRNGKey(3)
    up = torch.ones(m, dtype=torch.bool)
    bw = torch.full((m,), 5000.0)
    full = tres.evolve(cfg, key, up, bw, bw, m)
    rows = torch.tensor([2, 9, 31])
    part = tres.evolve(cfg, key, up[rows], bw[rows], bw[rows], m, rows=rows)
    for a, b in zip(full, part):
        assert torch.equal(a[rows], b)


def test_exhausted_mask_and_init_state_match_reference():
    budget = np.array([5.0, 0.0, -3.0, np.inf], np.float32)
    for b in (0.0, 10.0):
        jm = jres.exhausted_mask(jres.ResourceConfig(budget_bytes=b), jnp.asarray(budget))
        tm = tres.exhausted_mask(tres.ResourceConfig(budget_bytes=b),
                                 torch.as_tensor(budget))
        assert np.array_equal(tm.numpy(), np.asarray(jm))
    bw0 = np.array([[100.0, 200.0, 300.0]], np.float32)
    for b in (0.0, 64.0):
        t0 = tres.init_state(tres.ResourceConfig(budget_bytes=b), torch.as_tensor(bw0),
                             prng.PRNGKey(0)[None])
        j0 = jres.init_state(jres.ResourceConfig(budget_bytes=b), jnp.asarray(bw0[0]),
                             _jkey(0))
        assert np.array_equal(t0.budget[0].numpy(), np.asarray(j0.budget))
        assert t0.up.all() and torch.equal(t0.bw, torch.as_tensor(bw0))


SWEEP_POLICIES = ("efhc", "zero", "gossip")


@pytest.fixture(scope="module")
def sweep_pair():
    kw = dict(mix_impl="pallas", trace="full", iters=12, **RESOURCES)

    def grid(mod, make, Batches, by, images, sweep, **run_kw):
        sim, graph, _ = _golden(mod, make, Batches, by, images, **kw)
        x, y = images(600, seed=0, dim=DIM)
        parts = by(y, M, 3)
        return sweep(sim, graph, lambda s: Batches(x, y, parts, sim.batch, seed=2 + s),
                     None, seeds=(0, 1), policies=SWEEP_POLICIES, eval_every=5,
                     **run_kw)

    with jax.threefry_partitionable(False):
        want = grid(jsim, jmake_process, JBatches, jby_labels, jimage_dataset,
                    jrun_sweep)
    got = grid(tsim, make_process, FederatedBatches, by_labels, image_dataset,
               run_sweep, device="cpu")
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_under_resources_matches_reference(sweep_pair, seed):
    got, want = sweep_pair
    for f in ("down_count", "exhausted_count", "window_connected"):
        assert getattr(got, f).shape == (2, len(SWEEP_POLICIES), 12)
    for pol in SWEEP_POLICIES:
        assert_same_run(got.result(seed, pol), want.result(seed, pol),
                        f"seed {seed} {pol}")
    # the cells' adjacencies differ under churn: the grid keeps one per cell
    assert not np.array_equal(got.adj[0, 0], got.adj[1, 0])
