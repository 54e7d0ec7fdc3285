"""repro_torch's fault injection (cluster outages, the scripted bridge
partition, flapping links, crash/rejoin with warm start) against the JAX
package on the CPU: the fault fabric with native and Morton-fallback
labels, its dense and ELL tables, ``edge_keep`` and the Markov chains on
the same keys, the golden m = 8 run with faults on under every
single-device impl, a clustered fleet, and the scenario service under
dynamics, each cell against the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from test_torch_resources import IMPLS, assert_same_run, golden_port, golden_ref  # noqa: E402

FAULTS = dict(crash_rate=0.2, rejoin_rate=0.3, cluster_fail_rate=0.1,
              warm_start=True)
EDGE_FAULTS = dict(partition_start=3, partition_len=4, flap_rate=0.3, flap_len=2)
# a knob set per family of mechanisms
FAMILIES = {"faults": FAULTS, "edges": EDGE_FAULTS}


@pytest.fixture(scope="module")
def ref_runs():
    return {(fam, impl): golden_ref(mix_impl=impl, trace="full", **kw)
            for fam, kw in FAMILIES.items() for impl in IMPLS}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_golden_run_with_faults_matches_reference(ref_runs, family, impl):
    got = golden_port(mix_impl=impl, trace="full", **FAMILIES[family])
    assert_same_run(got, ref_runs[(family, impl)], f"{family} {impl}")
    if family == "faults":
        assert got.fault_down_count.max() > 0 and got.stale_max.max() > 0


@pytest.mark.parametrize("kw", [
    dict(cluster_fail_rate=1.5), dict(flap_rate=-0.1), dict(crash_rate=2.0),
    dict(rejoin_rate=-1.0), dict(cluster_recover_rate=3.0),
    dict(partition_len=-1), dict(flap_len=0)])
def test_fault_config_messages_match_reference(kw):
    with pytest.raises(ValueError) as want:
        jfaults.FaultConfig(**kw)
    with pytest.raises(ValueError) as got:
        tfaults.FaultConfig(**kw)
    assert str(got.value) == str(want.value)


def _graphs(topology, m, seed):
    return (jtopo.make_process(m, topology, time_varying="edge_dropout", drop=0.3,
                               seed=seed),
            ttopo.make_process(m, topology, time_varying="edge_dropout", drop=0.3,
                               seed=seed))


# clustered carries native labels; rgg falls back to Morton blocks over its
# coords, ring to contiguous id blocks
FABRICS = [("clustered", 40), ("rgg", 30), ("rgg", 300), ("ring", 16)]


@pytest.mark.parametrize("topology,m", FABRICS)
def test_fault_fabric_matches_reference(topology, m):
    jg, tg = _graphs(topology, m, 1)
    for kw in (dict(cluster_fail_rate=0.1), dict(flap_rate=0.4, seed=3)):
        want = jfaults.fault_fabric(jg, jfaults.FaultConfig(**kw))
        got = tfaults.fault_fabric(tg, tfaults.FaultConfig(**kw))
        assert got.n_clusters == want.n_clusters >= 2
        for name in ("labels", "cross", "flap", "phase"):
            assert np.array_equal(getattr(got, name), getattr(want, name)), name
    if tg.coords is not None:
        assert np.array_equal(ttopo._morton_codes(tg.coords),
                              jtopo._morton_codes(jg.coords))


@pytest.mark.parametrize("topology,m", FABRICS[:2])
def test_edge_tables_and_edge_keep_match_reference(topology, m):
    jg, tg = _graphs(topology, m, 0)
    kw = dict(partition_start=5, partition_len=3, flap_rate=0.4, flap_len=2)
    jcfg, tcfg = jfaults.FaultConfig(**kw), tfaults.FaultConfig(**kw)
    jfab, tfab = jfaults.fault_fabric(jg, jcfg), tfaults.fault_fabric(tg, tcfg)
    assert np.array_equal(tg.edges.eids(), jg.edges.eids())
    nl = tg.neighbors()
    rows = np.asarray([3, 11, m - 1])
    for jt, tt in ((jfaults.edge_tables_dense(jfab, jg.edges),
                    tfaults.edge_tables_dense(tfab, tg.edges)),
                   (jfaults.edge_tables_rows(jfab, jg.edges, nl.idx, nl.mask),
                    tfaults.edge_tables_rows(tfab, tg.edges, nl.idx, nl.mask)),
                   (jfaults.edge_tables_rows(jfab, jg.edges, nl.idx[rows],
                                             nl.mask[rows], rows=rows),
                    tfaults.edge_tables_rows(tfab, tg.edges, nl.idx[rows],
                                             nl.mask[rows], rows=rows))):
        for name in ("labels", "cross", "flap", "phase"):
            assert np.array_equal(getattr(tt, name).numpy(),
                                  np.asarray(getattr(jt, name))), name
        for k in (0, 4, 5, 7, 8, 9, 20):
            assert np.array_equal(
                tfaults.edge_keep(tcfg, torch.tensor(k), tt).numpy(),
                np.asarray(jfaults.edge_keep(jcfg, jnp.asarray(k), jt))), k


@pytest.mark.parametrize("m", [24, 1000])
def test_evolve_and_device_up_match_reference(m):
    kw = dict(crash_rate=0.3, rejoin_rate=0.4, cluster_fail_rate=0.3,
              cluster_recover_rate=0.5)
    jcfg, tcfg = jfaults.FaultConfig(**kw), tfaults.FaultConfig(**kw)
    rng = np.random.default_rng(m)
    n_cl = 5
    labels = rng.integers(0, n_cl, m)
    crashed = rng.uniform(size=m) < 0.3
    stale = np.where(crashed, rng.integers(1, 6, m), 0).astype(np.int32)
    cdown = np.zeros(n_cl, bool)
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(m)
        for _ in range(6):
            key, k = jax.random.split(key)
            want = jfaults.evolve(jcfg, k, jnp.asarray(crashed), jnp.asarray(stale),
                                  jnp.asarray(cdown), m)
            got = tfaults.evolve(tcfg, torch.as_tensor(np.array(k), dtype=torch.int64),
                                 torch.as_tensor(crashed), torch.as_tensor(stale),
                                 torch.as_tensor(cdown), m)
            for a, b in zip(got, want):
                assert np.array_equal(a.numpy(), np.asarray(b))
            up_want = jfaults.device_up(want[0], want[3], jnp.asarray(labels))
            up_got = tfaults.device_up(got[0], got[3], torch.as_tensor(labels))
            assert np.array_equal(up_got.numpy(), np.asarray(up_want))
            crashed, stale, cdown = (np.array(want[0]), np.array(want[2]),
                                     np.array(want[3]))
    assert stale.max() > 0


def test_fault_key_matches_reference():
    with jax.threefry_partitionable(False):
        want = jfaults.fault_key(jax.random.PRNGKey(5), jfaults.FaultConfig(seed=2))
    got = tfaults.fault_key(prng.PRNGKey(5), tfaults.FaultConfig(seed=2))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_clustered_fleet_with_every_fault_matches_reference():
    """A clustered fabric (native labels) at m=24 with every mechanism on,
    the watchdog included, under the dense kernel path."""
    kw = dict(m=24, topology="clustered", dim=16, n_classes=4, n_train=480,
              n_test=80, iters=16, eval_every=4, batch=8, trace="full",
              mix_impl="pallas", policy="zero", **FAULTS, **EDGE_FAULTS,
              watchdog_window=4)
    with jax.threefry_partitionable(False):
        want = japi.simulate(japi.ScenarioSpec(**kw))
    got = tapi.simulate(tapi.ScenarioSpec(**kw), device="cpu")
    assert_same_run(got, want, "clustered")
    assert not got.window_connected[3:7].all()  # the partition window
    np.testing.assert_array_equal(got.v.sum(axis=1) + got.fault_down_count, 24)


SERVE_KW = dict(m=8, dim=16, n_train=320, n_test=80, iters=12, eval_every=4,
                batch=8, crash_rate=0.15, rejoin_rate=0.3, cluster_fail_rate=0.1,
                flap_rate=0.2, partition_start=4, partition_len=3, warm_start=True,
                watchdog_window=4, churn_rate=0.1, budget_bytes=2000.0,
                trace="full")


@pytest.fixture(scope="module")
def serve_pair():
    specs = [dict(SERVE_KW, policy="efhc", seeds=(0, 1)),
             dict(SERVE_KW, policy="gossip", seeds=(2,)),
             dict(SERVE_KW, policy="zero", seeds=(0,), mix_impl="sparse_pallas")]
    with jax.threefry_partitionable(False):
        want = japi.serve([japi.ScenarioSpec(**kw) for kw in specs], max_cells=4)
    got = tapi.serve([tapi.ScenarioSpec(**kw) for kw in specs], max_cells=4,
                     device="cpu")
    return got, want


def test_serve_under_dynamics_matches_reference(serve_pair):
    got, want = serve_pair
    assert [r.ok for r in got] == [True] * 3
    # the two dense-impl requests share one launch, the sparse one its own
    assert got[0].launch_id == got[1].launch_id != got[2].launch_id
    for g, w in zip(got, want):
        assert set(g.results) == set(w.results)
        for s in g.results:
            assert_same_run(g.results[s], w.results[s], f"request {g.request_id} seed {s}")


def test_serve_dynamics_fields_shape_the_signature():
    a = tapi.ScenarioSpec(**SERVE_KW)
    b = tapi.ScenarioSpec(**{**SERVE_KW, "crash_rate": 0.3})
    assert a.signature() != b.signature()
    sim = a.to_sim()
    assert sim.faults().crash_rate == 0.15 and sim.watchdog().window == 4
    assert sim.resources().budget_bytes == 2000.0
