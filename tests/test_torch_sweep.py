"""repro_torch's sweep layer on the CPU: the seeds x policies grid as one
batched run against the reference's ``repro.api.sweep`` (run in the
non-partitionable threefry mode) for the dense, pallas, sparse and
sparse_pallas impls, every cell against the port's own solo run, the
trace modes, ``SweepResult`` slicing, the AUC and transmission accounting
and ``baselines.compare`` against the reference, and the same-dataset
check.  Integer and bool channels must be equal; float channels agree at
the golden tolerances (rtol 2e-4, atol 2e-5): the reference's own
sweep-vs-service check is 1 ULP off on this jax, so floats are held to a
tolerance, not to bits."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import accounting as jacc  # noqa: E402
from repro.core.topology import make_process as jmake_process  # noqa: E402
from repro.data.loader import FederatedBatches as JBatches  # noqa: E402
from repro.fl import baselines as jbase  # noqa: E402
from repro.fl import simulator as jsim  # noqa: E402
from repro.fl import sweep as jsweep  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import accounting as tacc  # noqa: E402
from repro_torch.core.topology import make_process  # noqa: E402
from repro_torch.data.loader import FederatedBatches  # noqa: E402
from repro_torch.data.partition import by_labels  # noqa: E402
from repro_torch.data.synthetic import image_dataset  # noqa: E402
from repro_torch.fl import baselines as tbase  # noqa: E402
from repro_torch.fl import simulator as tsim  # noqa: E402
from repro_torch.fl import sweep as tsweep  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
SEEDS = (0, 1)
POLICIES = ("efhc", "zero", "global", "gossip")
INT_FIELDS = ("v", "comm_count", "deg")
FLOAT_FIELDS = ("loss", "tx_time", "util", "consensus_err", "acc")
DYN_FIELDS = ("down_count", "exhausted_count", "fault_down_count",
              "stale_max", "window_connected", "window_needed")
# per mix impl: the model and trace mode its grid runs (every impl, both
# models and every trace mode are covered)
CASES = {"dense": ("svm", "full"), "pallas": ("mlp", "packed"),
         "sparse": ("mlp", "summary"), "sparse_pallas": ("svm", "full")}


def _spec_kw(mix_impl: str, **over) -> dict:
    model, trace = CASES[mix_impl]
    kw = dict(m=12, model=model, dim=32, n_train=600, n_test=120, iters=16,
              eval_every=5, trace=trace, labels_per_device=2, r=30.0,
              mix_impl=mix_impl, seeds=SEEDS)
    kw.update(over)
    return kw


@functools.lru_cache(maxsize=None)
def _ref_sweep(mix_impl: str):
    with jax.threefry_partitionable(False):
        return japi.sweep(japi.ScenarioSpec(**_spec_kw(mix_impl)), seeds=SEEDS)


@functools.lru_cache(maxsize=None)
def _port_sweep(mix_impl: str):
    return tapi.sweep(tapi.ScenarioSpec(**_spec_kw(mix_impl)), seeds=SEEDS,
                      device="cpu")


def _assert_channels(got, want, links: bool):
    for f in INT_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    np.testing.assert_allclose(got.bandwidths, want.bandwidths, rtol=1e-6)
    for f in DYN_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    if links:
        assert np.array_equal(got.comm, want.comm)
        assert np.array_equal(got.adj, want.adj)


@pytest.mark.parametrize("mix_impl", list(CASES))
def test_api_sweep_matches_reference(mix_impl):
    want, got = _ref_sweep(mix_impl), _port_sweep(mix_impl)
    assert got.seeds == want.seeds and got.policies == want.policies == POLICIES
    assert got.model_dim == want.model_dim and got.trace == want.trace
    assert got.v.shape == want.v.shape == (2, 4, 16, 12)
    _assert_channels(got, want, links=CASES[mix_impl][1] != "summary")
    efhc = got.v[:, POLICIES.index("efhc")]
    assert 0 < efhc.sum() < efhc.size  # the trigger really gates
    assert got.v[:, POLICIES.index("zero")].all()


@pytest.mark.parametrize("mix_impl", list(CASES))
def test_run_sweep_matches_reference(mix_impl):
    """``run_sweep`` on a graph and samplers built by hand (rgg with
    partition cycles, no eval, three policies in another order, seeds
    (2, 0)) against the reference's on the same inputs."""
    model, trace = CASES[mix_impl]
    x, y = image_dataset(500, seed=3, dim=24)
    parts = by_labels(y, 10, 2)
    sim_kw = dict(m=10, model=model, dim=24, iters=13, r=40.0, batch=8,
                  mix_impl=mix_impl, trace=trace)
    policies, seeds = ("gossip", "efhc", "global"), (2, 0)
    with jax.threefry_partitionable(False):
        want = jsweep.run_sweep(
            jsim.SimConfig(**sim_kw),
            jmake_process(10, "rgg", time_varying="partition_cycle", cycle_len=3, seed=1),
            lambda s: JBatches(x, y, parts, 8, seed=5 + s), None,
            seeds=seeds, policies=policies, eval_every=4)
    got = tsweep.run_sweep(
        tsim.SimConfig(**sim_kw),
        make_process(10, "rgg", time_varying="partition_cycle", cycle_len=3, seed=1),
        lambda s: FederatedBatches(x, y, parts, 8, seed=5 + s), None,
        seeds=seeds, policies=policies, eval_every=4, device="cpu")
    assert got.policies == policies and got.seeds == seeds
    _assert_channels(got, want, links=trace != "summary")
    assert not got.acc.any()  # no eval_fn: accuracy stays zero


@pytest.mark.parametrize("mix_impl", list(CASES))
def test_every_cell_equals_its_solo_run(mix_impl):
    """Each cell of the batched run is its solo ``api.simulate`` run:
    integer, bool and link channels and the bandwidth draw equal, floats
    within the golden tolerances (a reduction over a (C, m, D) tensor may
    split its work otherwise than over a (1, m, D) one, so
    ``consensus_err`` can move by an ulp)."""
    grid = _port_sweep(mix_impl)
    spec = tapi.ScenarioSpec(**_spec_kw(mix_impl))
    for s in SEEDS:
        for p in POLICIES:
            solo = tapi.simulate(dataclasses.replace(spec, policy=p), seed=s,
                                 device="cpu")
            cell = grid.result(s, p)
            for f in (*INT_FIELDS, "bandwidths", *DYN_FIELDS):
                assert np.array_equal(getattr(cell, f), getattr(solo, f)), (s, p, f)
            for f in FLOAT_FIELDS:
                np.testing.assert_allclose(getattr(cell, f), getattr(solo, f),
                                           rtol=RTOL, atol=ATOL, err_msg=f"{s} {p} {f}")
            if spec.trace != "summary":
                assert np.array_equal(cell.comm, solo.comm), (s, p)
                assert np.array_equal(cell.adj, solo.adj), (s, p)


def test_packed_and_summary_traces_equal_full():
    full = _port_sweep("sparse_pallas")
    kw = _spec_kw("sparse_pallas")
    packed = tapi.sweep(tapi.ScenarioSpec(**{**kw, "trace": "packed"}),
                        seeds=SEEDS, device="cpu")
    summary = tapi.sweep(tapi.ScenarioSpec(**{**kw, "trace": "summary"}),
                         seeds=SEEDS, device="cpu")
    assert packed._comm.dtype == np.uint32 and packed._comm.shape == (2, 4, 16, 12, 1)
    assert np.array_equal(packed.comm, full.comm)
    assert np.array_equal(packed.adj, full.adj)
    for f in (*INT_FIELDS, *FLOAT_FIELDS):
        assert np.array_equal(getattr(packed, f), getattr(full, f)), f
        assert np.array_equal(getattr(summary, f), getattr(full, f)), f
    assert np.array_equal(full.comm.sum(-1), full.comm_count)
    with pytest.raises(ValueError, match="summary"):
        summary.comm
    with pytest.raises(ValueError, match="summary"):
        summary.result(0, "efhc").adj


def test_result_slices_one_cell():
    grid = _port_sweep("dense")
    for si, s in enumerate(SEEDS):
        for pi, p in enumerate(POLICIES):
            r = grid.result(s, p)
            assert isinstance(r, tsim.SimResult) and r.trace == "full"
            assert np.array_equal(r.v, grid.v[si, pi])
            assert np.array_equal(r.loss, grid.loss[si, pi])
            assert np.array_equal(r.comm, grid.comm[si, pi])
            assert np.array_equal(r.bandwidths, grid.bandwidths[si, pi])
            assert np.array_equal(r.cum_tx_time, grid.cum_tx_time[si, pi])
            assert r.m == grid.m == 12 and r.model_dim == grid.model_dim
    # the policy axis shares bandwidths; seeds draw their own
    assert np.array_equal(grid.bandwidths[:, 0], grid.bandwidths[:, 3])
    assert not np.array_equal(grid.bandwidths[0, 0], grid.bandwidths[1, 0])
    with pytest.raises(ValueError):
        grid.result(7, "efhc")


def test_auc_and_accounting_match_reference():
    want, got = _ref_sweep("dense"), _port_sweep("dense")
    # the same arrays through both: the port's copies compute the same
    for s in range(len(SEEDS)):
        for p in range(len(POLICIES)):
            acc, cum = want.acc[s, p], want.cum_tx_time[s, p]
            for budget in (0.5 * cum[-1], cum[-1], 2.0 * cum[-1]):
                assert tsweep.acc_per_tx_auc(acc, cum, budget) == \
                    jsweep.acc_per_tx_auc(acc, cum, budget)
    # the port's results through the port against the reference's through
    # the reference
    jt, tt = jsweep.policy_auc_table(want), tapi.policy_auc_table(got)
    assert sorted(jt) == sorted(tt) == sorted(POLICIES)
    for p in POLICIES:
        np.testing.assert_allclose(tt[p], jt[p], rtol=RTOL, atol=ATOL, err_msg=p)
    for s in SEEDS:
        for p in POLICIES:
            jr, tr = want.result(s, p), got.result(s, p)
            ja, ta = jacc.tx_summary_from_result(jr), tapi.tx_summary_from_result(tr)
            assert isinstance(ta, tapi.TxSummary)
            jd, td = ja.as_dict(), ta.as_dict()
            assert sorted(jd) == sorted(td)
            for k in jd:
                np.testing.assert_allclose(td[k], jd[k], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{s} {p} {k}")
            js = jacc.report_from_result(jr)
            ts = tacc.report_from_result(tr)
            for f in dataclasses.fields(js):
                np.testing.assert_allclose(getattr(ts, f.name), getattr(js, f.name),
                                           rtol=RTOL, atol=ATOL, err_msg=f.name)
    with pytest.raises(ValueError, match="adjacency"):
        tacc.report_from_result(_port_sweep("sparse").result(0, "efhc"))


def test_compare_matches_reference():
    x, y = image_dataset(400, seed=0, dim=24)
    xt, yt = image_dataset(80, seed=1, dim=24)
    parts = by_labels(y, 8, 3)
    sim_kw = dict(m=8, dim=24, iters=11, batch=8, seed=1, mix_impl="dense")
    with jax.threefry_partitionable(False):
        jcfg = jsim.SimConfig(**sim_kw)
        want = jbase.compare(jcfg, jmake_process(8, "rgg", time_varying="edge_dropout",
                                                 drop=0.3, seed=0),
                             lambda: JBatches(x, y, parts, 8, seed=2),
                             jsim.make_eval_fn(jcfg, xt, yt), eval_every=5)
    tcfg = tsim.SimConfig(**sim_kw)
    got = tbase.compare(tcfg, make_process(8, "rgg", time_varying="edge_dropout",
                                           drop=0.3, seed=0),
                        lambda: FederatedBatches(x, y, parts, 8, seed=2),
                        tsim.make_eval_fn(tcfg, xt, yt), eval_every=5, device="cpu")
    assert list(got) == list(want) == ["EF-HC", "GT", "ZT", "RG"]
    for name in want:
        _assert_channels(got[name], want[name], links=True)
    assert (got["EF-HC"].acc > 0).all()
    with pytest.raises(NotImplementedError, match="python"):
        tbase.compare(tcfg, None, None, None, engine="python", device="cpu")


def test_samplers_must_share_one_dataset():
    x, y = image_dataset(200, seed=0, dim=16)
    parts = by_labels(y, 4, 2)
    sim = tsim.SimConfig(m=4, dim=16, iters=3)
    graph = make_process(4, "ring")

    def factory(s):
        xs = x if s == 0 else x + 1.0
        return FederatedBatches(xs, y, parts, 4, seed=s)

    with pytest.raises(ValueError) as got:
        tsweep.run_sweep(sim, graph, factory, seeds=(0, 1), device="cpu")
    with pytest.raises(ValueError) as want:
        jsweep.run_sweep(jsim.SimConfig(m=4, dim=16, iters=3),
                         jmake_process(4, "ring"),
                         lambda s: JBatches(x if s == 0 else x + 1.0, y, parts, 4,
                                            seed=s), seeds=(0, 1))
    assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="EvalFn"):
        tsweep.run_sweep(sim, graph, lambda s: FederatedBatches(x, y, parts, 4, seed=s),
                         lambda w: 0.0, device="cpu")
