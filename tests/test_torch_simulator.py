"""repro_torch's simulator end to end on the CPU: the golden m = 8 run
(tests/golden/efhc_m8_trajectory.json) for the dense, pallas, sparse and
sparse_pallas impls, live ``repro.api.simulate`` runs in the
non-partitionable threefry mode for svm and mlp on every SimResult
channel, and trace-mode storage (packed equal to full)."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import api as japi  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core.topology import make_process  # noqa: E402
from repro_torch.data.loader import FederatedBatches  # noqa: E402
from repro_torch.data.partition import by_labels  # noqa: E402
from repro_torch.data.synthetic import image_dataset  # noqa: E402
from repro_torch.fl.simulator import SimConfig, make_eval_fn, run  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden" / "efhc_m8_trajectory.json"
RTOL, ATOL = 2e-4, 2e-5
INT_FIELDS = ("v", "comm_count", "deg")
FLOAT_FIELDS = ("loss", "tx_time", "util", "consensus_err")


def _golden_run(mix_impl: str, trace: str = "full", eval_fn=False):
    x, y = image_dataset(600, seed=0, dim=24)
    parts = by_labels(y, 8, 3)
    graph = make_process(8, "rgg", time_varying="edge_dropout", drop=0.3, seed=0)
    sim = SimConfig(m=8, iters=18, dim=24, batch=8, r=50.0, seed=0,
                    mix_impl=mix_impl, trace=trace)
    ev = make_eval_fn(sim, *image_dataset(100, seed=1, dim=24)) if eval_fn else None
    return run(sim, graph, FederatedBatches(x, y, parts, sim.batch, seed=2),
               ev, eval_every=5, device="cpu")


@pytest.mark.parametrize("mix_impl", ["dense", "pallas", "sparse", "sparse_pallas"])
def test_port_reproduces_golden_trajectory(mix_impl):
    want = json.loads(GOLDEN.read_text())
    res = _golden_run(mix_impl)
    np.testing.assert_allclose(res.bandwidths, want["bandwidths"], rtol=1e-5)
    for f in INT_FIELDS:
        assert np.array_equal(np.asarray(getattr(res, f), np.int64),
                              np.asarray(want[f], np.int64)), f
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(res, f), np.float64),
                                   want[f], rtol=RTOL, atol=ATOL, err_msg=f)


def _spec_kw(model: str) -> dict:
    return dict(m=12, model=model, dim=32, n_train=600, n_test=120, iters=23,
                eval_every=5, trace="full", labels_per_device=2, r=30.0)


@pytest.mark.parametrize("model,mix_impl", [("svm", "dense"),
                                            ("mlp", "sparse"),
                                            ("mlp", "pallas")])
def test_simulate_matches_reference_on_every_channel(model, mix_impl):
    kw = _spec_kw(model)
    with jax.threefry_partitionable(False):
        want = japi.simulate(japi.ScenarioSpec(**kw, mix_impl=mix_impl))
    got = tapi.simulate(tapi.ScenarioSpec(**kw, mix_impl=mix_impl), device="cpu")
    assert got.model_dim == want.model_dim and got.trace == want.trace
    np.testing.assert_allclose(got.bandwidths, want.bandwidths, rtol=1e-6)
    for f in INT_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert np.array_equal(got.comm, want.comm)
    assert np.array_equal(got.adj, want.adj)
    for f in (*FLOAT_FIELDS, "acc"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    for f in ("down_count", "exhausted_count", "fault_down_count",
              "stale_max", "window_connected", "window_needed"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert 0 < got.v.sum() < got.v.size  # the trigger really gates


@pytest.mark.parametrize("mix_impl", ["dense", "sparse_pallas"])
def test_packed_trace_equals_full(mix_impl):
    full = _golden_run(mix_impl, "full", eval_fn=True)
    packed = _golden_run(mix_impl, "packed", eval_fn=True)
    summary = _golden_run(mix_impl, "summary", eval_fn=True)
    assert packed._comm.dtype == np.uint32 and packed._comm.shape[-1] == 1
    assert np.array_equal(packed.comm, full.comm)
    assert np.array_equal(packed.adj, full.adj)
    for f in (*INT_FIELDS, *FLOAT_FIELDS, "acc"):
        assert np.array_equal(getattr(packed, f), getattr(full, f)), f
        assert np.array_equal(getattr(summary, f), getattr(full, f)), f
    assert np.array_equal(full.comm.sum(-1), full.comm_count)
    with pytest.raises(ValueError, match="summary"):
        summary.comm


def test_eval_schedule_follows_chunks_and_last_iteration():
    res = _golden_run("dense", eval_fn=True)
    acc = res.acc
    # one value per eval chunk (iterations 0-4, 5-9, 10-14, 15-16), then
    # the k = T - 1 overwrite
    for lo, hi in ((0, 5), (5, 10), (10, 15), (15, 17)):
        assert np.all(acc[lo:hi] == acc[lo])
    assert np.isfinite(acc).all() and (acc > 0).all()
    assert res.timing["ms_per_step"] > 0
