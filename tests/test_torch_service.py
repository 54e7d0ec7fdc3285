"""repro_torch's scenario service on the CPU against the reference's
(``repro.fl.service``, run in the non-partitionable threefry mode): the
same request mix served by both, report for report (results per seed, tx
accounting, quarantine, launch grouping, padding, program and engine cache
hits, ``ServiceStats``), each served cell against the port's solo
``api.simulate``, the signature, deadlines, retries, the poisoned-row
quarantine, deep models through ``api.serve``, and the CLI's JSON against
the reference CLI's.  Integer channels must be equal; float channels agree
at the golden tolerances (rtol 2e-4, atol 2e-5): the reference's own
service-vs-sweep check is 1 ULP off on this jax, so floats are held to a
tolerance, not to bits."""
import dataclasses
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.data.synthetic import token_dataset, token_windows  # noqa: E402
from repro.fl import service as jservice  # noqa: E402
from repro.fl import simulator as jsim  # noqa: E402
from repro.launch import serve as jserve_cli  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.data.partition import by_labels  # noqa: E402
from repro_torch.fl import service as tservice  # noqa: E402
from repro_torch.fl import simulator as tsim  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
BASE = dict(m=8, dim=16, n_train=320, n_test=80, iters=8, eval_every=3, batch=8)
INT_FIELDS = ("v", "comm_count", "deg")
FLOAT_FIELDS = ("loss", "acc", "tx_time", "util", "consensus_err")
ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
# a mixed request set over three signatures (the dense mix, and mlp
# through the kernel wrappers); with max_cells=4 the first signature's five
# cells drain over two launches, 3 cells padded to 4 and then 2
MIX = [dict(policy="efhc", seeds=(0, 1)),
       dict(policy="gossip", seeds=(2,)),
       dict(policy="efhc", r=10.0, seeds=(0,)),
       dict(policy="zero", model="mlp", mix_impl="pallas", seeds=(3,)),
       dict(policy="global", model="mlp", mix_impl="pallas", seeds=(1,)),
       dict(policy="efhc", r=10.0, seeds=(4,), sample_seed=5),
       dict(policy="zero", seeds=(5, 6))]
# a second round of the first signature: 3 cells, the first launch's bucket
ROUND2 = [dict(policy="zero", seeds=(9, 11)), dict(policy="gossip", seeds=(12,))]


def _assert_cell(got, want, label=""):
    assert got.model_dim == want.model_dim
    for f in INT_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f"{label}: {f}"
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{label}: {f}")
    np.testing.assert_allclose(got.bandwidths, want.bandwidths, rtol=1e-6)


def _assert_tx(got, want, label=""):
    g, w = got.as_dict(), want.as_dict()
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{label}: tx {k}")


def _serve_both(kws, *, max_cells, rounds=()):
    """The same requests through both services from cleared engine caches;
    ``rounds`` are later request lists served by the same services."""
    jsim._ENGINE_CACHE.clear(reset_stats=True)
    tsim._ENGINE_CACHE.clear(reset_stats=True)
    jsvc = japi.ScenarioService(max_cells=max_cells)
    tsvc = tapi.ScenarioService(max_cells=max_cells, device="cpu")
    out = []
    for batch in (kws, *rounds):
        with jax.threefry_partitionable(False):
            want = jsvc.serve([japi.ScenarioSpec(**BASE, **kw) for kw in batch])
        got = tsvc.serve([tapi.ScenarioSpec(**BASE, **kw) for kw in batch])
        out.append((got, want))
    return out, tsvc, jsvc


@pytest.fixture(scope="module")
def served():
    return _serve_both(MIX, max_cells=4, rounds=(ROUND2,))


def test_reports_match_reference(served):
    rounds, _, _ = served
    for got_reps, want_reps in rounds:
        assert len(got_reps) == len(want_reps)
        for got, want in zip(got_reps, want_reps):
            label = f"request {want.request_id}"
            assert got.request_id == want.request_id and got.ok and want.ok
            assert set(got.results) == set(want.results) == set(want.spec.seeds)
            assert got.quarantined == want.quarantined == ()
            assert got.retries == want.retries == 0
            for s in want.spec.seeds:
                _assert_cell(got.results[s], want.results[s], f"{label} seed {s}")
                _assert_tx(got.tx[s], want.tx[s], f"{label} seed {s}")
            assert got.results[want.spec.seeds[0]].timing["ms_per_step"] > 0


def test_grouping_and_cache_hits_match_reference(served):
    """Launch ids, co-batched cells, engine and program cache hits per
    report, and the service's counters (requests, cells, launches, padded
    cells, program and engine cache) are the reference's."""
    rounds, tsvc, jsvc = served
    for got_reps, want_reps in rounds:
        for got, want in zip(got_reps, want_reps):
            for key in ("launch_id", "launch_cells", "cells", "engine_cache_hit",
                        "program_cache_hit"):
                assert got.timing_dict()[key] == want.timing_dict()[key], key
    got, want = tsvc.stats().as_dict(), jsvc.stats().as_dict()
    assert got == want
    assert (got["launches"], got["padded_cells"]) == (5, 2)
    assert (got["program_hits"], got["program_misses"]) == (1, 4)
    assert [r.launch_id for r in rounds[0][0]] == [0, 0, 1, 2, 2, 1, 3]
    assert [r.engine_cache_hit for r in rounds[0][0]] == [False] * 6 + [True]
    # round 2 is an engine and a program cache hit
    assert all(r.engine_cache_hit and r.program_cache_hit for r in rounds[1][0])


def test_stats_keys_match_reference():
    got = tapi.ScenarioService(device="cpu").stats().as_dict()
    want = japi.ScenarioService().stats().as_dict()
    assert got.keys() == want.keys()
    assert got["engine_cache"].keys() == want["engine_cache"].keys()
    assert set(tapi.__all__) == set(japi.__all__)


def test_served_cells_match_solo_runs(served):
    """``api.serve``'s cells against the port's own solo ``api.simulate``."""
    rounds, _, _ = served
    for got_reps, _ in rounds:
        for rep in got_reps:
            for s in rep.spec.seeds:
                solo = tapi.simulate(rep.spec, seed=s, device="cpu")
                _assert_cell(rep.results[s], solo, f"request {rep.request_id} seed {s}")


def test_api_serve_matches_api_simulate():
    specs = [tapi.ScenarioSpec(**BASE, policy=p, seeds=(s,))
             for p, s in (("efhc", 5), ("gossip", 6))]
    reports = tapi.serve(specs, max_cells=4, device="cpu")
    assert [r.launch_id for r in reports] == [reports[0].launch_id] * 2
    for spec, rep in zip(specs, reports):
        assert rep.launch_cells == 2
        _assert_cell(rep.result(), tapi.simulate(spec, device="cpu"))


def test_signature_matches_reference():
    """Equal signatures where the reference's are equal, and the same
    values: every field but the cell fields shapes the batch group."""
    assert tservice.CELL_FIELDS == jservice.CELL_FIELDS
    assert ([f.name for f in dataclasses.fields(tapi.ScenarioSpec)]
            == [f.name for f in dataclasses.fields(japi.ScenarioSpec)])
    for kw in (dict(policy="gossip", seeds=(4, 5)), dict(sample_seed=9),
               dict(deadline_s=3.0), dict(r=10.0), dict(mix_impl="sparse"),
               dict(model="mlp_blocks"), dict(graph_seed=2)):
        assert (tapi.ScenarioSpec(**BASE, **kw).signature()
                == japi.ScenarioSpec(**BASE, **kw).signature())
    base = tapi.ScenarioSpec(**BASE)
    assert dataclasses.replace(base, deadline_s=5.0).signature() == base.signature()
    assert dataclasses.replace(base, iters=6).signature() != base.signature()


def test_incompatible_specs_never_co_batch():
    grid = [tapi.ScenarioSpec(**BASE, policy=p, r=r, seeds=(s,))
            for p, r, s in itertools.product(("efhc", "gossip"), (50.0, 10.0), (0, 1))]
    reports = tapi.ScenarioService(max_cells=16, device="cpu").serve(grid)
    by_launch = {}
    for rep in reports:
        by_launch.setdefault(rep.launch_id, []).append(rep.spec)
    assert len(by_launch) == 2  # one launch per distinct r
    for specs in by_launch.values():
        assert len({s.signature() for s in specs}) == 1 and len(specs) == 4


def test_service_validates_its_arguments():
    with pytest.raises(TypeError, match="ScenarioSpec"):
        tapi.ScenarioService(device="cpu").submit({"m": 8})
    for kw, name in ((dict(max_cells=0), "max_cells"), (dict(max_retries=-1), "max_retries"),
                     (dict(retry_backoff_s=-0.1), "retry_backoff_s")):
        with pytest.raises(ValueError) as want:
            japi.ScenarioService(**kw)
        with pytest.raises(ValueError, match=name) as got:
            tapi.ScenarioService(**kw, device="cpu")
        assert str(got.value) == str(want.value)


def test_provider_rejects_token_models_with_the_reference_message():
    spec = dict(model="tiny_transformer", dim=16, n_classes=32)
    with pytest.raises(ValueError) as want:
        jservice.SyntheticProvider()(japi.ScenarioSpec(**spec))
    with pytest.raises(ValueError) as got:
        tapi.simulate(tapi.ScenarioSpec(**spec), device="cpu")
    assert str(got.value) == str(want.value)


def test_poisoned_spec_keeps_the_queue_draining():
    svc = tapi.ScenarioService(max_cells=4, device="cpu")
    healthy = tapi.ScenarioSpec(**BASE, seeds=(0, 1))
    poisoned = tapi.ScenarioSpec(**BASE, model="tiny_transformer", n_classes=32)
    reports = svc.serve([healthy, poisoned, dataclasses.replace(healthy, r=10.0)])
    assert [r.ok for r in reports] == [True, False, True]
    bad = reports[1]
    assert "provider" in bad.error and bad.results == {} and bad.launch_id == -1
    with pytest.raises(RuntimeError, match="request 1 failed"):
        bad.result()
    assert svc.stats().failures == 1 and svc.stats().retries == 1


def test_expired_request_is_answered_not_launched():
    svc = tapi.ScenarioService(max_cells=4, device="cpu")
    rid = svc.submit(tapi.ScenarioSpec(**BASE, deadline_s=1e-9))
    ok_rid = svc.submit(tapi.ScenarioSpec(**BASE))
    time.sleep(0.01)
    by_rid = {r.request_id: r for r in svc.serve()}
    bad = by_rid[rid]
    assert not bad.ok and "DeadlineExceeded" in bad.error
    assert bad.results == {} and bad.launch_id == -1
    assert by_rid[ok_rid].ok
    assert svc.stats().as_dict()["deadline_expired"] == 1


class _FlakyProvider:
    """Fails the first ``n_fail`` staging calls, then stages the default
    synthetic dataset."""

    def __init__(self, n_fail):
        self.n_fail = n_fail
        self.calls = 0

    def __call__(self, spec):
        self.calls += 1
        if self.calls <= self.n_fail:
            raise OSError("transient staging failure")
        return tservice._DEFAULT_PROVIDER(spec)


def test_transient_failure_retries_and_recovers():
    svc = tapi.ScenarioService(_FlakyProvider(1), max_cells=4, max_retries=2,
                               retry_backoff_s=0.0, device="cpu")
    spec = tapi.ScenarioSpec(**BASE, seeds=(0,))
    reports = svc.serve([spec])
    assert len(reports) == 1 and reports[0].ok and reports[0].retries == 1
    assert (svc.stats().retries, svc.stats().failures) == (1, 0)
    _assert_cell(reports[0].results[0], tapi.simulate(spec, device="cpu"))


def test_persistent_failure_exhausts_retries_then_errors():
    provider = _FlakyProvider(100)
    svc = tapi.ScenarioService(provider, max_cells=4, max_retries=2,
                               retry_backoff_s=0.0, device="cpu")
    reports = svc.serve([tapi.ScenarioSpec(**BASE)])
    assert len(reports) == 1 and not reports[0].ok
    assert "transient staging failure" in reports[0].error and reports[0].retries == 2
    assert (svc.stats().retries, svc.stats().failures) == (2, 1)
    assert provider.calls == 3  # the first attempt and two retries


class _PoisonedProvider:
    """The default synthetic dataset with one training row driven to Inf:
    only the cells whose sampler stream draws that row diverge."""

    def __init__(self, service_mod, row):
        self.mod, self.row, self._cache = service_mod, row, {}

    def __call__(self, spec):
        k = self.mod.SyntheticProvider.key(spec)
        if k not in self._cache:
            ds = self.mod._DEFAULT_PROVIDER(spec)
            x = np.array(ds.x)
            x[self.row] = np.inf
            self._cache[k] = dataclasses.replace(ds, x=x)
        return self._cache[k]


@pytest.mark.parametrize("mix_impl", ["dense", "pallas"])
def test_nan_quarantine_isolates_the_diverged_cell(mix_impl):
    """A cell that samples the poisoned row goes non-finite and is
    quarantined, as in the reference; its co-batched clean cell comes back
    as its solo run against the same provider gives it."""
    row = 7
    tprov = _PoisonedProvider(tservice, row)
    probe = tapi.ScenarioSpec(**BASE, model="mlp", mix_impl=mix_impl)
    ds = tprov(probe)
    hit = miss = None
    for s in range(64):
        idx = probe.batches(s, ds).stage(probe.iters)
        per_step = (idx == row).reshape(idx.shape[0], -1).any(1)
        if hit is None and per_step[: probe.iters // 2].any():
            hit = s
        if miss is None and not per_step.any():
            miss = s
    assert hit is not None and miss is not None
    kw = dict(BASE, model="mlp", mix_impl=mix_impl, seeds=(hit, miss))
    rep = tapi.ScenarioService(tprov, max_cells=4, device="cpu").serve(
        [tapi.ScenarioSpec(**kw)])[0]
    with jax.threefry_partitionable(False):
        want = japi.ScenarioService(_PoisonedProvider(jservice, row), max_cells=4).serve(
            [japi.ScenarioSpec(**kw)])[0]
    assert rep.ok and rep.quarantined == want.quarantined == (hit,)
    assert set(rep.results) == set(rep.tx) == {miss}
    with pytest.raises(RuntimeError, match="quarantined"):
        rep.result(hit)
    _assert_cell(rep.results[miss], want.results[miss], "clean cell vs reference")
    spec = tapi.ScenarioSpec(**kw)
    _assert_cell(rep.results[miss],
                 tservice.solo_run(spec, seed=miss, provider=tprov, device="cpu"),
                 "clean cell next to NaN")
    bad = tservice.solo_run(spec, seed=hit, provider=tprov, device="cpu")
    assert not np.isfinite(bad.loss).all()


class _MixedProvider:
    """Token windows for ``tiny_transformer``, synthetic images otherwise."""

    def __init__(self, m, seq, vocab):
        xw, yw = token_windows(token_dataset(3000, vocab=vocab, seed=0), seq, stride=2)
        xt, yt = token_windows(token_dataset(800, vocab=vocab, seed=1), seq, stride=seq)
        self.tokens = tservice.Dataset(xw, yw, by_labels(yw, m, 4), xt, yt)

    def __call__(self, spec):
        if spec.model == "tiny_transformer":
            return self.tokens
        return tservice._DEFAULT_PROVIDER(spec)


def test_serve_runs_the_deep_models():
    kw = dict(m=6, n_train=300, n_test=40, iters=5, eval_every=2, batch=4)
    specs = [tapi.ScenarioSpec(**kw, model="cnn", dim=36, smooth=1, seeds=(0, 1)),
             tapi.ScenarioSpec(**kw, model="mlp_blocks", dim=20, policy="gossip"),
             tapi.ScenarioSpec(**kw, model="tiny_transformer", dim=6, n_classes=12,
                               mix_impl="pallas", seeds=(2,))]
    provider = _MixedProvider(6, 6, 12)
    reports = tapi.serve(specs, provider=provider, device="cpu")
    assert [r.launch_id for r in reports] == [0, 1, 2]
    for spec, rep in zip(specs, reports):
        assert rep.ok
        for s in spec.seeds:
            _assert_cell(rep.results[s], tapi.simulate(spec, seed=s, provider=provider,
                                                       device="cpu"), spec.model)


def _keys(doc) -> dict:
    """The key sets of a CLI report: top level, a request row, its tx
    summary, the service's counters and its engine cache."""
    row = doc["requests"][0]
    return {"top": set(doc), "request": set(row),
            "tx": set(next(iter(row["tx"].values()))),
            "service": set(doc["service"]),
            "engine_cache": set(doc["service"]["engine_cache"])}


def test_cli_demo_report_matches_reference_cli(tmp_path):
    """``python -m repro_torch.launch.serve --demo --device cpu`` writes a
    report with the reference CLI's keys, requests and grouping."""
    got_path, want_path = tmp_path / "port.json", tmp_path / "ref.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--demo", "--iters", "6",
         "--device", "cpu", "--out", str(got_path)],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "sims/s" in out.stdout
    with jax.threefry_partitionable(False):
        assert jserve_cli.main(["--demo", "--iters", "6", "--out", str(want_path)]) == 0
    got, want = json.loads(got_path.read_text()), json.loads(want_path.read_text())
    assert _keys(got) == _keys(want)
    assert len(got["requests"]) == len(want["requests"]) == 5
    for g, w in zip(got["requests"], want["requests"]):
        for key in ("request_id", "launch_id", "launch_cells", "cells", "signature",
                    "policy"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["mean_final_acc"], w["mean_final_acc"],
                                   rtol=RTOL, atol=ATOL)
