"""repro_torch's B-connectivity watchdog, flow analyzers and crash-safe
checkpoints against the JAX package on the CPU: ``watchdog_step`` at
m <= 256 (exact rounds) and above, every host analyzer, the golden m = 8
run with the watchdog on under every single-device impl; and
``run_checkpointed`` on the checkpoint tests' faulty configuration (Adam,
M = 10, T = 25): against the reference's run, kill-and-resume bit for bit,
foreign checkpoints refused, segmenting validated, a packed tail segment,
the packer byte-equal to ``msgpack.packb`` and the reference reading a
directory the port wrote."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import flow as jflow  # noqa: E402
from repro.core.topology import make_process as jmake_process  # noqa: E402
from repro.data.loader import FederatedBatches as JBatches  # noqa: E402
from repro.data.partition import by_labels as jby_labels  # noqa: E402
from repro.data.synthetic import image_dataset as jimage_dataset  # noqa: E402
from repro.fl import simulator as jsim  # noqa: E402
from repro.fl import trace as jtrace  # noqa: E402
from repro_torch.checkpoint import msgpack_ckpt as tckpt  # noqa: E402
from repro_torch.core import flow as tflow  # noqa: E402
from repro_torch.core.topology import make_process  # noqa: E402
from repro_torch.data.loader import FederatedBatches  # noqa: E402
from repro_torch.data.partition import by_labels  # noqa: E402
from repro_torch.data.synthetic import image_dataset  # noqa: E402
from repro_torch.fl import simulator as tsim  # noqa: E402
from test_torch_resources import (IMPLS, INT_CHANNELS, assert_same_run,  # noqa: E402
                                  golden_port, golden_ref)

WATCHDOG = dict(watchdog_window=3, crash_rate=0.2, rejoin_rate=0.3)


@pytest.fixture(scope="module")
def ref_runs():
    return {impl: golden_ref(mix_impl=impl, trace="full", **WATCHDOG)
            for impl in IMPLS}


@pytest.mark.parametrize("impl", IMPLS)
def test_golden_run_with_watchdog_matches_reference(ref_runs, impl):
    got = golden_port(mix_impl=impl, trace="full", **WATCHDOG)
    assert_same_run(got, ref_runs[impl], impl)
    assert jflow.empirical_b(got.window_needed) == tflow.empirical_b(
        ref_runs[impl].window_needed)


def _ell_graph(m, seed):
    """A random symmetric fabric's neighbor list and a random
    information-flow slot mask over it."""
    g = make_process(m, "rgg", radius=0.4 if m <= 64 else 0.2, seed=seed)
    nl = g.neighbors()
    rng = np.random.default_rng(seed)
    comm = nl.mask & (rng.uniform(size=nl.mask.shape) < 0.4)
    return nl, comm


@pytest.mark.parametrize("m,n_prop", [(24, 0), (200, 0), (300, 0), (300, 7)])
def test_watchdog_step_matches_reference(m, n_prop):
    """Rounds are m up to 256 and 4 ceil(sqrt(m)) + 32 above; the integer
    results are exact, per cell, over several iterations."""
    nl, _ = _ell_graph(m, m)
    cfg_j = jflow.WatchdogConfig(window=4, n_prop=n_prop)
    cfg_t = tflow.WatchdogConfig(window=4, n_prop=n_prop)
    assert cfg_t.rounds(m) == cfg_j.rounds(m)
    rng = np.random.default_rng(1)
    age_j = jflow.watchdog_init(m, nl.d_max).age
    age_t = tflow.watchdog_init(m, nl.d_max, (2,)).age
    for it in range(5):
        comms = [nl.mask & (rng.uniform(size=nl.mask.shape) < 0.3) for _ in range(2)]
        want = jflow.watchdog_step(cfg_j, jnp.asarray(nl.idx), jnp.asarray(comms[0]),
                                   age_j)
        got = tflow.watchdog_step(cfg_t, torch.as_tensor(nl.idx, dtype=torch.int64),
                                  torch.as_tensor(np.stack(comms)), age_t)
        assert np.array_equal(got[0][0].numpy(), np.asarray(want[0])), it
        assert bool(got[1][0]) == bool(want[1]) and int(got[2][0]) == int(want[2]), it
        age_j, age_t = want[0], got[0]
    if n_prop == 0:  # converged rounds: some window connects the fleet
        assert int(got[2][0]) < tflow.AGE_INF


def test_comm_ell_from_dense_matches_reference():
    nl, comm_ell = _ell_graph(30, 2)
    dense = np.zeros((30, 30), bool)
    rows = np.repeat(np.arange(30)[:, None], nl.d_max, 1)
    dense[rows[comm_ell], nl.idx[comm_ell]] = True
    dense |= dense.T
    want = jflow.comm_ell_from_dense(jnp.asarray(dense), jnp.asarray(nl.idx),
                                     jnp.asarray(nl.mask))
    got = tflow.comm_ell_from_dense(torch.as_tensor(np.stack([dense, dense])),
                                    torch.as_tensor(nl.idx, dtype=torch.int64),
                                    torch.as_tensor(nl.mask))
    assert got.shape == (2, 30, nl.d_max)
    assert np.array_equal(got[1].numpy(), np.asarray(want))


def test_host_analyzers_match_reference():
    rng = np.random.default_rng(0)
    for m, p in ((6, 0.15), (12, 0.08), (33, 0.05)):
        a = rng.uniform(size=(14, m, m)) < p
        a = a | np.transpose(a, (0, 2, 1))
        packed = jtrace.pack_links_np(a)
        assert (tflow.union_connectivity(a) == jflow.union_connectivity(a)
                == tflow.union_connectivity(packed, m=m))
        for b in (1, 3, 6):
            assert np.array_equal(tflow.failing_windows(a, b),
                                  jflow.failing_windows(a, b))
            assert np.array_equal(tflow.failing_windows(packed, b, m=m),
                                  jflow.failing_windows(a, b))
        v = rng.uniform(size=(20, m)) < 0.3
        assert tflow.trigger_bound(v) == jflow.trigger_bound(v)
        needed = rng.integers(1, 9, 20)
        assert tflow.empirical_b(needed) == jflow.empirical_b(needed)
        for b1 in (1, 2, 5):
            assert tflow.b_certificate(needed, v, b1, window=4) == \
                jflow.b_certificate(needed, v, b1, window=4)
    for b1, b2 in ((1, 1), (2, 5), (3, 3), (4, 11), (5, 4)):
        assert tflow.predicted_b(b1, b2) == jflow.predicted_b(b1, b2)
    assert tflow.empirical_b(np.zeros(0)) == jflow.empirical_b(np.zeros(0))
    for m in (16, 256, 257, 4096, 10_000):
        assert tflow.default_prop_rounds(m) == jflow.default_prop_rounds(m)
    with pytest.raises(ValueError, match="device count"):
        tflow.union_connectivity(jtrace.pack_links_np(np.zeros((2, 4, 4), bool)))
    for kw in (dict(window=-1), dict(n_prop=-1)):
        with pytest.raises(ValueError) as want:
            jflow.WatchdogConfig(**kw)
        with pytest.raises(ValueError) as got:
            tflow.WatchdogConfig(**kw)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------ checkpoints --

M, T, DIM = 10, 25, 24
FAULTY = dict(trace="full", optimizer="adam", crash_rate=0.1, rejoin_rate=0.3,
              cluster_fail_rate=0.05, warm_start=True, churn_rate=0.1,
              watchdog_window=5)
FLOAT_CHANNELS = ("loss", "acc", "tx_time", "util", "consensus_err", "bandwidths")


def _setup(mod, make, Batches, by, images, **sim_kw):
    x, y = images(400, n_classes=4, dim=DIM, seed=0)
    parts = by(y, M, 1)
    graph = make(M, "rgg", time_varying="edge_dropout", drop=0.3, seed=0)
    kw = dict(m=M, model="svm", dim=DIM, n_classes=4, iters=T, batch=8, seed=0)
    kw.update(sim_kw)
    return mod.SimConfig(**kw), graph, lambda: Batches(x, y, parts, 8, seed=2)


def port_setup(**sim_kw):
    return _setup(tsim, make_process, FederatedBatches, by_labels, image_dataset,
                  **sim_kw)


def _checkpointed(sim, graph, batches, d, **kw):
    return tsim.run_checkpointed(sim, graph, batches, None, ckpt_dir=str(d),
                                 eval_every=kw.pop("eval_every", 5), device="cpu",
                                 **{"checkpoint_every": 10, **kw})


def assert_bit_equal(a, b, label):
    for f in INT_CHANNELS + FLOAT_CHANNELS:
        assert np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f))), \
            f"{label}: {f}"
    if a.trace != "summary":
        assert np.array_equal(a.comm, b.comm), f"{label}: comm"
        assert np.array_equal(a.adj, b.adj), f"{label}: adj"


@pytest.fixture(scope="module")
def faulty(tmp_path_factory):
    """The reference's faulty run, and the port's uninterrupted
    checkpointed run with its directory."""
    sim, graph, batches = _setup(jsim, jmake_process, JBatches, jby_labels,
                                 jimage_dataset, **FAULTY)
    with jax.threefry_partitionable(False):
        ref = jsim.run(sim, graph, batches(), None, eval_every=5)
    d = tmp_path_factory.mktemp("full")
    sim, graph, batches = port_setup(**FAULTY)
    return ref, _checkpointed(sim, graph, batches(), d), d


def test_checkpointed_run_matches_reference_and_run(faulty):
    ref, full, _ = faulty
    assert_same_run(full, ref, "checkpointed vs reference")
    assert full.fault_down_count.max() > 0 and full.down_count.max() > 0
    sim, graph, batches = port_setup(**FAULTY)
    one = tsim.run(sim, graph, batches(), None, eval_every=5, device="cpu")
    assert_bit_equal(one, full, "run vs checkpointed")  # the same loop on the CPU
    segs = full.timing["segments"]
    assert [s["end"] for s in segs] == [10, 20, 25] and all(s["bytes"] > 0 for s in segs)


def test_kill_and_resume_is_bit_identical(faulty, tmp_path):
    _, full, _ = faulty
    sim, graph, batches = port_setup(**FAULTY)
    with pytest.raises(tsim.CheckpointHalt, match="iteration 10"):
        _checkpointed(sim, graph, batches(), tmp_path, halt_after=1)
    with pytest.raises(tsim.CheckpointHalt, match="iteration 20"):
        _checkpointed(sim, graph, batches(), tmp_path, halt_after=1)
    resumed = _checkpointed(sim, graph, batches(), tmp_path)
    assert resumed.timing["restore_s"] is not None
    assert [s["end"] for s in resumed.timing["segments"]] == [25]
    assert_bit_equal(resumed, full, "resumed vs uninterrupted")


def test_resume_skips_completed_segments(tmp_path):
    sim, graph, batches = port_setup(trace="summary", crash_rate=0.1,
                                     watchdog_window=5)
    with pytest.raises(tsim.CheckpointHalt):
        _checkpointed(sim, graph, batches(), tmp_path, checkpoint_every=5,
                      halt_after=2)
    assert sorted(os.listdir(tmp_path)) == ["step_10.msgpack", "step_5.msgpack"]
    before = {fn: (tmp_path / fn).read_bytes() for fn in os.listdir(tmp_path)}
    _checkpointed(sim, graph, batches(), tmp_path, checkpoint_every=5)
    assert len(os.listdir(tmp_path)) == 5
    for fn, payload in before.items():
        assert (tmp_path / fn).read_bytes() == payload, fn


def test_refuses_foreign_checkpoints_and_validates_segments(tmp_path):
    sim, graph, batches = port_setup(trace="summary")
    with pytest.raises(tsim.CheckpointHalt):
        _checkpointed(sim, graph, batches(), tmp_path / "ck", checkpoint_every=5,
                      halt_after=1)
    with pytest.raises(ValueError, match="different scenario"):
        _checkpointed(dataclasses.replace(sim, r=10.0), graph, batches(),
                      tmp_path / "ck", checkpoint_every=5)
    fresh = _checkpointed(sim, graph, batches(), tmp_path / "ck2", checkpoint_every=5,
                          resume=False)
    assert fresh.loss.shape == (T, M) and fresh.timing["restore_s"] is None
    with pytest.raises(ValueError, match="multiple of eval_every"):
        _checkpointed(sim, graph, batches(), tmp_path / "x", checkpoint_every=7)
    # the sharded engine runs, but its runs are not checkpointable
    with pytest.raises(ValueError, match="not checkpointable"):
        _checkpointed(dataclasses.replace(sim, mix_impl="sharded", shards=1), graph,
                      batches(), tmp_path / "sharded", checkpoint_every=5)


def test_tail_segment_and_packed_trace(tmp_path):
    sim, graph, batches = port_setup(iters=22, trace="packed", crash_rate=0.1,
                                     watchdog_window=4)
    full = _checkpointed(sim, graph, batches(), tmp_path / "full", eval_every=2)
    with pytest.raises(tsim.CheckpointHalt):
        _checkpointed(sim, graph, batches(), tmp_path / "c", eval_every=2,
                      halt_after=2)
    resumed = _checkpointed(sim, graph, batches(), tmp_path / "c", eval_every=2)
    assert resumed.loss.shape == (22, M) and resumed._comm.dtype == np.uint32
    assert_bit_equal(resumed, full, "tail + packed resumed")


def test_packer_is_byte_equal_to_msgpack(faulty):
    msgpack = pytest.importorskip("msgpack")
    _, _, d = faulty
    raw = (d / "step_10.msgpack").read_bytes()
    tree = tckpt._tree_encode(tckpt.restore(str(d), 10))
    assert tckpt.packb(tree) == msgpack.packb(tree, use_bin_type=True) == raw
    assert tckpt.unpackb(raw) == msgpack.unpackb(raw, raw=False)
    edge = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
                     -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1,
                     -2**63],
            "floats": [0.0, -1.5, 1e300], "s" * 40: "x" * 300, "b": b"\x00" * 70000,
            "nil": None, "t": True, "f": False, "list": list(range(20)),
            "map": {str(i): i for i in range(17)}, "u": "é中"}
    assert tckpt.packb(edge) == msgpack.packb(edge, use_bin_type=True)
    assert tckpt.unpackb(tckpt.packb(edge)) == edge


def test_reference_restores_a_port_directory(faulty):
    pytest.importorskip("msgpack")
    from repro.checkpoint import msgpack_ckpt as jckpt

    _, full, d = faulty
    assert jckpt.latest_step(str(d)) == tckpt.latest_step(str(d)) == 25
    got = jckpt.restore(str(d), 25)
    mine = tckpt.restore(str(d), 25)
    assert got["meta"] == mine["meta"] and got["end"] == 25
    assert type(got["state"]).__name__ == "EFHCState"
    assert np.array_equal(got["ys"]["v"], full.v[20:])
    assert np.array_equal(got["state"].faults.staleness, mine["state"].faults.staleness)
