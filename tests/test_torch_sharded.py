"""repro_torch's sharded fleet engine against the JAX package on the CPU.

The shard plan's tables, the ``rows`` forms (``adjacency_ell_rows``,
``policy_branches_rows``, ``ModelSpec.init_rows``) and the halo forms
(``build_p_ell_halo``, ``mix_sparse_halo``, ``watchdog_step_halo``) on a
plan's shards, each against the reference's (its collectives under
``jax.vmap`` over the shards); the gather-mix's rectangular source (the
stacked ``[own; halo]`` buffer) against the halo mix bit for bit, with
the kernels' plan replayed in numpy; the engine at S = 1, 2, 4, 8 against
the reference's ``sparse`` run on the configurations of
``tests/sharded_worker.py`` (integer channels equal, floats within the
golden tolerances, ``consensus_err`` by tolerance) and bit-equal across S
and to the port's own ``sparse`` run on every other channel; the sweep,
the service and the refusals; and, in a subprocess with 8 forced host
devices, the reference's own sharded engine at S = 8 against the port's.
The reference runs with ``jax.threefry_partitionable(False)``, the
goldens' stream.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.core import efhc as jefhc  # noqa: E402
from repro.core import flow as jflow  # noqa: E402
from repro.core import mixing as jmixing  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core import triggers as jtrig  # noqa: E402
from repro.data.loader import FederatedBatches as JBatches  # noqa: E402
from repro.data.partition import by_labels as jby_labels  # noqa: E402
from repro.data.synthetic import image_dataset as jimage_dataset  # noqa: E402
from repro.fl import modelspec as jspec  # noqa: E402
from repro.fl import simulator as jsim  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core import efhc as tefhc  # noqa: E402
from repro_torch.core import flow as tflow  # noqa: E402
from repro_torch.core import mixing as tmixing  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core import triggers as ttrig  # noqa: E402
from repro_torch.data.loader import FederatedBatches  # noqa: E402
from repro_torch.data.partition import by_labels  # noqa: E402
from repro_torch.data.synthetic import image_dataset  # noqa: E402
from repro_torch.fl import modelspec as tspec  # noqa: E402
from repro_torch.fl import sharded as tsharded  # noqa: E402
from repro_torch.fl import simulator as tsim  # noqa: E402
from repro_torch.kernels.mixing import ops as tmix  # noqa: E402
from repro_torch.kernels.mixing import plan as tplan  # noqa: E402
from repro_torch.launch.mesh import make_fleet_group  # noqa: E402

from test_torch_mixing_plan import _replay  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 2e-5
SHARDS = (1, 2, 4, 8)
INT_CHANNELS = ("v", "comm_count", "deg", "down_count", "exhausted_count",
                "fault_down_count", "stale_max", "window_connected", "window_needed")
FLOAT_CHANNELS = ("loss", "acc", "tx_time", "util")
# every channel but the hierarchical consensus_err
EXACT_CHANNELS = INT_CHANNELS + FLOAT_CHANNELS + ("bandwidths",)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its runs are many small ops,
    which torch's OpenMP threads slow a hundredfold when several test
    workers share the cores; both sides of every comparison run so."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan_pair(topology: str, m: int, S: int):
    kw = dict(time_varying="edge_dropout", drop=0.3, seed=0)
    if topology == "rgg":
        kw["radius"] = 0.3
    return (jtopo.make_process(m, topology, **kw), ttopo.make_process(m, topology, **kw))


# ---- the shard plan and the rows forms -------------------------------------

@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("topology", ["rgg", "ring", "clustered"])
def test_shard_plan_matches_reference(topology, S):
    """Morton blocks (rgg, clustered: coords) or id blocks (ring), every
    table entry for entry."""
    jg, tg = _plan_pair(topology, 64, S)
    want = jtopo.shard_plan(jg.edges, S, coords=jg.coords)
    got = ttopo.shard_plan(tg.edges, S, coords=tg.coords)
    assert (got.n_shards, got.ms, got.d_max, got.b_max, got.h_max) == (
        want.n_shards, want.ms, want.d_max, want.b_max, want.h_max)
    for f in ("owned", "inv_perm", "nbr_gid", "nbr_loc", "mask", "send_idx",
              "recv_src", "n_send", "n_halo"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.boundary_frac == want.boundary_frac
    if S > 1 and topology != "ring":
        assert 0 < got.boundary_frac < 1


def test_shard_plan_refuses_indivisible_m():
    for mod in (jtopo, ttopo):
        with pytest.raises(ValueError, match="divisible") as err:
            mod.shard_plan(mod.ring_edges(10), 4)
        assert "m=10, n_shards=4" in str(err.value)
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        ttopo.shard_plan(ttopo.ring_edges(8), 0)


@pytest.mark.parametrize("kind", ["static", "edge_dropout", "partition_cycle"])
def test_adjacency_ell_rows_matches_reference(kind):
    """Random row subsets at k = 0..3, and the all-rows call equal to
    ``adjacency_ell``."""
    kw = dict(radius=0.3, time_varying=kind, seed=1, drop=0.4, cycle_len=3)
    jg, tg = jtopo.make_process(48, "rgg", **kw), ttopo.make_process(48, "rgg", **kw)
    nl = tg.neighbors()
    rng = np.random.default_rng(7)
    staged = ttopo.StagedNeighbors.from_host(nl, "cpu")
    for k in range(4):
        rows = np.sort(rng.choice(48, size=int(rng.integers(1, 48)), replace=False))
        with jax.threefry_partitionable(False):
            want = np.asarray(jg.adjacency_ell_rows(k, jnp.asarray(nl.idx[rows]),
                                                    jnp.asarray(nl.mask[rows]),
                                                    jnp.asarray(rows, jnp.int32)))
        got = tg.adjacency_ell_rows(k, staged.idx[rows], staged.mask[rows],
                                    torch.as_tensor(rows))
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(tg.adjacency_ell(k, staged),
                           tg.adjacency_ell_rows(k, staged.idx, staged.mask,
                                                 torch.arange(48)))


def test_policy_branches_rows_match_reference():
    """All four branches on an owned-row subset; gossip draws the whole
    fleet's uniform and takes the owned positions."""
    m = 40
    rows = np.asarray([3, 7, 8, 21, 39], np.int32)
    rng = np.random.default_rng(3)
    dev = rng.uniform(0, 0.05, size=rows.size).astype(np.float32)
    bw = rng.uniform(500, 9500, size=rows.size).astype(np.float32)
    cfg = dict(r=50.0, b_mean=5000.0, gossip_p=0.3)
    jb = jtrig.policy_branches_rows(jtrig.TriggerConfig(**cfg), m, jnp.asarray(rows))
    tb = ttrig.policy_branches_rows(ttrig.TriggerConfig(**cfg), m, torch.as_tensor(rows))
    for seed in range(3):
        with jax.threefry_partitionable(False):
            jkey = jax.random.PRNGKey(seed)
            want = [np.asarray(f(jnp.asarray(dev), jnp.asarray(bw), 0.7, jkey)) for f in jb]
        tkey = prng.PRNGKey(seed)
        got = [f(torch.as_tensor(dev), torch.as_tensor(bw), torch.tensor(0.7), tkey).numpy()
               for f in tb]
        for p, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(g, w), ttrig.POLICIES[p]
        assert np.array_equal(got[3], (prng.uniform(tkey, (m,)) < 0.3).numpy()[rows])


@pytest.mark.parametrize("model", ["svm", "mlp", "mlp_blocks"])
def test_init_rows_matches_reference(model):
    """The rows of ``init_stack`` without the whole stack: per-device keys
    (svm, mlp) or the shared init (mlp_blocks)."""
    m, rows = 12, np.asarray([0, 5, 6, 11], np.int32)
    js = jspec.make_model_spec(model, dim=16, n_classes=10)
    ts = tspec.make_model_spec(model, dim=16, n_classes=10)
    with jax.threefry_partitionable(False):
        want = np.asarray(jefhc._flatten_stack(
            js.init_rows(jax.random.PRNGKey(4), m, jnp.asarray(rows))))
    got = tefhc.flatten_stack(ts.init_rows(prng.PRNGKey(4), m, torch.as_tensor(rows)))
    full = tefhc.flatten_stack(ts.init_stack(prng.PRNGKey(4), m))
    assert torch.equal(got, full[rows])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


# ---- the halo forms on a plan's shards --------------------------------------

def _shard_fixture(S=4, m=64, d=33, seed=0):
    """A plan's shards on an rgg fabric with edge dropout, a broadcast
    pattern and flat rows, host numpy, with the full-fleet arrays."""
    jg, tg = _plan_pair("rgg", m, S)
    plan = ttopo.shard_plan(tg.edges, S, coords=tg.coords)
    nl = tg.neighbors()
    staged = ttopo.StagedNeighbors.from_host(nl, "cpu")
    adj = tg.adjacency_ell(2, staged)
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.uniform(size=m) < 0.4)
    comm = adj & (v[:, None] | v[staged.idx])
    w = rng.normal(size=(m, d)).astype(np.float32)
    return plan, staged, adj, comm, w


def _shard_tables(plan):
    return {f: jnp.asarray(getattr(plan, f)) for f in
            ("owned", "nbr_gid", "nbr_loc", "mask", "send_idx", "recv_src")}


def _ref_halo(plan, x):
    """The reference's ``halo_exchange`` of the full-fleet per-row ``x`` on
    every shard, under ``jax.vmap`` over the shards: (S, H_max, ...)."""
    def one(tabs, xs):
        ctx = jefhc.ShardCtx(**tabs)
        return jefhc.halo_exchange(ctx, "fl", xs)

    return jax.vmap(one, axis_name="fl")(_shard_tables(plan), jnp.asarray(x)[plan.owned])


def test_build_p_ell_halo_matches_reference():
    plan, staged, adj, comm, _ = _shard_fixture()
    deg = adj.sum(-1, dtype=torch.int32).numpy()
    deg_halo = np.asarray(_ref_halo(plan, deg))
    p_diag_full, p_off_full = tmixing.build_p_ell(staged.idx, adj, comm)
    for s in range(plan.n_shards):
        own = plan.owned[s]
        deg_buf = np.concatenate([deg[own], deg_halo[s]])
        want = jmixing.build_p_ell_halo(jnp.asarray(plan.nbr_loc[s]), jnp.asarray(adj[own].numpy()),
                                        jnp.asarray(comm[own].numpy()), jnp.asarray(deg_buf))
        got = tmixing.build_p_ell_halo(torch.as_tensor(plan.nbr_loc[s], dtype=torch.int64),
                                       adj[own], comm[own], torch.as_tensor(deg_buf))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
        # beta is elementwise: the shard's rows are the single device's
        assert torch.equal(got[1], p_off_full[own]) and torch.equal(got[0], p_diag_full[own])


def test_mix_sparse_halo_matches_reference_and_the_fleet_mix():
    plan, staged, adj, comm, w = _shard_fixture()
    p_diag, p_off = tmixing.build_p_ell(staged.idx, adj, comm)
    full = tcons.mix_sparse(staged.idx, p_diag, p_off, torch.as_tensor(w))
    halo = np.array(_ref_halo(plan, w))
    for s in range(plan.n_shards):
        own = plan.owned[s]
        loc = plan.nbr_loc[s]
        want = jcons.mix_sparse_halo(jnp.asarray(loc), jnp.asarray(p_diag[own].numpy()),
                                     jnp.asarray(p_off[own].numpy()), jnp.asarray(w[own]),
                                     jnp.asarray(halo[s]))
        got = tcons.mix_sparse_halo(torch.as_tensor(loc, dtype=torch.int64), p_diag[own],
                                    p_off[own], torch.as_tensor(w[own]),
                                    torch.as_tensor(halo[s]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        assert torch.equal(got, full[own])  # the single device's rows, bit for bit


@pytest.mark.parametrize("S", [2, 8])
def test_rectangular_mix_sparse_bit_equal_to_halo_mix_and_plan_replay(S):
    """All local shards in one call over the stacked [own; halo] buffer
    (the engine's layout, ``ShardCtx.nbr_loc``): the plain path equals the
    per-shard halo mix bit for bit; the plan of the rectangular table
    keeps every slot within its group's union and its replay of the
    kernels gives the plain bits, NaN for NaN; an index past the buffer
    is refused."""
    plan, staged, adj, comm, w = _shard_fixture(S=S, d=70)
    ctx = tefhc.ShardCtx.of(plan, range(S), "cpu")
    p_diag, p_off = tmixing.build_p_ell(staged.idx, adj, comm)
    own = plan.owned.reshape(-1)
    halo = np.array(_ref_halo(plan, w)).reshape(-1, w.shape[1])
    src = torch.as_tensor(np.concatenate([w[own], halo]))
    assert src.shape[0] == plan.m + S * plan.h_max > plan.m
    got = tmix.mix_sparse(ctx.nbr_loc, p_diag[own], p_off[own], src)
    per = torch.cat([tcons.mix_sparse_halo(torch.as_tensor(plan.nbr_loc[s], dtype=torch.int64),
                                           p_diag[plan.owned[s]], p_off[plan.owned[s]],
                                           torch.as_tensor(w[plan.owned[s]]),
                                           torch.as_tensor(halo.reshape(S, plan.h_max, -1)[s]))
                     for s in range(S)])
    assert torch.equal(got, per)
    pl = tplan.build_plan(ctx.nbr_loc)
    assert pl.n_src == int(ctx.nbr_loc.max()) + 1 > plan.m and not pl.wide
    rows = pl.rows.numpy()
    assert np.array_equal(np.sort(np.concatenate([rows, pl.direct.numpy()])),
                          np.arange(plan.m))
    assert torch.equal(_replay(pl, ctx.nbr_loc, p_diag[own], p_off[own], src), got)
    # inf and NaN in a source row every reader weights zero, NaN for NaN
    silent = int(ctx.nbr_loc[0, 0])
    p_off2 = torch.where(ctx.nbr_loc == silent, 0.0, p_off[own])
    bad = src.clone()
    bad[silent, 3], bad[silent, 50:52] = float("inf"), float("nan")
    want = tmix.mix_sparse(ctx.nbr_loc, p_diag[own], p_off2, bad)
    torch.testing.assert_close(_replay(pl, ctx.nbr_loc, p_diag[own], p_off2, bad), want,
                               atol=0, rtol=0, equal_nan=True)
    with pytest.raises(ValueError):
        tmix.mix_sparse(ctx.nbr_loc, p_diag[own], p_off[own], src[:plan.m - 1])


def test_watchdog_step_halo_matches_reference():
    """A few monitor iterations over a plan's shards: the port's halo
    watchdog against the reference's (its pmax under vmap) and against the
    single-device ``watchdog_step``."""
    S, m = 4, 64
    plan, staged, adj, _, _ = _shard_fixture(S=S, m=m)
    ctx = tefhc.ShardCtx.of(plan, range(S), "cpu")
    group = make_fleet_group(S)
    cfg = tflow.WatchdogConfig(window=3, n_prop=0)
    jcfg = jflow.WatchdogConfig(window=3, n_prop=0)
    rng = np.random.default_rng(5)
    own = plan.owned.reshape(-1)
    age_full = tflow.watchdog_init(m, plan.d_max).age
    age_sh = age_full[own]
    age_ref = jnp.asarray(age_full.numpy()[plan.owned])

    def ref_step(tabs, comm, age):
        ctx_j = jefhc.ShardCtx(**tabs)
        return jflow.watchdog_step_halo(jcfg, m, ctx_j.nbr_loc, ctx_j.owned, comm, age,
                                        lambda x: jefhc.halo_exchange(ctx_j, "fl", x), "fl")

    def buf(x):
        return torch.cat([x, tefhc.halo_exchange(ctx, group, x)])

    for k in range(4):
        comm = adj & torch.as_tensor(rng.uniform(size=adj.shape) < 0.5)
        age_full, ok_f, need_f = tflow.watchdog_step(cfg, staged.idx, comm, age_full)
        age_sh, ok, need = tflow.watchdog_step_halo(
            cfg, m, ctx.nbr_loc, ctx.owned, comm[own], age_sh, buf,
            lambda d: group.max(d.reshape(S, -1).amax(dim=1)))
        age_ref, ok_r, need_r = jax.vmap(ref_step, axis_name="fl")(
            _shard_tables(plan), jnp.asarray(comm.numpy()[plan.owned]), age_ref)
        assert torch.equal(age_sh, age_full[own])
        assert np.array_equal(age_sh.numpy().reshape(age_ref.shape), np.asarray(age_ref))
        assert int(need) == int(need_f) == int(np.asarray(need_r)[0])
        assert bool(ok) == bool(ok_f) == bool(np.asarray(ok_r)[0])


# ---- the engine --------------------------------------------------------------

def _worker_data(mod_img, m, dim, n=1024):
    x, y = mod_img(n, seed=0, dim=dim)
    rng = np.random.default_rng(0)
    return x, y, [np.sort(p) for p in np.array_split(rng.permutation(len(y)), m)]


def _golden_case():
    # tests/sharded_worker.py check_golden: m=8, 8 shards is every neighbor
    # a halo row
    return dict(m=8, T=18, dim=24, graph=("rgg", dict(time_varying="edge_dropout",
                                                     drop=0.3, seed=0)),
                sim=dict(batch=8, r=50.0), eval_every=5, golden=True)


_FAULTS = dict(policy="zero", cluster_fail_rate=0.15, cluster_recover_rate=0.3,
               partition_start=2, partition_len=2, flap_rate=0.2, flap_len=2,
               crash_rate=0.1, rejoin_rate=0.3, warm_start=True, watchdog_window=3)
# the m=256 configurations of tests/sharded_worker.py
CASES = {
    "golden_m8": _golden_case(),
    "parity_static": dict(graph=("rgg", dict(radius=0.15, time_varying="static"))),
    "parity_edge_dropout": dict(graph=("rgg", dict(radius=0.15, time_varying="edge_dropout",
                                                   drop=0.3))),
    "parity_partition_cycle": dict(graph=("rgg", dict(radius=0.15,
                                                      time_varying="partition_cycle",
                                                      cycle_len=2))),
    "scale_free": dict(graph=("scale_free", dict(time_varying="edge_dropout", drop=0.3))),
    "clustered": dict(graph=("clustered", dict(time_varying="edge_dropout", drop=0.3))),
    "resources": dict(graph=("clustered", dict(time_varying="edge_dropout", drop=0.3)),
                      sim=dict(policy="zero", churn_rate=0.2, straggle_rate=0.2,
                               bw_walk=0.1, budget_bytes=2.5 * 4 * (32 * 10 + 10))),
    "faults_watchdog": dict(T=6, graph=("clustered", dict(time_varying="edge_dropout",
                                                          drop=0.3)),
                            sim=_FAULTS),
}


def _case(name):
    c = dict(m=256, T=4, dim=32, sim={}, eval_every=None, golden=False)
    c.update(CASES[name])
    c["graph"][1].setdefault("seed", 0)
    return c


def _ref_run(c):
    topo, gkw = c["graph"]
    g = jtopo.make_process(c["m"], topo, **gkw)
    if c["golden"]:
        x, y = jimage_dataset(600, seed=0, dim=c["dim"])
        parts = jby_labels(y, c["m"], 3)
    else:
        x, y, parts = _worker_data(jimage_dataset, c["m"], c["dim"])
    sim = jsim.SimConfig(m=c["m"], iters=c["T"], dim=c["dim"], seed=0, trace="summary",
                         mix_impl="sparse", **{"r": 50.0, **c["sim"]})
    with jax.threefry_partitionable(False):
        return jsim.run(sim, g, JBatches(x, y, parts, sim.batch, seed=2), None,
                        eval_every=c["eval_every"] or c["T"])


def _port_run(c, mix_impl, shards=1, seed=0):
    topo, gkw = c["graph"]
    g = ttopo.make_process(c["m"], topo, **gkw)
    if c["golden"]:
        x, y = image_dataset(600, seed=0, dim=c["dim"])
        parts = by_labels(y, c["m"], 3)
    else:
        x, y, parts = _worker_data(image_dataset, c["m"], c["dim"])
    sim = tsim.SimConfig(m=c["m"], iters=c["T"], dim=c["dim"], seed=seed, trace="summary",
                         mix_impl=mix_impl, shards=shards, **{"r": 50.0, **c["sim"]})
    return tsim.run(sim, g, FederatedBatches(x, y, parts, sim.batch, seed=2), None,
                    eval_every=c["eval_every"] or c["T"], device="cpu")


def _assert_reference(got, want, label):
    np.testing.assert_allclose(got.bandwidths, np.asarray(want.bandwidths), rtol=1e-6)
    for f in INT_CHANNELS:
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f))), \
            f"{label}: {f}"
    for f in FLOAT_CHANNELS + ("consensus_err",):
        np.testing.assert_allclose(getattr(got, f), np.asarray(getattr(want, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{label}: {f}")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_engine_matches_reference_and_is_shard_invariant(name):
    """The port at S = 1, 2, 4, 8 against the reference's sparse run, and
    within the port every channel but ``consensus_err`` bit-equal to its
    ``sparse`` run at every S."""
    c = _case(name)
    want = _ref_run(c)
    plain = _port_run(c, "sparse")
    _assert_reference(plain, want, f"{name} sparse")
    if c["golden"]:
        gold = json.loads((ROOT / "tests" / "golden" / "efhc_m8_trajectory.json").read_text())
        for f in ("v", "comm_count", "deg"):
            assert np.array_equal(np.asarray(getattr(plain, f), np.int64),
                                  np.asarray(gold[f], np.int64)), f
    for S in SHARDS:
        got = _port_run(c, "sharded", S)
        _assert_reference(got, want, f"{name} S={S}")
        for f in EXACT_CHANNELS:
            assert np.array_equal(getattr(got, f), getattr(plain, f)), f"{name} S={S}: {f}"
        np.testing.assert_allclose(got.consensus_err, plain.consensus_err, rtol=1e-5)
    if name == "resources":
        assert plain.down_count.max() > 0 and plain.exhausted_count.max() > 0
    if name == "faults_watchdog":
        assert plain.fault_down_count.max() > 0 and plain.stale_max.max() > 0


def test_sharded_engine_with_models_policies_and_optimizers():
    """mlp with Adam under gossip, and mlp_blocks under efhc, with an
    EvalFn: the sharded run equals the sparse run on every channel but
    ``consensus_err``, accuracy included."""
    from repro_torch.fl.simulator import make_eval_fn

    x, y = image_dataset(800, seed=0, dim=16)
    xt, yt = image_dataset(120, seed=1, dim=16)
    parts = by_labels(y, 32, 3)
    g = ttopo.make_process(32, "rgg", radius=0.3, time_varying="edge_dropout", seed=0)
    for kw in (dict(model="mlp", optimizer="adam", policy="gossip"),
               dict(model="mlp_blocks", policy="efhc", crash_rate=0.1, warm_start=True)):
        sim = tsim.SimConfig(m=32, iters=7, dim=16, batch=8, r=30.0, trace="summary",
                             mix_impl="sparse", **kw)
        ev = make_eval_fn(sim, xt, yt)
        plain = tsim.run(sim, g, FederatedBatches(x, y, parts, 8, seed=2), ev,
                         eval_every=3, device="cpu")
        got = tsim.run(dataclasses.replace(sim, mix_impl="sharded", shards=4), g,
                       FederatedBatches(x, y, parts, 8, seed=2), ev, eval_every=3,
                       device="cpu")
        for f in EXACT_CHANNELS:
            assert np.array_equal(getattr(got, f), getattr(plain, f)), (kw, f)
        np.testing.assert_allclose(got.consensus_err, plain.consensus_err, rtol=1e-5)
        assert got.acc[-1] > 0


def test_make_sharded_engine_contract():
    """``(engine, model_dim, plan)``; one cell a call; trajectories in
    global device order with timing; the plan is ``shard_plan``'s."""
    c = _case("parity_edge_dropout")
    g = ttopo.make_process(256, "rgg", **c["graph"][1])
    x, y, parts = _worker_data(image_dataset, 256, 32)
    sim = tsim.SimConfig(m=256, iters=4, dim=32, trace="summary", mix_impl="sharded",
                         shards=4)
    eng, model_dim, plan = tsharded.make_sharded_engine(sim, g, T=4, eval_every=4, x=x,
                                                        y=y, device="cpu")
    assert model_dim == 330 and plan.n_shards == 4 and plan.ms == 64
    want = ttopo.shard_plan(g.edges, 4, coords=g.coords)
    assert np.array_equal(plan.owned, want.owned)
    idx = FederatedBatches(x, y, parts, 16, seed=2).stage(4)[None]
    host, timing = eng([0], [0], idx)
    assert host["v"].shape == (1, 4, 256) and host["bandwidths"].shape == (1, 256)
    assert set(timing) == {"first_step_ms", "ms_per_step"}
    res = tsim.result_of_cell(host, 0, model_dim, "summary")
    plain = _port_run(c, "sparse")
    assert np.array_equal(res.v, plain.v) and np.array_equal(res.loss, plain.loss)
    with pytest.raises(ValueError, match="one cell a call"):
        eng([0, 1], [0, 1], np.concatenate([idx, idx]))


def test_sharded_sweep_and_service_run_cells_serially():
    """``run_sweep`` and ``api.serve`` take sharded cells one after another
    on the one cached engine: the grid against the reference's sweep of
    the same scenario (its sparse engine: in one process the reference has
    one device), each cell against its solo sharded run."""
    spec = dict(m=16, dim=16, n_train=400, n_test=80, iters=6, eval_every=3, batch=8,
                r=30.0, topology="rgg")
    tspec_ = tapi.ScenarioSpec(mix_impl="sharded", shards=4, **spec)
    with jax.threefry_partitionable(False):
        want = japi.sweep(japi.ScenarioSpec(mix_impl="sparse", **spec), seeds=(0, 1))
    tsim._ENGINE_CACHE.clear()
    got = tapi.sweep(tspec_, seeds=(0, 1), device="cpu")
    assert tsim.engine_cache_stats().entries == 1
    assert got.v.shape == (2, 4, 6, 16) and got.policies == tuple(ttrig.POLICIES)
    for f in ("v", "comm_count", "deg"):
        assert np.array_equal(getattr(got, f), np.asarray(getattr(want, f))), f
    for f in ("loss", "acc", "tx_time", "util", "consensus_err"):
        np.testing.assert_allclose(getattr(got, f), np.asarray(getattr(want, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    solo = tapi.simulate(dataclasses.replace(tspec_, policy="gossip", seeds=(1,)),
                         device="cpu")
    cell = got.result(1, "gossip")
    for f in EXACT_CHANNELS + ("consensus_err",):
        assert np.array_equal(getattr(cell, f), getattr(solo, f)), f
    reports = tapi.serve([dataclasses.replace(tspec_, policy=p, seeds=(0, 1))
                          for p in ("efhc", "gossip")], device="cpu")
    assert [r.ok for r in reports] == [True, True]
    assert len({r.launch_id for r in reports}) == 1 and reports[0].launch_cells == 4
    assert all(r.engine_cache_hit for r in reports)
    for f in EXACT_CHANNELS + ("consensus_err",):
        assert np.array_equal(getattr(reports[1].results[1], f), getattr(solo, f)), f


def test_sharded_refusals():
    """The reference's refusals: link-matrix traces, the python engine and
    host eval callables, ``run_checkpointed``; and more shards than the
    fleet divides into."""
    with pytest.raises(ValueError, match="summary"):
        tsim.SimConfig(mix_impl="sharded", trace="packed")
    sim = tsim.SimConfig(m=8, iters=2, dim=8, trace="summary", mix_impl="sharded", shards=2)
    g = ttopo.make_process(8, "ring")
    x, y = image_dataset(80, seed=0, dim=8)
    b = FederatedBatches(x, y, by_labels(y, 8, 3), 4, seed=2)
    with pytest.raises(ValueError, match="engine='scan'"):
        tsim.run(sim, g, b, None, engine="python", device="cpu")
    with pytest.raises(ValueError, match="host eval callable"):
        tsim.run(sim, g, b, lambda w: 0.0, device="cpu")
    with pytest.raises(ValueError, match="not checkpointable"):
        tsim.run_checkpointed(sim, g, b, None, ckpt_dir="unused", checkpoint_every=2,
                              device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        tsim.run(dataclasses.replace(sim, shards=3), g, b, None, device="cpu")
    with pytest.raises(ValueError, match="host callable"):
        tsharded.make_sharded_engine(sim, g, T=2, x=x, y=y, eval_fn=lambda w: 0.0,
                                     device="cpu")
    assert make_fleet_group(4) == (4, 1, 0, False)  # one process holds every shard


# ---- the reference's own sharded engine on 8 forced host devices ------------

_REF_SHARDED = r"""
import sys
import numpy as np
from repro.core.topology import make_process
from repro.data.loader import FederatedBatches
from repro.data.synthetic import image_dataset
from repro.fl.simulator import SimConfig, run
m, T, dim = 256, 4, 32
x, y = image_dataset(1024, seed=0, dim=dim)
rng = np.random.default_rng(0)
parts = [np.sort(p) for p in np.array_split(rng.permutation(len(y)), m)]
graph = make_process(m, "rgg", radius=0.15, time_varying="edge_dropout", drop=0.3, seed=0)
sim = SimConfig(m=m, iters=T, dim=dim, r=50.0, seed=0, trace="summary",
                mix_impl="sharded", shards=8)
res = run(sim, graph, FederatedBatches(x, y, parts, sim.batch, seed=2), None, eval_every=T)
np.savez(sys.argv[1], **{f: np.asarray(getattr(res, f)) for f in
         ("v", "comm_count", "deg", "loss", "tx_time", "util", "consensus_err",
          "bandwidths")})
"""


def test_reference_sharded_engine_on_8_devices_matches_port(tmp_path):
    out = tmp_path / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_THREEFRY_PARTITIONABLE="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _REF_SHARDED, str(out)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(out)
    got = _port_run(_case("parity_edge_dropout"), "sharded", 8)
    for f in ("v", "comm_count", "deg"):
        assert np.array_equal(getattr(got, f), want[f]), f
    for f in ("loss", "tx_time", "util", "consensus_err", "bandwidths"):
        np.testing.assert_allclose(getattr(got, f), want[f], rtol=RTOL, atol=ATOL,
                                   err_msg=f)
