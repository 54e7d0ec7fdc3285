"""The sharded fleet engine across ``torch.distributed`` ranks on the CPU.

Each case spawns its ranks as processes of this file (gloo, a file store
under the test's ``tmp_path``, a timeout each): world 2 with 2 shards a
rank and world 4 with 1, S = 4, with churn, crashes with warm start,
flapping links and the watchdog on.  Every rank returns the whole fleet's
trajectories, and every channel, ``consensus_err`` included, equals the
one-process S = 4 run bit for bit.  A world that does not divide S is
refused.

The same ranks on NCCL, each on its own card (``ShardGroup.device``), run
where the machine has a CUDA device a rank and skip elsewhere:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_sharded_dist.py
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHANNELS = ("v", "comm_count", "deg", "loss", "acc", "tx_time", "util",
            "consensus_err", "bandwidths", "down_count", "exhausted_count",
            "fault_down_count", "stale_max", "window_connected", "window_needed")
INT_CHANNELS = ("v", "comm_count", "deg", "down_count", "exhausted_count",
                "fault_down_count", "stale_max", "window_connected", "window_needed")
TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its runs are many small ops,
    which torch's OpenMP threads slow a hundredfold when several test
    workers share the cores; both sides of every comparison run so."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(device="cpu"):
    """The S = 4 scenario, in this process's layout."""
    from repro_torch.core.topology import make_process
    from repro_torch.data.loader import FederatedBatches
    from repro_torch.data.partition import by_labels
    from repro_torch.data.synthetic import image_dataset
    from repro_torch.fl.simulator import SimConfig, make_eval_fn, run

    m = 64
    x, y = image_dataset(600, seed=0, dim=24)
    xt, yt = image_dataset(100, seed=1, dim=24)
    graph = make_process(m, "rgg", radius=0.3, time_varying="edge_dropout", drop=0.3,
                         seed=0)
    sim = SimConfig(m=m, iters=8, dim=24, batch=8, r=50.0, trace="summary",
                    mix_impl="sharded", shards=4, churn_rate=0.1, straggle_rate=0.1,
                    crash_rate=0.1, warm_start=True, flap_rate=0.2, watchdog_window=3)
    return run(sim, graph, FederatedBatches(x, y, by_labels(y, m, 3), 8, seed=2),
               make_eval_fn(sim, xt, yt), eval_every=5, device=device)


def _rank_main(rank: int, world: int, store: str, out: str, backend: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_fleet_group

    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=world,
                            rank=rank)
    try:
        group = make_fleet_group(4)
        assert (group.world, group.rank, group.local) == (world, rank, 4 // world)
        with pytest.raises(ValueError, match="divisible"):
            make_fleet_group(world + 1)
        res = _run("cuda" if backend == "nccl" else "cpu")
        if backend == "nccl":
            # the rank ran on its own card and left the others alone
            assert torch.cuda.current_device() == rank
            assert [torch.cuda.memory_allocated(c) > 0
                    for c in range(torch.cuda.device_count())] == [
                c == rank for c in range(torch.cuda.device_count())]
        np.savez(out, **{f: getattr(res, f) for f in CHANNELS})
    finally:
        dist.destroy_process_group()


def _ranks(tmp_path, world: int, backend: str) -> list:
    """Spawn ``world`` ranks of this file on ``backend``; their channels."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world),
                               str(tmp_path / "store"), str(tmp_path / f"rank{r}.npz"),
                               backend],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-2000:] for log in logs)
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_equal_one_process(tmp_path, world):
    got = _ranks(tmp_path, world, "gloo")
    want = _run()
    for r, ranks in enumerate(got):
        for f in CHANNELS:
            assert np.array_equal(ranks[f], getattr(want, f)), f"rank {r}: {f}"
    assert want.fault_down_count.max() > 0 and want.down_count.max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("world", [2, 4])
def test_nccl_ranks_on_their_own_cards(tmp_path, world):
    """NCCL ranks, one card each, against the one-process run on the card:
    integer channels equal and floats within the engine tests' rtol 2e-4 /
    atol 2e-5 (a rank's batched products over fewer rows may take other
    cuBLAS algorithms); whether each channel is bit-equal is printed."""
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices, one a rank")
    got = _ranks(tmp_path, world, "nccl")
    want = _run("cuda")
    for r, ranks in enumerate(got):
        for f in CHANNELS:
            if f in INT_CHANNELS:
                assert np.array_equal(ranks[f], getattr(want, f)), f"rank {r}: {f}"
            else:
                np.testing.assert_allclose(ranks[f], getattr(want, f), rtol=2e-4,
                                           atol=2e-5, err_msg=f"rank {r}: {f}")
        differ = [f for f in CHANNELS if not np.array_equal(ranks[f], getattr(want, f))]
        print(f"nccl world {world} rank {r}: "
              f"{'every channel bit-equal' if not differ else f'not bit-equal: {differ}'}"
              f" to the one-process run")
    assert want.fault_down_count.max() > 0 and want.down_count.max() > 0


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
               sys.argv[5])
