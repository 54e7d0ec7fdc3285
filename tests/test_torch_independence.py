"""repro_torch stands alone: no module of it, and not chip_smoke.py,
imports jax, the JAX package or msgpack (the checkpoints carry their own
packer); importing it loads no jax (the sharded engine and its shard
group included); it never moves to the CPU on its own; what it has not
ported yet (the python engine) raises NotImplementedError while invalid
values keep the reference's messages; and every scenario-dynamics knob
runs and gives the reference's channels."""
import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.fl import service as jservice  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.fl import service as tservice  # noqa: E402
from repro_torch.fl import simulator as tsim  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [n for n in _imports(path)
           if n.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack")]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch, repro_torch.api, "
            "repro_torch.convert, repro_torch.kernels.build, "
            "repro_torch.configs, repro_torch.launch.steps, "
            "repro_torch.launch.train, repro_torch.checkpoint.msgpack_ckpt, "
            "repro_torch.fl.sharded, repro_torch.launch.mesh; "
            "assert 'jax' not in sys.modules, 'jax loaded'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro loaded'")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = tapi.ScenarioSpec(m=4, dim=8, n_train=40, n_test=8, iters=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.simulate(spec, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.simulate(spec)  # the default device is the card
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.sweep(spec, seeds=(0, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.serve([spec])
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.ScenarioService()
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train(smoke_config("starcoder2-15b"), m=2, steps=1)  # the default device


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Alone in a directory, or with no card, the smoke script exits
    non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


DYN_SPEC = dict(m=8, dim=16, n_train=320, n_test=80, iters=12, eval_every=4,
                batch=8, trace="full", r=30.0)


@pytest.mark.parametrize("kw", [
    dict(churn_rate=0.1),
    dict(budget_bytes=1e3),
    dict(crash_rate=0.1),
    dict(watchdog_window=4),
    dict(flap_rate=0.1),
    dict(partition_start=0, partition_len=4),
])
def test_dynamics_knobs_run_and_match_reference(kw):
    """Each knob set that once raised NotImplementedError runs in the port
    and gives the reference's channels: integers (the six dynamics
    channels, v, counts, links) equal, floats within the golden
    tolerances."""
    spec = dict(DYN_SPEC, **kw)
    with jax.threefry_partitionable(False):
        want = japi.simulate(japi.ScenarioSpec(**spec))
    got = tapi.simulate(tapi.ScenarioSpec(**spec), device="cpu")
    for f in ("v", "comm_count", "deg", "down_count", "exhausted_count",
              "fault_down_count", "stale_max", "window_connected", "window_needed"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert np.array_equal(got.comm, want.comm) and np.array_equal(got.adj, want.adj)
    for f in ("loss", "acc", "tx_time", "util", "consensus_err"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=2e-4,
                                   atol=2e-5, err_msg=f)


def test_unported_entry_points_raise_not_implemented():
    spec = tapi.ScenarioSpec(m=4, dim=8, n_train=40, n_test=8, iters=2)
    grid = tapi.sweep(spec, seeds=(0,), device="cpu")  # item 5 is ported
    assert grid.v.shape == (1, 4, 2, 4) and grid.policies == ("efhc", "zero",
                                                             "global", "gossip")
    reports = tapi.serve([spec], device="cpu")  # item 8 is ported
    assert len(reports) == 1 and reports[0].ok and set(reports[0].results) == {0}
    with pytest.raises(NotImplementedError, match="python"):
        tsim.run(tsim.SimConfig(m=2), None, None, engine="python", device="cpu")


def test_python_engine_refusals_name_the_item_that_ports_it():
    """Both refusals of ``engine='python'`` name ROADMAP Queue 1 item 10."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tsim.run(tsim.SimConfig(m=2), None, None, engine="python", device="cpu")
    from repro_torch.fl import baselines

    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        baselines.compare(tsim.SimConfig(m=2), None, None, None, engine="python",
                                device="cpu")


@pytest.mark.parametrize("kw", [
    dict(policy="nope"), dict(model="resnet"), dict(optimizer="lion"),
    dict(mix_impl="fast"), dict(trace="dense"), dict(m=0), dict(iters=0),
    dict(batch=0), dict(shards=0), dict(shards=2), dict(sigma_n=1.0),
    dict(mix_impl="sharded", trace="full"), dict(topology="torus"),
    dict(time_varying="churn"), dict(partition="iid"), dict(n_train=0),
    dict(eval_every=0), dict(seeds=()), dict(deadline_s=-1.0),
    dict(churn_rate=1.5), dict(bw_walk=-1), dict(budget_bytes=-1),
    dict(flap_len=0), dict(partition_len=-1), dict(watchdog_window=-1),
    dict(watchdog_nprop=-1),
])
def test_validation_messages_match_reference(kw):
    with pytest.raises(ValueError) as want:
        jservice.ScenarioSpec(**kw)
    with pytest.raises(ValueError) as got:
        tservice.ScenarioSpec(**kw)
    assert str(got.value) == str(want.value)
