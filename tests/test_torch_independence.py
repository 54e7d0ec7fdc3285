"""repro_torch stands alone: no module of it, and not chip_smoke.py,
imports jax or the JAX package; importing it loads no jax; it never
moves to the CPU on its own; and what it has not ported yet raises
NotImplementedError while invalid values keep the reference's messages."""
import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

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
           if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch, repro_torch.api, "
            "repro_torch.convert, repro_torch.kernels.build; "
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


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Alone in a directory, or with no card, the smoke script exits
    non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("kw,item", [
    (dict(churn_rate=0.1), "item 7"),
    (dict(budget_bytes=1e6), "item 7"),
    (dict(crash_rate=0.1), "item 7"),
    (dict(watchdog_window=4), "item 7"),
    (dict(mix_impl="sharded"), "item 9"),
    (dict(model="cnn"), "item 6"),
    (dict(model="tiny_transformer"), "item 6"),
])
def test_unported_features_raise_not_implemented(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        tsim.SimConfig(**kw, **({"trace": "summary"}
                                if kw.get("mix_impl") == "sharded" else {}))
    with pytest.raises(NotImplementedError, match=item):
        tservice.ScenarioSpec(**kw)


def test_unported_entry_points_raise_not_implemented():
    spec = tapi.ScenarioSpec(m=4, dim=8)
    with pytest.raises(NotImplementedError, match="item 5"):
        tapi.sweep(spec)
    with pytest.raises(NotImplementedError, match="item 8"):
        tapi.serve([spec])
    with pytest.raises(NotImplementedError, match="python"):
        tsim.run(tsim.SimConfig(m=2), None, None, engine="python", device="cpu")


@pytest.mark.parametrize("kw", [
    dict(policy="nope"), dict(model="resnet"), dict(optimizer="lion"),
    dict(mix_impl="fast"), dict(trace="dense"), dict(m=0), dict(iters=0),
    dict(batch=0), dict(shards=0), dict(shards=2), dict(sigma_n=1.0),
    dict(mix_impl="sharded", trace="full"), dict(topology="torus"),
    dict(time_varying="churn"), dict(partition="iid"), dict(n_train=0),
    dict(eval_every=0), dict(seeds=()), dict(deadline_s=-1.0),
])
def test_validation_messages_match_reference(kw):
    with pytest.raises(ValueError) as want:
        jservice.ScenarioSpec(**kw)
    with pytest.raises(ValueError) as got:
        tservice.ScenarioSpec(**kw)
    assert str(got.value) == str(want.value)
