"""Training the architectures ported after starcoder2 against the reference,
on the CPU: hymba-1.5b and xlstm-125m here, paligemma-3b, hubert-xlarge and
deepseek-v3-671b in ``test_torch_train_archs_more.py`` (which imports this
file's helpers).

For each architecture's smoke configuration, with the reference's weights
carried across by ``convert.arch_params_from_jax``: ``loss_fn`` and every
leaf's gradient (``torch.autograd`` against ``jax.value_and_grad``) in fp32
at batch 2 x 32 with a random loss mask (paligemma and hubert with random
frontend embeddings; hymba under the ``xla`` and ``chunked`` attention
paths, its Mamba branch through ``kernels.scan.ops.SelectiveScan``); then
three EF-HC train steps at m=4 on a ring with pods=2 against the
reference's ``make_train_step`` / ``make_neighbor_train_step`` jitted on a
one-device host mesh, one dtype and schedule an architecture (xlstm in
bf16): ``trigger_rate`` equal at every step, the loss, the parameters and
w_hat within tolerance.  The reference runs inside
``jax.threefry_partitionable(False)``.

Tolerances: fp32 the golden rtol 2e-4 / atol 2e-5; bf16 parameters rtol
2^-7 beside a floor of 4 bf16 ulps of the leaf's largest value
(``tests/test_torch_train.py`` states why), the loss rtol 2^-7.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.data.loader import lm_batches  # noqa: E402
from repro.data.synthetic import token_dataset  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smoke_config as tsmoke  # noqa: E402
from repro_torch.kernels.scan import ops as tscan  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# many small ops: one thread keeps the file's time low under pytest -n 6
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
BF16_RTOL = 2.0 ** -7
BF16_LEAF_ULPS = 4
M_REPL, PODS, STEPS = 4, 2, 3
BATCH, SEQ = 2, 32


def cfgs(arch: str, **kw):
    return (dataclasses.replace(jsmoke(arch), **kw), dataclasses.replace(tsmoke(arch), **kw))


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t32(t) -> np.ndarray:
    return t.detach().float().numpy()


def ref_params(jcfg):
    """The reference's weights of ``jcfg`` (fp32 leaves for an fp32 config)."""
    with jax.threefry_partitionable(False):
        return jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(0)))


def _frontend(cfg, rng, lead: tuple[int, ...], s: int) -> np.ndarray:
    """Random frontend embeddings: the vision patches, or s audio frames."""
    nt = cfg.frontend.tokens if cfg.frontend.kind == "vision" else s
    return rng.normal(size=(*lead, nt, cfg.frontend.dim)).astype(np.float32)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.as_tensor(v, dtype=torch.int64 if v.dtype == np.int32 else torch.float32)
            for k, v in batch.items()}


def check_loss_and_grads(arch: str, **kw):
    """``loss_fn`` and every leaf's gradient, fp32, batch BATCH x SEQ with a
    random loss mask (and random frontend embeddings)."""
    jcfg, tcfg = cfgs(arch, **kw)
    params = ref_params(jcfg)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, jcfg.vocab, size=(BATCH, SEQ)).astype(np.int32),
             "targets": rng.integers(0, jcfg.vocab, size=(BATCH, SEQ)).astype(np.int32),
             "loss_mask": (rng.random((BATCH, SEQ)) < 0.8).astype(np.float32)}
    if jcfg.frontend is not None:
        batch["frontend"] = _frontend(jcfg, rng, (BATCH,), SEQ)
    jb = _jbatch(batch)
    (jloss, jmet), jgrad = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, jb), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tparams = convert.arch_params_from_jax(params, "cpu")
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    tloss, tmet = TM.loss_fn(tcfg, tparams, _tbatch(batch))
    # hubert's frames take the token embedding's place: its gradient is 0,
    # as jax.grad gives it
    grads = torch.autograd.grad(tloss, leaves, allow_unused=True, materialize_grads=True)
    assert sorted(tmet) == sorted(jmet)
    for name in jmet:
        np.testing.assert_allclose(float(tmet[name].detach()), float(jmet[name]), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    pairs = list(zip(jax.tree_util.tree_leaves_with_path(jgrad), grads, strict=True))
    for (path, a), g in pairs:
        np.testing.assert_allclose(_t32(g), _f32(a), rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert sum(bool(g.abs().max() > 0) for g in grads) >= len(grads) - 2  # gradients reach


def _batches(cfg, steps: int, seed: int = 0):
    """Each replica's ``lm_batches`` over its shard of a token stream,
    stacked (M_REPL, BATCH, SEQ); with a frontend, random embeddings
    and a random loss mask."""
    stream = token_dataset(8000, vocab=cfg.vocab, seed=seed)
    iters = [lm_batches(s, BATCH, SEQ, seed=i)
             for i, s in enumerate(np.array_split(stream, M_REPL))]
    rng = np.random.default_rng(seed + 1)
    for _ in range(steps):
        per = [next(it) for it in iters]
        b = {k: np.stack([p[k] for p in per]) for k in per[0]}
        if cfg.frontend is not None:
            b["frontend"] = _frontend(cfg, rng, (M_REPL, BATCH), SEQ)
            b["loss_mask"] = (rng.random((M_REPL, BATCH, SEQ)) < 0.8).astype(np.float32)
        yield b


def _params_close(want_tree, got_tree, dtype: str, label: str) -> None:
    for (path, a), t in zip(jax.tree_util.tree_leaves_with_path(want_tree),
                            tree_leaves(got_tree), strict=True):
        want, got = _f32(a), _t32(t)
        msg = f"{label} {jax.tree_util.keystr(path)}"
        if dtype == "bfloat16":
            floor = BF16_LEAF_ULPS * BF16_RTOL * float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=floor, err_msg=msg)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=msg)


def check_train_steps(arch: str, dtype: str, mix: str, **kw) -> None:
    """STEPS EF-HC steps of both frameworks from the reference's weights."""
    jcfg, tcfg = cfgs(arch, dtype=dtype, **kw)
    setup = tsteps.make_setup(tcfg, M_REPL, mix=mix, pods=PODS)
    n_par = tcfg.n_params
    assert n_par == jcfg.n_params
    jset = jsteps.TrainSetup(cfg=jcfg, mode=setup.mode, m=setup.m, adjacency=setup.adjacency,
                             bandwidths=setup.bandwidths, r=setup.r, alpha0=setup.alpha0,
                             mix=setup.mix)
    mesh = make_host_mesh(data=1, model=1)
    make = jsteps.make_neighbor_train_step if mix == "neighbor" else jsteps.make_train_step
    jstep = jax.jit(make(jset, mesh, n_model_params=n_par))
    tmake = tsteps.make_neighbor_train_step if mix == "neighbor" else tsteps.make_train_step
    tstep = tmake(setup, n_model_params=n_par)
    base = ref_params(jcfg)
    jp = jax.tree.map(lambda a: jnp.stack([jnp.asarray(a)] * M_REPL), base)
    jh = jax.tree.map(jnp.copy, jp)
    tp = convert.arch_params_from_jax(jax.device_get(jp), "cpu")
    th = convert.arch_params_from_jax(jax.device_get(jh), "cpu")
    for k, b in enumerate(_batches(jcfg, STEPS)):
        jp, jh, jm = jstep(jp, jh, _jbatch(b), jnp.asarray(k, jnp.int32))
        tp, th, tm = tstep(tp, th, _tbatch(b), k)
        assert float(tm["trigger_rate"]) == float(jm["trigger_rate"]), f"step {k}"
        rtol = BF16_RTOL if dtype == "bfloat16" else RTOL
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=rtol, atol=ATOL,
                                   err_msg=f"loss at step {k}")
        jp, jh = jax.device_get((jp, jh))
        _params_close(jp, tp, dtype, f"params after step {k}")
        _params_close(jh, th, dtype, f"w_hat after step {k}")


# ---------------------------------------------------------------------------
# hymba-1.5b and xlstm-125m
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["xla", "chunked"])
def test_hymba_loss_and_grads_match_reference(attn_impl, monkeypatch):
    """attn_chunk 16: the chunked path's online softmax over 2 kv chunks;
    both Mamba branches through the scan's autograd Function."""
    calls = []
    real = tscan.SelectiveScan.apply
    monkeypatch.setattr(tscan.SelectiveScan, "apply", lambda *a: calls.append(1) or real(*a))
    check_loss_and_grads("hymba-1.5b", attn_impl=attn_impl, attn_chunk=16)
    assert len(calls) == 2


def test_xlstm_loss_and_grads_match_reference():
    check_loss_and_grads("xlstm-125m")


def test_hymba_train_steps_match_reference():
    """fp32, dense schedule, remat on (the Mamba branch's Function runs
    again in the recompute)."""
    check_train_steps("hymba-1.5b", "float32", "dense", attn_impl="xla", remat=True)


def test_xlstm_train_steps_match_reference():
    """bf16, neighbor schedule: the bf16 entries of the trigger and mix
    wrappers' plain versions on the CPU."""
    check_train_steps("xlstm-125m", "bfloat16", "neighbor")
