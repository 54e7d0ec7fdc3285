"""repro_torch's modality frontends (paligemma-3b's vision prefix, hubert-xlarge's
audio frames) against the JAX package's, on the CPU.

The smoke configurations (the reference's frontend override: 4 patches of
dim 32 for vision, audio frames of dim 32) with the reference's weights
carried across: ``forward`` in fp32 and bf16 (vision: logits over the text
suffix only), the prefix-LM mask (a patch row sees every patch and no
text; a text row sees the prefix and its own past), hubert's bidirectional
attention through ``xla`` and ``chunked`` alike, paligemma's text-only
decode, and ``launch/train.py``'s batches (frontend zeros and a loss mask)
through ``loss_fn`` against the reference's.  The reference runs inside
``jax.threefry_partitionable(False)``.

Tolerances: fp32 the golden rtol 2e-4 / atol 2e-5; bf16 logits within
2^-4 of the reference's (one bf16 ulp at 8; the smoke logits reach ~4) and
each request within relative L2 2e-2: the MLP's GELU rounds once in torch
and op by op in jax, so a few bf16 logits differ by more than a layer's
rtol 2^-7 / atol 2e-2 (hubert: 4 of 24192, at most 0.024 apart).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("paligemma-3b", "hubert-xlarge")
RTOL, ATOL = 2e-4, 2e-5
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SEQ = 24


def _cfgs(arch, **kw):
    return tuple(dataclasses.replace(mod.smoke_config(arch), **kw)
                 for mod in (jconfigs, tconfigs))


def _rng(*seed):
    return np.random.default_rng(list(seed))


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t32(t) -> np.ndarray:
    return t.detach().float().numpy()


def _close(got, want, dtype="float32", err_msg=""):
    if dtype == "bfloat16":
        g, w = _t32(got), _f32(want)
        np.testing.assert_allclose(g, w, rtol=0, atol=2.0 ** -4, err_msg=err_msg)
        rel = np.linalg.norm((g - w).reshape(len(w), -1), axis=1) / \
            np.linalg.norm(w.reshape(len(w), -1), axis=1)
        assert np.all(rel <= 2e-2), (err_msg, rel)
    else:
        np.testing.assert_allclose(_t32(got), _f32(want), rtol=RTOL, atol=ATOL,
                                   err_msg=err_msg)


def _params(jcfg):
    with jax.threefry_partitionable(False):
        jp = jax.device_get(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    return jp, convert.arch_params_from_jax(jp, "cpu")


def _batch(cfg, b: int, s: int, seed: int, zeros: bool = False):
    """Tokens (the text part), targets and the stub's frontend embeddings
    (cfg.frontend.tokens patches for vision, s frames for audio), as numpy."""
    rng = _rng(seed, s)
    nt = cfg.frontend.tokens if cfg.frontend.kind == "vision" else s
    fe = rng.normal(size=(b, nt, cfg.frontend.dim)).astype(np.float32)
    return {"tokens": rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32),
            "frontend": np.zeros_like(fe) if zeros else fe,
            "loss_mask": np.ones((b, s), np.float32)}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.as_tensor(v, dtype=torch.int64 if v.dtype == np.int32 else torch.float32)
            for k, v in batch.items()}


def _smoke(arch):
    jcfg, tcfg = _cfgs(arch)
    return (jcfg, tcfg, *_params(jcfg))


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    return _smoke(request.param)


@pytest.fixture(scope="module")
def pali():
    return _smoke("paligemma-3b")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    """Vision: logits over the S text tokens only, after the 4-patch
    prefix; audio: the S frames are the sequence."""
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, 2, SEQ, 1)
    want, _ = JM.forward(jcfg, jp, _jbatch(batch))
    got = tsteps.make_prefill_step(tcfg)(tp, _tbatch(batch))
    assert tuple(got.shape) == (2, SEQ, jcfg.vocab) == want.shape
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, dtype)


def test_prefix_lm_mask_matches_reference():
    """4 patches then 8 text positions: a patch row sees every patch and no
    text, a text row sees every patch and its own past."""
    pos = np.arange(12)
    want = np.asarray(JA._mask(jnp.asarray(pos), jnp.asarray(pos), causal=True, window=None,
                               prefix_len=jnp.asarray(4)))
    got = TA._mask(torch.as_tensor(pos), torch.as_tensor(pos), causal=True, window=None,
                   prefix_len=4).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:4, :4].all() and not got[:4, 4:].any()
    for q in range(4, 12):
        assert got[q, :q + 1].all() and not got[q, q + 1:].any()


def test_vision_prefix_rows_see_no_text(pali):
    """In the backbone: a changed text token leaves every patch row's and
    every earlier text row's output as it was, and changes its own; a
    changed patch embedding changes every row."""
    _, tcfg, _, tp = pali
    p = tcfg.frontend.tokens
    base = _tbatch(_batch(tcfg, 1, 12, 2))

    def hidden(batch):
        x, pos, prefix = TM._embed_inputs(tcfg, tp, batch)
        assert prefix == p and x.shape[1] == p + 12
        return TM.backbone_seq(tcfg, tp, x, pos, prefix)[0][0]

    h0 = hidden(base)
    changed = dict(base, tokens=base["tokens"].clone())
    changed["tokens"][0, 5] = (changed["tokens"][0, 5] + 1) % tcfg.vocab
    h1 = hidden(changed)
    assert torch.equal(h0[:p + 5], h1[:p + 5])
    assert not torch.equal(h0[p + 5], h1[p + 5])
    patched = dict(base, frontend=base["frontend"].clone())
    patched["frontend"][0, p - 1] += 1.0
    h2 = hidden(patched)
    assert all(not torch.equal(h0[i], h2[i]) for i in range(p + 12))


@pytest.mark.parametrize("impl", ["xla", "chunked"])
def test_hubert_is_bidirectional_through_each_attention_path(impl):
    """``causal=False``: the forward through ``impl`` against the
    reference's through the same path; a changed last frame changes every
    row's logits."""
    jcfg, tcfg = _cfgs("hubert-xlarge", attn_impl=impl, attn_chunk=8)
    jp, tp = _params(jcfg)
    batch = _batch(jcfg, 2, SEQ, 3)
    want, _ = JM.forward(jcfg, jp, _jbatch(batch))
    tb = _tbatch(batch)
    got, _ = TM.forward(tcfg, tp, tb)
    _close(got, want)
    tb["frontend"][:, -1] += 1.0
    moved, _ = TM.forward(tcfg, tp, tb)
    assert bool(((moved - got).abs().amax(-1) > 0).all())


def test_paligemma_decodes_text_only_prompts(pali):
    """``decode_step`` embeds tokens only, as the reference's does: 12
    text-only steps against the reference's, and against ``forward`` on
    the same tokens with no frontend in the batch (which, as the
    reference's, still drops the logits of the first ``frontend.tokens``
    positions)."""
    jcfg, tcfg, jp, tp = pali
    tok = _rng(4).integers(0, jcfg.vocab, size=(2, 12)).astype(np.int32)
    jc = JM.init_cache(jcfg, 2, 16)
    tc = TM.init_cache(tcfg, 2, 16, device="cpu")
    step = jax.jit(JM.decode_step, static_argnums=0)
    serve = tsteps.make_serve_step(tcfg)
    got = []
    for t in range(12):
        want, jc = step(jcfg, jp, jc, jnp.asarray(tok[:, t]), jnp.asarray(t, jnp.int32))
        lg, tc = serve(tp, tc, torch.as_tensor(tok[:, t], dtype=torch.int64), t)
        _close(lg, want, err_msg=f"step {t}")
        got.append(lg)
    fwd, _ = TM.forward(tcfg, tp, {"tokens": torch.as_tensor(tok, dtype=torch.int64)})
    p = tcfg.frontend.tokens
    assert tuple(fwd.shape) == (2, 12 - p, tcfg.vocab)
    np.testing.assert_allclose(_t32(torch.stack(got, 1)[:, p:]), _t32(fwd), rtol=RTOL,
                               atol=ATOL)


def test_train_batches_carry_the_frontend(smoke):
    """``launch/train.py``'s stream: per replica (batch // m) rows of int64
    tokens and targets, fp32 frontend zeros (the patches for vision, seq
    frames for audio) and a loss mask of ones, as the reference's
    ``next_batch`` builds them."""
    _, tcfg, _, _ = smoke
    batch = next(ttrain._batches(tcfg, 2, 4, 16, 0, "cpu"))
    nt = tcfg.frontend.tokens if tcfg.frontend.kind == "vision" else 16
    assert sorted(batch) == ["frontend", "loss_mask", "targets", "tokens"]
    assert tuple(batch["tokens"].shape) == tuple(batch["targets"].shape) == (2, 2, 16)
    assert batch["tokens"].dtype == torch.int64
    assert tuple(batch["frontend"].shape) == (2, 2, nt, tcfg.frontend.dim)
    assert batch["frontend"].dtype == torch.float32 and not batch["frontend"].any()
    assert batch["loss_mask"].dtype == torch.float32 and bool((batch["loss_mask"] == 1).all())


@pytest.mark.parametrize("zeros", [True, False])
def test_loss_matches_reference(smoke, zeros):
    """``loss_fn`` on one replica's batch as the train stream gives it
    (frontend zeros and a loss mask), and with random frontend embeddings."""
    jcfg, tcfg, jp, tp = smoke
    batch = _batch(jcfg, 2, SEQ, 5, zeros=zeros)
    jloss, jmet = JM.loss_fn(jcfg, jp, _jbatch(batch))
    tloss, tmet = TM.loss_fn(tcfg, tp, _tbatch(batch))
    assert sorted(tmet) == sorted(jmet)
    _close(tloss, jloss)
    _close(tmet["ce"], jmet["ce"])
