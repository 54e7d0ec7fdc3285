"""The port's architecture models against the JAX package's, on the CPU.

Layers, every ``attention_seq`` path, the ring-buffer ``attention_decode``,
and the starcoder2-15b smoke configuration end to end (``forward`` with
``attn_impl="pallas_swa"``, where the reference runs its Pallas kernel in
interpret mode and the port its plain version, and 24 ``decode_step``s),
all fp32 on weights drawn by the reference and carried across with
``convert.arch_params_from_jax``; the full configuration's parameter tree
against ``jax.eval_shape`` with nothing allocated.  The reference draws
inside ``jax.threefry_partitionable(False)``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import arch_params_from_jax  # noqa: E402
from repro_torch.kernels.swa import ops as tswa  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCH = "starcoder2-15b"
TOL = 1e-4  # fp32 logits: the same products, summed in another order


def _rng(*seed):
    return np.random.default_rng(list(seed))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def _tcfg(jcfg):
    """The port's ArchConfig with the reference config's fields."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    return tcommon.ArchConfig(**fields)


def _jparams(init, *args):
    with jax.threefry_partitionable(False):
        return jax.device_get(init(*args))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", ["get_config", "smoke_config"])
def test_configs_equal_reference(make):
    want = getattr(jconfigs, make)(ARCH)
    got = getattr(tconfigs, make)(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tcommon.INPUT_SHAPES.keys() == jcommon.INPUT_SHAPES.keys()
    for name, shape in jcommon.INPUT_SHAPES.items():
        assert dataclasses.asdict(tcommon.INPUT_SHAPES[name]) == dataclasses.asdict(shape)
    assert tcommon.supported_shapes(got) == jcommon.supported_shapes(want)


@pytest.mark.parametrize("arch", [a for a in jconfigs.ARCH_IDS if a != ARCH])
def test_unported_configs_raise_not_implemented(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 1[2-7]"):
        tconfigs.get_config(arch)


@pytest.mark.parametrize("bt", ["moe", "mla", "mla_moe", "hybrid", "hybrid_g",
                                "mamba", "mlstm", "slstm"])
def test_unported_block_types_raise_not_implemented(bt):
    cfg = tconfigs.smoke_config(ARCH)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 1[2-5]"):
        TB.init_block(cfg, bt, None, torch.float32, "meta")


@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("make", ["get_config", "smoke_config"])
def test_count_params_analytic_equals_reference(make, active_only):
    got = TM.count_params_analytic(getattr(tconfigs, make)(ARCH), active_only)
    want = JM.count_params_analytic(getattr(jconfigs, make)(ARCH), active_only)
    assert got == want


def test_full_param_tree_matches_reference_shapes_unallocated():
    jcfg = jconfigs.get_config(ARCH)
    want = jax.eval_shape(lambda k: JM.init_params(jcfg, k), jax.random.PRNGKey(0))
    got = TM.init_params(tconfigs.get_config(ARCH), None, "meta")
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree_util.tree_leaves_with_path(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert [jax.tree_util.keystr(p) for p, _ in got_leaves] == \
        [jax.tree_util.keystr(p) for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.device.type == "meta", jax.tree_util.keystr(path)
        assert tuple(g.shape) == tuple(w.shape), jax.tree_util.keystr(path)
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
    n = sum(int(np.prod(w.shape)) for _, w in want_leaves)
    assert 15.9e9 < n < 16.0e9


def test_init_params_draws_from_the_generator():
    cfg = tconfigs.smoke_config(ARCH)
    a = TM.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = TM.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    c = TM.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    w = lambda p: p["stages"][0]["0_attn"]["ffn"]["w_in"]  # noqa: E731
    assert torch.equal(w(a), w(b)) and not torch.equal(w(a), w(c))
    assert not torch.equal(w(a)[0], w(a)[1])  # each layer slice its own draw
    scale = w(a).std() * np.sqrt(cfg.d_model)
    assert 0.9 < float(scale) < 1.1


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_cache(cfg, 1, 8)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_apply_norm_matches_reference(norm):
    cfg = dataclasses.replace(tconfigs.smoke_config(ARCH), norm=norm)
    rng = _rng(1)
    x = rng.normal(1.0, 2.0, size=(2, 5, cfg.d_model)).astype(np.float32)
    p = {"scale": rng.normal(size=cfg.d_model).astype(np.float32),
         "bias": rng.normal(size=cfg.d_model).astype(np.float32)}
    if norm == "rmsnorm":
        del p["bias"]
    want = JL.apply_norm(cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = TL.apply_norm(cfg, arch_params_from_jax(p, "cpu"), torch.as_tensor(x))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("act", ["gelu", "swiglu", "geglu"])
def test_apply_mlp_matches_reference(act):
    cfg = dataclasses.replace(tconfigs.smoke_config(ARCH), act=act)
    p = _jparams(JL.init_mlp, cfg, jax.random.PRNGKey(2), cfg.d_model, cfg.d_ff,
                 jnp.float32)
    x = _rng(2).normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    want = JL.apply_mlp(cfg, p, jnp.asarray(x))
    got = TL.apply_mlp(cfg, arch_params_from_jax(p, "cpu"), torch.as_tensor(x))
    _close(got, want, 1e-5)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    _close(TL.act_fn("gelu", torch.as_tensor(x)), jax.nn.gelu(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("theta", [1e4, 1e5])
def test_apply_rope_matches_reference(theta):
    x = _rng(3).normal(size=(2, 9, 3, 32)).astype(np.float32)
    pos = np.arange(100, 109)[None]
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    _close(got, want, 1e-5)


def test_embed_and_head_match_reference():
    cfg = tconfigs.smoke_config(ARCH)
    key = jax.random.PRNGKey(4)
    pe = _jparams(JL.init_embed, cfg, key, jnp.float32)
    ph = _jparams(JL.init_head, cfg, key, jnp.float32)
    tok = _rng(4).integers(0, cfg.vocab, size=(2, 6))
    x = JL.embed_tokens(pe, jnp.asarray(tok))
    te, th = arch_params_from_jax(pe, "cpu"), arch_params_from_jax(ph, "cpu")
    tx = TL.embed_tokens(te, torch.as_tensor(tok))
    _close(tx, x, 0)
    _close(TL.apply_head(cfg, th, te, tx), JL.apply_head(cfg, ph, pe, x), 1e-5)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_cfg(**kw):
    base = dict(name="t", family="dense", source="t", n_layers=1, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=0, vocab=11, qkv_bias=True,
                layer_plan=((("attn",), 1),), dtype="float32", attn_chunk=16)
    base.update(kw)
    return jcommon.ArchConfig(**base)


def _attn_params(jcfg, seed):
    p = _jparams(JA.init_attention, jcfg, jax.random.PRNGKey(seed), jnp.float32)
    rng = _rng(seed, 1)
    for b in ("bq", "bk", "bv"):  # the reference inits them to zero
        p[b] = rng.normal(0, 0.1, size=p[b].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("impl,window,s", [
    ("xla", None, 48), ("xla", 16, 48), ("chunked", None, 64),
    ("chunked", 16, 64), ("banded", 16, 64), ("pallas_swa", 16, 64),
    ("pallas_swa", 64, 64),  # S <= window: falls back to xla
    ("pallas_swa", 24, 64),  # S % window != 0: falls back to xla
    ("auto", 16, 64),
])
def test_attention_seq_paths_match_reference(impl, window, s):
    jcfg = _attn_cfg(attn_impl=impl, window=window)
    p = _attn_params(jcfg, 5)
    x = _rng(5, s).normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    pos = np.arange(s)
    want = JA.attention_seq(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            jnp.asarray(pos), layer_window=window)
    got = TA.attention_seq(_tcfg(jcfg), arch_params_from_jax(p, "cpu"),
                           torch.as_tensor(x), torch.as_tensor(pos),
                           layer_window=window)
    _close(got, want, 2e-5)


def test_attention_seq_prefix_mask_matches_reference():
    jcfg = _attn_cfg(attn_impl="xla", window=16)
    p = _attn_params(jcfg, 6)
    x = _rng(6).normal(size=(1, 48, jcfg.d_model)).astype(np.float32)
    pos = np.arange(48)
    want = JA.attention_seq(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            jnp.asarray(pos), layer_window=16,
                            prefix_len=jnp.asarray(4))
    got = TA.attention_seq(_tcfg(jcfg), arch_params_from_jax(p, "cpu"),
                           torch.as_tensor(x), torch.as_tensor(pos),
                           layer_window=16, prefix_len=4)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("window,cache_len", [(8, 8), (None, 32), (8, 32)])
def test_attention_decode_ring_buffer_matches_reference(window, cache_len):
    """20 one-token steps: with window 8 and an 8-slot cache the ring
    wraps twice."""
    jcfg = _attn_cfg(window=window)
    p = _attn_params(jcfg, 7)
    jp, tp = jax.tree.map(jnp.asarray, p), arch_params_from_jax(p, "cpu")
    tcfg = _tcfg(jcfg)
    jc = JA.init_kv_cache(jcfg, 2, cache_len, jnp.float32)
    tc = TA.init_kv_cache(tcfg, 2, cache_len, torch.float32)
    xs = _rng(7).normal(size=(20, 2, 1, jcfg.d_model)).astype(np.float32)
    for t in range(20):
        want, jc = JA.attention_decode(jcfg, jp, jnp.asarray(xs[t]), jc,
                                       jnp.asarray(t, jnp.int32), layer_window=window)
        got, tc = TA.attention_decode(tcfg, tp, torch.as_tensor(xs[t]), tc, t,
                                      layer_window=window)
        _close(got, want, 2e-5)
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    _close(tc.k, jc.k, 2e-5)


def test_prefill_kv_cache_matches_reference():
    rng = _rng(8)
    k = rng.normal(size=(1, 20, 2, 8)).astype(np.float32)
    v = rng.normal(size=(1, 20, 2, 8)).astype(np.float32)
    cfg = _attn_cfg()
    for cache_len in (8, 32):
        want = JA.prefill_kv_cache(cfg, jnp.asarray(k), jnp.asarray(v),
                                   jnp.arange(20), cache_len)
        got = TA.prefill_kv_cache(_tcfg(cfg), torch.as_tensor(k), torch.as_tensor(v),
                                  torch.arange(20), cache_len)
        for g, w in zip(got, want):
            _close(g, w, 0)


# ---------------------------------------------------------------------------
# the smoke model end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), attn_impl="pallas_swa")
    jp = _jparams(JM.init_params, jcfg, jax.random.PRNGKey(0))
    return jcfg, _tcfg(jcfg), jp, arch_params_from_jax(jp, "cpu")


def test_smoke_forward_pallas_swa_matches_reference(smoke):
    jcfg, tcfg, jp, tp = smoke
    tok = _rng(9).integers(0, jcfg.vocab, size=(2, 128)).astype(np.int32)
    want, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(tok)})
    prefill = tsteps.make_prefill_step(tcfg)
    before = tswa.LAUNCHES["swa_attention_tf32"]  # the kernel that serves fp32
    got = prefill(tp, {"tokens": torch.as_tensor(tok, dtype=torch.int64)})
    assert tswa.LAUNCHES["swa_attention_tf32"] == before  # CPU: the plain version
    assert tuple(got.shape) == (2, 128, jcfg.vocab)
    _close(got, want)
    _close(TM.prefill(tcfg, tp, {"tokens": torch.as_tensor(tok)}), want)


def test_smoke_pallas_swa_path_reaches_the_kernel_wrapper(smoke, monkeypatch):
    """S=128 > window 32 and 128 % 32 == 0: each layer calls swa_attention
    once; S=32 falls back to the xla path."""
    _, tcfg, _, tp = smoke
    calls = []
    real = tswa.swa_attention
    monkeypatch.setattr(tswa, "swa_attention",
                        lambda *a, **kw: calls.append(kw["window"]) or real(*a, **kw))
    TM.forward(tcfg, tp, {"tokens": torch.zeros((1, 128), dtype=torch.int64)})
    assert calls == [32] * tcfg.n_layers
    TM.forward(tcfg, tp, {"tokens": torch.zeros((1, 32), dtype=torch.int64)})
    assert calls == [32] * tcfg.n_layers


@pytest.mark.parametrize("cache_len", [16, 64])
def test_smoke_decode_matches_reference(smoke, cache_len):
    """24 one-token steps of the smoke model; with cache_len 16 the ring
    buffer (16 slots, window 32) wraps."""
    jcfg, tcfg, jp, tp = smoke
    tok = _rng(10).integers(0, jcfg.vocab, size=(24, 3)).astype(np.int32)
    jc = JM.init_cache(jcfg, 3, cache_len)
    tc = TM.init_cache(tcfg, 3, cache_len, device="cpu")
    serve = tsteps.make_serve_step(tcfg)
    for t in range(24):
        want, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(tok[t]),
                                  jnp.asarray(t, jnp.int32))
        got, tc = serve(tp, tc, torch.as_tensor(tok[t], dtype=torch.int64), t)
        _close(got, want)


def test_decode_replays_forward(smoke):
    """Decode logits over a 40-token prompt equal forward's (window 32, so
    the window cuts into the cache)."""
    _, tcfg, _, tp = smoke
    tok = torch.as_tensor(_rng(11).integers(0, tcfg.vocab, size=(2, 40)))
    full, _ = TM.forward(tcfg, tp, {"tokens": tok})
    cache = TM.init_cache(tcfg, 2, 64, device="cpu")
    for t in range(40):
        logits, cache = TM.decode_step(tcfg, tp, cache, tok[:, t], t)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), atol=TOL,
                                   rtol=TOL)


def test_arch_params_from_jax_carries_bf16():
    jcfg = jconfigs.smoke_config(ARCH)
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    jp = _jparams(JM.init_params, jcfg, jax.random.PRNGKey(1))
    tp = arch_params_from_jax(jp, "cpu")
    w = tp["stages"][0]["0_attn"]["attn"]["wq"]
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (2, 128, 4, 32)
    want = np.asarray(jp["stages"][0]["0_attn"]["attn"]["wq"], np.float32)
    np.testing.assert_array_equal(w.float().numpy(), want)
    f32 = arch_params_from_jax(jp, "cpu", torch.float32)
    assert f32["head"]["w"].dtype == torch.float32
