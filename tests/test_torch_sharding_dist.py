"""The architecture models laid over a device mesh, across
``torch.distributed`` ranks on the CPU (``models/sharding.py``,
``launch/mesh.py``, the mesh forms of ``launch/steps.py`` and
``launch/train.py``).

One module fixture starts everything at once and waits for it: gloo
ranks of this file at world 2 and world 4 (a file store under
``tmp_path``, torch pinned to one thread), and the reference jitted on
``make_host_mesh`` over forced host devices in a subprocess (under
``jax.threefry_partitionable(False)``).  Then:

* serving: forward logits and the decode of every step, at world 2
  (model 2) and world 4 (data 2 x model 2, and model 4), on the smoke
  starcoder2 and qwen2 configs (4 q heads, 1 KV head: the KV heads stay
  whole) and a 4-head, 2-KV-head config (KV split at model 2; at model 4
  each rank's one q head reads its group of the whole KV heads), against
  the port's one-process run and the reference's run sharded on data 2 x
  model 2 (each config once; the meshes compute one function): rtol 2e-4 /
  atol 2e-5; the ranks of a model group return the same bits, and the
  sharded init is the one-card init's blocks;
* training: 3 EF-HC steps of the starcoder2 smoke config (fl_m = 2,
  replica 1's ``w_hat`` another seed's weights, so that it fires and P !=
  I), ``dense`` and ``neighbor``, at data 2 x model 2 against the
  reference's sharded step: ``v`` and ``comm`` equal, the loss, ``trigger_rate``, the
  parameters and ``w_hat`` within rtol 2e-4 / atol 2e-5; leaves whole over
  ``model`` bit-identical across each model group;
* replica mode at model 1 (hymba's smoke config at data 2): bit-equal to
  the one-process run;
* the rest of the dense family at model 2 (paligemma, hubert, phi3,
  deepseek-coder smoke configs): ``loss_fn`` and every gradient against
  the same weights run whole, rtol 2e-4 / atol 2e-5;
* the train CLI over four ranks (``--data 2 --model 2``) with a
  checkpoint a rank, and a resume that continues bit for bit;
* the refusals of the block types whose tensor-parallel forms are item
  19b (in process, on a stand-in mesh).

The same ranks on NCCL, one card each, run where the machine has the
cards and skip elsewhere:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_sharding_dist.py
"""
import dataclasses
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
RTOL, ATOL = 2e-4, 2e-5
B, SEQ = 4, 8  # serving: requests and tokens
TRAIN_B, TRAIN_SEQ, TRAIN_STEPS = 2, 16, 3  # a replica's batch rows and tokens
# (world, mesh (data, model), configs) of the serving cases
SERVE = {2: [((1, 2), ("starcoder2", "kv2"))],
         4: [((2, 2), ("qwen2", "kv2")), ((1, 4), ("qwen2", "kv2"))]}
MIXES = ("dense", "neighbor")
REF_SERVE = ("starcoder2", "qwen2", "kv2")  # the reference's serving runs, on data 2 x model 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name: str, smoke_config):
    if name == "starcoder2":
        return smoke_config("starcoder2-15b")
    if name == "qwen2":
        return smoke_config("qwen2-72b")
    if name == "kv2":  # 4 q heads over 2 KV heads
        return dataclasses.replace(smoke_config("starcoder2-15b"), n_kv_heads=2)
    if name == "train":
        return dataclasses.replace(smoke_config("starcoder2-15b"), fl_m=2, attn_impl="xla")
    raise KeyError(name)


def _tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(7).integers(0, vocab, (B, SEQ)).astype(np.int64)


def _train_batches(vocab: int, m: int):
    from repro_torch.data.loader import lm_batches
    from repro_torch.data.synthetic import token_dataset

    stream = token_dataset(8000, vocab=vocab, seed=0)
    iters = [lm_batches(s, TRAIN_B, TRAIN_SEQ, seed=i)
             for i, s in enumerate(np.array_split(stream, m))]
    out = []
    for _ in range(TRAIN_STEPS):
        per = [next(it) for it in iters]
        out.append({k: np.stack([p[k] for p in per]) for k in per[0]})
    return out


# ---------------------------------------------------------------------------
# the reference, jitted on make_host_mesh in a subprocess
# ---------------------------------------------------------------------------

_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[2])
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import smoke_config
    from repro.launch import input_specs as ispec
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as M
    from repro.models import sharding as S
    from repro.models.common import InputShape
    from repro.optim.schedules import paper_diminishing
    import test_torch_sharding_dist as T

    out = {}
    named = lambda mesh, t: ispec.to_named(mesh, t)
    part = sys.argv[3]
    with jax.threefry_partitionable(False):
        if part == "serve":
            # each config once, on data 2 x model 2: the ranks' meshes all
            # compute the same function
            data, model = 2, 2
            mesh = make_host_mesh(data=data, model=model)
            for name in T.REF_SERVE:
                cfg = T._cfg(name, smoke_config)
                params = M.init_params(cfg, jax.random.PRNGKey(0))
                pspec = named(mesh, S.param_specs(cfg, params, mesh, "serve"))
                tok = jnp.asarray(T._tokens(cfg.vocab), jnp.int32)
                tspec = named(mesh, S.token_batch_specs({"tokens": tok}, mesh,
                                                        fl_axis=False, mode="serve"))
                fwd = jax.jit(jsteps.make_prefill_step(cfg, mesh),
                              in_shardings=(pspec, tspec))
                out[f"{name}/fwd"] = np.asarray(fwd(params, {"tokens": tok}))
                # the cache placed by XLA: cache_specs gives the KV length
                # 'model' a second time where the KV heads took it
                cache = M.init_cache(cfg, T.B, T.SEQ)
                dspec = NamedSharding(mesh, P("data"))
                dec = jax.jit(jsteps.make_serve_step(cfg, mesh),
                              in_shardings=(pspec, None, dspec, None))
                steps = []
                for t in range(T.SEQ):
                    logits, cache = dec(params, cache, tok[:, t], jnp.int32(t))
                    steps.append(np.asarray(logits))
                out[f"{name}/dec"] = np.stack(steps)
        else:
            cfg = T._cfg("train", smoke_config)
            mesh = make_host_mesh(data=2, model=2)
            batches = T._train_batches(cfg.vocab, 2)
            base = M.init_params(cfg, jax.random.PRNGKey(0))
            other = M.init_params(cfg, jax.random.PRNGKey(1))
            for mix in T.MIXES:
                setup = jsteps.make_setup(cfg, mesh, mix=mix)
                assert (setup.m, setup.mode) == (2, "replica")
                make = (jsteps.make_neighbor_train_step if mix == "neighbor"
                        else jsteps.make_train_step)
                fn = make(setup, mesh, n_model_params=cfg.n_params)
                shape = InputShape("t", T.TRAIN_SEQ, setup.m * T.TRAIN_B, "train")
                sp = ispec.train_specs(cfg, shape, mesh, setup.m, setup.mode)
                step = jax.jit(fn, in_shardings=named(mesh, sp.in_shardings),
                               out_shardings=named(mesh, sp.out_shardings))
                params = jax.tree.map(lambda l: jnp.stack([l] * setup.m), base)
                # replica 1's last sent weights another seed's: it fires at step 0
                w_hat = jax.tree.map(lambda l, o: jnp.stack([l, o]), base, other)
                bw = jnp.asarray(setup.bandwidths, jnp.float32)
                rho = 1.0 / bw * jnp.mean(bw)
                sched = paper_diminishing(setup.alpha0, gamma=1.0, theta=0.5)
                sq_diff = jax.jit(jsteps._param_sq_diff)
                for k, b in enumerate(batches):
                    # the step's own Event 2, on the state it starts from
                    sq = sq_diff(params, w_hat)
                    v = np.asarray(jnp.sqrt(sq / float(cfg.n_params))
                                   > setup.r * rho * sched(jnp.int32(k)))
                    batch = {n: jnp.asarray(x, jnp.int32) for n, x in b.items()}
                    params, w_hat, met = step(params, w_hat, batch, jnp.asarray(k, jnp.int32))
                    out[f"train/{mix}/{k}/v"] = v
                    for n in ("loss", "trigger_rate", "alpha"):
                        out[f"train/{mix}/{k}/{n}"] = np.asarray(met[n])
                for i, leaf in enumerate(jax.tree.leaves(params)):
                    out[f"train/{mix}/params/{i}"] = np.asarray(leaf)
                for i, leaf in enumerate(jax.tree.leaves(w_hat)):
                    out[f"train/{mix}/w_hat/{i}"] = np.asarray(leaf)
    np.savez(sys.argv[1], **out)
""")


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _serve_case(mesh, name: str, out: dict, dev: str = "cpu") -> None:
    from repro_torch import prng
    from repro_torch.configs import smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import sharding as S
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _cfg(name, smoke_config)
    full = M.init_params(cfg, prng.PRNGKey(0), "cpu")
    specs = S.param_specs(cfg, full, mesh, "serve")
    params = tree_map(lambda t: t.to(dev), S.shard_tree(full, specs, mesh))
    # the sharded init draws the one-card init's weights and keeps the blocks
    gen = torch.Generator().manual_seed(3)
    drawn = M.init_params(cfg, gen, "cpu", shard=S.layer_slicer(mesh, "serve"))
    want = S.shard_tree(M.init_params(cfg, torch.Generator().manual_seed(3), "cpu"),
                        specs, mesh)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(drawn), tree_leaves(want)))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves(S.gather_tree(params, specs, mesh)), tree_leaves(full)))

    d, n_data = mesh.coords["data"], mesh.shape["data"]
    rows = slice(d * B // n_data, (d + 1) * B // n_data)
    tok = torch.as_tensor(_tokens(cfg.vocab))[rows].to(dev)
    fwd = steps.make_prefill_step(cfg, mesh)(params, {"tokens": tok})
    cache = M.init_cache(cfg, B, SEQ, dev, mesh=mesh)
    serve = steps.make_serve_step(cfg, mesh)
    dec = torch.stack([serve(params, cache, tok[:, t], t)[0] for t in range(SEQ)])
    key = f"{name}/{n_data}x{mesh.shape['model']}"
    for part, x in (("fwd", fwd), ("dec", dec)):
        # every rank of a model group holds the same bits
        same = mesh.axis("model").gather(x)
        assert all(torch.equal(p, x) for p in same), f"{key}/{part}"
        out[f"{key}/{part}"] = x.cpu().numpy()


def _train_case(mesh, mix: str, out: dict, dev: str = "cpu") -> None:
    from repro_torch import prng
    from repro_torch.configs import smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import sharding as S
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _cfg("train", smoke_config)
    setup = steps.make_setup(cfg, mesh, mix=mix)
    assert (setup.m, setup.mode, setup.own) == (2, "replica",
                                                slice(mesh.coords["data"], mesh.coords["data"] + 1))
    base = M.init_params(cfg, prng.PRNGKey(0), "cpu")
    specs = S.add_fl_axis(S.param_specs(cfg, base, mesh, "replica"), mesh, "replica")
    other = M.init_params(cfg, prng.PRNGKey(1), "cpu")
    full = tree_map(lambda t: torch.stack([t] * setup.m), base)
    params = tree_map(lambda t: t.to(dev), S.shard_tree(full, specs, mesh))
    # replica 1's last sent weights another seed's: it fires at step 0
    full_hat = tree_map(lambda t, o: torch.stack([t, o]), base, other)
    w_hat = tree_map(lambda t: t.to(dev), S.shard_tree(full_hat, specs, mesh))
    make = steps.make_neighbor_train_step if mix == "neighbor" else steps.make_train_step
    step = make(setup, n_model_params=cfg.n_params)
    for k, b in enumerate(_train_batches(cfg.vocab, setup.m)):
        local = {n: torch.as_tensor(x[setup.own], dtype=torch.int64, device=dev)
                 for n, x in b.items()}
        params, w_hat, met = step(params, w_hat, local, k)
        for n in ("loss", "trigger_rate", "alpha", "v"):
            out[f"train/{mix}/{k}/{n}"] = met[n].cpu().numpy()
    model = mesh.axis("model")
    for spec, leaf in zip(S.spec_leaves(specs), tree_leaves(params)):
        if S.whole_over_model(spec[1:]):  # a replicated leaf: one value a model group
            assert all(torch.equal(p, leaf) for p in model.gather(leaf)), spec
    for name, tree in (("params", params), ("w_hat", w_hat)):
        for i, leaf in enumerate(tree_leaves(S.gather_tree(tree, specs, mesh))):
            out[f"train/{mix}/{name}/{i}"] = leaf.cpu().numpy()


def _replica_case(mesh, out: dict, dev: str = "cpu") -> None:
    from repro_torch.configs import smoke_config
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models import sharding as S
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(smoke_config("hymba-1.5b"), fl_m=2)
    run = train.train(cfg, m=None, mesh=mesh, steps=TRAIN_STEPS, batch=4, seq=TRAIN_SEQ,
                      device=dev, log=lambda _: None)
    specs = S.add_fl_axis(S.param_specs(cfg, M.init_params(cfg, device="meta"), mesh,
                                        "replica"), mesh, "replica")
    for name, tree in (("params", run.params), ("w_hat", run.w_hat)):
        for i, leaf in enumerate(tree_leaves(S.gather_tree(tree, specs, mesh))):
            out[f"hymba/{name}/{i}"] = leaf.cpu().numpy()
    out["hymba/records"] = np.asarray([[r[n] for n in ("loss", "trigger_rate", "alpha")]
                                       for r in run.records])
    out["hymba/v"] = np.asarray([r["v"] for r in run.records])


GRAD_ARCHS = ("paligemma-3b", "hubert-xlarge", "phi3-medium-14b", "deepseek-coder-33b")


def _grad_case(mesh, arch: str, out: dict, dev: str = "cpu") -> None:
    """The smoke config's ``loss_fn`` and every gradient tensor-parallel
    over the mesh's model axis, beside the same weights run whole on this
    rank: the loss and the gathered gradients."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M
    from repro_torch.models import sharding as S
    from repro_torch.tree import tree_leaves, tree_map

    cfg = smoke_config(arch)
    full = tree_map(lambda t: t.to(dev),
                    M.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    specs = S.param_specs(cfg, full, mesh, "serve")
    rng = np.random.default_rng(1)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 12)), device=dev)
             for k in ("tokens", "targets")}
    if cfg.frontend is not None:
        nt = cfg.frontend.tokens if cfg.frontend.kind == "vision" else 12
        batch["frontend"] = torch.as_tensor(
            rng.normal(size=(2, nt, cfg.frontend.dim)).astype(np.float32), device=dev)
        batch["loss_mask"] = torch.ones((2, 12), device=dev)

    def loss_grads(params, axis):
        params = tree_map(lambda t: t.detach().requires_grad_(), params)
        with S.tensor_parallel(axis):
            loss, _ = M.loss_fn(cfg, params, batch)
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(t) if g is None else g
                               for t, g in zip(leaves, grads)]

    want_loss, want = loss_grads(full, None)
    got_loss, got = loss_grads(S.shard_tree(full, specs, mesh), mesh.axis("model"))
    got = [S.gather_leaf(g, s, mesh) for g, s in zip(got, S.spec_leaves(specs))]
    out[f"grad/{arch}/loss"] = np.asarray([float(got_loss), float(want_loss)])
    for i, (g, w) in enumerate(zip(got, want)):
        out[f"grad/{arch}/{i}"] = np.stack([g.cpu().numpy(), w.cpu().numpy()])


def _cli_case(rank: int, world: int, ckpt: str, out: dict, dev: str = "cpu") -> None:
    """The train CLI over the ranks (a process group of its own each call,
    env://, on ports rank 0 picks just before): the smoke config as it is
    (fl_m = 1: fsdp over data 2) refused, naming item 19b; then in replica
    mode (``--fl_m 2``) 2 steps and a resume of 1 in one directory, 3 steps
    in another."""
    import torch.distributed as dist

    from repro_torch.checkpoint import msgpack_ckpt
    from repro_torch.launch import train

    ports = [[_free_port() for _ in range(4)] if rank == 0 else None]
    dist.broadcast_object_list(ports, src=0)
    dist.destroy_process_group()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost")
    flags = ["--arch", "starcoder2-15b", "--smoke", "--data", "2", "--model", "2",
             "--seq", "16", "--batch", "4", "--device", dev, "--ckpt_every", "100"]
    os.environ["MASTER_PORT"] = ports[0][0]
    with pytest.raises(NotImplementedError, match="item 19b"):
        train.main(flags + ["--steps", "1"])
    flags += ["--fl_m", "2"]
    for port, more in zip(ports[0][1:], (["--steps", "2", "--ckpt", f"{ckpt}/a"],
                                     ["--steps", "1", "--ckpt", f"{ckpt}/a"],
                                     ["--steps", "3", "--ckpt", f"{ckpt}/b"])):
        os.environ["MASTER_PORT"] = port  # a port a process group
        train.main(flags + more)
    coords = f"data{rank // 2}_model{rank % 2}"
    a = msgpack_ckpt.restore(f"{ckpt}/a/{coords}", 3)
    b = msgpack_ckpt.restore(f"{ckpt}/b/{coords}", 3)
    from repro_torch.tree import tree_leaves
    for name in ("params", "w_hat"):
        la, lb = tree_leaves(a[name]), tree_leaves(b[name])
        assert len(la) == len(lb) > 0
        assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb)), name
    out["cli/ok"] = np.asarray(True)


def _rank_main(rank: int, world: int, store: str, out_path: str, backend: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=world,
                            rank=rank)
    dev = "cuda" if backend == "nccl" else "cpu"
    out: dict = {}
    try:
        for (data, model), names in SERVE[world]:
            mesh = make_host_mesh(data=data, model=model)
            for name in names:
                print(f"rank {rank}: serve {name} on {data}x{model}", flush=True)
                _serve_case(mesh, name, out, dev)
        if world == 4:
            with pytest.raises(ValueError, match="needs 2 ranks"):
                make_host_mesh(data=1, model=2)
            mesh = make_host_mesh(data=2, model=2)
            for mix in MIXES:
                print(f"rank {rank}: train {mix}", flush=True)
                _train_case(mesh, mix, out, dev)
            print(f"rank {rank}: cli", flush=True)
            _cli_case(rank, world, os.path.dirname(out_path) + "/ckpt", out, dev)
        else:
            _replica_case(make_host_mesh(data=2, model=1), out, dev)
            mesh = make_host_mesh(data=1, model=2)
            for arch in GRAD_ARCHS:
                _grad_case(mesh, arch, out, dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    np.savez(out_path, **out)


def _free_port() -> str:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return str(sock.getsockname()[1])


def _spawn(tmp: pathlib.Path, world: int, backend: str) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    (tmp / f"w{world}").mkdir(parents=True, exist_ok=True)
    return [subprocess.Popen([sys.executable, __file__, str(r), str(world),
                              str(tmp / f"w{world}" / "store"),
                              str(tmp / f"w{world}" / f"rank{r}.npz"), backend],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _wait(procs) -> None:
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=TIMEOUT_S)[0])
            except subprocess.TimeoutExpired as exc:  # say where it stood
                for q in procs:
                    q.kill()
                outs = [exc.output or ""] + [q.communicate()[0] for q in procs]
                raise AssertionError("a rank timed out:\n" + "\n".join(
                    str(o)[-1500:] for o in outs)) from None
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results at world 2 and 4 and the reference's, run at
    once."""
    tmp = tmp_path_factory.mktemp("sharding_dist")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    refs = [subprocess.Popen([sys.executable, "-c", _REF, str(tmp / f"ref_{part}.npz"),
                              str(ROOT / "tests"), part], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for part in ("serve", "train")]
    ranks = {w: _spawn(tmp, w, "gloo") for w in (2, 4)}
    _wait(refs)
    for procs in ranks.values():
        _wait(procs)
    ref = {**np.load(tmp / "ref_serve.npz"), **np.load(tmp / "ref_train.npz")}
    return ({w: [dict(np.load(tmp / f"w{w}" / f"rank{r}.npz")) for r in range(w)]
             for w in ranks}, ref)


def _one_process_serve(name: str):
    from repro_torch import prng
    from repro_torch.configs import smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    cfg = _cfg(name, smoke_config)
    params = M.init_params(cfg, prng.PRNGKey(0), "cpu")
    tok = torch.as_tensor(_tokens(cfg.vocab))
    fwd = steps.make_prefill_step(cfg)(params, {"tokens": tok})
    cache = M.init_cache(cfg, B, SEQ, "cpu")
    serve = steps.make_serve_step(cfg)
    dec = torch.stack([serve(params, cache, tok[:, t], t)[0] for t in range(SEQ)])
    return {"fwd": fwd.numpy(), "dec": dec.numpy()}


SERVE_CASES = [pytest.param(w, mesh, name, id=f"w{w}-{mesh[0]}x{mesh[1]}-{name}")
               for w, cases in SERVE.items() for mesh, names in cases for name in names]


@pytest.mark.parametrize("world,mesh,name", SERVE_CASES)
def test_sharded_serving_matches_one_process_and_reference(runs, world, mesh, name):
    ranks, ref = runs
    data, model = mesh
    key = f"{name}/{data}x{model}"
    mine = _one_process_serve(name)
    for r, got in enumerate(ranks[world]):
        rows = slice((r // model) * B // data, (r // model + 1) * B // data)
        for part in ("fwd", "dec"):
            g = got[f"{key}/{part}"]
            want = mine[part][rows] if part == "fwd" else mine[part][:, rows]
            np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {key}/{part} vs one process")
            want = ref[f"{name}/{part}"]
            want = want[rows] if part == "fwd" else want[:, rows]
            np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {key}/{part} vs the reference")


@pytest.mark.parametrize("mix", MIXES)
def test_sharded_train_steps_match_reference(runs, mix):
    ranks, ref = runs
    fired = 0
    adj = torch.tensor([[False, True], [True, False]])
    for r, got in enumerate(ranks[4]):
        for k in range(TRAIN_STEPS):
            v = got[f"train/{mix}/{k}/v"]
            assert np.array_equal(v, ref[f"train/{mix}/{k}/v"]), f"rank {r} step {k}"
            vt = torch.as_tensor(v)
            comm = (vt[:, None] | vt[None, :]) & adj
            want_v = torch.as_tensor(ref[f"train/{mix}/{k}/v"])
            assert torch.equal(comm, (want_v[:, None] | want_v[None, :]) & adj)
            fired += int(v.sum())
            for n in ("loss", "trigger_rate", "alpha"):
                np.testing.assert_allclose(got[f"train/{mix}/{k}/{n}"],
                                           ref[f"train/{mix}/{k}/{n}"], rtol=RTOL, atol=ATOL)
        for name in ("params", "w_hat"):
            i = 0
            while f"train/{mix}/{name}/{i}" in ref:
                np.testing.assert_allclose(got[f"train/{mix}/{name}/{i}"],
                                           ref[f"train/{mix}/{name}/{i}"], rtol=RTOL,
                                           atol=ATOL, err_msg=f"rank {r} {name} leaf {i}")
                i += 1
            assert i > 10
    assert fired > 0  # a trigger fired, so P != I in some step


def test_replica_mode_bit_equal_to_one_process(runs):
    from repro_torch.configs import smoke_config
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    ranks, _ = runs
    cfg = dataclasses.replace(smoke_config("hymba-1.5b"), fl_m=2)
    run = train.train(cfg, m=2, steps=TRAIN_STEPS, batch=4, seq=TRAIN_SEQ, device="cpu",
                      log=lambda _: None)
    want = np.asarray([[r[n] for n in ("loss", "trigger_rate", "alpha")] for r in run.records])
    for r, got in enumerate(ranks[2]):
        assert np.array_equal(got["hymba/records"], want), f"rank {r}"
        assert np.array_equal(got["hymba/v"], np.asarray([x["v"] for x in run.records]))
        for name, tree in (("params", run.params), ("w_hat", run.w_hat)):
            for i, leaf in enumerate(tree_leaves(tree)):
                assert np.array_equal(got[f"hymba/{name}/{i}"], leaf.numpy()), \
                    f"rank {r} {name} leaf {i}"


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_tensor_parallel_loss_and_grads_match_one_process(runs, arch):
    """The rest of the dense attention family (a vision prefix with tied
    embeddings, bidirectional audio frames, full-attention GQA) at model 2:
    loss_fn and every leaf's gradient within rtol 2e-4 / atol 2e-5 of the
    same weights run whole."""
    ranks, _ = runs
    for r, got in enumerate(ranks[2]):
        tp, whole = got[f"grad/{arch}/loss"]
        np.testing.assert_allclose(tp, whole, rtol=RTOL, atol=ATOL)
        i = 0
        while f"grad/{arch}/{i}" in got:
            g, w = got[f"grad/{arch}/{i}"]
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {arch} leaf {i}")
            i += 1
        assert i > 10


def test_train_cli_over_four_ranks_resumes_bit_for_bit(runs):
    ranks, _ = runs
    assert all(bool(got["cli/ok"]) for got in ranks[4])


class _Mesh:
    """A stand-in mesh of one rank's coordinates (no collectives)."""

    def __init__(self, data: int, model: int):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}
        self.coords = {"data": 0, "model": 0}

    def axis(self, axes):
        from repro_torch.models.sharding import AxisGroup

        names = (axes,) if isinstance(axes, str) else tuple(axes)
        return AxisGroup(int(np.prod([self.shape[a] for a in names])), 0)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m", "granite-moe-3b-a800m",
                                  "deepseek-v3-671b"])
def test_model_axis_refuses_block_types_of_item_19b(arch):
    from repro_torch.configs import smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.models import sharding as S

    cfg = dataclasses.replace(smoke_config(arch), fl_m=2)
    with pytest.raises(NotImplementedError, match="item 19b"):
        steps.make_setup(cfg, _Mesh(2, 2))
    with pytest.raises(NotImplementedError, match="item 19b"):
        steps.make_prefill_step(cfg, _Mesh(1, 2))
    # under a model axis the block itself refuses (no quiet whole run)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with S.tensor_parallel(S.AxisGroup(2, 0)), pytest.raises(NotImplementedError,
                                                             match="item 19b"):
        M.forward(cfg, params, {"tokens": torch.zeros((1, 4), dtype=torch.int64)})
    # at model = 1 the same config lays out in replica mode
    assert steps.make_setup(cfg, _Mesh(2, 1)).m == 2


def test_moe_shard_map_refuses_under_a_model_axis():
    from repro_torch.configs import smoke_config
    from repro_torch.models import moe
    from repro_torch.models import sharding as S

    cfg = smoke_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="shard_map"))
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), torch.float32)
    x = torch.randn((1, 4, cfg.d_model))
    out, _ = moe.moe_ffn(cfg, p, x)  # no model axis: as scatter
    assert torch.isfinite(out).all()
    with S.tensor_parallel(S.AxisGroup(2, 0)), pytest.raises(NotImplementedError,
                                                             match="item 19b"):
        moe.moe_ffn(cfg, p, x)


def test_fsdp_over_data_refuses():
    from repro_torch.configs import smoke_config
    from repro_torch.launch import steps

    cfg = smoke_config("starcoder2-15b")  # fl_m = 1: fsdp mode
    with pytest.raises(NotImplementedError, match="item 19b"):
        steps.make_setup(cfg, _Mesh(2, 2))
    assert steps.make_setup(cfg, _Mesh(1, 2)).mode == "fsdp"


def test_mesh_refuses_a_world_that_is_not_its_product():
    from repro_torch.launch.mesh import make_host_mesh

    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_host_mesh(data=2, model=2)
    mesh = make_host_mesh(data=1, model=1)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.axis("model").size == 1


# ---------------------------------------------------------------------------
# NCCL ranks, one card each
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("world", [2, 4])
def test_nccl_ranks_serve_on_their_own_cards(tmp_path, world):
    """The serving cases on NCCL ranks, a card each, against the port's
    one-process run on the card: rtol 2e-4 / atol 2e-5, the ranks of a
    model group bit-equal."""
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices, one a rank")
    procs = _spawn(tmp_path, world, "nccl")
    _wait(procs)
    got = [dict(np.load(tmp_path / f"w{world}" / f"rank{r}.npz")) for r in range(world)]
    for (data, model), names in SERVE[world]:
        for name in names:
            key = f"{name}/{data}x{model}"
            mine = _one_process_serve(name)
            for r in range(world):
                rows = slice((r // model) * B // data, (r // model + 1) * B // data)
                np.testing.assert_allclose(got[r][f"{key}/fwd"], mine["fwd"][rows],
                                           rtol=RTOL, atol=ATOL)
                np.testing.assert_allclose(got[r][f"{key}/dec"], mine["dec"][:, rows],
                                           rtol=RTOL, atol=ATOL)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
