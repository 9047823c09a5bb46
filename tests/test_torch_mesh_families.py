"""The port's mamba2, jamba, whisper and vision models across a ``(data,
model)`` mesh of gloo CPU ranks against the reference's sharded run.

The reference side runs once, in a subprocess with four forced host
devices (as ``test_torch_mesh.py``'s): reduced mamba2-2.7b,
jamba-v0.1-52b, whisper-medium and llama-3.2-vision-11b on JAX meshes (1,
2) and (2, 1), and mamba2 on (2, 2), built with ``AxisType.Auto`` axes,
their parameters and AdamW state placed by ``param_pspecs()`` /
``opt_pspecs()`` and the batch (tokens, frames, patch embeddings) by the
data axis. It records the prefill's logits and caches (K/V, SSM state and
conv window, cross K/V), two decode steps' logits and the caches after
them, and, under one ``jax.jit``, ``jax.value_and_grad(Model.loss)`` and
one AdamW step from moments drawn from the seed at step 3. The reference
runs every one of these families sharded, so no case falls back to its
single-device run. The port side spawns one gloo rank per device (file
store), only once that subprocess has ended, one spawn per mesh for all
of its cases; the weights come through ``params_from_jax`` and the AdamW
state through ``opt_state_from_jax``. Each rank's blocks are held to the
reference's whole arrays cut to its rows and heads: the port splits the
K/V and the cross K/V by KV heads where the reference splits their rows.

Tolerances are ``test_torch_mesh.py``'s (1e-5 for caches, 1e-4 for
logits) and ``test_torch_mesh_train.py``'s (1e-5 for gradients and
parameters, 1e-4 for the loss and the grad norm). Reduced jamba runs as a
float64 copy on both sides (every weight, its config's dtype and every
float32 cast point of both packages widened; the reference in a
subprocess of its own, since x64 is global to JAX), as
``test_torch_train.py`` and ``test_torch_hybrid.py`` hold it: in float32
one device's port and reference already differ by 2e-4 of the magnitude
through its fourteen SSM layers, and its gradients reach 1e3 (about 0.17
apart on the embedding on either mesh). The planted faults (the SSM's
gated norm taking its variance over the rank's channels, ``wB``'s gradient
and whisper's cross source's gradient not summed over ``model``), each
planted in the ranks of its own case on 1 x 2, must fail the same
comparison.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_mesh_rank import Cell, cell_steps, run_family_cases
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import opt_state_from_jax, params_from_jax, \
    tree_from_jax
from repro_torch.distributed.sharding import (ShardingCtx, param_shardings,
                                              shard_shape)
from repro_torch.launch import spmd
from repro_torch.launch.mesh import LocalMesh
from repro_torch.models import build_model, init_params
from repro_torch.models.common import param_specs, pspec_tree
from repro_torch.training.optimizer import OptConfig
from repro_torch.tree import leaves, leaves_with_paths, tree_map


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODELS = ("mamba2-2.7b", "jamba-v0.1-52b", "whisper-medium",
          "llama-3.2-vision-11b")
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
CASES = ([(n, m) for n in MODELS for m in ("1x2", "2x1")]
         + [("mamba2-2.7b", "2x2")])
# run as a float64 copy on both sides (the reference in its own subprocess)
WIDE = ("jamba-v0.1-52b",)
# fault -> the model it is planted in, on 1 x 2
FAULTS = {"gated_norm_local": "mamba2-2.7b",
          "wB_grad_not_summed": "mamba2-2.7b",
          "kv_src_grad_not_summed": "whisper-medium"}
# the reference's cases by subprocess
REFERENCE_SPLIT = ([[c] for c in CASES if c[0] in WIDE]
                   + [[c for c in CASES if c[0] == "llama-3.2-vision-11b"],
                      [c for c in CASES if c[0] in ("mamba2-2.7b",
                                                    "whisper-medium")]])
B, S, SMAX, STEPS = 2, 16, 32, 2
# build_cell's train cells: (model, mesh), at CELL_SHAPE
CELLS = (("mamba2-2.7b", "1x2"), ("whisper-medium", "2x1"),
         ("llama-3.2-vision-11b", "1x2"))
CELL_SHAPE = dict(kind="train", seq_len=8, global_batch=4)
OPT = dict(lr=1e-2, warmup_steps=1)
TOL, LOGIT_TOL = 1e-5, 1e-4
SRC = pathlib.Path(__file__).resolve().parent.parent / "src"

REFERENCE = """
import dataclasses
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import build_model
from repro.training.optimizer import OptConfig, adamw_update, opt_pspecs
from repro.training.train_step import make_loss_fn

B, S, SMAX, STEPS, MESHES, OPT = %d, %d, %d, %d, %r, %r
CASES, WIDE = eval(sys.argv[3]), sys.argv[4] == "wide"
if WIDE:    # a float64 copy: every float32 cast point widened
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
res = {}
inputs = np.load(sys.argv[1])
for name, label in CASES:
    cfg = get_config(name).reduced()
    if WIDE:
        cfg = dataclasses.replace(cfg, dtype=jnp.float64)
    mesh = jax.make_mesh(MESHES[label], ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    m = build_model(cfg, mesh=mesh)
    structure = jax.tree.structure(m.abstract_params())
    tree = lambda k: jax.tree.unflatten(structure, [
        jnp.asarray(inputs[f"{name}/{k}/{i}"], jnp.float32)
        for i in range(structure.num_leaves)])
    place = lambda specs, t: jax.tree.map(
        lambda s, a: jax.device_put(a, NamedSharding(mesh, s)), specs, t,
        is_leaf=lambda s: isinstance(s, P))
    p = place(m.param_pspecs(), tree("params"))
    o = place(opt_pspecs(m.param_pspecs()),
              {"m": tree("m"), "v": tree("v"),
               "step": jnp.asarray(inputs[f"{name}/step"])})
    rows = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(
        mesh, m.ctx.spec("batch", *[None] * (a.ndim - 1), dims=a.shape)))
    toks = rows(inputs[f"{name}/tokens"])
    extras = {k.split("/")[-1]: rows(inputs[k].astype(jnp.float32))
              for k in inputs.files if k.startswith(f"{name}/extras/")}
    key = f"{name}/{label}"
    logits, caches = jax.jit(m.prefill)(p, toks, extras or None)
    res[f"{key}/prefill"] = logits
    structs, _ = m.cache_specs(B, SMAX)
    cache = {}
    for sl, sub in caches.items():
        cache[sl] = {}
        for kk, a in sub.items():
            res[f"{key}/prefill/{sl}/{kk}"] = a
            st = structs[sl][kk]
            cache[sl][kk] = (a if a.shape == st.shape else jnp.zeros(
                st.shape, st.dtype).at[:, :, :S].set(a))
    decode = jax.jit(m.decode_step)
    feed = inputs[f"{name}/feed"]
    for i in range(STEPS):
        # (under x64 the update's start indices are int64)
        pos = jnp.full((B,), S + i, jnp.int64 if WIDE else jnp.int32)
        logits, cache = decode(p, cache, jnp.asarray(feed[:, i:i + 1]), pos)
        res[f"{key}/decode{i}"] = logits
    for sl, sub in cache.items():
        for kk, a in sub.items():
            res[f"{key}/cache/{sl}/{kk}"] = a
    batch = {"tokens": toks,
             "labels": rows(np.roll(inputs[f"{name}/tokens"], -1, 1)),
             **extras}
    loss_fn = make_loss_fn(m)

    def both(p, o, b):
        loss, grads = jax.value_and_grad(loss_fn)(p, b)
        p2, _, metrics = adamw_update(grads, o, p, OptConfig(**OPT))
        return loss, grads, p2, metrics["grad_norm"]

    loss, grads, p2, gnorm = jax.jit(both)(p, o, batch)
    res[f"{key}/loss"] = loss
    res[f"{key}/grad_norm"] = gnorm
    for i, a in enumerate(jax.tree.leaves(grads)):
        res[f"{key}/grad/{i}"] = a
    for i, a in enumerate(jax.tree.leaves(p2)):
        res[f"{key}/params/{i}"] = a
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in res.items()})
""" % (B, S, SMAX, STEPS, MESHES, OPT)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The cases' inputs (tokens, fed tokens, frames or patch embeddings),
    the weights (the reference's ``init`` at key 0) and an AdamW state
    (moments from the seed, step 3), saved in the port's layout for the
    ranks to load; the reference's run started on the same in a
    subprocess of its own (its forced host devices must be set before JAX
    starts)."""
    d = tmp_path_factory.mktemp("mesh_families")
    rng = np.random.default_rng(4)
    inputs, files = {}, {}
    for name in MODELS:
        jcfg = jax_config(name).reduced()
        cfg = get_config(name).reduced()
        inputs[f"{name}/tokens"] = rng.integers(
            0, jcfg.vocab, (B, S)).astype(np.int32)
        inputs[f"{name}/feed"] = rng.integers(
            0, jcfg.vocab, (B, STEPS)).astype(np.int32)
        if cfg.n_ctx:
            inputs[f"{name}/extras/{cfg.ctx_key}"] = rng.standard_normal(
                (B, cfg.n_ctx, cfg.ctx_width)).astype(np.float32)
        tree = jax.tree.map(np.asarray,
                            jax_build(jcfg).init(jax.random.PRNGKey(0)))
        ls, structure = jax.tree.flatten(tree)
        m = [rng.normal(0, 1e-3, a.shape).astype(np.float32) for a in ls]
        v = [rng.uniform(1e-6, 1e-4, a.shape).astype(np.float32)
             for a in ls]
        for i, (a, mi, vi) in enumerate(zip(ls, m, v)):
            inputs[f"{name}/params/{i}"] = a
            inputs[f"{name}/m/{i}"] = mi
            inputs[f"{name}/v/{i}"] = vi
        inputs[f"{name}/step"] = np.asarray(3, np.int32)
        files[name] = (str(d / f"{name}.pt"), str(d / f"{name}-opt.pt"))
        params = params_from_jax(tree, cfg, "cpu")
        opt = opt_state_from_jax({"m": jax.tree.unflatten(structure, m),
                                  "v": jax.tree.unflatten(structure, v),
                                  "step": inputs[f"{name}/step"]}, cfg, "cpu")
        if name in WIDE:
            params = tree_map(torch.Tensor.double, params)
            opt.update({k: tree_map(torch.Tensor.double, opt[k])
                        for k in ("m", "v")})
        torch.save(params, files[name][0])
        torch.save(opt, files[name][1])
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true")
    # most of the reference's run is compiling, one process at a time:
    # four subprocesses of about equal work, the float64 cases in their
    # own (x64 is global to JAX), at a lower priority than the test
    # workers beside them (whose socket workers keep heartbeats)
    procs = []
    for i, cases in enumerate(REFERENCE_SPLIT):
        out = d / f"ref{i}.npz"
        wide = cases[0][0] in WIDE
        procs.append((subprocess.Popen(
            ["nice", "-n", "10", sys.executable, "-c", REFERENCE,
             str(d / "inputs.npz"), str(out), repr(cases),
             "wide" if wide else "narrow"], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True),
            out))
    yield dict(inputs=inputs, files=files, procs=procs)
    for proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


_REF = {}


@pytest.fixture(scope="module")
def reference(setup):
    """The reference's outputs, once its subprocesses have ended."""
    def get():
        if not _REF:
            for proc, out in setup["procs"]:
                _, err = proc.communicate(timeout=600)
                assert proc.returncode == 0, err[-4000:]
                _REF.update(np.load(out))
        return _REF
    return get


def _extras(setup, name):
    cfg = get_config(name).reduced()
    if not cfg.n_ctx:
        return None
    return {cfg.ctx_key: torch.from_numpy(
        setup["inputs"][f"{name}/extras/{cfg.ctx_key}"])}


def _config(name):
    cfg = get_config(name).reduced()
    if name in WIDE:
        cfg = dataclasses.replace(cfg, dtype=torch.float64)
    return cfg


def _jobs(setup, name):
    """The serving job and the training job (one AdamW step) of a
    model."""
    cfg = _config(name)
    arr = lambda k: torch.from_numpy(setup["inputs"][f"{name}/{k}"])
    params, opt = setup["files"][name]
    extras = _extras(setup, name)
    return (spmd.Job(cfg, arr("tokens"), STEPS, feed=arr("feed"),
                     params=params, extras=extras),
            spmd.TrainJob(cfg, arr("tokens"), 1, opt=OptConfig(**OPT),
                          params=params, opt_state=opt, extras=extras))


@pytest.fixture(scope="module")
def port(setup, reference):
    """Every case of every mesh, one spawn of ranks per mesh, once the
    reference's subprocess has ended; the planted faults' training cases
    on 1 x 2."""
    reference()
    runs = {}
    for label, shape in MESHES.items():
        cases = {}
        for name, mesh_label in CASES:
            if mesh_label == label:
                serve, train = _jobs(setup, name)
                cases[f"{name}/serve"] = (serve, None, name in WIDE)
                cases[f"{name}/train"] = (train, None, name in WIDE)
        for name, mesh_label in CELLS:
            if mesh_label == label:
                cases[f"{name}/cell"] = (Cell(get_config(name).reduced(),
                                              CELL_SHAPE), None, False)
        if label == "1x2":
            for fault, name in FAULTS.items():
                cases[f"{name}/{fault}"] = (_jobs(setup, name)[1], fault,
                                            False)
        _, runs[label] = spmd.launch(run_family_cases, shape, (cases,),
                                     device="cpu", threads=1)
    return runs


def _close(got, want, tol: float, what: str = ""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol, (what, err)


def _records(port, name, label, kind):
    return [r[f"{name}/{kind}"] for r in port[label]]


def _ref_cache(ref, key, model):
    """The reference's slotted caches ``[G, B, ...]`` in the port's
    layout: the K/V in arena order (attention slot, then group), the SSM
    state and conv window and the cross K/V in layer order."""
    cfg = model.cfg
    period = cfg.layer_pattern_period
    G = cfg.n_layers // period
    slots = {"k": [], "v": [], "state": [], "conv": [], "cross_k": [],
             "cross_v": []}
    for s in range(period):
        if model.layers[s].mixer == "attn":
            for n in ("k", "v"):
                slots[n].append(ref[f"{key}/slot{s}/{n}"])
    out = {n: np.concatenate(ts) for n, ts in slots.items() if ts}
    for g in range(G):
        for s in range(period):
            blk = model.layers[s]
            if blk.mixer == "ssm":
                for n in ("state", "conv"):
                    slots[n].append(ref[f"{key}/slot{s}/{n}"][g])
            if blk.cross is not None:
                for n in ("k", "v"):
                    slots[f"cross_{n}"].append(
                        ref[f"{key}/slot{s}_cross/{n}"][g])
    out.update({n: np.stack(ts) for n, ts in slots.items()
                if ts and n not in ("k", "v")})
    return out


# the dim of each cache entry that the port splits over model
HEAD_DIM = {"k": 3, "v": 3, "cross_k": 3, "cross_v": 3, "state": 2,
            "conv": 3}


def _block(whole, name, rec, tp):
    (lo, hi), m = rec["rows"], rec["coords"][1]
    d = HEAD_DIM[name]
    n = whole.shape[d] // tp
    return np.take(whole[:, lo:hi], np.arange(m * n, (m + 1) * n), axis=d)


MODEL_CASES = [pytest.param(n, m, id=f"{n}-{m}") for n, m in CASES]


@pytest.mark.parametrize("name,label", MODEL_CASES)
def test_prefill_matches_the_reference_sharded_run(name, label, port,
                                                   reference):
    """Logits [B, Vp] whole on every rank of a data index, bitwise alike;
    each rank's blocks of the K/V, the SSM state and conv window and the
    cross K/V (its rows and heads)."""
    ref = reference()
    tp = MESHES[label][1]
    key = f"{name}/{label}"
    recs = _records(port, name, label, "serve")
    _close(spmd.gather_rows(recs)[0], ref[f"{key}/prefill"],
                  LOGIT_TOL, "logits")
    model = build_model(get_config(name).reduced(), device="meta")
    want = _ref_cache(_sub(ref, f"{key}/prefill"), "", model)
    for rec in recs:
        assert rec["foreign"] == []
        assert not any(rec["counts"]["launches"].values())
        got = dict(rec["state"] or {})
        if rec["k"] is not None:
            got.update(k=rec["k"], v=rec["v"])
        assert sorted(got) == sorted(want)
        for n, w in want.items():
            _close(got[n], _block(w, n, rec, tp), TOL, n)
        twin = next(q for q in recs if q["coords"][0] == rec["coords"][0])
        assert torch.equal(rec["logits"], twin["logits"])


def _sub(ref, prefix):
    """The reference's entries under ``prefix``/, keyed by the rest
    (``"/slot0/k"``)."""
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix + "/")}


@pytest.mark.parametrize("name,label", MODEL_CASES)
def test_decode_steps_match_the_reference_sharded_run(name, label, port,
                                                      reference):
    """Two decode steps from the prefilled dense cache: each step's
    logits, and each rank's blocks of every cache entry after them."""
    ref = reference()
    tp = MESHES[label][1]
    key = f"{name}/{label}"
    recs = _records(port, name, label, "serve")
    logits = spmd.gather_rows(recs)
    for i in range(STEPS):
        _close(logits[1 + i], ref[f"{key}/decode{i}"], LOGIT_TOL, i)
    model = build_model(get_config(name).reduced(), device="meta")
    want = _ref_cache(_sub(ref, f"{key}/cache"), "", model)
    for rec in recs:
        got = dict(rec["cache_state"] or {})
        if rec["cache_k"] is not None:
            got.update(k=rec["cache_k"], v=rec["cache_v"])
        assert sorted(got) == sorted(want)
        for n, w in want.items():
            _close(got[n], _block(w, n, rec, tp), TOL, n)


def _ref_tree(ref, key, kind, name):
    """The reference's ``kind`` tree (``grad`` / ``params``) of a case in
    the port's layout."""
    jcfg = jax_config(name).reduced()
    structure = jax.tree.structure(jax_build(jcfg).abstract_params())
    tree = jax.tree.unflatten(structure, [
        ref[f"{key}/{kind}/{i}"] for i in range(structure.num_leaves)])
    return tree_from_jax(tree, get_config(name).reduced(), "cpu")


def _blocks(want_tree, rec, shape, name):
    """The reference's whole leaves cut to this rank's blocks."""
    mesh = LocalMesh(("data", "model"), shape,
                     rank=rec["coords"][0] * shape[1] + rec["coords"][1],
                     coords=tuple(rec["coords"]))
    model = build_model(get_config(name).reduced(), device="meta")
    pspecs = spmd._spec_leaves(param_shardings(mesh, model.param_defs()))
    ctx = ShardingCtx(mesh)
    return [ctx.local_block(w, s) for w, s in zip(leaves(want_tree), pspecs)]


def _grad_errors(rec, want, shape, name):
    """Per leaf path, the largest error of the rank's gradient blocks."""
    return {path: float((g - w).abs().max())
            for (path, g), w in zip(leaves_with_paths(rec["grads"]),
                                    _blocks(want, rec, shape, name))}


@pytest.mark.parametrize("name,label", MODEL_CASES)
def test_gradients_match_the_reference_sharded_run(name, label, port,
                                                   reference):
    """``jax.value_and_grad(Model.loss)`` on the reference's mesh against
    each rank's blocks of the gradients at the starting weights (the
    encoder's and the SSM's leaves among them), and the loss summed over
    ``data``."""
    ref = reference()
    shape = MESHES[label]
    key = f"{name}/{label}"
    want = _ref_tree(ref, key, "grad", name)
    for rec in _records(port, name, label, "train"):
        assert rec["foreign"] == []
        _close(rec["grad_loss"], ref[f"{key}/loss"], LOGIT_TOL, "loss")
        errs = _grad_errors(rec, want, shape, name)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= TOL, (worst, errs[worst])


@pytest.mark.parametrize("name,label", MODEL_CASES)
def test_train_step_matches_the_reference_sharded_step(name, label, port,
                                                       reference):
    """One AdamW step: the loss and the global grad norm (over the SSM's,
    the encoder's and the cross layers' leaves too) on every rank, and
    each rank's blocks of the updated parameters; the replicas of every
    leaf agree bitwise."""
    ref = reference()
    shape = MESHES[label]
    key = f"{name}/{label}"
    recs = _records(port, name, label, "train")
    want = _ref_tree(ref, key, "params", name)
    for rec in recs:
        _close(rec["losses"][0], ref[f"{key}/loss"], LOGIT_TOL, "loss")
        _close(rec["grad_norms"][0], ref[f"{key}/grad_norm"], LOGIT_TOL,
               "grad norm")
        for (path, got), w in zip(leaves_with_paths(rec["params"]),
                                  _blocks(want, rec, shape, name)):
            _close(got, w, TOL, path)
    _, agree = spmd.whole(recs, "params", get_config(name).reduced(), shape)
    assert agree


@pytest.mark.parametrize("fault", ["none", *FAULTS])
def test_a_planted_fault_fails_the_gradient_check(fault, port, reference):
    """The SSM's gated norm with its variance over the rank's channels,
    ``wB``'s gradient not summed over ``model`` and whisper's cross source
    (the encoder's output) with its gradient not summed, each planted in
    the ranks of its own 1 x 2 case: the gradients at the starting
    weights leave the tolerance that the repaired code keeps, in the
    leaves the fault reaches."""
    ref = reference()
    name = FAULTS.get(fault, "mamba2-2.7b")
    kind = "train" if fault == "none" else fault
    want = _ref_tree(ref, f"{name}/1x2", "grad", name)
    errs = {}
    for rec in _records(port, name, "1x2", kind):
        for path, e in _grad_errors(rec, want, (1, 2), name).items():
            errs[path] = max(e, errs.get(path, 0.0))
    worst = max(errs, key=errs.get)
    if fault == "none":
        assert errs[worst] <= TOL, (worst, errs[worst])
        return
    assert errs[worst] > 100 * TOL, (worst, errs[worst])
    reached = {"gated_norm_local": "ssm/", "wB_grad_not_summed": "ssm/wB",
               "kv_src_grad_not_summed": "encoder/"}[fault]
    assert any(reached in p and e > 100 * TOL for p, e in errs.items())


def test_a_mesh_that_does_not_split_the_ssm_heads_raises():
    """Reduced mamba2 has 16 SSM heads: 3 ranks on ``model`` cannot split
    them, and the error names ``ssm/wdt``; nor 3 ranks jamba's attention
    heads, named before its SSM's."""
    mesh = LocalMesh(("data", "model"), (1, 3), rank=0, coords=(0, 0))
    with pytest.raises(ValueError, match="layers/\\*/ssm/wdt: 16 SSM heads"):
        build_model(get_config("mamba2-2.7b").reduced(), device="cpu",
                    mesh=mesh)
    with pytest.raises(ValueError, match="attn/wq: 4 heads"):
        build_model(get_config("jamba-v0.1-52b").reduced(), device="cpu",
                    mesh=mesh)
    # 12 SSM heads in 3 groups of 4: a rank's 6 heads straddle two groups
    cfg = get_config("mamba2-2.7b").reduced()
    cfg = dataclasses.replace(cfg, d_model=96, ssm=dataclasses.replace(
        cfg.ssm, n_groups=3))
    two = LocalMesh(("data", "model"), (1, 2), rank=0, coords=(0, 0))
    with pytest.raises(ValueError, match="ssm/wB: 3 groups of 4 heads"):
        build_model(cfg, device="cpu", mesh=two)


@pytest.mark.parametrize("groups", [1, 2, 4, 16])
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_each_rank_repeats_the_groups_of_its_heads(groups, tp):
    """``mamba2._groups`` on a rank's block of the 16 SSM heads of reduced
    mamba2 (n_groups 1 in every zoo config; here 1, 2, 4 or 16): that
    block of the one-card repeat over the whole heads, bitwise, whether
    the block holds whole groups or lies in one."""
    from repro_torch.models import mamba2 as M2
    cfg = get_config("mamba2-2.7b").reduced()
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, n_groups=groups))
    Bm = torch.randn(2, 3, groups, 16, generator=torch.Generator()
                     .manual_seed(groups))
    whole = M2._groups(Bm, 16, cfg, None)
    assert whole.shape[-2] == 16
    H = 16 // tp
    for rank in range(tp):
        ctx = ShardingCtx(LocalMesh(("data", "model"), (1, tp), rank=rank,
                                    coords=(0, rank)))
        assert torch.equal(M2._groups(Bm, H, cfg, ctx),
                           whole[..., rank * H:(rank + 1) * H, :])


@pytest.mark.parametrize("name", MODELS)
def test_the_cache_on_a_live_mesh_has_the_blocks_of_cache_specs(name):
    """On rank 3 of a live 2 x 2 mesh, ``Model.cache`` of the rank's 2 of
    4 lanes has, for every entry, the per-rank shape of ``cache_specs``
    on 4 lanes: lanes over ``data``, the K/V, cross K/V and SSM state by
    heads and the conv window by channels over ``model``."""
    mesh = LocalMesh(("data", "model"), (2, 2), rank=3, coords=(1, 1))
    model = build_model(get_config(name).reduced(), device="cpu", mesh=mesh)
    cache = model.cache(2, 24)
    structs, specs = model.cache_specs(4, 24)
    assert sorted(cache) == sorted(structs)
    for k, t in cache.items():
        assert tuple(t.shape) == shard_shape(mesh, structs[k].shape,
                                             specs[k]), k
        assert t.dtype == structs[k].dtype
        assert specs[k][-3:].count("model") == 1, (k, specs[k])


@pytest.mark.parametrize("name", MODELS)
def test_the_leaf_by_leaf_draw_keeps_the_blocks_of_the_whole_draw(name):
    """``build_model(cfg, seed=, mesh=)`` draws each leaf and keeps its
    block before drawing the next: on every rank of a 2 x 2 mesh its
    parameters are bitwise ``local_block`` of the whole tree drawn from
    the same seed."""
    cfg = get_config(name).reduced()
    whole = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    for rank in range(4):
        mesh = LocalMesh(("data", "model"), (2, 2), rank=rank,
                         coords=divmod(rank, 2))
        ctx = ShardingCtx(mesh)
        want = ctx.shard_tree(whole, pspec_tree(param_specs(cfg),
                                                ctx.rules))
        got = build_model(cfg, device="cpu", seed=5, mesh=mesh).param_tree()
        for (path, g), w in zip(leaves_with_paths(got), leaves(want)):
            assert g.dtype == w.dtype and torch.equal(g, w), path


@pytest.mark.parametrize("name,label", [pytest.param(n, m, id=f"{n}-{m}")
                                        for n, m in CELLS])
def test_a_train_cell_steps_as_one_process(name, label, port):
    """``training.build_cell``'s train cell on a live mesh (each rank its
    rows of the batch, the frames or patch embeddings among them, and its
    blocks of the parameters and the AdamW state): two steps' loss and
    grad norm, the same on every rank, those of the cell in one
    process."""
    want = cell_steps(None, torch.device("cpu"),
                      Cell(get_config(name).reduced(), CELL_SHAPE))
    recs = [r[f"{name}/cell"] for r in port[label]]
    for got in recs:
        assert got == recs[0]
        for g, w in zip(got, want):
            for k in ("loss", "grad_norm"):
                assert abs(g[k] - w[k]) <= LOGIT_TOL * max(1.0, abs(w[k])), \
                    (k, g[k], w[k])


@pytest.mark.parametrize("name,dtype,family", [
    ("mamba2-2.7b", torch.bfloat16, "ssm"),
    ("mamba2-2.7b", torch.float32, "ssm"),
    ("qwen3-8b", torch.bfloat16, None),
    ("whisper-medium", torch.bfloat16, None),
    ("jamba-v0.1-52b", torch.float32, None)])
def test_train_limits_are_keyed_by_family_and_dtype(name, dtype, family):
    """``spmd.train_limits``: mamba2's own limits in either dtype (set
    from its readings on the card), every other family the dtype's, each
    with the four limits ``check_train`` reads."""
    cfg = dataclasses.replace(get_config(name), dtype=dtype)
    got = spmd.train_limits(cfg)
    assert got is spmd.TRAIN_LIMITS[(family, dtype)]
    assert set(got) == {"loss", "grad_norm", "grads", "params"}
    if family is not None:
        assert got is not spmd.TRAIN_LIMITS[(None, dtype)]
