"""The head layout across a live mesh against the reference's sharded run:
KV heads replicated where ``model`` exceeds them, and a KV group's query
heads split unevenly over the ranks that share its KV head.

The reference runs in subprocesses with four forced host devices (as
``test_torch_mesh_families.py``'s), on a JAX mesh (1, 4) built with
``AxisType.Auto`` axes: its GSPMD splits the flattened ``Hkv * hd``
columns, so no case falls back to one device. The cases: reduced
qwen3-8b (4 heads, 2 KV heads: each KV head on 2 ranks, one query head
a rank), the same with 6 heads (a group's 3 query heads as 2 and 1), and
reduced whisper-medium (its decoder's, cross layers' and encoder's heads
alike). It records the prefill's logits and caches, two decode steps'
logits, and under one ``jax.jit`` ``jax.value_and_grad(Model.loss)`` and
one AdamW step from moments drawn from the seed at step 3. The port's
gloo ranks (one spawn, once the subprocesses have ended) serve and train
the same weights; each rank's K/V and cross K/V are its KV head's block
of the reference's whole caches; the gradients and the updated
parameters, put back together from the ranks' blocks
(``spmd.whole``), are held to the reference's within ``spmd.TRAIN_LIMITS``'
float32 limits, the loss and grad norm too, and the replicas of every
leaf (each KV block's among them) agree bitwise.
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

from _torch_mesh_rank import run_family_cases
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import (opt_state_from_jax, params_from_jax,
                                 tree_from_jax)
from repro_torch.distributed.sharding import head_layout
from repro_torch.launch import spmd
from repro_torch.training.optimizer import OptConfig
from repro_torch.tree import leaves_with_paths


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# case -> (config, overrides of its reduced widths)
CASES = {"qwen3-8b": ("qwen3-8b", {}),
         "qwen3-8b-h6": ("qwen3-8b", {"n_heads": 6}),
         "whisper-medium": ("whisper-medium", {})}
MESH = (1, 4)
B, S, SMAX, STEPS = 2, 16, 32, 2
OPT = dict(lr=1e-2, warmup_steps=1)
LOGIT_TOL, TOL = 1e-4, 1e-5
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

B, S, SMAX, STEPS, MESH, OPT = %d, %d, %d, %d, %r, %r
CASES = eval(sys.argv[3])
res = {}
inputs = np.load(sys.argv[1])
mesh = jax.make_mesh(MESH, ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
for key, (name, over) in CASES.items():
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    m = build_model(cfg, mesh=mesh)
    structure = jax.tree.structure(m.abstract_params())
    tree = lambda k: jax.tree.unflatten(structure, [
        jnp.asarray(inputs[f"{key}/{k}/{i}"], jnp.float32)
        for i in range(structure.num_leaves)])
    place = lambda specs, t: jax.tree.map(
        lambda s, a: jax.device_put(a, NamedSharding(mesh, s)), specs, t,
        is_leaf=lambda s: isinstance(s, P))
    p = place(m.param_pspecs(), tree("params"))
    o = place(opt_pspecs(m.param_pspecs()),
              {"m": tree("m"), "v": tree("v"),
               "step": jnp.asarray(inputs[f"{key}/step"])})
    toks = jnp.asarray(inputs[f"{key}/tokens"])
    extras = {k.split("/")[-1]: jnp.asarray(inputs[k])
              for k in inputs.files if k.startswith(f"{key}/extras/")}
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
    feed = inputs[f"{key}/feed"]
    for i in range(STEPS):
        pos = jnp.full((B,), S + i, jnp.int32)
        logits, cache = decode(p, cache, jnp.asarray(feed[:, i:i + 1]), pos)
        res[f"{key}/decode{i}"] = logits
    batch = {"tokens": toks,
             "labels": jnp.asarray(np.roll(inputs[f"{key}/tokens"], -1, 1)),
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
""" % (B, S, SMAX, STEPS, MESH, OPT)


def _configs(key):
    name, over = CASES[key]
    return (dataclasses.replace(jax_config(name).reduced(), **over),
            dataclasses.replace(get_config(name).reduced(), **over))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The cases' inputs and weights (the reference's ``init`` at key 0)
    and AdamW states (moments from the seed, step 3), saved for the
    ranks; the reference's runs started on them, the qwen3 cases and
    whisper's in subprocesses of their own."""
    d = tmp_path_factory.mktemp("mesh_heads")
    rng = np.random.default_rng(6)
    inputs, files = {}, {}
    for key in CASES:
        jcfg, cfg = _configs(key)
        inputs[f"{key}/tokens"] = rng.integers(
            0, jcfg.vocab, (B, S)).astype(np.int32)
        inputs[f"{key}/feed"] = rng.integers(
            0, jcfg.vocab, (B, STEPS)).astype(np.int32)
        if cfg.n_ctx:
            inputs[f"{key}/extras/{cfg.ctx_key}"] = rng.standard_normal(
                (B, cfg.n_ctx, cfg.ctx_width)).astype(np.float32)
        tree = jax.tree.map(np.asarray,
                            jax_build(jcfg).init(jax.random.PRNGKey(0)))
        ls, structure = jax.tree.flatten(tree)
        m = [rng.normal(0, 1e-3, a.shape).astype(np.float32) for a in ls]
        v = [rng.uniform(1e-6, 1e-4, a.shape).astype(np.float32)
             for a in ls]
        for i, (a, mi, vi) in enumerate(zip(ls, m, v)):
            inputs[f"{key}/params/{i}"] = a
            inputs[f"{key}/m/{i}"] = mi
            inputs[f"{key}/v/{i}"] = vi
        inputs[f"{key}/step"] = np.asarray(3, np.int32)
        files[key] = (str(d / f"{key}.pt"), str(d / f"{key}-opt.pt"))
        torch.save(params_from_jax(tree, cfg, "cpu"), files[key][0])
        torch.save(opt_state_from_jax(
            {"m": jax.tree.unflatten(structure, m),
             "v": jax.tree.unflatten(structure, v),
             "step": inputs[f"{key}/step"]}, cfg, "cpu"), files[key][1])
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true")
    procs = []
    for i, keys in enumerate((["qwen3-8b", "qwen3-8b-h6"],
                              ["whisper-medium"])):
        out = d / f"ref{i}.npz"
        procs.append((subprocess.Popen(
            ["nice", "-n", "10", sys.executable, "-c", REFERENCE,
             str(d / "inputs.npz"), str(out),
             repr({k: CASES[k] for k in keys})], env=env,
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
    if not _REF:
        for proc, out in setup["procs"]:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            _REF.update(np.load(out))
    return _REF


@pytest.fixture(scope="module")
def port(setup, reference):
    """Every case's serving and training on one spawn of 1 x 4 gloo
    ranks, once the reference's subprocesses have ended."""
    cases = {}
    for key in CASES:
        _, cfg = _configs(key)
        arr = lambda k: torch.from_numpy(setup["inputs"][f"{key}/{k}"])
        params, opt = setup["files"][key]
        extras = (None if not cfg.n_ctx else
                  {cfg.ctx_key: arr(f"extras/{cfg.ctx_key}")})
        cases[f"{key}/serve"] = (spmd.Job(
            cfg, arr("tokens"), STEPS, feed=arr("feed"), params=params,
            extras=extras), None, False)
        cases[f"{key}/train"] = (spmd.TrainJob(
            cfg, arr("tokens"), 1, opt=OptConfig(**OPT), params=params,
            opt_state=opt, extras=extras), None, False)
    _, records = spmd.launch(run_family_cases, MESH, (cases,), device="cpu",
                             threads=1)
    return records


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol, (what, err)


KEYS = list(CASES)


@pytest.mark.parametrize("key", KEYS)
def test_each_rank_holds_its_heads_of_the_layout(key, port):
    """Each rank's K/V (and cross K/V) hold its one KV head of the layout,
    the ranks sharing it bitwise alike; its query heads are 1 a rank, or
    2 and 1 where a group's 3 split over 2 ranks."""
    _, cfg = _configs(key)
    recs = [r[f"{key}/serve"] for r in port]
    for rec in recs:
        hb = head_layout(cfg.n_heads, cfg.n_kv_heads, MESH[1],
                         rec["coords"][1])
        assert hb.kv[1] - hb.kv[0] == 1 and hb.replicas == 2
        assert rec["k"].shape[3] == 1
        twin = recs[rec["coords"][1] ^ 1]
        assert torch.equal(rec["k"], twin["k"])
        assert torch.equal(rec["cache_v"], twin["cache_v"])
    sizes = [head_layout(cfg.n_heads, cfg.n_kv_heads, MESH[1], m).q
             for m in range(MESH[1])]
    want = ([(0, 2), (2, 3), (3, 5), (5, 6)] if cfg.n_heads == 6
            else [(m, m + 1) for m in range(4)])
    assert sizes == want


@pytest.mark.parametrize("key", KEYS)
def test_serving_matches_the_reference_sharded_run(key, port, reference):
    """The prefill's and two decode steps' logits whole on every rank;
    each rank's K/V after the prefill (and whisper's cross K/V) its KV
    head's block of the reference's."""
    ref = reference
    _, cfg = _configs(key)
    recs = [r[f"{key}/serve"] for r in port]
    logits = spmd.gather_rows(recs)
    _close(logits[0], ref[f"{key}/prefill"], LOGIT_TOL, "prefill")
    for i in range(STEPS):
        _close(logits[1 + i], ref[f"{key}/decode{i}"], LOGIT_TOL, i)
    for rec in recs:
        assert rec["foreign"] == []
        g0, g1 = head_layout(cfg.n_heads, cfg.n_kv_heads, MESH[1],
                             rec["coords"][1]).kv
        for n in ("k", "v"):
            _close(rec[n], ref[f"{key}/prefill/slot0/{n}"][..., g0:g1, :],
                   TOL, n)
        if cfg.n_ctx:
            for n in ("k", "v"):
                _close(rec["state"][f"cross_{n}"],
                       ref[f"{key}/prefill/slot0_cross/{n}"][..., g0:g1, :],
                       TOL, f"cross_{n}")


def _ref_tree(ref, key, kind):
    """The reference's ``kind`` tree (``grad`` / ``params``) of a case in
    the port's layout."""
    jcfg, cfg = _configs(key)
    structure = jax.tree.structure(jax_build(jcfg).abstract_params())
    tree = jax.tree.unflatten(structure, [
        ref[f"{key}/{kind}/{i}"] for i in range(structure.num_leaves)])
    return tree_from_jax(tree, cfg, "cpu")


@pytest.mark.parametrize("key", KEYS)
def test_training_matches_the_reference_sharded_run(key, port, reference):
    """``jax.value_and_grad(Model.loss)`` and one AdamW step on the
    reference's mesh against the ranks' gradients at the starting weights
    and parameters after the step, put back together by the head layout:
    within the float32 ``spmd.TRAIN_LIMITS`` (and 1e-5 of any element);
    the loss and grad norm on every rank; the replicas of every leaf of
    both, each shared KV block's among them, bitwise equal."""
    _, cfg = _configs(key)
    limits = spmd.train_limits(cfg)
    recs = [r[f"{key}/train"] for r in port]
    rel = lambda a, b: abs(float(a) - float(b)) / abs(float(b))
    for rec in recs:
        assert rec["foreign"] == []
        assert rel(rec["grad_loss"], reference[f"{key}/loss"]) \
            <= limits["loss"]
        assert rel(rec["losses"][0], reference[f"{key}/loss"]) \
            <= limits["loss"]
        assert rel(rec["grad_norms"][0], reference[f"{key}/grad_norm"]) \
            <= limits["grad_norm"]
    for kind, what in (("grad", "grads"), ("params", "params")):
        got, agree = spmd.whole(recs, what, cfg, MESH)
        assert agree, what
        want = _ref_tree(reference, key, kind)
        err, leaf = spmd.leaf_scaled_err(got, want)
        assert err <= limits[what], (what, leaf, err)
        for (path, g), (_, w) in zip(leaves_with_paths(got),
                                     leaves_with_paths(want)):
            _close(g, w, TOL, f"{what} {path}")
