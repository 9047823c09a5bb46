"""Training in the reference's two other sharding modes, ``tp_sp_opt`` and
``fsdp_cp``: the port's gloo CPU ranks against the reference's sharded
training step in the same mode, and the plain flash backward with a query
offset, which a context-parallel rank's attention differentiates.

The plain backward: rank r of a context-parallel line holds query rows
r s .. (r + 1) s - 1 (s = S / tp) and every key. ``ref.flash_attention_bwd_ref``
at ``q_offset`` r s, and autograd of ``ref.blockwise_attention`` (the CPU's
path of ``ops.flash_attention``) at that offset, against ``jax.vjp`` of the
reference's ``kv_blockwise_attention`` over the whole sequence with a
cotangent that is zero outside the rank's rows: its dk and dv, and those
rows of its dq.

The modes: the reference runs once, in a subprocess with four forced host
devices (``test_torch_mesh_train.py``'s harness): reduced qwen3-8b in both
modes on JAX meshes (1, 2), (2, 1) and (2, 2), and on (2, 2) with
``n_micro`` 2, and reduced moonshot-v1-16b-a3b (dropless: capacity factor
E / K on both sides) in both modes on (1, 2); under one ``jax.jit``
``jax.value_and_grad(Model.loss)`` and one AdamW step from a state 3 steps
in. The port spawns one gloo rank per device, one spawn per mesh, once the
subprocess has ended, and each rank runs ``spmd.train`` of every case of
its mesh from the same weights and state. Compared per rank: the loss, the
gradients' blocks (each norm scale's summed over ``model``, the leaves a
sequence split leaves partial), the step's loss and global grad norm and
the updated parameters' blocks, within ``test_torch_mesh_train.py``'s
tolerances (atol 1e-5; 1e-4 for the loss and the grad norm). A named pin
holds the norm scales' and the router's gradients on 1 x 2.

About 60 s on one worker with one intra-op thread.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_rank import run_train_cases
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models.layers import kv_blockwise_attention
from repro_torch.configs import get_config
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.kernels import ref
from repro_torch.launch import spmd
from repro_torch.training.optimizer import OptConfig
from repro_torch.tree import leaves, leaves_with_paths
from test_torch_mesh_train import (LOSS_TOL, OPT, SRC, TOL, _blocks, _close,
                                   _ref_tree)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The plain backward with a query offset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,tp", [(64, 2), (60, 4)])
def test_the_plain_backward_at_an_offset_is_the_whole_attentions_rows(S, tp):
    """Each rank r of a line of ``tp``: ``ref.flash_attention_bwd_ref``
    (from ``ref.flash_attention_lse``'s output and log-sum-exp at the
    offset) and autograd of ``ref.blockwise_attention`` at ``q_offset``
    r S/tp, against ``jax.vjp`` of ``kv_blockwise_attention`` over the
    whole sequence with the rank's rows' cotangent: dk, dv and the rows'
    dq equal within 1e-5."""
    rng = np.random.default_rng(S * tp)
    B, H, Hkv, hd = 2, 4, 2, 32
    q, k, v = (rng.standard_normal((B, S, h, hd)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    g = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: kv_blockwise_attention(
        a, b, c, causal=True), *map(jnp.asarray, (q, k, v)))
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    s = S // tp
    for r in range(tp):
        rows = slice(r * s, (r + 1) * s)
        ct = np.zeros_like(g)
        ct[:, rows] = g[:, rows]
        want_q, want_k, want_v = (np.asarray(t) for t in
                                  vjp(jnp.asarray(ct)))
        qr, gr = torch.from_numpy(q[:, rows]), torch.from_numpy(g[:, rows])
        o, lse = ref.flash_attention_lse(qr, kt, vt, True, r * s)
        dq, dk, dv = ref.flash_attention_bwd_ref(qr, kt, vt, o, lse, gr,
                                                 True, r * s)
        for got, want in ((dq, want_q[:, rows]), (dk, want_k),
                          (dv, want_v)):
            _close(got, want, **TOL)
        xs = [t.clone().requires_grad_(True) for t in (qr, kt, vt)]
        ref.blockwise_attention(*xs, True, r * s).backward(gr)
        for x, want in zip(xs, (want_q[:, rows], want_k, want_v)):
            _close(x.grad, want, **TOL)


# ---------------------------------------------------------------------------
# Each mode against the reference's sharded training step
# ---------------------------------------------------------------------------

QWEN, MOE = "qwen3-8b", "moonshot-v1-16b-a3b"
MODES = ("tp_sp_opt", "fsdp_cp")
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
S, B = 16, 4
# (model, mode, label, mesh label, n_micro)
CASES = ([(QWEN, mode, m, m, 1) for mode in MODES for m in MESHES]
         + [(QWEN, mode, "2x2-micro2", "2x2", 2) for mode in MODES]
         + [(MOE, mode, "1x2", "1x2", 1) for mode in MODES])

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
from repro.training.train_step import make_loss_fn, make_train_step

S, B, CASES, MESHES, OPT = %d, %d, %r, %r, %r
res = {}


def dropless(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


inputs = np.load(sys.argv[1])
for name, mode, label, mesh_label, n_micro in CASES:
    cfg = dropless(get_config(name).reduced())
    structure = jax.tree.structure(build_model(cfg).abstract_params())
    tree = lambda k: jax.tree.unflatten(structure, [
        jnp.asarray(inputs[f"{name}/{k}/{i}"])
        for i in range(structure.num_leaves)])
    state = {"m": tree("m"), "v": tree("v"),
             "step": jnp.asarray(inputs[f"{name}/step"])}
    mesh = jax.make_mesh(MESHES[mesh_label], ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    m = build_model(cfg, mesh=mesh, mode=mode)
    place = lambda specs, t: jax.tree.map(
        lambda s, a: jax.device_put(a, NamedSharding(mesh, s)), specs, t,
        is_leaf=lambda s: isinstance(s, P))
    p = place(m.param_pspecs(), tree("params"))
    o = place(opt_pspecs(m.param_pspecs()), state)
    bs = NamedSharding(mesh, m.ctx.spec("batch", None, dims=(B, S)))
    batch = {k: jax.device_put(jnp.asarray(inputs[f"{name}/{k}"]), bs)
             for k in ("tokens", "labels")}
    loss_fn = make_loss_fn(m)
    step = make_train_step(m, OptConfig(**OPT), n_micro)

    def both(p, o, b):
        loss, grads = jax.value_and_grad(loss_fn)(p, b)
        if n_micro > 1:
            p2, _, metrics = step(p, o, b)
        else:   # make_train_step's own n_micro == 1 step, on these grads
            p2, _, metrics = adamw_update(grads, o, p, OptConfig(**OPT))
            metrics["loss"] = loss
        return loss, grads, p2, metrics

    loss, grads, p2, metrics = jax.jit(both)(p, o, batch)
    key = f"{name}/{mode}/{label}"
    res[f"{key}/loss"] = loss
    res[f"{key}/step_loss"] = metrics["loss"]
    res[f"{key}/grad_norm"] = metrics["grad_norm"]
    for i, a in enumerate(jax.tree.leaves(grads)):
        res[f"{key}/grad/{i}"] = a
    for i, a in enumerate(jax.tree.leaves(p2)):
        res[f"{key}/params/{i}"] = a
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in res.items()})
""" % (S, B, CASES, MESHES, OPT)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, the weights (the reference's ``init`` at key 0) and an
    AdamW state (moments from the seed, step 3), saved in the port's
    layout for the ranks; the reference's run started on the same in a
    subprocess of its own (its forced host devices must be set before JAX
    starts)."""
    d = tmp_path_factory.mktemp("mesh_modes_train")
    rng = np.random.default_rng(4)
    inputs, files = {}, {}
    for name in (QWEN, MOE):
        jcfg = jax_config(name).reduced()
        toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
        inputs[f"{name}/tokens"] = toks
        inputs[f"{name}/labels"] = np.roll(toks, -1, 1)
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
        cfg = get_config(name).reduced()
        files[name] = (str(d / f"{name}.pt"), str(d / f"{name}-opt.pt"))
        torch.save(params_from_jax(tree, cfg, "cpu"), files[name][0])
        torch.save(opt_state_from_jax(
            {"m": jax.tree.unflatten(structure, m),
             "v": jax.tree.unflatten(structure, v),
             "step": inputs[f"{name}/step"]}, cfg, "cpu"), files[name][1])
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "inputs.npz"),
         str(d / "ref.npz")], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    yield dict(inputs=inputs, files=files, proc=proc, out=d / "ref.npz")
    if proc.poll() is None:
        proc.kill()
        proc.wait()


_REF = {}


@pytest.fixture(scope="module")
def reference(setup):
    """The reference's outputs, once its subprocess has ended."""
    if not _REF:
        _, err = setup["proc"].communicate(timeout=900)
        assert setup["proc"].returncode == 0, err[-4000:]
        _REF.update(np.load(setup["out"]))
    return _REF


def _key(name, mode, label):
    return f"{name}/{mode}/{label}"


@pytest.fixture(scope="module")
def port(setup, reference):
    """Every case of every mesh, one spawn of ranks per mesh, once the
    reference's subprocess has ended."""
    runs = {}
    for mesh_label, shape in MESHES.items():
        cases = {}
        for name, mode, label, m, n_micro in CASES:
            if m != mesh_label:
                continue
            params, opt = setup["files"][name]
            cases[_key(name, mode, label)] = spmd.TrainJob(
                spmd.dropless(get_config(name).reduced()),
                torch.from_numpy(setup["inputs"][f"{name}/tokens"]), 1,
                n_micro, opt=OptConfig(**OPT), params=params,
                opt_state=opt, mode=mode)
        _, runs[mesh_label] = spmd.launch(run_train_cases, shape, (cases,),
                                          device="cpu", threads=1)
    return runs


def _records(port, name, mode, label):
    mesh_label = next(m for n, md, lab, m, _ in CASES
                      if (n, md, lab) == (name, mode, label))
    return MESHES[mesh_label], [r[_key(name, mode, label)]
                                for r in port[mesh_label]]


GRAD_CASES = [(n, md, lab) for n, md, lab, _, nm in CASES if nm == 1]
STEP_CASES = [(n, md, lab) for n, md, lab, _, _ in CASES]


@pytest.mark.parametrize("name,mode,label", GRAD_CASES)
def test_gradients_match_the_reference_sharded_run_in_the_mode(
        name, mode, label, port, reference):
    """``jax.value_and_grad(Model.loss)`` on the reference's mesh in
    ``mode`` against each rank's blocks of the gradients and its loss
    summed over ``data``."""
    shape, recs = _records(port, name, mode, label)
    key = _key(name, mode, label)
    want = _ref_tree(reference, key, "grad", name)
    for rec in recs:
        assert rec["foreign"] == []
        _close(rec["grad_loss"], reference[f"{key}/loss"], **LOSS_TOL)
        for got, w in zip(leaves(rec["grads"]),
                          _blocks(want, rec, shape, name)):
            _close(got, w)


@pytest.mark.parametrize("name,mode,label", STEP_CASES)
def test_train_step_matches_the_reference_sharded_step_in_the_mode(
        name, mode, label, port, reference):
    """One AdamW step of ``make_train_step`` in ``mode``: the loss and the
    global grad norm on every rank (each replicated leaf counted once),
    each rank's blocks of the updated parameters, the replicas of every
    leaf bitwise equal."""
    shape, recs = _records(port, name, mode, label)
    key = _key(name, mode, label)
    want = _ref_tree(reference, key, "params", name)
    for rec in recs:
        _close(rec["losses"][0], reference[f"{key}/step_loss"], **LOSS_TOL)
        _close(rec["grad_norms"][0], reference[f"{key}/grad_norm"],
               **LOSS_TOL)
        for got, w in zip(leaves(rec["params"]),
                          _blocks(want, rec, shape, name)):
            _close(got, w)
    _, agree = spmd.whole(recs, "params", get_config(name).reduced(), shape,
                          mode=mode)
    assert agree


def _replicated_over_model(path):
    return path == "final_ln" or path.endswith(("/ln", "/router"))


@pytest.mark.parametrize("name,mode", [(n, md) for n in (QWEN, MOE)
                                       for md in MODES])
def test_the_norm_scales_and_router_gradients_are_summed_over_model(
        name, mode, port, reference):
    """The pin of the leaves replicated over ``model`` that a sequence
    split leaves partial on each rank (every ``ln`` scale and
    ``final_ln``; the router, which enters the rank's block): on 1 x 2,
    each rank's gradient of each is the reference's whole one."""
    shape, recs = _records(port, name, mode, "1x2")
    want = _ref_tree(reference, _key(name, mode, "1x2"), "grad", name)
    n_layers = get_config(name).reduced().n_layers
    for rec in recs:
        wants = _blocks(want, rec, shape, name)
        got = [(g, w) for (p, g), w in zip(leaves_with_paths(rec["grads"]),
                                           wants)
               if _replicated_over_model(p)]
        # two norms a layer and the final one; a MoE layer's router
        assert len(got) == (3 if name == MOE else 2) * n_layers + 1
        for g, w in got:
            _close(g, w)
