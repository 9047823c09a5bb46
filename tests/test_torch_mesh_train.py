"""The port's training step across a ``(data, model)`` mesh of gloo CPU
ranks against the reference's sharded training step.

The reference side runs once, in a subprocess with four forced host
devices (as ``test_torch_mesh.py``'s): reduced qwen3-8b and
moonshot-v1-16b-a3b on JAX meshes (2, 2), (1, 2) and (2, 1) built with
``AxisType.Auto`` axes, their parameters and AdamW state placed by
``param_pspecs()`` / ``opt_pspecs()`` and the batch by the data axis where
it divides it; under one ``jax.jit``, ``jax.value_and_grad(Model.loss)``
and one ``make_train_step`` step. Cases: B 4 x S 16 on every mesh, qwen3
with ``n_micro=2`` on 2 x 2, and B 1 on 2 x 1 (the data axis does not
divide it: the batch is replicated, and each data rank's loss is its
share, so the batch counts once). It also takes ``jax.vjp`` of each
collective in a ``shard_map`` on rank-tagged blocks. The port side spawns
one gloo rank per device (file store), only once that subprocess has
ended, one spawn per mesh for all of its cases; the weights come through
``params_from_jax`` and the AdamW state through ``opt_state_from_jax``.

The AdamW state is not zeros: moments drawn from the seed at step 3, so
that the update is a smooth function of the gradient (from zeros the
first step is ``g / |g|``, whose sign flips on gradients near zero).
Tolerances are ``test_torch_mesh.py``'s: atol 1e-5 for gradients and
parameters, 1e-4 for the loss (and the grad norm).
"""
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_mesh_rank import run_train_cases
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import opt_state_from_jax, params_from_jax, \
    tree_from_jax
from repro_torch.distributed.sharding import (ShardingCtx, param_shardings,
                                              placements)
from repro_torch.launch import spmd
from repro_torch.launch.mesh import LocalMesh
from repro_torch.models import build_model
from repro_torch.training.optimizer import OptConfig
from repro_torch.tree import leaves


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODELS = ("qwen3-8b", "moonshot-v1-16b-a3b")
MESHES = {"2x2": (2, 2), "1x2": (1, 2), "2x1": (2, 1)}
S = 16
# (model, label, mesh, B, n_micro)
CASES = ([(n, m, m, 4, 1) for n in MODELS for m in MESHES]
         + [("qwen3-8b", "2x2-micro2", "2x2", 4, 2)]
         + [(n, "2x1-B1", "2x1", 1, 1) for n in MODELS])
OPT = dict(lr=1e-2, warmup_steps=1)
TOL = dict(rtol=0, atol=1e-5)
LOSS_TOL = dict(rtol=0, atol=1e-4)
SRC = pathlib.Path(__file__).resolve().parent.parent / "src"

REFERENCE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import build_model
from repro.training.optimizer import OptConfig, adamw_update, opt_pspecs
from repro.training.train_step import make_loss_fn, make_train_step

S, CASES, MESHES, OPT = %d, %r, %r, %r
res = {}


def make_mesh(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


inputs = np.load(sys.argv[1])
for name, label, mesh_label, B, n_micro in CASES:
    cfg = get_config(name).reduced()
    structure = jax.tree.structure(build_model(cfg).abstract_params())
    tree = lambda k: jax.tree.unflatten(structure, [
        jnp.asarray(inputs[f"{name}/{k}/{i}"])
        for i in range(structure.num_leaves)])
    params = tree("params")
    state = {"m": tree("m"), "v": tree("v"),
             "step": jnp.asarray(inputs[f"{name}/step"])}
    mesh = make_mesh(MESHES[mesh_label])
    m = build_model(cfg, mesh=mesh)
    place = lambda specs, t: jax.tree.map(
        lambda s, a: jax.device_put(a, NamedSharding(mesh, s)), specs, t,
        is_leaf=lambda s: isinstance(s, P))
    p = place(m.param_pspecs(), params)
    o = place(opt_pspecs(m.param_pspecs()), state)
    bs = NamedSharding(mesh, m.ctx.spec("batch", None, dims=(B, S)))
    batch = {k: jax.device_put(jnp.asarray(inputs[f"{name}/{k}{B}"]), bs)
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
    key = f"{name}/{label}"
    res[f"{key}/loss"] = loss
    res[f"{key}/step_loss"] = metrics["loss"]
    res[f"{key}/grad_norm"] = metrics["grad_norm"]
    for i, a in enumerate(jax.tree.leaves(grads)):
        res[f"{key}/grad/{i}"] = a
    for i, a in enumerate(jax.tree.leaves(p2)):
        res[f"{key}/params/{i}"] = a

# each collective's vjp on rank-tagged blocks: rank r = d * model + m
# holds arange(24).reshape(4, 2, 3) + 100 r; where the output differs
# across the ranks its cotangent is rank-tagged (1000 + 10 r), where it is
# whole over model, the data row's (1000 + 10 d model)
for label, (dp, tp) in MESHES.items():
    mesh = make_mesh((dp, tp))
    n = dp * tp
    base = np.arange(24, dtype=np.float32).reshape(1, 4, 2, 3)
    x = base + 100 * np.arange(n, dtype=np.float32).reshape(n, 1, 1, 1)
    x_row = base + 100 * np.arange(dp, dtype=np.float32).reshape(
        dp, 1, 1, 1)
    ranks, rows = P(("data", "model")), P("data")
    kinds = {
        "gather_sum": (lambda b: lax.all_gather(b, "model", axis=2,
                                                tiled=True), x, ranks, ranks),
        "gather_block": (lambda b: lax.all_gather(b, "model", axis=2,
                                                  tiled=True), x, ranks, rows),
        "all_reduce": (lambda b: lax.psum(b, "model"), x, ranks, rows),
        "enter": (lambda b: b * 1.0, x_row, rows, ranks),
        "all_to_all": (lambda b: lax.all_to_all(b, "model", 1, 2,
                                                tiled=True), x, ranks, ranks),
        "reduce_scatter": (lambda b: lax.psum_scatter(
            b, "model", scatter_dimension=1, tiled=True), x, ranks, ranks),
        "all_reduce_max": (lambda b: lax.pmax(b, "model"), x, ranks, ranks)}
    fns = {k: jax.shard_map(body, mesh=mesh, in_specs=ins, out_specs=outs,
                            check_vma=False)
           for k, (body, _, ins, outs) in kinds.items()}

    def cotangent(y, outs):
        # one block per rank (per data row where the output is whole over
        # model) along dim 0
        step = 1 if outs == ranks else tp
        return jnp.stack([jnp.arange(np.prod(y.shape[1:]), dtype=jnp.float32)
                          .reshape(y.shape[1:]) + 1000 + 10 * j * step
                          for j in range(y.shape[0])])

    def probe(args):
        out = {}
        for k, f in fns.items():
            if k == "all_reduce_max":        # no gradient
                out[k] = (f(args[k]), None)
                continue
            y, vjp = jax.vjp(f, args[k])
            out[k] = (y, vjp(cotangent(y, kinds[k][3]))[0])
        return out

    got = jax.jit(probe)({k: jnp.asarray(v[1]) for k, v in kinds.items()})
    for k, (y, g) in got.items():
        res[f"probe/{label}/{k}/y"] = y
        if g is not None:
            res[f"probe/{label}/{k}/ct"] = g
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in res.items()})
""" % (S, CASES, MESHES, OPT)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The cases' inputs, the weights (the reference's ``init`` at key 0)
    and an AdamW state (moments from the seed, step 3), saved in the
    port's layout for the ranks to load; the reference's run started on
    the same in a subprocess of its own (its forced host devices must be
    set before JAX starts)."""
    d = tmp_path_factory.mktemp("mesh_train")
    rng = np.random.default_rng(2)
    inputs, files = {}, {}
    for name in MODELS:
        jcfg = jax_config(name).reduced()
        for B in (4, 1):
            toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
            inputs[f"{name}/tokens{B}"] = toks
            inputs[f"{name}/labels{B}"] = np.roll(toks, -1, 1)
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
    def get():
        if not _REF:
            _, err = setup["proc"].communicate(timeout=600)
            assert setup["proc"].returncode == 0, err[-4000:]
            _REF.update(np.load(setup["out"]))
        return _REF
    return get


def _job(setup, name, B, n_micro, steps=1):
    arr = lambda k: torch.from_numpy(setup["inputs"][f"{name}/{k}{B}"])
    params, opt = setup["files"][name]
    return spmd.TrainJob(get_config(name).reduced(), arr("tokens"), steps,
                         n_micro, opt=OptConfig(**OPT), params=params,
                         opt_state=opt)


@pytest.fixture(scope="module")
def port(setup, reference):
    """Every case of every mesh, one spawn of ranks per mesh, once the
    reference's subprocess has ended."""
    reference()
    runs = {}
    for mesh_label, shape in MESHES.items():
        cases = {f"{name}/{label}": _job(setup, name, B, n_micro)
                 for name, label, m, B, n_micro in CASES if m == mesh_label}
        _, runs[mesh_label] = spmd.launch(
            run_train_cases, shape, (cases, get_config(MODELS[1]).reduced()),
            device="cpu", threads=1)
    return runs


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
    ctx = ShardingCtx(mesh)
    pspecs = spmd._spec_leaves(param_shardings(mesh, model.param_defs()))
    return [ctx.local_block(w, s) for w, s in zip(leaves(want_tree), pspecs)]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _records(port, label, name):
    mesh_label = next(m for n, lab, m, _, _ in CASES
                      if n == name and lab == label)
    return MESHES[mesh_label], [r[f"{name}/{label}"]
                                for r in port[mesh_label]]


GRAD_CASES = [(n, lab) for n, lab, _, _, nm in CASES if nm == 1]
STEP_CASES = [(n, lab) for n, lab, _, _, _ in CASES]


@pytest.mark.parametrize("name,label", GRAD_CASES)
def test_gradients_match_the_reference_sharded_run(name, label, port,
                                                   reference):
    """``jax.value_and_grad(Model.loss)`` on the reference's mesh against
    each rank's blocks of the gradients (each replicated leaf's summed
    over ``data``, each ZeRO-3 leaf's reduce-scattered), and the loss
    summed over ``data``."""
    ref = reference()
    shape, recs = _records(port, label, name)
    key = f"{name}/{label}"
    want = _ref_tree(ref, key, "grad", name)
    for rec in recs:
        assert rec["foreign"] == []
        _close(rec["grad_loss"], ref[f"{key}/loss"], **LOSS_TOL)
        for got, w in zip(leaves(rec["grads"]),
                          _blocks(want, rec, shape, name)):
            _close(got, w)


@pytest.mark.parametrize("name,label", STEP_CASES)
def test_train_step_matches_the_reference_sharded_step(name, label, port,
                                                       reference):
    """One AdamW step of ``make_train_step``: the loss and the global grad
    norm on every rank, and each rank's blocks of the updated parameters;
    the replicas of every leaf agree bitwise."""
    ref = reference()
    shape, recs = _records(port, label, name)
    key = f"{name}/{label}"
    want = _ref_tree(ref, key, "params", name)
    for rec in recs:
        _close(rec["losses"][0], ref[f"{key}/step_loss"], **LOSS_TOL)
        _close(rec["grad_norms"][0], ref[f"{key}/grad_norm"], **LOSS_TOL)
        for got, w in zip(leaves(rec["params"]),
                          _blocks(want, rec, shape, name)):
            _close(got, w)
    _, agree = spmd.whole(recs, "params", get_config(name).reduced(), shape)
    assert agree


@pytest.mark.parametrize("mesh_label", list(MESHES))
def test_collective_transposes_match_jax_vjp(mesh_label, port, reference):
    """Each collective's forward and, through autograd, its backward on
    rank-tagged blocks, rank by rank against ``jax.vjp`` of the matching
    ``lax`` collective in a ``shard_map`` on the same mesh: the ZeRO-3
    all-gather's reduce-scatter, the replicated gather's block, the
    all-reduce's identity, ``enter``'s all-reduce, the all-to-all's
    reverse; ``reduce_scatter`` against ``lax.psum_scatter`` (and its
    all-gather) and ``all_reduce_max`` against ``lax.pmax``."""
    ref = reference()
    dp, tp = MESHES[mesh_label]
    for r in port[mesh_label]:
        d = r["rank"] // tp
        for kind, (y, g) in r["probe"].items():
            wy = ref[f"probe/{mesh_label}/{kind}/y"]
            rows_out = kind in ("gather_block", "all_reduce")
            _close(y, wy[d if rows_out else r["rank"]][None], rtol=0, atol=0)
            if g is None:
                continue
            wg = ref[f"probe/{mesh_label}/{kind}/ct"]
            _close(g, wg[d if kind == "enter" else r["rank"]][None], rtol=0,
                   atol=0)


@pytest.mark.parametrize("mesh_label", list(MESHES))
def test_backward_collectives_are_counted(mesh_label, port):
    """The backward's calls count under the kind they run: ZeRO-3's
    reduce-scatters over ``data`` (every one a backward call), ``enter``'s
    all-reduces over ``model``, moonshot's reverse all-to-alls."""
    dp, tp = MESHES[mesh_label]
    for r in port[mesh_label]:
        for name in MODELS:
            st = r[f"{name}/{mesh_label}"]["collectives"]
            if dp > 1:
                rs = st["reduce_scatter"]["data"]
                assert rs["calls"] == rs["backward"] > 0
            else:
                assert "reduce_scatter" not in st
            if tp > 1:
                assert st["all_reduce"]["model"]["backward"] > 0
                assert st["all_reduce_max"]["model"]["backward"] == 0
            if tp > 1 and name.startswith("moonshot"):
                a2a = st["all_to_all"]["model"]
                assert 0 < a2a["backward"] < a2a["calls"]


@pytest.mark.parametrize("mesh_label", list(MESHES))
def test_int8_compression_scales_each_leaf_by_its_whole_max(mesh_label,
                                                            port):
    """int8 gradient compression on each rank's blocks (moonshot's
    leaves: split over both axes, over one, or none) takes each leaf's
    scale from its max over the ranks that split it: the blocks of the
    decompressed gradients and of the residual are bitwise those of the
    same compression of the whole leaves in one process."""
    from repro_torch.training.optimizer import adamw_init, compress_grads
    from repro_torch.tree import tree_map
    cfg = get_config(MODELS[1]).reduced()
    model = build_model(cfg, device="cpu", seed=0)
    grads = tree_map(lambda p: p * 1e-3, model.param_tree())
    state = adamw_init(grads, "int8")
    q, state = compress_grads(grads, state, OptConfig(compression="int8"))
    shape = MESHES[mesh_label]
    for r in port[mesh_label]:
        got_q, got_ef = r["int8"]
        at = {"coords": divmod(r["rank"], shape[1])}
        for got, want in ((got_q, q), (got_ef, state["ef"])):
            for g, w in zip(leaves(got), _blocks(want, at, shape,
                                                 MODELS[1])):
                assert torch.equal(g, w)


def test_the_batch_counts_once_where_the_data_axis_does_not_divide_it(
        port, reference):
    """B 1 on 2 x 1: both data ranks hold the row, each loss is half the
    row's, and they sum to the reference's; the gradients (held above)
    are not doubled."""
    ref = reference()
    for name in MODELS:
        _, recs = _records(port, "2x1-B1", name)
        assert {tuple(r["rows"]) for r in recs} == {(0, 1)}
        whole = float(ref[f"{name}/2x1-B1/loss"])
        for r in recs:
            _close(r["grad_loss"], whole, **LOSS_TOL)


def test_placements_name_the_axes_each_leaf_is_split_and_replicated_over():
    """From ``param_pspecs()``: on 2 x 2, ``wq`` is split over both axes,
    the norms are replicated over both, the router over ``model`` alone,
    the experts split over both; with no mesh, no axis."""
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    mesh = LocalMesh(("data", "model"), (2, 2), rank=0, coords=(0, 0))
    model = build_model(cfg, device="meta")
    pl = placements(param_shardings(mesh, model.param_defs()), mesh)
    attn, moe = pl["layers"][0]["attn"], pl["layers"][0]["moe"]
    assert attn["wq"].split == ("data", "model") and not attn["wq"].replicated
    assert attn["ln"].replicated == ("data", "model")
    assert moe["router"].split == ("data",)
    assert moe["router"].replicated == ("model",)
    assert moe["w_gate"].split == ("data", "model")
    one = LocalMesh(("data", "model"), (1, 2), rank=0, coords=(0, 0))
    assert placements(param_shardings(one, model.param_defs()),
                      one)["embed"].split == ("model",)
    assert placements((("data", None)), None).split == ()


@pytest.fixture(scope="module")
def train_run():
    """Reduced qwen3-8b trained on 2 x 1 gloo CPU ranks through
    ``spmd.run`` (the weights and the warm AdamW state from the seed), and
    the same job trained again in this process for planting faults in."""
    cfg = get_config("qwen3-8b").reduced()
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, S)).astype(np.int32))
    job = spmd.TrainJob(cfg, toks, 2, opt=OptConfig(lr=spmd.TRAIN_LR,
                                                    warmup_steps=1))
    _, (out,) = spmd.run([job], (2, 1), device="cpu", threads=1)
    return job, out, spmd.train(None, torch.device("cpu"), job)


def _plant(records, fault, cfg):
    """A copy of the ranks' records with ``fault`` planted."""
    import copy
    specs = spmd._spec_leaves(param_shardings(
        LocalMesh(("data", "model"), (2, 1)), build_model(
            cfg, device="meta").param_defs()))
    records = copy.deepcopy(records)
    at = lambda pred: next(i for i, s in enumerate(specs) if pred(tuple(s)))
    if fault == "replicated_grad_times_dp":     # summed twice over data
        i = at(lambda s: not any(s))
        for r in records:
            leaves(r["grads"])[i].mul_(2)
    elif fault == "zero3_grad_block_times_dp":  # one rank's block only
        i = at(lambda s: "data" in s)
        leaves(records[0]["grads"])[i].mul_(2)
    elif fault == "blocks_swapped":             # put back in each other's place
        records[0]["coords"], records[1]["coords"] = (records[1]["coords"],
                                                      records[0]["coords"])
    return records


@pytest.mark.parametrize("fault", ["none", "replicated_grad_times_dp",
                                   "zero3_grad_block_times_dp",
                                   "blocks_swapped"])
def test_check_train_passes_the_mesh_run_and_fails_a_planted_fault(
        fault, train_run):
    """``spmd.run`` of a train job on 2 x 1 checks ``ok``; ``check_train``
    on the same records with a gradient doubled (a replicated leaf's on
    every rank, as a second sum over ``data`` would; one ZeRO-3 block's)
    or the ranks' blocks swapped is not."""
    job, out, single = train_run
    assert out["check"]["ok"], out["check"]
    assert [r["rows"] for r in out["records"]] == [(0, 2), (2, 4)]
    res = spmd.check_train(_plant(out["records"], fault, job.cfg), single,
                           job, (2, 1))
    limits = spmd.TRAIN_LIMITS[job.cfg.dtype]
    if fault == "none":
        assert res["ok"], res
        assert res["grads_leaf_scaled_err"] <= limits["grads"]
        assert res["params_leaf_scaled_err"] <= limits["params"]
        return
    assert not res["ok"]
    if fault == "blocks_swapped":
        assert res["params_leaf_scaled_err"] > 0.5
    else:
        assert res["grads_leaf_scaled_err"] > 0.5
