"""The port's model across a ``(data, model)`` mesh of gloo CPU ranks
against the reference's sharded run.

The reference side runs once, in a subprocess with four forced host
devices: reduced qwen3-8b and moonshot-v1-16b-a3b on JAX meshes (2, 2),
(1, 2) and (2, 1) built with ``AxisType.Auto`` axes (under this JAX
``jax.make_mesh`` defaults to Explicit axes, with which the reference's
own ``make_local_mesh`` cannot run the model sharded), their parameters
placed by ``param_pspecs()``: prefill logits and K/V, two decode steps'
logits and caches, layer 0's MoE output, and the three collectives on
rank-tagged blocks. The port side spawns one gloo rank per device with a
file store (no TCP port), the weights through ``params_from_jax``, each
rank keeping its blocks; one spawn per mesh runs all of its cases.

Cases: prefill at B 4, S 16, and B 1, which the data axis does not split
(the batch replicated); decode steps (S == 1, dropless). Tolerances are
``test_torch_moe.py``'s: 1e-5 for layers and planes, 1e-4 for logits.
Moonshot's sharded logits differ from its single-device ones, because
capacity is per shard, and the port holds to the sharded ones.
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

from _torch_mesh_rank import run_cases
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.distributed import collectives as C
from repro_torch.launch import spmd
from repro_torch.launch.mesh import LocalMesh, make_local_mesh
from repro_torch.models import build_model
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_step import build_cell
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
BATCHES = (4, 1)
S, SMAX, STEPS = 16, 32, 2
TOL = dict(rtol=0, atol=1e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
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
from repro.models import moe as jmoe

S, SMAX, STEPS = %d, %d, %d
MESHES = {"2x2": (2, 2), "1x2": (1, 2), "2x1": (2, 1)}
res = {}


def make_mesh(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def run(name, cfg, label, mesh, params, toks, feed, x_moe, whole=True):
    m = build_model(cfg, mesh=mesh)
    p = params if mesh is None else jax.tree.map(
        lambda s, a: jax.device_put(a, NamedSharding(mesh, s)),
        m.param_pspecs(), params, is_leaf=lambda s: isinstance(s, P))
    prefill, decode = jax.jit(m.prefill), jax.jit(m.decode_step)
    for B in toks:
        key = f"{name}/{label}/{B}"
        logits, caches = prefill(p, jnp.asarray(toks[B]))
        res[f"{key}/prefill"] = logits
        res[f"{key}/k"] = caches["slot0"]["k"]
        res[f"{key}/v"] = caches["slot0"]["v"]
        if not whole:
            continue
        structs, _ = m.cache_specs(B, SMAX)
        cache = {sl: {kk: jnp.zeros(st.shape, st.dtype).at[:, :, :S].set(
                     caches[sl][kk]) for kk, st in sub.items()}
                 for sl, sub in structs.items()}
        for i in range(STEPS):
            pos = jnp.full((B,), S + i, jnp.int32)
            logits, cache = decode(p, cache, jnp.asarray(feed[B][:, i:i + 1]),
                                   pos)
            res[f"{key}/decode{i}"] = logits
        res[f"{key}/cache_k"] = cache["slot0"]["k"]
        res[f"{key}/cache_v"] = cache["slot0"]["v"]
    if cfg.moe is not None and whole:
        pm = jax.tree.map(lambda a: a[0], p["groups"]["slot0"]["moe"])
        res[f"{name}/{label}/moe_y"] = jax.jit(
            lambda pm, x: jmoe.moe_apply(pm, x, cfg, m.ctx))(
                pm, jnp.asarray(x_moe))


inputs = np.load(sys.argv[1])
for name in ("qwen3-8b", "moonshot-v1-16b-a3b"):
    cfg = get_config(name).reduced()
    structure = jax.tree.structure(build_model(cfg).abstract_params())
    params = jax.tree.unflatten(structure, [
        jnp.asarray(inputs[f"{name}/params/{i}"])
        for i in range(structure.num_leaves)])
    toks = {B: inputs[f"{name}/tokens{B}"] for B in (4, 1)}
    feed = {B: inputs[f"{name}/feed{B}"] for B in (4, 1)}
    x_moe = inputs[f"{name}/moe_x"]
    for label, shape in MESHES.items():
        run(name, cfg, label, make_mesh(shape), params, toks, feed, x_moe)
    if cfg.moe is not None:   # the pin: sharded logits differ from these
        run(name, cfg, "single", None, params, {4: toks[4]}, feed, x_moe,
            whole=False)

# the collectives on rank-tagged blocks: rank r = d * model + m holds
# arange(24).reshape(4, 2, 3) + 100 r
for label, shape in MESHES.items():
    n = shape[0] * shape[1]
    x = (np.arange(24, dtype=np.float32).reshape(1, 4, 2, 3)
         + 100 * np.arange(n, dtype=np.float32).reshape(n, 1, 1, 1))
    spec = P(("data", "model"))
    for kind, body in {
            "all_to_all": lambda b: lax.all_to_all(b[0], "model", 0, 1,
                                                   tiled=True)[None],
            "all_gather": lambda b: lax.all_gather(b[0], "model", axis=1,
                                                   tiled=True)[None],
            "all_reduce": lambda b: lax.psum(b, "model")}.items():
        res[f"probe/{label}/{kind}"] = jax.jit(jax.shard_map(
            body, mesh=make_mesh(shape), in_specs=spec,
            out_specs=spec))(jnp.asarray(x))
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in res.items()})
""" % (S, SMAX, STEPS)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The cases' inputs and the weights (the reference's ``init`` at key
    0; in the port's layout, saved for the ranks to load); the reference's
    run started on the same in a subprocess of its own (its forced host
    devices must be set before JAX starts)."""
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(1)
    inputs, params = {}, {}
    for name in MODELS:
        jcfg = jax_config(name).reduced()
        for B in BATCHES:
            inputs[f"{name}/tokens{B}"] = rng.integers(
                0, jcfg.vocab, (B, S)).astype(np.int32)
            inputs[f"{name}/feed{B}"] = rng.integers(
                0, jcfg.vocab, (B, STEPS)).astype(np.int32)
        inputs[f"{name}/moe_x"] = rng.standard_normal(
            (4, S, jcfg.d_model)).astype(np.float32)
        tree = jax.tree.map(np.asarray,
                            jax_build(jcfg).init(jax.random.PRNGKey(0)))
        for i, a in enumerate(jax.tree.leaves(tree)):
            inputs[f"{name}/params/{i}"] = a
        params[name] = str(d / f"{name}.pt")
        torch.save(params_from_jax(tree, get_config(name).reduced(), "cpu"),
                   params[name])
    np.savez(d / "inputs.npz", **inputs)
    # XLA's cheaper compile: most of the reference's run is compiling
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "inputs.npz"),
         str(d / "ref.npz")], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    yield dict(inputs=inputs, params=params, proc=proc,
               out=d / "ref.npz")
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


@pytest.fixture(scope="module")
def port(setup, reference):
    """Every case of every mesh, one spawn of ranks per mesh, once the
    reference's subprocess has ended: the file then keeps at most four
    busy processes (the 2 x 2 mesh's ranks), beside the other test
    workers."""
    reference()
    runs = {}
    for label, shape in MESHES.items():
        cases = {}
        for name in MODELS:
            cfg = get_config(name).reduced()
            arr = lambda k: torch.from_numpy(setup["inputs"][f"{name}/{k}"])
            jobs = {B: spmd.Job(cfg, arr(f"tokens{B}"), STEPS,
                                feed=arr(f"feed{B}"),
                                params=setup["params"][name])
                    for B in BATCHES}
            cases[name] = {"jobs": jobs, "params": setup["params"][name],
                           "moe_x": (arr("moe_x") if cfg.moe is not None
                                     else None)}
        _, runs[label] = spmd.launch(run_cases, shape, (cases,),
                                     device="cpu", threads=1)
    return runs


@pytest.fixture
def ranks(port, request):
    return request.param, port[request.param]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _block(ref_t, rec, tp):
    """The reference's whole [L, B, S, Hkv, hd] cut to a rank's rows and
    KV heads."""
    (lo, hi), m = rec["rows"], rec["coords"][1]
    h = ref_t.shape[3] // tp
    return ref_t[:, lo:hi, :, m * h:(m + 1) * h]


MESH_IDS = list(MESHES)


@pytest.mark.parametrize("ranks", MESH_IDS, indirect=True)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("name", MODELS)
def test_prefill_matches_the_reference_sharded_run(ranks, name, B,
                                                   reference):
    """Logits [B, Vp] whole on every rank, the K/V blocks of the rank's
    rows and KV heads; the ranks of one data index agree bitwise."""
    ref = reference()
    label, recs = ranks
    tp = MESHES[label][1]
    jobs = [r[name]["jobs"][B] for r in recs]
    key = f"{name}/{label}/{B}"
    _close(spmd.gather_rows(jobs)[0], ref[f"{key}/prefill"], **LOGIT_TOL)
    for rec in jobs:
        assert rec["foreign"] == []
        assert not any(rec["counts"]["launches"].values())
        _close(rec["k"], _block(ref[f"{key}/k"], rec, tp))
        _close(rec["v"], _block(ref[f"{key}/v"], rec, tp))
        twin = next(q for q in jobs if q["coords"][0] == rec["coords"][0])
        assert torch.equal(rec["logits"], twin["logits"])
    if B == 1:        # the data axis does not split one row
        assert {r["rows"] for r in jobs} == {(0, 1)}


@pytest.mark.parametrize("ranks", MESH_IDS, indirect=True)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("name", MODELS)
def test_decode_steps_match_the_reference_sharded_run(ranks, name, B,
                                                      reference):
    """Two decode steps (S == 1: dropless) from the prefilled dense cache:
    each step's logits, and each rank's cache block after them."""
    ref = reference()
    label, recs = ranks
    tp = MESHES[label][1]
    jobs = [r[name]["jobs"][B] for r in recs]
    key = f"{name}/{label}/{B}"
    logits = spmd.gather_rows(jobs)
    for i in range(STEPS):
        _close(logits[1 + i], ref[f"{key}/decode{i}"], **LOGIT_TOL)
    for rec in jobs:
        _close(rec["cache_k"], _block(ref[f"{key}/cache_k"], rec, tp))
        _close(rec["cache_v"], _block(ref[f"{key}/cache_v"], rec, tp))


@pytest.mark.parametrize("ranks", MESH_IDS, indirect=True)
def test_moe_layer_matches_the_reference_sharded_moe(ranks, reference):
    """Layer 0's MoE FFN (``_moe_sharded``: local routing and capacity,
    two all-to-alls, ZeRO-3 expert gathers) on [4, 16, D], by rank rows."""
    ref = reference()
    label, recs = ranks
    name = "moonshot-v1-16b-a3b"
    want = ref[f"{name}/{label}/moe_y"]
    for r in recs:
        (lo, hi), y = r[name]["moe"]
        _close(y, want[lo:hi])


@pytest.mark.parametrize("ranks", MESH_IDS, indirect=True)
def test_collectives_lay_out_blocks_as_the_reference(ranks, reference):
    """``all_to_all`` (tiled, split 0, concat 1), ``all_gather`` (tiled,
    dim 1) and ``all_reduce_sum`` over ``model`` on rank-tagged blocks,
    rank by rank against ``lax``'s in a ``shard_map`` on the same mesh (a
    one-rank line returns its input)."""
    ref = reference()
    label, recs = ranks
    for r in recs:
        for kind, got in r["probe"].items():
            _close(got, ref[f"probe/{label}/{kind}"][r["rank"]], rtol=0,
                   atol=0)


def test_moonshot_sharded_logits_differ_from_one_device(reference):
    """The pin: capacity per shard drops other pairs than capacity over
    the whole batch, so the reference's sharded prefill is not its
    single-device one, and the port follows the sharded one (above)."""
    ref = reference()
    name = "moonshot-v1-16b-a3b"
    gap = np.abs(ref[f"{name}/2x2/4/prefill"]
                 - ref[f"{name}/single/4/prefill"]).max()
    assert gap > 1e-2


@pytest.mark.parametrize("name", MODELS)
def test_a_one_by_one_mesh_is_bitwise_the_single_device_model(name, setup):
    """``make_local_mesh(1, 1)`` needs no process group: the model, its
    prefill, decode steps and caches are the one-card model's bit for bit,
    and no collective is called."""
    cfg = get_config(name).reduced()
    inputs = setup["inputs"]
    job = spmd.Job(cfg, torch.from_numpy(inputs[f"{name}/tokens4"]), STEPS,
                   feed=torch.from_numpy(inputs[f"{name}/feed4"]),
                   params=setup["params"][name])
    cpu = torch.device("cpu")
    mesh = make_local_mesh(1, 1)
    one = spmd.serve(mesh, cpu, job)
    assert one["collectives"] == {}
    bare = spmd.serve(None, cpu, job)
    for k in ("logits", "k", "v", "cache_k", "cache_v"):
        assert torch.equal(one[k], bare[k]), k
    assert one["moe_dropped"] == bare["moe_dropped"]


@pytest.mark.parametrize("multi", [False, True])
def test_tp_axis_and_batch_axes_equal_the_reference(multi):
    """On the production meshes (data) and on a live 2 x 2 mesh, against
    the reference's context on the same axes; none without a mesh."""
    from jax.sharding import AbstractMesh
    from repro.distributed.sharding import ShardingCtx as JaxCtx
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch.mesh import make_production_mesh
    m = make_production_mesh(multi_pod=multi)
    live = LocalMesh(("data", "model"), (2, 2), rank=3, coords=(1, 1))
    for mesh in (m, live):
        ctx = ShardingCtx(mesh)
        ref = JaxCtx(AbstractMesh(mesh.axis_sizes, mesh.axis_names))
        assert (ctx.tp_axis, ctx.batch_axes) == (ref.tp_axis,
                                                 ref.batch_axes)
    assert ShardingCtx(live).live and not ShardingCtx(m).live
    assert (ShardingCtx().tp_axis, ShardingCtx().batch_axes) == (None, ())
    assert ShardingCtx(live).index("tp") == ShardingCtx(live).index(
        "batch") == 1


def test_a_mesh_that_does_not_divide_a_leaf_raises():
    """Reduced qwen3-8b has 2 KV heads: 4 ranks on ``model`` cannot split
    them (though ``wk``'s 64 columns split), where the reference's
    partitioner would pad; nor 3 ranks on ``data`` its width of 128,
    named by the first leaf it splits."""
    mesh = LocalMesh(("data", "model"), (1, 4), rank=1, coords=(0, 1))
    with pytest.raises(ValueError, match="attn/wk: 2 KV heads"):
        build_model(get_config("qwen3-8b").reduced(), device="cpu",
                    mesh=mesh)
    with pytest.raises(ValueError, match=r"/embed: dim 1 of \(512, 128\)"):
        build_model(get_config("qwen3-8b").reduced(), device="cpu",
                    mesh=LocalMesh(("data", "model"), (3, 1), rank=0,
                                   coords=(0, 0)))
    # the blocks of a dividing leaf are the rank's
    from repro_torch.distributed.sharding import ShardingCtx
    t = torch.arange(8.0).reshape(4, 2)
    assert torch.equal(ShardingCtx(mesh).local_block(t, ("model", None)),
                       t[1:2])


@pytest.mark.parametrize("name", ["mamba2-2.7b", "whisper-medium",
                                  "jamba-v0.1-52b"])
def test_other_families_across_a_mesh_name_the_next_slice(name):
    mesh = LocalMesh(("data", "model"), (1, 2), rank=0, coords=(0, 0))
    with pytest.raises(NotImplementedError, match="next mesh slice"):
        build_model(get_config(name).reduced(), device="cpu", mesh=mesh)


@pytest.mark.parametrize("name", MODELS)
def test_a_train_cell_on_a_one_by_one_mesh_steps_as_one_process(name,
                                                               setup):
    """``make_local_mesh(1, 1)`` needs no process group: a train cell
    built on it takes the one-process step bit for bit (loss, grad norm,
    every parameter and moment), and calls no collective; on a live
    2 x 1 mesh a prefill cell holds the rank's rows (rank 1: rows 2-3 of
    4) without any collective, and the paged methods stay one card's."""
    from repro_torch.distributed import collectives as C
    cfg = get_config(name).reduced()
    shape = dict(kind="train", seq_len=8, global_batch=4)
    out = []
    for mesh in (make_local_mesh(1, 1), None):
        C.reset_stats()
        model = build_model(cfg, torch.load(setup["params"][name]),
                            device="cpu", trainable=True, mesh=mesh)
        step, args = build_cell(model, shape,
                                OptConfig(lr=1e-2, warmup_steps=1),
                                generator=torch.Generator().manual_seed(0))
        for _ in range(2):
            _, state, metrics = step(*args)
        out.append((metrics, model.param_tree(), state, C.stats()))
    (m1, p1, s1, c1), (m0, p0, s0, _) = out
    assert c1 == {}
    for k in ("loss", "grad_norm"):
        assert torch.equal(m1[k], m0[k]), k
    for a, b in zip(leaves(p1) + leaves(s1), leaves(p0) + leaves(s0)):
        assert torch.equal(a, b)
    mesh = LocalMesh(("data", "model"), (2, 1), rank=1, coords=(1, 0))
    live = build_model(cfg, device="cpu", mesh=mesh)
    gen = torch.Generator().manual_seed(0)
    full = build_cell(build_model(cfg, device="cpu"),
                      dict(kind="prefill", seq_len=8, global_batch=4),
                      generator=gen)[1][1]
    gen.manual_seed(0)
    mine = build_cell(live, dict(kind="prefill", seq_len=8, global_batch=4),
                      generator=gen)[1][1]
    assert torch.equal(mine["tokens"], full["tokens"][2:4])
    with pytest.raises(NotImplementedError, match="one card"):
        live.decode_step_paged(*[None] * 9)


def test_the_entry_point_needs_a_card_unless_told_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        spmd.main(["--arch", "qwen3-8b", "--reduced", "--mesh", "1x2"])
    assert spmd.backend_for(2, "cpu") == "gloo"
