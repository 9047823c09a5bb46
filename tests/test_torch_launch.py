"""The port's launch tooling against the JAX package's, on the CPU, and the
counter's own tests.

Parity (the same configs through both packages): the shape suite and its
cells, the batch of every cell; for every config at full width, without
allocating anything, each parameter leaf's shape, dtype and partition spec
under both production meshes (a port leaf is one layer of the reference's
stacked leaf), the parameter count and bytes, and each leaf's per-device
shape where ``jax.sharding.AbstractMesh`` gives the reference's; the decode
cache's shapes and specs at ``decode_32k``; the optimizer state for each
compression; ``model_flops``, ``_traffic`` and ``roofline_terms`` given
the reference's hardware constants; the report's rows.

The counter (:mod:`repro_torch.launch.counter`), at reduced size: its
flops equal a count written out from the projections, FFN, LM head and the
kernels' cost functions, its argument bytes the bytes of the same tensors
made on the CPU and, for one compiled reference cell, XLA's
``memory_analysis()``; the reference's 1/2-group extrapolation, made here
from two counts of cut-down configs, equals the direct count; a step on
``meta`` runs no plain version; and the dry-run CLI writes every cell of
both production meshes, skipping ``long_500k`` where the reference does.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import base as jax_base
from repro.configs import get_config as jax_config
from repro.distributed import sharding as jax_sharding
from repro.launch import report as jax_report
from repro.launch import roofline as jax_roofline
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models import build_model as jax_build
from repro.models import common as jax_common
from repro.training import optimizer as jax_opt
from repro.training.train_step import lower_cell as jax_lower_cell
from repro_torch.configs import base
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import mesh_rules, shard_shape
from repro_torch.kernels import ops
from repro_torch.launch import counter, dryrun, report, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.common import (_spec_leaves, param_specs,
                                       pspec_tree, tree_bytes, tree_params)
from repro_torch.training import abstract_opt_state, build_cell, opt_pspecs


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NAMES = jax_base.list_configs()
MESHES = {"single": False, "multi": True}


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).rsplit(".", 1)[-1]
    return np.dtype(dt).name


def _abstract_mesh(multi: bool) -> AbstractMesh:
    m = make_production_mesh(multi_pod=multi)
    return AbstractMesh(m.axis_sizes, m.axis_names)


def _pairs(port, ref, period):
    """(path, port leaf, reference leaf, stacked) for every leaf of a port
    tree and the reference's tree of the same parameters: layer i of the
    port is group i // period of the reference's slot i % period; encoder
    layer i is entry i of its stacked encoder leaf."""
    out = [(k, port[k], ref[k], False)
           for k in ("embed", "final_ln", "lm_head") if k in port]
    for i, layer in enumerate(port["layers"]):
        slot = ref["groups"][f"slot{i % period}"]
        out += [(f"layers/{i}/{part}/{name}", leaf, slot[part][name], True)
                for part, leaves in layer.items()
                for name, leaf in leaves.items()]
    if "encoder" in port:
        enc = ref["encoder"]
        out.append(("encoder/ln", port["encoder"]["ln"], enc["ln"], False))
        for i, layer in enumerate(port["encoder"]["layers"]):
            out += [(f"encoder/layers/{i}/{part}/{name}", leaf,
                     enc["layers"][part][name], True)
                    for part, leaves in layer.items()
                    for name, leaf in leaves.items()]
    return out


# ------------------------------------------------------------ configs, cells
def test_shape_suite_cells_and_input_specs_equal_the_reference():
    assert base.SHAPES == jax_base.SHAPES
    assert base.list_configs() == jax_base.list_configs()
    assert base.all_cells() == jax_base.all_cells()
    assert len(base.all_cells()) == 40
    for name in NAMES:
        cfg, jcfg = get_config(name), jax_config(name)
        assert cfg.supports_long_context == jcfg.supports_long_context
        assert cfg.has_decoder == jcfg.has_decoder
        assert cfg.applicable_shapes() == jcfg.applicable_shapes()
        assert cfg.skipped_shapes() == jcfg.skipped_shapes()
    for name, shape in base.all_cells():
        got = base.input_specs(get_config(name), shape)
        want = jax_base.input_specs(jax_config(name), shape)
        assert list(got) == list(want), (name, shape)
        for k, s in got.items():
            assert s.shape == want[k].shape, (name, shape, k)
            assert _dtype_name(s.dtype) == _dtype_name(want[k].dtype)
        # a shape dict with the same keys gives the same specs
        assert base.input_specs(get_config(name),
                                dict(base.SHAPES[shape])) == got


@pytest.mark.parametrize("name", NAMES)
def test_parameter_leaves_pspecs_and_shard_shapes_equal_the_reference(name):
    cfg, jcfg = get_config(name), jax_config(name)
    specs = param_specs(cfg)
    defs = jax_build(jcfg).param_defs()
    pairs = _pairs(specs, defs, cfg.layer_pattern_period)
    assert len(pairs) == len(_spec_leaves(specs))
    for path, s, leaf, stacked in pairs:
        ref_shape = leaf.shape[1:] if stacked else leaf.shape
        ref_axes = leaf.axes[1:] if stacked else leaf.axes
        assert s.shape == ref_shape and s.axes == ref_axes, path
        assert _dtype_name(s.dtype) == _dtype_name(leaf.dtype), path
        if stacked:
            assert leaf.axes[0] == "stack"
    assert tree_params(specs) == jax_common.tree_params(defs)
    assert tree_bytes(specs) == jax_common.tree_bytes(defs)
    pad = jax_common.pad_vocab(cfg.vocab, 256) - cfg.vocab
    assert tree_params(specs) == cfg.param_count() + pad * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    assert cfg.param_count() == jcfg.param_count()
    for mesh_name, multi in MESHES.items():
        mesh = make_production_mesh(multi_pod=multi)
        am = _abstract_mesh(multi)
        got = pspec_tree(specs, mesh_rules(mesh))
        want = jax_common.pspec_tree(defs, jax_sharding.mesh_rules(am))
        gpairs = _pairs(got, want, cfg.layer_pattern_period)
        assert len(gpairs) == len(pairs)
        n_checked = 0
        for (path, spec, ref_spec, stacked), (_, s, leaf, _) in zip(gpairs,
                                                                    pairs):
            ref = tuple(ref_spec)
            assert spec == (ref[1:] if stacked else ref), (mesh_name, path)
            try:
                ref_shard = NamedSharding(am, ref_spec).shard_shape(
                    leaf.shape)
            except ValueError:   # a dim the mesh does not divide
                continue
            mine = shard_shape(mesh, s.shape, spec)
            assert ref_shard == ((leaf.shape[0],) + mine if stacked
                                 else mine), (mesh_name, path)
            n_checked += 1
        assert n_checked > len(pairs) // 2, (mesh_name, n_checked)


@pytest.mark.parametrize("multi", [False, True])
def test_sharding_ctx_equals_the_reference(multi):
    """``spec`` (with and without the dividing rule), ``axis_size`` and
    ``enabled`` on a production mesh, and the context without a mesh."""
    from repro_torch.distributed.sharding import ShardingCtx
    ctx = ShardingCtx(make_production_mesh(multi_pod=multi))
    ref = jax_sharding.ShardingCtx(_abstract_mesh(multi))
    assert mesh_rules(ctx.mesh) == jax_sharding.mesh_rules(ref.mesh)
    assert ctx.enabled == ref.enabled is True
    for axes in [("batch", "kv_sp", None, None), ("fsdp", "tp"),
                 ("exp", "fsdp", None), ("batch", "sp", None), (None,)]:
        for a in axes:
            assert ctx.axis_size(a) == ref.axis_size(a), a
        assert ctx.spec(*axes) == tuple(ref.spec(*axes)), axes
        for dims in [(1, 524288, 8, 128), (128, 32768, 8, 128),
                     (30, 48, 64, 4), (256, 1, 7, 2)]:
            d = dims[:len(axes)]
            assert ctx.spec(*axes, dims=d) == tuple(ref.spec(*axes, dims=d))
    none, ref_none = ShardingCtx(), jax_sharding.ShardingCtx()
    assert none.enabled == ref_none.enabled is False
    assert none.spec("batch", "tp") == tuple(ref_none.spec("batch", "tp"))


def _slot_layout(cfg, flat, fspecs):
    """The port's per-layer cache (``Model.cache_specs``: each entry stacks
    its layers on a leading dim) regrouped as the reference's
    ``cache_specs`` stacks it: per period slot ``i``, ``"slot{i}"`` (``k``
    and ``v`` of an attention slot, ``state`` and ``conv`` of an SSM slot)
    and ``"slot{i}_cross"`` (``k`` and ``v``), each entry (shape, dtype,
    spec) with a leading dim of the number of groups."""
    period = cfg.layer_pattern_period
    g = cfg.n_layers // period
    out = {}

    def put(name, keys):
        out[name] = {k: ((g,) + tuple(flat[src].shape[1:]), flat[src].dtype,
                         fspecs[src]) for k, src in keys.items()}

    for i in range(period):
        put(f"slot{i}", {"k": "k", "v": "v"} if cfg.is_attn_layer(i)
            else {"state": "state", "conv": "conv"})
        if cfg.is_cross_layer(i) or cfg.family == "encdec":
            put(f"slot{i}_cross", {"k": "cross_k", "v": "cross_v"})
    return out


@pytest.mark.parametrize("name", NAMES)
def test_decode_cache_specs_equal_the_reference(name):
    """At decode_32k on the single-pod mesh: the port's per-layer cache,
    regrouped by the reference's slots, has the reference's per-slot
    stacked shapes, dtypes and specs, and holds the same bytes."""
    sh = base.SHAPES["decode_32k"]
    B, S = sh["global_batch"], sh["seq_len"]
    mesh = make_production_mesh()
    cfg = get_config(name)
    model = build_model(cfg, device="meta", mesh=mesh)
    jmodel = jax_build(jax_config(name), mesh=_abstract_mesh(False))
    flat, fspecs = model.cache_specs(B, S)
    slots = _slot_layout(cfg, flat, fspecs)
    jstructs, jspecs = jmodel.cache_specs(B, S)
    assert list(slots) == list(jstructs)
    total = 0
    for slot, entries in slots.items():
        assert list(entries) == list(jstructs[slot])
        for k, (shape, dtype, spec) in entries.items():
            want = jstructs[slot][k]
            assert shape == want.shape, (slot, k)
            assert _dtype_name(dtype) == _dtype_name(want.dtype)
            assert spec == tuple(jspecs[slot][k]), (slot, k)
            total += math.prod(shape) * np.dtype(want.dtype).itemsize
    assert sum(s.nbytes for s in flat.values()) == total


@pytest.mark.parametrize("compression", ["none", "bf16", "int8"])
@pytest.mark.parametrize("name", ["qwen3-8b", "jamba-v0.1-52b"])
def test_optimizer_state_and_pspecs_equal_the_reference(name, compression):
    cfg = get_config(name)
    mesh = make_production_mesh(multi_pod=True)
    model = build_model(cfg, device="meta", mesh=mesh)
    jmodel = jax_build(jax_config(name), mesh=_abstract_mesh(True))
    state = abstract_opt_state(model.abstract_params(), compression)
    jstate = jax_opt.abstract_opt_state(jmodel.abstract_params(), compression)
    pspecs = opt_pspecs(model.param_pspecs(), compression)
    jpspecs = jax_opt.opt_pspecs(jmodel.param_pspecs(), compression)
    assert set(state) == set(jstate) == set(pspecs) == set(jpspecs)
    assert state["step"].shape == jstate["step"].shape == ()
    assert _dtype_name(state["step"].dtype) == "int32"
    assert pspecs["step"] == tuple(jpspecs["step"]) == ()
    period = cfg.layer_pattern_period
    for k in set(state) - {"step"}:
        for path, t, ref, stacked in _pairs(state[k], jstate[k], period):
            assert t.device.type == "meta"
            assert tuple(t.shape) == (ref.shape[1:] if stacked
                                      else ref.shape), (k, path)
            assert _dtype_name(t.dtype) == _dtype_name(ref.dtype) == \
                "float32"
        for path, s, ref, stacked in _pairs(pspecs[k], jpspecs[k], period):
            assert s == (tuple(ref)[1:] if stacked else tuple(ref)), path


# ------------------------------------------------------------ roofline
REF_HW = roofline.Hardware("reference", jax_roofline.PEAK_FLOPS,
                           jax_roofline.HBM_BW, jax_roofline.HBM_CAP,
                           jax_roofline.ICI_BW)
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "ragged-all-to-all", "send")


def test_model_flops_traffic_and_roofline_terms_equal_the_reference():
    for name, shape in base.all_cells():
        assert roofline.model_flops(get_config(name), base.SHAPES[shape]) \
            == jax_roofline.model_flops(jax_config(name),
                                        jax_base.SHAPES[shape])
    for kind in KINDS:
        for n in (1, 2, 16, 256):
            assert roofline._traffic(kind, 12345, n) == \
                jax_roofline._traffic(kind, 12345, n), (kind, n)
    rng = np.random.default_rng(0)
    for name, shape in [("qwen3-8b", "train_4k"), ("mamba2-2.7b",
                                                   "decode_32k"),
                        ("moonshot-v1-16b-a3b", "prefill_32k")]:
        for _ in range(4):
            cost = {"flops": float(rng.uniform(1e12, 1e15)),
                    "bytes accessed": float(rng.uniform(1e9, 1e12)),
                    "ideal_bytes": float(rng.uniform(1e9, 1e11))}
            coll = {k: {"traffic": float(rng.uniform(0, 1e10))}
                    for k in KINDS[:int(rng.integers(0, 4))]}
            got = roofline.roofline_terms(cost, coll, 256, get_config(name),
                                          base.SHAPES[shape], hw=REF_HW)
            want = jax_roofline.roofline_terms(cost, coll, 256,
                                               jax_config(name),
                                               jax_base.SHAPES[shape])
            assert got == want
    # an unknown collective term: left out of the bound, which stays the
    # larger of the other two
    t = roofline.roofline_terms({"flops": 1e12, "ideal_bytes": 1e9}, None, 1)
    assert t["collective_s"] is None
    assert t["step_s_lower_bound"] == max(t["compute_s"], t["memory_s"])


def test_report_renders_the_reference_rows(tmp_path, monkeypatch):
    recs = [{"arch": "a", "shape": "s1", "status": "skipped",
             "skip_reason": "x"},
            {"arch": "b", "shape": "s2", "status": "error"},
            {"arch": "c", "shape": "s3", "status": "ok",
             "memory": {"peak_bytes_per_device": 12.5e9,
                        "fits_v5e_16g": True, "fits_h100_80g": True},
             "roofline": {"bottleneck": "compute", "compute_s": 0.0123,
                          "memory_s": 0.0045, "collective_s": 0.0006,
                          "useful_flop_ratio": 0.81,
                          "roofline_fraction": 0.4567}},
            {"arch": "d", "shape": "s4", "status": "ok",
             "memory": {"peak_bytes_per_device": 99e9,
                        "fits_v5e_16g": False, "fits_h100_80g": False},
             "roofline": {"bottleneck": "memory", "compute_s": 0.1,
                          "memory_s": 0.2, "collective_s": 0.0}}]
    for d, mod in (("ref", jax_report), ("port", dryrun)):
        for r in recs:
            (tmp_path / d / "single").mkdir(parents=True, exist_ok=True)
            (tmp_path / d / "single" / f"{r['arch']}__{r['shape']}.json") \
                .write_text(json.dumps(r))
        monkeypatch.setattr(mod, "RESULTS", tmp_path / d)
    got = report.table("single").splitlines()
    want = jax_report.table("single").splitlines()
    assert got[0] == want[0].replace("fits v5e", "fits H100 80 GB")
    assert got[1:] == want[1:]
    assert len(got) == 2 + len(recs)


# ------------------------------------------------------------ the counter
def _small(name, n_layers=None):
    cfg = get_config(name).reduced()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg


def _dense_flops(cfg, T, n_logits, kernel_flops):
    """Projections, SwiGLU FFN and LM head of a dense stack over T rows,
    logits for ``n_logits`` rows, plus the kernels' flops."""
    D, H, Hkv, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim_, cfg.d_ff)
    Vp = jax_common.pad_vocab(cfg.vocab, 256)
    per_layer = 2 * T * (D * H * hd + 2 * D * Hkv * hd + H * hd * D
                         + 3 * D * F)
    return cfg.n_layers * per_layer + 2 * n_logits * D * Vp + kernel_flops


def test_counted_flops_and_argument_bytes_at_a_reduced_dense_config():
    cfg = _small("qwen3-8b")
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    B, S = 2, 48
    pre = dryrun.count_cell(cfg, dict(kind="prefill", seq_len=S,
                                      global_batch=B))
    _, fl = roofline.flash_cost(S, S, H, Hkv, hd, True, 4)
    assert pre["cost"]["flops"] == _dense_flops(cfg, B * S, B,
                                                cfg.n_layers * B * fl)
    assert pre["kernels"] == {"flash_attention": {
        "calls": cfg.n_layers, "bytes": cfg.n_layers * B * roofline
        .flash_cost(S, S, H, Hkv, hd, True, 4)[0],
        "flops": cfg.n_layers * B * fl}}
    dec = dryrun.count_cell(cfg, dict(kind="decode", seq_len=S,
                                      global_batch=B))
    _, pf = roofline.paged_cost([S] * B, H, Hkv, hd, S // 16, 4)
    assert dec["cost"]["flops"] == _dense_flops(cfg, B, B,
                                                cfg.n_layers * pf)
    assert dec["kernels"]["paged_attention"]["calls"] == cfg.n_layers
    # the argument bytes of the same cells made for real on the CPU
    for kind, n_micro in (("prefill", 1), ("decode", 1), ("train", 2)):
        shape = dict(kind=kind, seq_len=S, global_batch=B)
        got = dryrun.count_cell(cfg, shape, n_micro=n_micro)["memory"]
        model = build_model(cfg, device="cpu", trainable=kind == "train")
        _, args = build_cell(model, shape, n_micro=n_micro)
        assert got["argument_bytes"] == counter.tensor_bytes(args), kind
        real = sum(t.numel() * t.element_size() for t in
                   jax.tree.leaves(args, is_leaf=torch.is_tensor))
        assert got["argument_bytes"] == real
        if kind == "train":
            # parameters and moments updated in place; the step counter
            # is a new scalar
            params, opt, _ = args
            assert got["alias_bytes"] == counter.tensor_bytes(
                (params, opt["m"], opt["v"]))
        assert got["peak_bytes"] >= got["argument_bytes"]


def _depth_variant(cfg, k: int):
    """The config with k layer groups (and k encoder layers): the
    reference's 1- and 2-group cost points (``repro.launch.dryrun``)."""
    changes = {"n_layers": k * cfg.layer_pattern_period}
    if cfg.encoder is not None:
        changes["encoder"] = dataclasses.replace(cfg.encoder, n_layers=k)
    return dataclasses.replace(cfg, **changes)


@pytest.mark.parametrize("name", NAMES)
def test_two_point_extrapolation_equals_the_direct_count(name):
    """At three layer groups (and three encoder layers), the reference's
    cost(1) + (G - 1) (cost(2) - cost(1)) equals the count of every
    layer of a train step (forward, recomputation, backward, AdamW)."""
    cfg = get_config(name).reduced()
    cfg = dataclasses.replace(cfg, n_layers=3 * cfg.layer_pattern_period)
    if cfg.encoder is not None:
        cfg = dataclasses.replace(
            cfg, encoder=dataclasses.replace(cfg.encoder, n_layers=3))
    shape = dict(kind="train", seq_len=32, global_batch=2)
    direct = dryrun.count_cell(cfg, shape)["cost"]
    points = [dryrun.count_cell(_depth_variant(cfg, k), shape)["cost"]
              for k in (1, 2)]
    for k in ("flops", "bytes accessed", "transcendentals", "ideal_bytes"):
        got = points[0][k] + 2 * (points[1][k] - points[0][k])
        assert got == direct[k], (name, k)
    assert direct["flops"] > points[1]["flops"] > points[0]["flops"]


def test_argument_bytes_equal_xla_memory_analysis_of_one_reference_cell():
    """Reduced qwen3-8b at decode_32k on a 1 x 1 mesh: the parameters, the
    128 x 32,768 cache, the tokens and positions."""
    mesh = jax_local_mesh(1, 1)
    jmodel = jax_build(jax_config("qwen3-8b").reduced(), mesh=mesh)
    with mesh:
        compiled = jax_lower_cell(jmodel, "decode_32k").compile()
    want = compiled.memory_analysis().argument_size_in_bytes
    got = dryrun.count_cell(get_config("qwen3-8b").reduced(),
                            "decode_32k")["memory"]["argument_bytes"]
    assert got == want


@pytest.mark.parametrize("name", ["qwen3-8b", "mamba2-2.7b",
                                  "whisper-medium", "moonshot-v1-16b-a3b"])
def test_a_step_on_meta_runs_no_plain_version_and_launches_nothing(name):
    cfg = get_config(name).reduced()
    ops.reset_counts()
    kernels = set()
    for kind in ("train", "prefill", "decode"):
        rec = dryrun.count_cell(cfg, dict(kind=kind, seq_len=40,
                                          global_batch=2))
        kernels |= set(rec["kernels"])
    c = ops.counts()
    assert all(n == 0 for n in c["plain_calls"].values()), c
    assert all(n == 0 for n in c["launches"].values()), c
    attn = cfg.family != "ssm"
    want = ({"flash_attention", "flash_attention_lse",
             "flash_attention_bwd"} if attn else set())
    if cfg.family == "ssm":
        want |= {"ssd_chunk", "ssd_chunk_bwd"}
    if attn:
        want.add("paged_attention")
    assert kernels == want


def test_the_cli_writes_every_cell_of_both_meshes(tmp_path, monkeypatch,
                                                  capsys):
    """Every config at its published widths with one layer group (one
    encoder layer): each cell of both production meshes is rank 0's count
    of its sharded step, every memory field, the collectives and their
    term filled, rank 0's flops no more than an even share of the whole
    step's and no less than its own of the multi-pod mesh's data."""
    monkeypatch.setattr(dryrun, "CONFIG",
                        lambda n: _depth_variant(get_config(n), 1))
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    dryrun.main(["--all", "--mesh", "both"])
    flops = {}   # a cell's rank-0 flops on each mesh
    for mesh_name, multi in MESHES.items():
        files = sorted((tmp_path / mesh_name).glob("*.json"))
        assert len(files) == 40
        for f in files:
            r = json.loads(f.read_text())
            cfg = get_config(r["arch"])
            skip = (r["shape"] == "long_500k"
                    and cfg.family not in ("ssm", "hybrid"))
            assert r["status"] == ("skipped" if skip else "ok"), f.name
            if skip:
                assert r["skip_reason"] == \
                    jax_config(r["arch"]).skipped_shapes()["long_500k"]
                continue
            mem = r["memory"]
            for k in ("argument_bytes", "output_bytes", "temp_bytes",
                      "alias_bytes", "peak_bytes_per_device",
                      "fits_h100_80g", "spec_argument_bytes"):
                assert mem[k] is not None, (f.name, k)
            assert mem["peak_bytes_per_device"] == (
                mem["argument_bytes"] + mem["output_bytes"]
                + mem["temp_bytes"] - mem["alias_bytes"])
            assert mem["spec_argument_bytes"] > 0
            assert r["collectives"] and r["collectives_by_axis"]
            assert r["roofline"]["collective_s"] > 0
            assert r["counted_as"] == ([32, 16] if multi else [16, 16])
            assert r["mode"] == "tp_sp" and "cost_points" not in r
            assert r["cost"]["flops"] > 0
            flops.setdefault(f.name, []).append(r["cost"]["flops"])
        table = report.table(mesh_name)
        assert len(table.splitlines()) == 42
        assert "ERROR" not in table and "n/a" not in table
    # twice the data ranks: each holds half the rows of a batch they split
    for name, (single, multi) in flops.items():
        assert multi <= single, name
@pytest.mark.parametrize("Sq,Sk", [(1, 1), (7, 7), (5, 9), (9, 5), (4096, 4096),
                                   (448, 1500), (1, 1601)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_cost_counts_each_visible_pair(Sq, Sk, causal):
    """The closed form of the visible (query, key) pairs is the sum the
    smoke's cost function took before it moved: min(i + 1, Sk) per query
    row, top-left causal."""
    pairs = (sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk)
    n_bytes, n_flops = roofline.flash_cost(Sq, Sk, 32, 8, 128, causal, 2)
    assert n_flops == 4 * pairs * 32 * 128
    assert n_bytes == (2 * Sq * 32 * 128 + 2 * Sk * 8 * 128) * 2
    _, bwd = roofline.bwd_cost(2, Sq, Sk, 32, 8, 128, causal, 2)
    assert bwd == 2 * n_flops * 10 // 4
