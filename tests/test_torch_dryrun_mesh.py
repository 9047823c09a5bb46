"""The dry run's multi-device count: one rank's sharded step in a world of
``torch.distributed``'s ``fake`` backend (``launch.mesh.counting_mesh``)
against the same rank of a live world.

Fake world against live ranks: gloo CPU ranks on 2 x 2 (reduced qwen3-8b,
moonshot, mamba2 and whisper) and on 1 x 4 (reduced qwen3-8b and whisper,
whose 2 KV heads each rank of a pair then shares) each count
``training.build_cell``'s prefill, decode and train steps under the
counter, and on 2 x 2 qwen3-8b's and moonshot's prefill, decode and
train steps in the sharding modes ``tp_sp_opt`` and ``fsdp_cp`` as well;
every rank's count is matched by the fake world's count of the
same rank, exactly: on CPU tensors drawn from the same seed on every cost
key, memory field, kernel and collective; on ``meta`` (the dry run's own
count, whose hand kernels are charged by their cost functions) on every
collective and on the argument, output and alias bytes.

The CLI on both production meshes: every config at its published widths
with one layer group, every shape; each record filled, its argument bytes
the reference's partition specs' plus exactly what the head layout and the
cache split by KV heads hold beyond them, whisper's prefill flops times the
devices its one-device count. A reduced config (4 heads) at ``model`` = 16
is refused. And the counter's charge of a collective, the head layout's
blocks, the counting world's guards and the roofline's per-axis link rates.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from _torch_mesh_rank import count_cells, count_step
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (ShardingCtx, axes_size,
                                              head_layout, head_leaf,
                                              mesh_rules, shard_shape)
from repro_torch.launch import dryrun, report, roofline, spmd
from repro_torch.launch.counter import Counter
from repro_torch.launch.mesh import (COUNTED, counting_mesh,
                                     make_production_mesh)
from repro_torch.models import build_model
from repro_torch.models.common import _zip_specs, param_specs, pspec_tree


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE = {"prefill": dict(kind="prefill", seq_len=16, global_batch=2),
         "decode": dict(kind="decode", seq_len=32, global_batch=2),
         "train": dict(kind="train", seq_len=16, global_batch=4)}
MESHES = {(2, 2): ("qwen3-8b", "moonshot-v1-16b-a3b", "mamba2-2.7b",
                   "whisper-medium"),
          (1, 4): ("qwen3-8b", "whisper-medium")}
# the other sharding modes' cells, counted on 2 x 2
MODE_CASES = [("qwen3-8b", "moonshot-v1-16b-a3b"),
              ("prefill", "decode", "train"), ("tp_sp_opt", "fsdp_cp")]
CASES = ([pytest.param(m, n, k, "tp_sp", id=f"{n}-{k}-{m[0]}x{m[1]}")
          for m, names in MESHES.items() for n in names for k in SHAPE]
         + [pytest.param((2, 2), n, k, mode, id=f"{n}-{k}-{mode}-2x2")
            for n in MODE_CASES[0] for k in MODE_CASES[1]
            for mode in MODE_CASES[2]])


def _key(name, kind, mode):
    return f"{name}/{kind}" + ("" if mode == "tp_sp" else f"/{mode}")


@pytest.fixture(scope="module")
def live():
    """Every rank's counts, one spawn of gloo CPU ranks per mesh."""
    out = {}
    for shape, names in MESHES.items():
        cases = {f"{n}/{k}": (get_config(n).reduced(), sh)
                 for n in names for k, sh in SHAPE.items()}
        if shape == (2, 2):
            cases.update({_key(n, k, mode): (get_config(n).reduced(),
                                             SHAPE[k], mode)
                          for n in MODE_CASES[0] for k in MODE_CASES[1]
                          for mode in MODE_CASES[2]})
        _, out[shape] = spmd.launch(count_cells, shape, (cases,),
                                    device="cpu", threads=1)
    return out


@pytest.mark.parametrize("mesh,name,kind,mode", CASES)
def test_the_fake_world_counts_each_rank_as_the_live_world(mesh, name, kind,
                                                           mode, live):
    """Each rank's count on gloo against the fake world's count of that
    rank: on CPU tensors everything, on ``meta`` the collectives and the
    argument, output and alias bytes (a decode cell's cache the rank's
    block, not the whole mesh's), in each sharding mode."""
    cfg, sh = get_config(name).reduced(), SHAPE[kind]
    for rank, got in enumerate(live[mesh]):
        want = got[_key(name, kind, mode)]
        with counting_mesh(mesh, rank) as lm:
            cpu = count_step(lm, torch.device("cpu"), cfg, sh, mode=mode)
            meta = dryrun.count_cell(cfg, sh, mesh=lm, mode=mode)
        assert want["collectives"], (rank, "no collective")
        for k in ("cost", "memory", "collectives", "kernels"):
            assert cpu[k] == want[k], (rank, k, cpu[k], want[k])
        assert meta["collectives"] == want["collectives"], rank
        for k in ("argument_bytes", "output_bytes", "alias_bytes"):
            assert meta["memory"][k] == want["memory"][k], (rank, k)
    assert not dist.is_initialized()


# one config of each family, each counted twice in a fresh interpreter
PIN_FAMILIES = ("qwen3-8b", "moonshot-v1-16b-a3b", "mamba2-2.7b",
                "jamba-v0.1-52b", "whisper-medium", "llama-3.2-vision-11b")
PIN = """
import gc, json, sys
import torch
sys.path.insert(0, sys.argv[1])
torch.set_num_threads(1)
from _torch_mesh_rank import count_step
from repro_torch.configs import get_config
from repro_torch.launch.mesh import counting_mesh
out = {}
for name in %r:
    cfg = get_config(name).reduced()
    out[name] = []
    for collector in ("disabled", "threshold 1"):
        gc.collect()
        if collector == "disabled":
            gc.disable()
        else:
            gc.set_threshold(1)
        try:
            with counting_mesh((2, 2), 0) as lm:
                out[name].append(count_step(lm, torch.device("cpu"), cfg,
                                            %r)["memory"])
        finally:
            gc.enable()
            gc.set_threshold(700, 10, 10)
print(json.dumps(out))
""" % (PIN_FAMILIES, SHAPE["train"])


def test_a_train_steps_count_does_not_depend_on_the_cyclic_collector():
    """The pin of a fault of the port: the first checkpointed layer (and
    the counter's first dispatch) imported ``torch._dynamo``, whose import
    left a reference cycle through a frame holding the calling stack, so
    the step's tensors lived until Python's cyclic collector ran and the
    count's temporaries depended on when it did. Every family's train cell
    (reduced, rank 0 of a fake 2 x 2), in a fresh interpreter where
    nothing has imported ``torch._dynamo`` yet, is counted first with the
    collector disabled, then at threshold 1: the memory records are
    equal."""
    tests = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(tests.parent / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", PIN, str(tests)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(out) == sorted(PIN_FAMILIES)
    for name, (disabled, eager) in out.items():
        assert disabled == eager, (name, disabled, eager)


# ---------------------------------------------------------------------------
# The CLI on both production meshes
# ---------------------------------------------------------------------------

def _one_group(cfg):
    """The config with one layer group (and one encoder layer), at its
    published widths: the reference's 1-group cost point."""
    changes = {"n_layers": cfg.layer_pattern_period}
    if cfg.encoder is not None:
        changes["encoder"] = dataclasses.replace(cfg.encoder, n_layers=1)
    return dataclasses.replace(cfg, **changes)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """``dryrun.main(["--all", "--mesh", "both"])`` over the one-group
    configs: the records by mesh and file name."""
    d = tmp_path_factory.mktemp("dryrun_mesh")
    saved = dryrun.CONFIG, dryrun.RESULTS
    dryrun.CONFIG = lambda n: _one_group(get_config(n))
    dryrun.RESULTS = d
    try:
        dryrun.main(["--all", "--mesh", "both"])
        tables = {m: report.table(m) for m in COUNTED}
    finally:
        dryrun.CONFIG, dryrun.RESULTS = saved
    recs = {m: {f.stem: json.loads(f.read_text())
                for f in sorted((d / m).glob("*.json"))} for m in COUNTED}
    return recs, tables


def _excess(cfg, shape_name: str, mesh_name: str) -> int:
    """Rank 0's argument bytes beyond the reference's partition specs':
    each attention leaf's block of the head layout against its spec's (its
    AdamW moments too in a train cell), and in a decode cell the K/V and
    cross K/V split by KV heads against the specs' split of their rows."""
    data, model = COUNTED[mesh_name]
    pm = make_production_mesh(multi_pod=mesh_name == "multi")
    sh = SHAPES[shape_name]
    if cfg.family == "ssm":
        return 0
    hb = head_layout(cfg.n_heads, cfg.n_kv_heads, model, 0)
    heads = {"q": cfg.n_heads, "kv": cfg.n_kv_heads}
    size = torch.empty((), dtype=cfg.dtype).element_size()
    per = size + (8 if sh["kind"] == "train" else 0)   # and f32 m and v
    total = 0

    def leaf(spec, pspec, path):
        nonlocal total
        kind = head_leaf(path)
        if kind is None:
            return
        lo, hi = getattr(hb, kind)
        mine = [(hi - lo) * (n // heads[kind]) if e == "model"
                else n // axes_size(pm, e) for n, e in zip(spec.shape, pspec)]
        total += (math.prod(mine) - math.prod(shard_shape(
            pm, spec.shape, pspec))) * per
    specs = param_specs(cfg)
    _zip_specs(leaf, specs, pspec_tree(specs, mesh_rules(pm)))
    if sh["kind"] == "decode":
        m = build_model(cfg, device="meta", mesh=pm)
        B = sh["global_batch"]
        lanes = B // data if B % data == 0 else B
        structs, cspecs = m.cache_specs(B, sh["seq_len"])
        for k in ("k", "v", "cross_k", "cross_v"):
            if k in structs:
                n, _, S, _, hd = structs[k].shape
                mine = n * lanes * S * (hb.kv[1] - hb.kv[0]) * hd
                total += (mine - math.prod(shard_shape(
                    pm, structs[k].shape, cspecs[k]))) * size
    return total


@pytest.mark.parametrize("mesh", list(COUNTED))
def test_every_cell_of_a_production_mesh_is_filled(mesh, cli):
    """80 records, every one not skipped ``ok``, with every memory field,
    the collectives and their term; the report prints no "n/a" and no
    ERROR."""
    recs, tables = cli
    assert len(recs[mesh]) == 40
    for stem, r in recs[mesh].items():
        cfg = get_config(r["arch"])
        if r["shape"] == "long_500k" and not cfg.supports_long_context:
            assert r["status"] == "skipped", stem
            continue
        assert r["status"] == "ok", (stem, r.get("error"))
        for k in ("argument_bytes", "output_bytes", "temp_bytes",
                  "alias_bytes", "peak_bytes_per_device", "fits_h100_80g",
                  "spec_argument_bytes"):
            assert r["memory"][k] is not None, (stem, k)
        assert r["collectives"] and r["roofline"]["collective_s"] > 0, stem
        assert set(r["collectives"]) <= {"all-gather", "all-reduce",
                                         "reduce-scatter", "all-to-all"}
        for kind, d in r["collectives"].items():
            assert d["count"] == sum(
                a[kind]["count"] for a in r["collectives_by_axis"].values()
                if kind in a), (stem, kind)
        assert r["counted_as"] == list(COUNTED[mesh])
    assert "n/a" not in tables[mesh] and "ERROR" not in tables[mesh]
    assert len(tables[mesh].splitlines()) == 42


@pytest.mark.parametrize("mesh", list(COUNTED))
def test_argument_bytes_are_the_specs_plus_the_head_layout(mesh, cli):
    """``argument_bytes`` exceed ``spec_argument_bytes`` by exactly the
    head layout's extra bytes (replicated KV heads, scout's uneven query
    blocks, the cache split by KV heads): none for moonshot and mamba2,
    whose heads split evenly, nor for whisper but its decode cells, whose
    cross K/V the reference's specs leave whole."""
    recs, _ = cli
    for stem, r in recs[mesh].items():
        if r["status"] != "ok":
            continue
        cfg = _one_group(get_config(r["arch"]))
        got = (r["memory"]["argument_bytes"]
               - r["memory"]["spec_argument_bytes"])
        assert got == _excess(cfg, r["shape"], mesh), stem
        if r["arch"] in ("moonshot-v1-16b-a3b", "mamba2-2.7b") or (
                r["arch"] == "whisper-medium"
                and SHAPES[r["shape"]]["kind"] != "decode"):
            assert got == 0, stem


@pytest.mark.parametrize("mesh", list(COUNTED))
def test_whisper_prefill_flops_split_evenly(mesh, cli):
    """whisper-medium's 16 heads and 16 KV heads split evenly over 16
    ranks and its 32 prompts over the data ranks: a rank's prefill flops
    times the devices are the one-device count."""
    recs, _ = cli
    r = recs[mesh]["whisper-medium__prefill_32k"]
    cfg = _one_group(get_config("whisper-medium"))
    one = dryrun.count_cell(cfg, "prefill_32k")["cost"]["flops"]
    assert r["cost"]["flops"] * math.prod(COUNTED[mesh]) == one


def test_a_config_the_layout_refuses_is_an_error(tmp_path, monkeypatch):
    """Reduced qwen3-8b (4 heads, 2 KV heads) on 16 x 16: more ranks than
    heads; the record is an error naming ``layers/*/attn/wq``, with no
    fallback to another count."""
    monkeypatch.setattr(dryrun, "CONFIG", lambda n: get_config(n).reduced())
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen3-8b", "--shape", "train_4k"])
    r = json.loads((tmp_path / "single" / "qwen3-8b__train_4k.json")
                   .read_text())
    assert r["status"] == "error"
    assert "layers/*/attn/wq: 4 heads (2 KV heads)" in r["error"]
    assert "memory" not in r and "cost" not in r
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------

def test_the_counter_charges_a_collective_its_input_and_output():
    """On a fake 1 x 4 world: an all-gather of a [4, 8] bf16 block over
    ``model`` is charged its input and its [16, 8] output; an all-reduce
    its buffer twice."""
    with counting_mesh((1, 4)) as lm:
        ctx = ShardingCtx(lm)
        x = torch.zeros(4, 8, dtype=torch.bfloat16)
        c = Counter()
        with c:
            y = C.all_gather(x, "tp", 0, ctx)
        assert tuple(y.shape) == (16, 8)
        assert c.ideal_bytes == 4 * 8 * 2 + 16 * 8 * 2
        c = Counter()
        with c:
            C.all_reduce_sum(x, "tp", ctx)
        assert c.ideal_bytes == 2 * 4 * 8 * 2
    assert not dist.is_initialized()


def test_a_counting_world_is_one_at_a_time_and_torn_down():
    """A counting mesh refuses to start inside a world, and leaves none
    behind when its body raises."""
    with counting_mesh((2, 2)) as lm:
        assert (lm.size, lm.rank, lm.coords) == (4, 0, (0, 0))
        with pytest.raises(RuntimeError, match="already initialised"):
            with counting_mesh("single"):
                pass
    with pytest.raises(KeyError):
        with counting_mesh("multi", rank=511) as lm:
            assert lm.coords == (31, 15)
            assert lm.line("model", 4) is not None
            raise KeyError("inside")
    assert not dist.is_initialized()


@pytest.mark.parametrize("H,Hkv,tp,want", [
    # equal blocks where tp divides the KV heads
    (32, 8, 8, [((4 * i, 4 * i + 4), (i, i + 1), 1) for i in range(8)]),
    # qwen3-8b on 16: each KV head on 2 ranks, 2 query heads each
    (32, 8, 16, [((2 * i, 2 * i + 2), (i // 2, i // 2 + 1), 2)
                 for i in range(16)]),
    # llama4-scout on 16: a group's 5 query heads as 3 and 2
    (40, 8, 16, [(((i // 2) * 5 + (0 if i % 2 == 0 else 3),
                   (i // 2) * 5 + (3 if i % 2 == 0 else 5)),
                  (i // 2, i // 2 + 1), 2) for i in range(16)]),
    # 6 heads, 2 KV heads on 4: 2 and 1
    (6, 2, 4, [((0, 2), (0, 1), 2), ((2, 3), (0, 1), 2),
               ((3, 5), (1, 2), 2), ((5, 6), (1, 2), 2)]),
    # starcoder2 on 16: 4 KV heads, each on 4 ranks of 3 query heads
    (48, 4, 16, [((3 * i, 3 * i + 3), (i // 4, i // 4 + 1), 4)
                 for i in range(16)])])
def test_the_head_layout(H, Hkv, tp, want):
    got = [head_layout(H, Hkv, tp, i) for i in range(tp)]
    assert [(b.q, b.kv, b.replicas) for b in got] == want
    # every query head on one rank; rank 0 holds a largest block
    assert sorted(h for b in got for h in range(*b.q)) == list(range(H))
    assert got[0].q[1] - got[0].q[0] == max(b.q[1] - b.q[0] for b in got)


@pytest.mark.parametrize("H,Hkv,tp", [(4, 2, 16), (4, 2, 3), (8, 8, 12),
                                      (24, 6, 4)])
def test_the_head_layout_refuses_what_it_cannot_lay_out(H, Hkv, tp):
    with pytest.raises(ValueError, match=f"attn/wq: {H} heads "
                       f"\\({Hkv} KV heads\\)"):
        head_layout(H, Hkv, tp, 0)


def test_only_lines_inside_a_node_run_at_the_link_rate():
    """On 16 x 16 (rank ``d * 16 + m``) the ``model`` and ``data`` lines
    leave their 8-GPU node; the ranks sharing a KV head do not."""
    hw = roofline.H100
    lines = dryrun.collective_lines(make_production_mesh(), 2)
    assert hw.line_bw(lines["model"]) == hw.line_bw(lines["data"]) == 50e9
    assert hw.line_bw(lines["kv"]) == hw.link_bw == 450e9
    t = roofline.roofline_terms(
        {"flops": 0.0}, {"all-reduce": {"traffic": 3e9}}, 256,
        by_axis={"model": {"all-reduce": {"traffic": 1e9}},
                 "kv": {"all-reduce": {"traffic": 2e9}}}, lines=lines)
    assert t["collective_s"] == 1e9 / 50e9 + 2e9 / 450e9
