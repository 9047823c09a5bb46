"""Dry run: the cost, memory and roofline of every (architecture x input
shape) cell, without touching device memory. The port of
``repro/launch/dryrun.py``.

The reference lowers and compiles each cell's step for the TPU meshes and
reads XLA's cost and memory analyses. The port runs the step of
:func:`repro_torch.training.train_step.build_cell` on ``meta`` tensors
under :class:`repro_torch.launch.counter.Counter`: every layer is counted
directly, as eager dispatch sees them all (the reference unrolls 1- and
2-group variants and extrapolates; the port's tests hold that
extrapolation to the direct count). ``--sharding-mode`` picks the
reference's distribution mode (``tp_sp``, ``tp_sp_opt``, ``fsdp_cp``:
:mod:`repro_torch.distributed.sharding`), each with its own collectives
and memory per rank, counted as they run; a record keeps its ``mode``,
and the other modes' records land under ``<mesh>-<mode>/``. A cell a mode
does not run yet (a family other than dense and MoE in ``tp_sp_opt`` and
``fsdp_cp``) is written as an error naming the mode.

Meshes:
  * ``single`` (16x16) and ``multi`` (2x16x16): the reference's production
    meshes. The port counts one rank's real sharded step: the model built
    on ``meta`` across a live mesh of the production shape in a world of
    ``torch.distributed``'s ``fake`` backend
    (:func:`repro_torch.launch.mesh.counting_mesh`; the multi-pod mesh as
    ``(data=32, model=16)``, ``pod`` folded into ``data``), rank 0's step
    run under the counter. Its memory (the peak among it), cost and
    collectives are that rank's; rank 0 holds a largest block of the head
    layout, so its count bounds every rank's. The collectives are in the
    reference's form, ``{kind: {count, bytes, traffic, max_group}}``
    (``bytes`` each op's output), with a split by mesh axis
    (``collectives_by_axis``; the ranks of rank 0's line along each axis
    in ``collective_lines``), which the roofline's collective term reads.
    ``spec_argument_bytes`` keeps the per-device argument bytes of the
    reference's partition specs; the rank's differ from them by the head
    layout (replicated KV heads, uneven query blocks) and by the cache
    split by KV heads where the specs split its rows. A cell whose heads
    the mesh cannot lay out is an error.
  * ``local``: one card (``make_local_mesh``); every field is filled, the
    collective term is 0.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k --mesh local
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      [--mesh single|multi|both|local] [--skip-existing] \\
      [--sharding-mode tp_sp|tp_sp_opt|fsdp_cp]

Results land in results/dryrun_torch/<mesh>/<arch>__<shape>.json
(``<mesh>-<mode>/`` for a mode other than ``tp_sp``).
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import SHAPES, get_config, list_configs, shape_of
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import MODES, shard_shape
from repro_torch.launch.counter import Counter
from repro_torch.launch.mesh import (COUNTED, Mesh, counting_mesh,
                                     make_local_mesh, make_production_mesh)
from repro_torch.launch.roofline import (H100, Hardware, _traffic,
                                         roofline_terms)

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# the config of an arch name (a test points it at the reduced configs)
CONFIG = get_config

def make_mesh(name) -> Mesh:
    """The mesh of ``name`` ("single", "multi", "local" or a (data,
    model) shape)."""
    if not isinstance(name, str):
        return Mesh(("data", "model"), tuple(name))
    if name == "local":
        # the one card the roofline's H100 terms describe
        if not torch.cuda.is_available():
            raise ValueError("the local mesh is one card; none is present")
        return make_local_mesh(1, 1)
    return make_production_mesh(multi_pod=(name == "multi"))


def count_cell(cfg, shape, overrides=None, opt_cfg=None,
               n_micro: int = 1, mesh=None,
               mode: str = "tp_sp") -> Dict[str, Any]:
    """One step of the cell on ``meta`` under a counter: ``{"cost",
    "memory", "kernels", "collectives", "count_s"}``: the whole step on one
    device, or this rank's of a live ``mesh`` (a
    :func:`~repro_torch.launch.mesh.counting_mesh`) in sharding mode
    ``mode``, with its collectives (``collectives.stats()`` of the
    step)."""
    from repro_torch.models import build_model
    from repro_torch.training.train_step import build_cell
    sh = shape_of(shape)
    model = build_model(cfg, device="meta", trainable=sh["kind"] == "train",
                        mesh=mesh, mode=mode)
    for k, v in (overrides or {}).items():
        setattr(model, k, v)
    step, args = build_cell(model, sh, opt_cfg=opt_cfg, n_micro=n_micro)
    t0 = time.perf_counter()
    c = Counter()
    C.reset_stats()
    with torch.set_grad_enabled(sh["kind"] == "train"):
        mem = c.run(step, *args)
    return {"cost": c.cost(), "memory": mem,
            "kernels": {k: dict(v) for k, v in sorted(c.kernels.items())},
            "collectives": C.stats(), "count_s": time.perf_counter() - t0}


# the reference's kind of each of the port's collectives
KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "all_reduce_max": "all-reduce", "reduce_scatter": "reduce-scatter",
         "all_to_all": "all-to-all"}


def collective_lines(mesh, kv_replicas: int) -> Dict[str, list]:
    """The ranks of rank 0's line along each axis a collective can run on:
    ``data`` (stride ``model``), ``model`` and the KV replicas' ``kv``."""
    data, model = mesh.axis_sizes
    return {"data": [d * model for d in range(data)],
            "model": list(range(model)), "kv": list(range(kv_replicas))}


def collective_record(stats, lines: Dict[str, list]):
    """``collectives.stats()`` in the reference's form: (``{kind: {count,
    bytes, traffic, max_group}}``, the same by mesh axis). ``bytes`` is each
    op's output, as the reference's ``parse_collectives`` reads it: the
    all-gather's gathered tensor, the all-reduce's buffer, the
    reduce-scatter's block (``stats()`` counts its input: over the line's
    size), the all-to-all's buffer; ``traffic`` is ``_traffic`` over the
    line's ranks."""
    total: Dict[str, Dict[str, float]] = {}
    by_axis: Dict[str, Dict[str, Dict[str, float]]] = {}
    for kind, axes in sorted(stats.items()):
        k = KINDS[kind]
        for axis, s in sorted(axes.items()):
            n = len(lines[axis])
            b = s["bytes"] // n if k == "reduce-scatter" else s["bytes"]
            rec = by_axis.setdefault(axis, {}).setdefault(
                k, {"count": 0, "bytes": 0, "traffic": 0.0, "group": n})
            tot = total.setdefault(k, {"count": 0, "bytes": 0,
                                       "traffic": 0.0, "max_group": 0})
            for d in (rec, tot):
                d["count"] += s["calls"]
                d["bytes"] += b
                d["traffic"] += _traffic(k, b, n)
            tot["max_group"] = max(tot["max_group"], n)
    return total, by_axis


def _leaf_pairs(tree, specs):
    """(tensor, partition spec) pairs of a tree and its spec tree (a spec
    is a tuple: a leaf, not a container)."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k in tree:
            yield from _leaf_pairs(tree[k], specs[k])
    else:
        for t, s in zip(tree, specs):
            yield from _leaf_pairs(t, s)


def sharded_bytes(tree, specs, mesh: Optional[Mesh]) -> int:
    """One device's bytes of a tree of tensors under its spec tree."""
    return sum(torch.Size(shard_shape(mesh, t.shape, s)).numel()
               * t.element_size() for t, s in _leaf_pairs(tree, specs))


def per_device_arguments(cfg, shape, mesh: Mesh, opt_cfg=None,
                         mode: str = "tp_sp") -> int:
    """Per-device bytes of a cell's arguments on ``mesh``: the parameters
    under their pspecs, the optimizer state under ``opt_pspecs``, the batch
    under ``batch_pspecs`` and the decode cache under its specs (those of
    sharding mode ``mode``)."""
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import OptConfig, opt_pspecs
    from repro_torch.training.train_step import batch_pspecs, build_cell
    sh = shape_of(shape)
    model = build_model(cfg, device="meta", mesh=mesh, mode=mode)
    _, args = build_cell(model, sh, opt_cfg=opt_cfg)
    pspecs = model.param_pspecs()
    bspecs = batch_pspecs(model, sh)
    total = sharded_bytes(args[0], pspecs, mesh)
    if sh["kind"] == "train":
        comp = (opt_cfg or OptConfig()).compression
        total += sharded_bytes(args[1], opt_pspecs(pspecs, comp), mesh)
        total += sharded_bytes(args[2], bspecs, mesh)
    elif sh["kind"] == "prefill":
        total += sharded_bytes(args[1], bspecs, mesh)
    else:
        _, cspecs = model.cache_specs(sh["global_batch"], sh["seq_len"])
        total += sharded_bytes(args[1], cspecs, mesh)
        total += sharded_bytes([args[2], args[3]],
                               [bspecs["tokens"], bspecs["positions"]], mesh)
    return total


def _count(cfg, shape_name, overrides, opt_cfg, n_micro: int, mesh,
           rank: int = 0, mode: str = "tp_sp") -> Dict[str, Any]:
    """The cell's count on ``mesh``: the whole step for ``local``, else
    rank ``rank``'s in a counting world of the mesh's shape
    (:func:`~repro_torch.launch.mesh.counting_mesh`) in sharding mode
    ``mode``, with the lines of its collectives."""
    if mesh == "local":
        return count_cell(cfg, shape_name, overrides=overrides,
                          opt_cfg=opt_cfg, n_micro=n_micro, mode=mode)
    from repro_torch.models.transformer import sharding_ctx
    with counting_mesh(mesh, rank) as lm:
        rec = count_cell(cfg, shape_name, overrides=overrides,
                         opt_cfg=opt_cfg, n_micro=n_micro, mesh=lm,
                         mode=mode)
        rec["lines"] = collective_lines(
            lm, sharding_ctx(cfg, lm, mode).kv_replicas)
    return rec


def shape_label(shape) -> str:
    """A shape's name, or ``<kind>_<batch>x<seq>`` for a shape dict."""
    if isinstance(shape, str):
        return shape
    return f"{shape['kind']}_{shape['global_batch']}x{shape['seq_len']}"


def run_cell(arch: str, shape_name, mesh, overrides=None,
             hw: Hardware = H100, cfg=None, opt_cfg=None,
             n_micro: int = 1, rank: int = 0, mode: str = "tp_sp") -> dict:
    """Count one cell on ``mesh`` ("single", "multi", "local" or a (data,
    model) shape, counted as the production meshes are, rank ``rank``'s
    step) in sharding mode ``mode``; return the analysis record.
    ``shape_name`` is a name of ``SHAPES`` or a shape dict (the smoke's
    card shapes); ``cfg`` replaces the arch's config (a config cut in
    depth), ``opt_cfg`` and ``n_micro`` set a train cell's step as
    ``build_cell`` takes them."""
    cfg = cfg or CONFIG(arch)
    mesh = mesh if isinstance(mesh, str) else tuple(mesh)
    label = shape_label(shape_name)
    rec: Dict[str, Any] = {"arch": arch, "shape": label, "mode": mode,
                           "mesh": mesh if isinstance(mesh, str)
                           else list(mesh)}
    if isinstance(shape_name, str) and shape_name in cfg.skipped_shapes():
        rec["status"] = "skipped"
        rec["skip_reason"] = cfg.skipped_shapes()[shape_name]
        return rec
    n = make_mesh(mesh).size
    direct = _count(cfg, shape_name, overrides, opt_cfg, n_micro, mesh, rank,
                    mode)
    rec["count_s"] = round(direct["count_s"], 2)
    mem = dict(direct["memory"])
    mem["peak_bytes_per_device"] = mem.pop("peak_bytes")
    mem["fits_h100_80g"] = bool(mem["peak_bytes_per_device"] <= hw.hbm_cap)
    by_axis = lines = None
    if n > 1:
        mem["spec_argument_bytes"] = per_device_arguments(
            cfg, shape_name, make_mesh(mesh), opt_cfg, mode)
        rec["counted_as"] = list(COUNTED.get(mesh, mesh))
        rec["rank"] = rank
        lines = direct["lines"]
        rec["collectives"], by_axis = collective_record(
            direct["collectives"], lines)
        rec["collectives_by_axis"] = by_axis
        rec["collective_lines"] = lines
    else:
        rec["collectives"] = {}
    rec["memory"] = mem
    rec["cost"] = dict(direct["cost"])
    rec["kernels"] = direct["kernels"]
    rec["roofline"] = roofline_terms(rec["cost"], rec["collectives"], n, cfg,
                                     shape_of(shape_name), hw,
                                     by_axis=by_axis, lines=lines)
    rec["status"] = "ok"
    return rec


def cell_path(arch: str, shape: str, mesh: str, mode: str = "tp_sp") -> Path:
    d = mesh if mode == "tp_sp" else f"{mesh}-{mode}"
    return RESULTS / d / f"{arch}__{shape}.json"


def _line(rec: dict) -> str:
    r, mem = rec["roofline"], rec["memory"]
    peak = mem.get("peak_bytes_per_device")
    coll = r["collective_s"]
    return (f"  ok: count={rec['count_s']}s "
            f"args={mem['argument_bytes'] / 1e9:.2f}GB "
            f"peak={'n/a' if peak is None else f'{peak / 1e9:.2f}GB'} "
            f"compute={r['compute_s'] * 1e3:.2f}ms "
            f"memory={r['memory_s'] * 1e3:.2f}ms "
            f"coll={'n/a' if coll is None else f'{coll * 1e3:.2f}ms'} "
            f"bound={r['bottleneck']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "local"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--sharding-mode", default="tp_sp", choices=list(MODES),
                    help="the distribution mode (the reference's): tp_sp, "
                         "tp_sp_opt (sequence-parallel prefill) or fsdp_cp "
                         "(ZeRO-3 + context parallel, weight-stationary "
                         "decode)")
    args = ap.parse_args(argv)
    mode = args.sharding_mode

    archs = list_configs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
                out = cell_path(arch, shape, mesh_name, mode)
                if args.skip_existing and out.exists():
                    print(f"[skip-existing] {mesh_name}/{arch}/{shape}")
                    continue
                print(f"[dryrun] mesh={mesh_name} mode={mode} arch={arch} "
                      f"shape={shape} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, mesh_name, mode=mode)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "mode": mode, "status": "error", "error": str(e),
                           "traceback": traceback.format_exc()}
                    failures.append((mesh_name, arch, shape, str(e)))
                out.parent.mkdir(parents=True, exist_ok=True)
                out.write_text(json.dumps(rec, indent=1))
                if rec["status"] == "ok":
                    print(_line(rec), flush=True)
                elif rec["status"] == "skipped":
                    print(f"  skipped: {rec['skip_reason']}")
                else:
                    print(f"  ERROR: {rec['error'][:500]}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f[:3], f[3][:200])
        raise SystemExit(1)
    print("\nAll requested cells passed.")


if __name__ == "__main__":
    main()
