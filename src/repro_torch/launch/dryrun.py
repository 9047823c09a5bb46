"""Dry run: the cost, memory and roofline of every (architecture x input
shape) cell, without touching device memory. The port of
``repro/launch/dryrun.py``.

The reference lowers and compiles each cell's step for the TPU meshes and
reads XLA's cost and memory analyses. The port runs the step of
:func:`repro_torch.training.train_step.build_cell` on ``meta`` tensors
under :class:`repro_torch.launch.counter.Counter`: every layer is counted
directly, as eager dispatch sees them all (the reference unrolls 1- and
2-group variants and extrapolates; the port's tests hold that
extrapolation to the direct count). There is one sharding mode: the
reference's ``--sharding-mode`` changes only activation constraints,
which the port does not model.

Meshes:
  * ``single`` (16x16) and ``multi`` (2x16x16): the reference's production
    meshes, as data. Per-device argument bytes come from each leaf's
    partition spec; flops and bytes are the whole step's over the device
    count. ``temp_bytes``, the peak and the collective term are null: with
    no SPMD partitioner the port has no source for them.
  * ``local``: one card (``make_local_mesh``); every field is filled, the
    collective term is 0.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k --mesh local
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      [--mesh single|multi|both|local] [--skip-existing]

Results land in results/dryrun_torch/<mesh>/<arch>__<shape>.json.
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
from repro_torch.distributed.sharding import shard_shape
from repro_torch.launch.counter import Counter
from repro_torch.launch.mesh import (Mesh, make_local_mesh,
                                     make_production_mesh)
from repro_torch.launch.roofline import H100, Hardware, roofline_terms

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# the config of an arch name (a test points it at the reduced configs)
CONFIG = get_config

def make_mesh(name: str) -> Mesh:
    if name == "local":
        return make_local_mesh(1, 1)
    return make_production_mesh(multi_pod=(name == "multi"))


def count_cell(cfg, shape, overrides=None, opt_cfg=None,
               n_micro: int = 1) -> Dict[str, Any]:
    """One step of the cell on ``meta`` under a counter: ``{"cost",
    "memory", "kernels", "count_s"}`` (the whole step, one device)."""
    from repro_torch.models import build_model
    from repro_torch.training.train_step import build_cell
    sh = shape_of(shape)
    model = build_model(cfg, device="meta", trainable=sh["kind"] == "train")
    for k, v in (overrides or {}).items():
        setattr(model, k, v)
    step, args = build_cell(model, sh, opt_cfg=opt_cfg, n_micro=n_micro)
    t0 = time.perf_counter()
    c = Counter()
    with torch.set_grad_enabled(sh["kind"] == "train"):
        mem = c.run(step, *args)
    return {"cost": c.cost(), "memory": mem,
            "kernels": {k: dict(v) for k, v in sorted(c.kernels.items())},
            "count_s": time.perf_counter() - t0}


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


def per_device_arguments(cfg, shape, mesh: Mesh, opt_cfg=None) -> int:
    """Per-device bytes of a cell's arguments on ``mesh``: the parameters
    under their pspecs, the optimizer state under ``opt_pspecs``, the batch
    under ``batch_pspecs`` and the decode cache under its specs."""
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import OptConfig, opt_pspecs
    from repro_torch.training.train_step import batch_pspecs, build_cell
    sh = shape_of(shape)
    model = build_model(cfg, device="meta", mesh=mesh)
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


_COUNTS: Dict[Any, Dict[str, Any]] = {}


def _count(arch: str, cfg, shape_name, overrides, opt_cfg,
           n_micro: int) -> Dict[str, Any]:
    """The cell's count, made once per process (the same for every mesh:
    the port divides it)."""
    key = (arch, json.dumps(shape_of(shape_name), sort_keys=True),
           repr(sorted((overrides or {}).items())), repr(cfg), repr(opt_cfg),
           n_micro)
    if key not in _COUNTS:
        _COUNTS[key] = count_cell(cfg, shape_name, overrides=overrides,
                                  opt_cfg=opt_cfg, n_micro=n_micro)
    return _COUNTS[key]


def shape_label(shape) -> str:
    """A shape's name, or ``<kind>_<batch>x<seq>`` for a shape dict."""
    if isinstance(shape, str):
        return shape
    return f"{shape['kind']}_{shape['global_batch']}x{shape['seq_len']}"


def run_cell(arch: str, shape_name, mesh: str, overrides=None,
             hw: Hardware = H100, cfg=None, opt_cfg=None,
             n_micro: int = 1) -> dict:
    """Count one cell on ``mesh`` ("single", "multi" or "local"); return
    the analysis record. ``shape_name`` is a name of ``SHAPES`` or a shape
    dict (the smoke's card shapes); ``cfg`` replaces the arch's config (a
    config cut in depth), ``opt_cfg`` and ``n_micro`` set a train cell's
    step as ``build_cell`` takes them."""
    cfg = cfg or CONFIG(arch)
    label = shape_label(shape_name)
    rec: Dict[str, Any] = {"arch": arch, "shape": label, "mesh": mesh}
    if isinstance(shape_name, str) and shape_name in cfg.skipped_shapes():
        rec["status"] = "skipped"
        rec["skip_reason"] = cfg.skipped_shapes()[shape_name]
        return rec
    m = make_mesh(mesh)
    n = m.size
    direct = _count(arch, cfg, shape_name, overrides, opt_cfg, n_micro)
    rec["count_s"] = round(direct["count_s"], 2)
    mem = dict(direct["memory"])
    if n > 1:
        mem = {"argument_bytes": per_device_arguments(cfg, shape_name, m,
                                                      opt_cfg),
               "output_bytes": None, "temp_bytes": None,
               "alias_bytes": None, "peak_bytes_per_device": None,
               "fits_h100_80g": None,
               "unsharded_argument_bytes": direct["memory"]["argument_bytes"]}
    else:
        mem["peak_bytes_per_device"] = mem.pop("peak_bytes")
        mem["fits_h100_80g"] = bool(mem["peak_bytes_per_device"]
                                    <= hw.hbm_cap)
    rec["memory"] = mem
    rec["cost"] = {k: v / n for k, v in direct["cost"].items()}
    rec["kernels"] = direct["kernels"]
    rec["collectives"] = None if n > 1 else {}
    rec["roofline"] = roofline_terms(rec["cost"], rec["collectives"], n, cfg,
                                     shape_of(shape_name), hw)
    rec["status"] = "ok"
    return rec


def cell_path(arch: str, shape: str, mesh: str) -> Path:
    return RESULTS / mesh / f"{arch}__{shape}.json"


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
    args = ap.parse_args(argv)

    archs = list_configs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
                out = cell_path(arch, shape, mesh_name)
                if args.skip_existing and out.exists():
                    print(f"[skip-existing] {mesh_name}/{arch}/{shape}")
                    continue
                print(f"[dryrun] mesh={mesh_name} arch={arch} "
                      f"shape={shape} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, mesh_name)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": str(e),
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
