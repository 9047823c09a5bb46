"""The model's prefill and dense-cache decode steps across a ``(data,
model)`` mesh of ``torch.distributed`` ranks, checked against the same
model in one process.

    PYTHONPATH=src python -m repro_torch.launch.spmd --arch qwen3-8b \\
        --mesh 1x2 --shape prefill|decode [--layers 4] [--reduced] \\
        [--device cpu]

:func:`launch` spawns one process per rank (``torch.multiprocessing``,
spawn), which meet through a file store in a temporary directory (no TCP
port) and build :func:`repro_torch.launch.mesh.make_local_mesh`. The
backend is NCCL when every rank has a card of its own and gloo when ranks
share one card (NCCL refuses two ranks on one device) or run on the CPU
(``--device cpu``); the choice is printed and never switched. Without
``--device cpu`` the ranks run on ``cuda`` and the run fails when no card
is present.

:func:`serve` is one rank's work: the model built from the whole weights
(drawn from one seed on every rank alike), its block of each leaf kept,
one prefill of the rank's rows of the prompts (2 x 1,024; 2 x 16
``--reduced``) and, for ``--shape decode``, 8 decode steps from the dense
cache. :func:`check` holds the ranks' logits against :func:`serve` in this
process with no mesh, fed the tokens the ranks fed (greedy on the mesh):
within :data:`ROW_LIMIT` of each row's magnitude, and the same greedy
token except where the one-process row's top two are closer than that. A
MoE drops pairs differently on the mesh, where capacity is per rank, as
the reference's does, so the entry point runs it :func:`dropless` on both
sides.

Each rank prints its kernel launches by variant, its plain-version calls,
its collectives' calls and bytes, and any ``jax`` or ``repro`` module it
loaded (none may be).
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import foreign_modules
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import make_local_mesh

# the logits' error over each row's largest magnitude (the smoke's bf16
# limit), and the top-2 gap under which a greedy token may differ
ROW_LIMIT = 2e-2


def backend_for(world: int, device: str) -> str:
    """gloo on the CPU or where ranks share a card, else NCCL."""
    if device == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the ranks run on the card unless "
                           "--device cpu is given")
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def dropless(cfg: ArchConfig) -> ArchConfig:
    """``cfg`` with a MoE's capacity factor E / K: an expert's capacity is
    then every token (a token picks an expert once), so no pair drops, on
    one card or per rank, and the sharded MoE is the one-card one."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def _rank_main(rank: int, world: int, shape: Tuple[int, int], store: str,
               out_dir: str, backend: str, device: str,
               threads: Optional[int], timeout_s: float, fn: Callable,
               args: tuple) -> None:
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    if device == "cuda":
        torch.cuda.set_device(rank if backend == "nccl" else 0)
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(make_local_mesh(*shape), dev, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, shape: Sequence[int], args: tuple = (), *,
           device: str = "cuda", threads: Optional[int] = None,
           timeout_s: float = 600.0) -> Tuple[str, List[Any]]:
    """``fn(mesh, device, *args)`` on each rank of a ``shape`` = (data,
    model) mesh, in processes of their own; ``fn`` and ``args`` must
    pickle (``fn`` a module-level function of a module that imports
    neither JAX nor the JAX package). Returns (backend, each rank's
    result in rank order). A rank that raises ends them all and the error
    is raised here; a collective that waits longer than ``timeout_s``
    fails."""
    # by the package's name, which pickles where this file runs as
    # ``__main__`` (``python -m``)
    from repro_torch.launch import spmd
    data, model = shape
    world = data * model
    backend = backend_for(world, device)
    with tempfile.TemporaryDirectory(prefix="spmd-") as d:
        torch.multiprocessing.start_processes(
            spmd._rank_main, args=(world, (data, model), os.path.join(d, "store"),
                              d, backend, device, threads, timeout_s, fn,
                              tuple(args)),
            nprocs=world, join=True, start_method="spawn")
        return backend, [torch.load(os.path.join(d, f"rank{r}.pt"),
                                    weights_only=False)
                         for r in range(world)]


# ---------------------------------------------------------------------------
# One rank's prefill and decode steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Job:
    """Prompts ``tokens`` [B, S] (int32, on the CPU) prefilled, then
    ``steps`` decode steps fed ``feed`` [B, steps] (None: each step's
    greedy token). ``params``: a file holding the whole parameter tree
    (``torch.save``), else the weights drawn from ``seed``."""
    cfg: ArchConfig
    tokens: torch.Tensor
    steps: int = 0
    feed: Optional[torch.Tensor] = None
    params: Optional[str] = None
    seed: int = 0


def batch_rows(ctx, B: int) -> Tuple[int, int]:
    """This rank's rows of a batch of B: its block over ``data``, or all B
    where the data axis does not divide it."""
    dp = ctx.axis_size("batch")
    if B % dp:
        return 0, B
    i = ctx.index("batch")
    return i * B // dp, (i + 1) * B // dp


@torch.no_grad()
def serve(mesh, device: torch.device, job: Job) -> Dict[str, Any]:
    """One rank's prefill and decode steps (``mesh`` None: one process).
    Returns its record: ``logits`` [1 + steps, b, Vp] f32 of its rows
    ``rows``, the tokens it fed, ``k``/``v`` of the prefill and
    ``cache_k``/``cache_v`` after the steps (its blocks), its launches,
    plain calls, collectives, dropped MoE pairs, seconds and foreign
    modules; tensors on the CPU."""
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, moe
    params = (None if job.params is None
              else torch.load(job.params, map_location=device))
    model = build_model(job.cfg, params, device=device, seed=job.seed,
                        mesh=mesh)
    del params
    ctx = model.ctx
    B, S = job.tokens.shape
    lo, hi = batch_rows(ctx, B)
    toks = job.tokens[lo:hi].to(device)
    ops.reset_counts()
    C.reset_stats()
    moe.drop_log = []
    t0 = time.perf_counter()
    try:
        logits, k, v = model.prefill(toks)
        out, fed = [logits], []
        cache = model.cache(hi - lo, S + job.steps)
        cache["k"][:, :, :S] = k
        cache["v"][:, :, :S] = v
        for i in range(job.steps):
            nxt = (logits.argmax(-1).int() if job.feed is None
                   else job.feed[lo:hi, i].to(device))
            fed.append(nxt)
            pos = torch.full((hi - lo,), S + i, dtype=torch.int32,
                             device=device)
            logits = model.decode_step(cache, nxt[:, None], pos)
            out.append(logits)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        drops = [(int(d), n) for d, n in moe.drop_log]
    finally:
        moe.drop_log = None
    rec = dict(rank=getattr(mesh, "rank", 0),
               coords=list(getattr(mesh, "coords", (0, 0))), rows=(lo, hi),
               logits=torch.stack(out).cpu(),
               fed=(torch.stack(fed, 1).cpu() if fed
                    else torch.zeros((hi - lo, 0), dtype=torch.int32)),
               k=k.cpu(), v=v.cpu(), cache_k=cache["k"].cpu(),
               cache_v=cache["v"].cpu(),
               counts=ops.counts(), collectives=C.stats(),
               moe_pairs=sum(n for _, n in drops),
               moe_dropped=sum(d for d, _ in drops), seconds=seconds,
               foreign=foreign_modules())
    return rec


def gather_rows(records: List[Dict[str, Any]], key: str = "logits",
                dim: int = 1) -> torch.Tensor:
    """The whole batch of ``key`` (its batch dim ``dim``) from the ranks at
    model index 0, which hold every row between them."""
    blocks: Dict[Tuple[int, int], torch.Tensor] = {}
    for r in records:
        if r["coords"][1] == 0:
            blocks.setdefault(tuple(r["rows"]), r[key])
    return torch.cat([blocks[rows] for rows in sorted(blocks)], dim=dim)


def row_scaled_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row (last dim), the largest error over the largest magnitude."""
    diff = (got.float() - want.float()).abs().amax(-1)
    return diff / want.float().abs().amax(-1).clamp_min(1e-30)


def check(records: List[Dict[str, Any]], single: Dict[str, Any],
          limit: float = ROW_LIMIT) -> Dict[str, Any]:
    """The ranks' logits against the one-process run's (fed the same
    tokens): ``ok`` when every row is within ``limit`` of its magnitude,
    every greedy token equal but where the one-process top-2 gap is under
    ``limit`` of the row's magnitude (``near_ties``), the ranks of one
    data index hold the same logits, and no rank loaded a foreign
    module."""
    got = gather_rows(records)
    want = single["logits"]
    err = row_scaled_err(got, want)
    top2 = want.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]) / want.abs().amax(-1).clamp_min(
        1e-30)
    differ = got.argmax(-1) != want.argmax(-1)
    near = differ & (gap < limit)
    replicated = all(
        torch.equal(r["logits"], q["logits"]) for r in records
        for q in records if r["coords"][0] == q["coords"][0])
    res = dict(max_row_scaled_err=float(err.max()),
               tokens_differ=int(differ.sum()), near_ties=int(near.sum()),
               replicated_over_model=replicated,
               foreign=sorted({m for r in records for m in r["foreign"]}),
               dropped={"mesh": sum(r["moe_dropped"] for r in records),
                        "one_process": single["moe_dropped"]})
    res["ok"] = bool(err.max() <= limit and int((differ & ~near).sum()) == 0
                     and replicated and not res["foreign"])
    return res


def rank_line(rec: Dict[str, Any]) -> Dict[str, Any]:
    """What a rank prints: its launches by variant, plain calls,
    collectives, dropped pairs, seconds and foreign modules."""
    c = rec["counts"]
    return dict(rank=rec["rank"], coords=rec["coords"], rows=rec["rows"],
                launches={k: n for k, n in c["launches"].items() if n},
                launches_by_variant={k: {v: n for v, n in by.items() if n}
                                     for k, by in
                                     c["launches_by_variant"].items()
                                     if any(by.values())},
                plain_calls={k: n for k, n in c["plain_calls"].items() if n},
                collectives=rec["collectives"],
                moe_pairs=rec["moe_pairs"], moe_dropped=rec["moe_dropped"],
                seconds=rec["seconds"], foreign=rec["foreign"])


def serve_all(mesh, device: torch.device, jobs: Sequence[Job]
              ) -> List[Dict[str, Any]]:
    """:func:`serve` of each job in turn, on one spawn of the ranks."""
    return [serve(mesh, device, job) for job in jobs]


def run(jobs: Sequence[Job], shape: Sequence[int], *, device: str = "cuda",
        threads: Optional[int] = None) -> Tuple[str, List[Dict[str, Any]]]:
    """The jobs on one spawn of a ``shape`` mesh, then each in this
    process fed the tokens the mesh fed, and the checks. Returns (backend,
    per job ``{"mesh_seconds", "ranks": [rank_line], "check", "records",
    "single"}``); ``mesh_seconds`` is the spawn's, all jobs together."""
    from repro_torch.launch import spmd     # see launch
    t0 = time.perf_counter()
    backend, per_rank = launch(spmd.serve_all, shape, (list(jobs),),
                               device=device, threads=threads)
    mesh_s = time.perf_counter() - t0
    out = []
    for i, job in enumerate(jobs):
        records = [r[i] for r in per_rank]
        single = serve(None, torch.device(device), dataclasses.replace(
            job, feed=gather_rows(records, "fed", dim=0)))
        out.append(dict(mesh_seconds=mesh_s,
                        ranks=[rank_line(r) for r in records],
                        check=check(records, single), records=records,
                        single=single))
    return backend, out


def main(argv=None) -> int:
    from repro_torch.configs import get_config
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", required=True, help="DxM: data x model ranks")
    ap.add_argument("--shape", choices=["prefill", "decode"],
                    default="decode")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced widths (f32)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    data, model = (int(n) for n in args.mesh.lower().split("x"))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    cfg = dropless(cfg)
    batch, seq = 2, (16 if args.reduced else 1024)
    tokens = torch.randint(0, cfg.vocab, (batch, seq),
                           generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32)
    steps = 8 if args.shape == "decode" else 0
    backend = backend_for(data * model, args.device)
    print(json.dumps({"spmd": "backend", "backend": backend,
                      "mesh": [data, model], "device": args.device}),
          flush=True)
    # by the package's name: its classes pickle (see launch)
    from repro_torch.launch import spmd
    _, (out,) = spmd.run([spmd.Job(cfg, tokens, steps)], (data, model),
                         device=args.device)
    for line in out["ranks"]:
        print(json.dumps({"spmd": "rank", **line}), flush=True)
    print(json.dumps({"spmd": "check", "arch": cfg.name,
                      "layers": cfg.n_layers, "batch": batch, "seq": seq,
                      "steps": steps,
                      "mesh_seconds": out["mesh_seconds"],
                      **out["check"]}), flush=True)
    return 0 if out["check"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
