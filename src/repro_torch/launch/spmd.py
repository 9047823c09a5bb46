"""The model's prefill, dense-cache decode and training steps across a
``(data, model)`` mesh of ``torch.distributed`` ranks, checked against the
same model in one process.

    PYTHONPATH=src python -m repro_torch.launch.spmd --arch qwen3-8b \\
        --mesh 1x2 --shape prefill|decode|train [--layers 4] [--reduced] \\
        [--mode tp_sp|tp_sp_opt|fsdp_cp] [--device cpu]

:func:`launch` spawns one process per rank (``torch.multiprocessing``,
spawn), which meet through a file store in a temporary directory (no TCP
port) and build :func:`repro_torch.launch.mesh.make_local_mesh`. The
backend is NCCL when every rank has a card of its own and gloo when ranks
share one card (NCCL refuses two ranks on one device) or run on the CPU
(``--device cpu``); the choice is printed and never switched. Without
``--device cpu`` the ranks run on ``cuda`` and the run fails when no card
is present.

:func:`serve` is one rank's work: the model built from the whole weights
(drawn from one seed on every rank alike, leaf by leaf), its block of
each leaf kept, one prefill of the rank's rows of the prompts (2 x 1,024;
2 x 16 ``--reduced``) and of the frames or patch embeddings of an
encoder-decoder or vlm model, and, for ``--shape decode``, 8 decode steps
from the dense cache, seeded with the prefill's K/V, SSM state and conv
window and cross K/V. :func:`check` holds the ranks' logits against
:func:`serve` in this process with no mesh, fed the tokens the ranks fed
(greedy on the mesh):
within :data:`ROW_LIMIT` of each row's magnitude, and the same greedy
token except where the one-process row's top two are closer than that. A
MoE drops pairs differently on the mesh, where capacity is per rank, as
the reference's does, so the entry point runs it :func:`dropless` on both
sides. ``--mode`` picks the reference's distribution mode
(:mod:`repro_torch.distributed.sharding`) of the serving and training
steps alike; the ranks are held against the same one process, with no
mesh, in every mode.

:func:`train` is one rank's training: the model built trainable from
the whole weights, its blocks of the parameters and of an AdamW state a
few steps in (:func:`warm_state`), the gradient at the starting weights,
then 2 AdamW steps (lr :data:`TRAIN_LR`, no warmup) on its rows of the
batch (the tokens, labels the tokens shifted by one). :func:`check_train`
puts the ranks' blocks of the gradients and of the updated parameters
back together (:func:`whole`) and holds them, and each step's loss and
grad norm, against :func:`train` in one process with no mesh, within
:func:`train_limits`. :func:`run` makes that check in rank 0's process
once the ranks have trained (:func:`train_checked`): the blocks reach it
over the world's default group, leaf by leaf, so that no job's weights
or gradients go through a file.

Each rank prints its kernel launches by variant, its plain-version calls,
its collectives' calls and bytes (backward calls among them), and any
``jax`` or ``repro`` module it loaded (none may be).
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
from repro_torch.distributed.sharding import MODES
from repro_torch.launch.mesh import make_local_mesh

# the logits' error over each row's largest magnitude (the smoke's bf16
# limit), and the top-2 gap under which a greedy token may differ
ROW_LIMIT = 2e-2
# the learning rate of the entry point's train steps (no warmup)
TRAIN_LR = 1e-4


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
    (``torch.save``), else the weights drawn from ``seed``. ``extras``:
    the model's modality inputs for the whole batch (``{"frames": [B, F,
    D]}`` or ``{"ctx_embeds": [B, N, C]}``, on the CPU), each rank
    taking its rows. ``mode``: the sharding mode of the model on the
    mesh."""
    cfg: ArchConfig
    tokens: torch.Tensor
    steps: int = 0
    feed: Optional[torch.Tensor] = None
    params: Optional[str] = None
    seed: int = 0
    extras: Optional[Dict[str, torch.Tensor]] = None
    mode: str = "tp_sp"


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> Optional[int]:
    """The device memory this process allocated at most since
    :func:`_reset_peak` (None on the CPU)."""
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)


def batch_rows(ctx, B: int) -> Tuple[int, int]:
    """This rank's rows of a batch of B: its block over ``data``, or all B
    where the data axis does not divide it."""
    dp = ctx.axis_size("batch")
    if B % dp:
        return 0, B
    i = ctx.index("batch")
    return i * B // dp, (i + 1) * B // dp


def rows_of(extras, lo: int, hi: int, device) -> Optional[Dict[str, Any]]:
    """Rows ``lo:hi`` of each modality input, on ``device``."""
    if not extras:
        return None
    return {k: v[lo:hi].to(device) for k, v in extras.items()}


def modality_extras(cfg: ArchConfig, batch: int,
                    generator: torch.Generator) -> Optional[Dict[str, Any]]:
    """Standard-normal frames or patch embeddings [batch, n_ctx,
    ctx_width] in the model dtype for a model with cross-attention (on
    the CPU, from ``generator``); None for one without."""
    if not cfg.n_ctx:
        return None
    x = torch.randn((batch, cfg.n_ctx, cfg.ctx_width), generator=generator)
    return {cfg.ctx_key: x.to(cfg.dtype)}


@torch.no_grad()
def serve(mesh, device: torch.device, job: Job) -> Dict[str, Any]:
    """One rank's prefill and decode steps (``mesh`` None: one process).
    Returns its record: ``logits`` [1 + steps, b, Vp] f32 of its rows
    ``rows``, the tokens it fed, ``k``/``v`` of the prefill (None without
    attention layers) and ``state``, its SSM state, conv window and cross
    K/V (``Model.prefill_with_state``'s; None without), the dense cache
    after the steps (``cache_k``/``cache_v``, ``cache_state``), each
    entry its blocks, its launches, plain calls, collectives, dropped MoE
    pairs, seconds, peak device memory (from the model's build on) and
    foreign modules; tensors on the CPU."""
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, moe
    _reset_peak(device)
    params = (None if job.params is None
              else torch.load(job.params, map_location=device))
    model = build_model(job.cfg, params, device=device, seed=job.seed,
                        mesh=mesh, mode=job.mode)
    del params
    ctx = model.ctx
    B, S = job.tokens.shape
    lo, hi = batch_rows(ctx, B)
    toks = job.tokens[lo:hi].to(device)
    extras = rows_of(job.extras, lo, hi, device)
    ops.reset_counts()
    C.reset_stats()
    moe.drop_log = []
    t0 = time.perf_counter()
    try:
        logits, k, v, state = model.prefill_with_state(toks, extras)
        out, fed = [logits], []
        cache = model.cache(hi - lo, S + job.steps)
        model.fill_cache(cache, k, v, state)
        for i in range(job.steps):
            nxt = (logits.argmax(-1).int() if job.feed is None
                   else job.feed[lo:hi, i].to(device))
            fed.append(nxt)
            pos = torch.full((hi - lo,), S + i, dtype=torch.int32,
                             device=device)
            logits = model.decode_step(cache, nxt[:, None], pos,
                                       global_rows=B)
            out.append(logits)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        drops = [(int(d), n) for d, n in moe.drop_log]
    finally:
        moe.drop_log = None
    cpu = lambda t: None if t is None else t.cpu()
    rec = dict(rank=getattr(mesh, "rank", 0),
               coords=list(getattr(mesh, "coords", (0, 0))), rows=(lo, hi),
               logits=torch.stack(out).cpu(),
               fed=(torch.stack(fed, 1).cpu() if fed
                    else torch.zeros((hi - lo, 0), dtype=torch.int32)),
               k=cpu(k), v=cpu(v), cache_k=cpu(cache.get("k")),
               cache_v=cpu(cache.get("v")),
               state=state and {n: t.cpu() for n, t in state.items()},
               cache_state=state and {n: cache[n].cpu() for n in state},
               counts=ops.counts(), collectives=C.stats(),
               moe_pairs=sum(n for _, n in drops),
               moe_dropped=sum(d for d, _ in drops), seconds=seconds,
               peak_bytes=_peak(device), foreign=foreign_modules())
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
    """What a rank prints: its launches by variant and with a query
    offset, plain calls, collectives, dropped pairs, seconds, peak device
    memory and foreign modules."""
    c = rec["counts"]
    return dict(rank=rec["rank"], coords=rec["coords"], rows=rec["rows"],
                launches={k: n for k, n in c["launches"].items() if n},
                launches_by_variant={k: {v: n for v, n in by.items() if n}
                                     for k, by in
                                     c["launches_by_variant"].items()
                                     if any(by.values())},
                launches_with_offset={k: n for k, n in
                                      c["launches_with_offset"].items()
                                      if n},
                plain_calls={k: n for k, n in c["plain_calls"].items() if n},
                collectives=rec["collectives"],
                moe_pairs=rec["moe_pairs"], moe_dropped=rec["moe_dropped"],
                seconds=rec["seconds"], peak_bytes=rec["peak_bytes"],
                foreign=rec["foreign"])


# ---------------------------------------------------------------------------
# One rank's training steps
# ---------------------------------------------------------------------------

# within which a train run on the mesh is the one process's, by the
# config's family (None: every family without an entry of its own) and
# dtype (:func:`train_limits`): each step's loss and grad norm relative to
# the one process's, and the largest error of any leaf of the gradients at
# the starting weights and of the parameters after the steps over that
# leaf's largest magnitude. bf16: the products' partial sums move with the
# split. Each is 2-10 times the largest that sound runs on the H100
# showed (PERF.md): qwen3-8b bf16 2.5e-5, 1.2e-4, 2.4e-2 and 4.0e-3,
# moonshot f32 1.8e-7, 5.9e-7, 6.3e-6 and 9.7e-8. A gradient scaled by
# the data or model axis (a wrong transpose) is off by half the leaf's
# magnitude or more. mamba2 ("ssm"): in bf16 its scan's bf16 operands put
# its gradients 1-2% of their norm off f32's, and the split moves that
# rounding. Each of its limits lies between the largest reading of its
# sound runs on the H100 and that of a run with a planted fault (PERF.md):
# bf16 6.2e-7, 6.0e-4, 7.4e-2, 3.6e-3 against 1.4e-5, 3.8e-3, 0.64,
# 1.8e-2; f32 8.8e-8, 8.5e-7, 6.3e-5, 2.1e-7 against 7.4e-6, 2.8e-3,
# 0.81, 2.4e-4.
TRAIN_LIMITS = {
    (None, torch.bfloat16): dict(loss=1e-4, grad_norm=5e-4, grads=5e-2,
                                 params=1e-2),
    (None, torch.float32): dict(loss=1e-6, grad_norm=2e-6, grads=5e-5,
                                params=1e-6),
    ("ssm", torch.bfloat16): dict(loss=5e-6, grad_norm=1.5e-3, grads=2e-1,
                                  params=1e-2),
    ("ssm", torch.float32): dict(loss=1e-6, grad_norm=2e-6, grads=2e-4,
                                 params=1e-6)}
# the AdamW state a train job without a state file starts from
# (:func:`warm_state`): this many steps in, its moments drawn from the seed
WARM_STEP = 3


@dataclasses.dataclass
class TrainJob:
    """``steps`` AdamW steps (``opt``) on the batch ``tokens`` [B, S]
    (int32, on the CPU; the labels are the tokens shifted by one) and its
    modality inputs ``extras`` (as :class:`Job`'s), each step's batch cut
    into ``n_micro`` microbatches of each rank's rows. ``params`` /
    ``opt_state``: files holding the whole parameter tree and AdamW state
    (``torch.save``), else the weights drawn from ``seed`` and
    :func:`warm_state`. ``mode``: the sharding mode of the model on the
    mesh."""
    cfg: ArchConfig
    tokens: torch.Tensor
    steps: int = 2
    n_micro: int = 1
    opt: Any = None
    params: Optional[str] = None
    opt_state: Optional[str] = None
    seed: int = 0
    extras: Optional[Dict[str, torch.Tensor]] = None
    mode: str = "tp_sp"


def train_batch(ctx, tokens: torch.Tensor, device,
                extras=None) -> Dict[str, Any]:
    """This rank's rows (:func:`batch_rows`) of ``tokens`` [B, S], of
    their labels, the tokens shifted by one, and of the modality inputs
    ``extras``, on ``device``."""
    lo, hi = batch_rows(ctx, tokens.shape[0])
    labels = torch.roll(tokens, -1, 1)
    return {"tokens": tokens[lo:hi].to(device),
            "labels": labels[lo:hi].to(device),
            **(rows_of(extras, lo, hi, device) or {})}


def warm_state(model, opt_cfg, seed: int) -> Dict[str, Any]:
    """An AdamW state :data:`WARM_STEP` steps in, this rank's blocks of
    it: ``m`` ~ N(0, 1e-3) and ``v`` ~ U(1e-6, 1e-4) in f32 (and a zero
    residual when compressing), each leaf drawn whole from ``seed`` on the
    parameters' device, alike on every rank and in one process. From zero
    moments the first step moves each element by about lr sign(g), which
    flips where g is near 0, so two runs whose gradients differ in the
    last bits move such elements 2 lr apart; from these the update is
    smooth in the gradient. Each leaf is cut as its parameter is (the head
    layout's blocks of the attention's leaves)."""
    from repro_torch.tree import leaves, leaves_with_paths, unflatten
    pspecs = _spec_leaves(model.param_pspecs())
    whole = leaves_with_paths(model.abstract_params())
    dev = leaves(model.param_tree())[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    ctx = model.ctx

    def draw(fill):
        return [ctx.local_block(fill(torch.empty(w.shape, dtype=torch.float32,
                                                 device=dev)), spec, path)
                for (path, w), spec in zip(whole, pspecs)]

    tree = model.param_tree()
    state = {"m": unflatten(tree, draw(
                 lambda t: t.normal_(0.0, 1e-3, generator=gen))),
             "v": unflatten(tree, draw(
                 lambda t: t.uniform_(1e-6, 1e-4, generator=gen))),
             "step": torch.tensor(WARM_STEP, dtype=torch.int32, device=dev)}
    if opt_cfg.compression != "none":
        state["ef"] = unflatten(tree, draw(torch.Tensor.zero_))
    return state


def train(mesh, device: torch.device, job: TrainJob) -> Dict[str, Any]:
    """One rank's training in ``job.mode`` (``mesh`` None: one process,
    where the mode changes nothing). Returns its
    record: ``grads``, its blocks of the gradient at the starting weights
    (taken before the steps; the counts and ``seconds`` cover the steps
    alone), and
    ``grad_loss``, that pass's loss; each step's ``losses`` and
    ``grad_norms`` (the batch's, the same on every rank); its blocks of
    the updated ``params`` (the model's own tensors; ``grads`` too are on
    ``device``); its launches by variant, plain calls, collectives,
    dropped MoE pairs, seconds, peak device memory (from the model's
    build on) and foreign modules; the other tensors on the CPU."""
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, moe
    from repro_torch.training.optimizer import OptConfig, opt_pspecs
    from repro_torch.training.train_step import (loss_and_grads,
                                                 make_train_step)
    _reset_peak(device)
    params = (None if job.params is None
              else torch.load(job.params, map_location=device))
    model = build_model(job.cfg, params, device=device, seed=job.seed,
                        trainable=True, mesh=mesh, mode=job.mode)
    del params
    ctx = model.ctx
    opt_cfg = job.opt or OptConfig()
    if job.opt_state is None:
        state = warm_state(model, opt_cfg, job.seed)
    else:
        state = ctx.shard_tree(
            torch.load(job.opt_state, map_location=device),
            opt_pspecs(model.param_pspecs(), opt_cfg.compression))
    B = job.tokens.shape[0]
    batch = train_batch(ctx, job.tokens, device, job.extras)
    with torch.enable_grad():
        grad_loss, grads = loss_and_grads(model, batch, B)
    grad_loss = C.all_reduce_sum(grad_loss, "batch", ctx).cpu()
    model.zero_grad(set_to_none=True)
    step = make_train_step(model, opt_cfg, job.n_micro, B)
    ops.reset_counts()
    C.reset_stats()
    moe.drop_log = []
    t0 = time.perf_counter()
    try:
        with torch.enable_grad():
            losses, norms = [], []
            for _ in range(job.steps):
                _, state, metrics = step(model.param_tree(), state, batch)
                losses.append(metrics["loss"])
                norms.append(metrics["grad_norm"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        drops = [(int(d), n) for d, n in moe.drop_log]
    finally:
        moe.drop_log = None
    return dict(rank=getattr(mesh, "rank", 0),
                coords=list(getattr(mesh, "coords", (0, 0))),
                rows=batch_rows(ctx, B), grads=grads, grad_loss=grad_loss,
                losses=torch.stack(losses).cpu(),
                grad_norms=torch.stack(norms).cpu(),
                params=model.param_tree(), counts=ops.counts(),
                collectives=C.stats(), moe_pairs=sum(n for _, n in drops),
                moe_dropped=sum(d for d, _ in drops), seconds=seconds,
                peak_bytes=_peak(device), foreign=foreign_modules())


def whole(records: List[Dict[str, Any]], key: str, cfg: ArchConfig,
          shape: Sequence[int], device=None, mode: str = "tp_sp"):
    """The whole tree of ``key`` (``"params"`` or ``"grads"``) put back
    together on ``device`` (default: the blocks') from the ranks' blocks,
    each placed where its leaf's partition spec and the head layout put
    it on the ``shape`` mesh in sharding mode ``mode``
    (:meth:`~repro_torch.distributed.sharding.ShardingCtx.block_slices`;
    ``fsdp_cp`` cuts no head layout); and whether every rank's block equals the
    whole's at its place (the replicas of a leaf, a shared KV block's
    among them, agree bitwise)."""
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.mesh import LocalMesh
    from repro_torch.models.common import abstract_tree, param_specs
    from repro_torch.models.transformer import sharding_ctx
    from repro_torch.tree import leaves, leaves_with_paths, unflatten
    mesh_of = lambda r: LocalMesh(("data", "model"), tuple(shape),
                                  rank=r["rank"], coords=tuple(r["coords"]))
    specs = _spec_leaves(param_shardings(mesh_of(records[0]),
                                         param_specs(cfg)))
    shapes = [t.shape for t in leaves(abstract_tree(param_specs(cfg)))]
    blocks = [(sharding_ctx(cfg, mesh_of(r), mode), leaves(r[key]))
              for r in records]
    paths = [p for p, _ in leaves_with_paths(records[0][key])]
    parts, agree = [], True
    for i, (spec, path) in enumerate(zip(specs, paths)):
        ref = blocks[0][1][i]
        out = torch.empty(shapes[i], dtype=ref.dtype,
                          device=device or ref.device)
        places = []
        for ctx, bl in blocks:
            idx = tuple(slice(lo, hi) for lo, hi in
                        ctx.block_slices(shapes[i], spec, path))
            places.append((idx, bl[i].to(out.device)))
            out[idx] = places[-1][1]
        agree &= all(torch.equal(out[idx], b) for idx, b in places)
        parts.append(out)
    return unflatten(records[0][key], parts), agree


def _spec_leaves(tree) -> List[tuple]:
    """The partition specs of a spec tree in the order of
    :func:`repro_torch.tree.leaves` (dict keys sorted)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [s for t in tree for s in _spec_leaves(t)]
    return [tree]


def leaf_scaled_err(got, want) -> Tuple[float, str]:
    """The largest over the leaves of a tree of each leaf's largest error
    over its largest magnitude, and that leaf's path."""
    from repro_torch.tree import leaves_with_paths
    return max((float((g.float() - w.float()).abs().max()
                      / w.float().abs().max().clamp_min(1e-30)), path)
               for (path, g), (_, w) in zip(leaves_with_paths(got),
                                            leaves_with_paths(want)))


def train_limits(cfg: ArchConfig) -> Dict[str, float]:
    """:data:`TRAIN_LIMITS` of ``cfg``'s family and dtype, else of its
    dtype."""
    return TRAIN_LIMITS.get((cfg.family, cfg.dtype),
                            TRAIN_LIMITS[(None, cfg.dtype)])


def check_train(records: List[Dict[str, Any]], single: Dict[str, Any],
                job: TrainJob, shape: Sequence[int]) -> Dict[str, Any]:
    """The ranks' training against the same training in one process:
    ``ok`` when each step's loss and grad norm, the gradients at the
    starting weights and the parameters after the steps (both put back
    together from the ranks' blocks, each leaf's error over its largest
    magnitude) are within :func:`train_limits` of the one process's,
    every rank reports the same losses and norms, the replicas of each
    leaf of both agree bitwise, and no rank loaded a foreign module."""
    from repro_torch.tree import leaves
    limits = train_limits(job.cfg)
    rel = lambda a, b: float(((a - b).abs() / b.abs().clamp_min(1e-30))
                             .max())
    dev = leaves(single["params"])[0].device
    grads, grads_agree = whole(records, "grads", job.cfg, shape, dev,
                               job.mode)
    grad_err, grad_leaf = leaf_scaled_err(grads, single["grads"])
    del grads
    params, agree = whole(records, "params", job.cfg, shape, dev, job.mode)
    param_err, param_leaf = leaf_scaled_err(params, single["params"])
    del params
    same = all(torch.equal(r["losses"], records[0]["losses"])
               and torch.equal(r["grad_norms"], records[0]["grad_norms"])
               for r in records)
    res = dict(losses=records[0]["losses"].tolist(),
               losses_one_process=single["losses"].tolist(),
               grad_norms=records[0]["grad_norms"].tolist(),
               grad_norms_one_process=single["grad_norms"].tolist(),
               loss_rel_err=rel(records[0]["losses"], single["losses"]),
               grad_norm_rel_err=rel(records[0]["grad_norms"],
                                     single["grad_norms"]),
               grads_leaf_scaled_err=grad_err, grads_worst_leaf=grad_leaf,
               params_leaf_scaled_err=param_err,
               params_worst_leaf=param_leaf, limits=limits,
               ranks_agree=same, replicas_agree=agree and grads_agree,
               foreign=sorted({m for r in records for m in r["foreign"]}),
               dropped={"mesh": sum(r["moe_dropped"] for r in records),
                        "one_process": single["moe_dropped"]})
    res["ok"] = bool(res["loss_rel_err"] <= limits["loss"]
                     and res["grad_norm_rel_err"] <= limits["grad_norm"]
                     and grad_err <= limits["grads"]
                     and param_err <= limits["params"]
                     and same and res["replicas_agree"]
                     and not res["foreign"])
    return res


# ---------------------------------------------------------------------------
# One rank's cell steps: what the dry run's counting world predicts
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellJob:
    """``training.build_cell``'s step of ``cfg`` at each of ``shapes``
    (label -> shape dict), in turn on one trainable model drawn from
    ``seed``: what :mod:`repro_torch.launch.dryrun` counts on a fake world
    of the same mesh (:func:`~repro_torch.launch.mesh.counting_mesh`), in
    sharding mode ``mode``."""
    cfg: ArchConfig
    shapes: Dict[str, Any]
    seed: int = 0
    mode: str = "tp_sp"


def cell(mesh, device: torch.device, job: CellJob) -> Dict[str, Any]:
    """One rank's steps of ``job``: each shape's step once, with the
    device's peak reset (run after jobs of the same models, the smoke's
    mesh phase holds no first-use allocation in it). Returns per label the
    arguments' bytes, the step's peak (the arguments plus the most the
    step allocated above what was resident before it; None on the CPU),
    the collectives it made (``collectives.stats()``) and its launches;
    the seconds of the whole job, the model's build included, and the
    foreign modules."""
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import ops
    from repro_torch.launch.counter import tensor_bytes
    from repro_torch.models import build_model
    from repro_torch.training.train_step import build_cell
    t0 = time.perf_counter()
    model = build_model(job.cfg, device=device, seed=job.seed,
                        trainable=True, mesh=mesh, mode=job.mode)
    out = {}
    for label, shape in job.shapes.items():
        gen = torch.Generator(device=device).manual_seed(job.seed)
        step, args = build_cell(model, shape, generator=gen)
        with torch.set_grad_enabled(shape["kind"] == "train"):
            cuda = device.type == "cuda"
            if cuda:
                torch.cuda.synchronize(device)
                base = torch.cuda.memory_allocated(device)
            _reset_peak(device)
            C.reset_stats()
            ops.reset_counts()
            res = step(*args)
            if cuda:
                torch.cuda.synchronize(device)
        arg_bytes = tensor_bytes(args)
        out[label] = dict(
            argument_bytes=arg_bytes,
            peak_bytes=(arg_bytes + _peak(device) - base if cuda else None),
            collectives=C.stats(),
            launches={k: n for k, n in ops.counts()["launches"].items()
                      if n})
        del res, step, args
    return dict(rank=getattr(mesh, "rank", 0),
                coords=list(getattr(mesh, "coords", (0, 0))), cells=out,
                seconds=time.perf_counter() - t0, foreign=foreign_modules())


# ---------------------------------------------------------------------------
# Jobs on the mesh, then in one process
# ---------------------------------------------------------------------------

# the trees of a train record: its gradient and parameter blocks
TREES = ("grads", "params")


def _gather_trees(mesh, device: torch.device, rec: Dict[str, Any]
                  ) -> Optional[List[Dict[str, Any]]]:
    """Every rank's train record with its :data:`TREES` on rank 0, on the
    CPU, each leaf of another rank sent over the world's default group (on
    the CPU where it is gloo's, else on ``device``); None on the other
    ranks, which send theirs."""
    import torch.distributed as dist
    from repro_torch.tree import leaves, tree_map, unflatten
    via = torch.device("cpu") if dist.get_backend() == "gloo" else device
    if mesh.rank:
        small = {k: v for k, v in rec.items() if k not in TREES}
        small["shapes"] = {key: [(tuple(t.shape), t.dtype)
                                 for t in leaves(rec[key])] for key in TREES}
        dist.send_object_list([small], dst=0)
        for key in TREES:
            for t in leaves(rec[key]):
                dist.send(t.detach().to(via).contiguous(), dst=0)
        return None
    out = [{**rec, **{key: tree_map(lambda t: t.detach().cpu(), rec[key])
                      for key in TREES}}]
    for src in range(1, mesh.size):
        got = [None]
        dist.recv_object_list(got, src=src)
        r = got[0]
        for key, shapes in r.pop("shapes").items():
            blocks = []
            for shape, dtype in shapes:
                t = torch.empty(shape, dtype=dtype, device=via)
                dist.recv(t, src=src)
                blocks.append(t.cpu())
            r[key] = unflatten(rec[key], blocks)
        out.append(r)
    return out


def train_checked(mesh, device: torch.device, job: TrainJob
                  ) -> Dict[str, Any]:
    """One rank's :func:`train` of ``job``, then on rank 0 the check of all
    ranks' records: their blocks gathered there (:func:`_gather_trees`),
    the same job trained in this process with no mesh, and
    :func:`check_train`. Returns the rank's record without its
    :data:`TREES`; rank 0's holds under ``"train_check"`` the check, the
    one process's record without its trees, and the seconds of the one
    process's run and of the check."""
    rec = train(mesh, device, job)
    records = _gather_trees(mesh, device, rec)
    if records is not None:
        t1 = time.perf_counter()
        single = train(None, device, job)
        t2 = time.perf_counter()
        chk = check_train(records, single, job, mesh.axis_sizes)
        rec["train_check"] = dict(
            check=chk, one_process_seconds=t2 - t1,
            check_seconds=time.perf_counter() - t2,
            single={k: v for k, v in single.items() if k not in TREES})
        del records, single
    return {k: v for k, v in rec.items() if k not in TREES}


def work_all(mesh, device: torch.device, jobs: Sequence[Any]
             ) -> List[Dict[str, Any]]:
    """Each job in turn on one spawn of the ranks: :func:`serve` of a
    :class:`Job`, :func:`train_checked` of a :class:`TrainJob` (checked in
    rank 0), :func:`cell` of a :class:`CellJob`."""
    out = []
    for job in jobs:
        if isinstance(job, CellJob):
            rec = cell(mesh, device, job)
        elif isinstance(job, TrainJob):
            rec = train_checked(mesh, device, job)
        else:
            rec = serve(mesh, device, job)
        out.append(rec)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def run(jobs: Sequence[Any], shape: Sequence[int], *, device: str = "cuda",
        threads: Optional[int] = None) -> Tuple[str, List[Dict[str, Any]]]:
    """The jobs (:class:`Job`, :class:`TrainJob` and :class:`CellJob`) on
    one spawn of a ``shape`` mesh, then each serving job in this process
    (fed the tokens the mesh fed), and the checks; a train job is trained
    in one process and checked in rank 0's (:func:`train_checked`), and
    a cell job's records are its ranks' alone (its ``check`` and
    ``single`` None: the caller holds them to the dry run's count).
    Returns (backend, per job ``{"mesh_seconds", "one_process_seconds",
    "check_seconds", "ranks": [rank_line], "check", "records",
    "single"}``); ``mesh_seconds`` is the spawn's, all jobs together (a
    train job's one-process run among them), and a train job's records
    and one-process record come without their gradients and
    parameters."""
    from repro_torch.launch import spmd     # see launch
    t0 = time.perf_counter()
    backend, per_rank = launch(spmd.work_all, shape, (list(jobs),),
                               device=device, threads=threads)
    mesh_s = time.perf_counter() - t0
    dev = torch.device(device)
    out = []
    for i, job in enumerate(jobs):
        records = [r[i] for r in per_rank]
        t1 = time.perf_counter()
        if isinstance(job, CellJob):
            out.append(dict(mesh_seconds=mesh_s, records=records,
                            check=None, single=None))
            continue
        if isinstance(job, TrainJob):
            tc = records[0].pop("train_check")
            out.append(dict(mesh_seconds=mesh_s,
                            one_process_seconds=tc["one_process_seconds"],
                            check_seconds=tc["check_seconds"],
                            ranks=[rank_line(r) for r in records],
                            check=tc["check"], records=records,
                            single=tc["single"]))
            continue
        single = serve(None, dev, dataclasses.replace(
            job, feed=gather_rows(records, "fed", dim=0)))
        t2 = time.perf_counter()
        chk = check(records, single)
        if device == "cuda":
            torch.cuda.empty_cache()
        out.append(dict(mesh_seconds=mesh_s, one_process_seconds=t2 - t1,
                        check_seconds=time.perf_counter() - t2,
                        ranks=[rank_line(r) for r in records], check=chk,
                        records=records, single=single))
    return backend, out


def main(argv=None) -> int:
    from repro_torch.configs import get_config
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", required=True, help="DxM: data x model ranks")
    ap.add_argument("--shape", choices=["prefill", "decode", "train"],
                    default="decode")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced widths (f32)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--mode", choices=list(MODES), default="tp_sp",
                    help="the sharding mode of the ranks' model")
    args = ap.parse_args(argv)
    data, model = (int(n) for n in args.mesh.lower().split("x"))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    cfg = dropless(cfg)
    batch, seq = 2, (16 if args.reduced else 1024)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           dtype=torch.int32)
    extras = modality_extras(cfg, batch, gen)
    steps = {"decode": 8, "prefill": 0, "train": 2}[args.shape]
    backend = backend_for(data * model, args.device)
    print(json.dumps({"spmd": "backend", "backend": backend,
                      "mesh": [data, model], "device": args.device}),
          flush=True)
    # by the package's name: its classes pickle (see launch)
    from repro_torch.launch import spmd
    if args.shape == "train":
        from repro_torch.training.optimizer import OptConfig
        job = spmd.TrainJob(cfg, tokens, steps,
                            opt=OptConfig(lr=TRAIN_LR, warmup_steps=1),
                            extras=extras, mode=args.mode)
    else:
        job = spmd.Job(cfg, tokens, steps, extras=extras, mode=args.mode)
    _, (out,) = spmd.run([job], (data, model), device=args.device)
    for line in out["ranks"]:
        print(json.dumps({"spmd": "rank", **line}), flush=True)
    print(json.dumps({"spmd": "check", "arch": cfg.name,
                      "layers": cfg.n_layers, "batch": batch, "seq": seq,
                      "steps": steps, "mode": args.mode,
                      "mesh_seconds": out["mesh_seconds"],
                      **out["check"]}), flush=True)
    return 0 if out["check"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
