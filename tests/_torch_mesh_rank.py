"""The rank side of ``test_torch_mesh.py``, ``test_torch_mesh_train.py``
and ``test_torch_mesh_families.py``: what each spawned rank runs.

Imports the port alone (a rank must load neither JAX nor the JAX
package), so that ``torch.multiprocessing``'s spawn can unpickle
:func:`run_cases` in a fresh process.
"""
import dataclasses
from typing import Any

import torch

from repro_torch.distributed import collectives as C
from repro_torch.launch import spmd
from repro_torch.models import build_model, moe
from repro_torch.models import layers as L


def probe_collectives(mesh):
    """The three collectives over ``model`` on a rank-tagged [4, 2, 3]
    tensor (its elements plus 100 times the rank)."""
    from repro_torch.distributed.sharding import ShardingCtx
    ctx = ShardingCtx(mesh)
    x = torch.arange(24, dtype=torch.float32).reshape(4, 2, 3) + 100 * mesh.rank
    return {"all_to_all": C.all_to_all(x, "exp", 0, 1, ctx),
            "all_gather": C.all_gather(x, "tp", 1, ctx),
            "all_reduce": C.all_reduce_sum(x.clone(), "tp", ctx)}


def run_cases(mesh, device, cases):
    """Every case of one mesh. ``cases``: per model name ``{"jobs": {B:
    spmd.Job}, "moe_x": [B, S, D] or None, "params": path}``. Returns per
    model the jobs' records and, for a MoE, this rank's rows of layer 0's
    MoE output on ``moe_x``; and the collectives' probe."""
    out = {"rank": mesh.rank, "probe": probe_collectives(mesh)}
    for name, case in cases.items():
        res = {"jobs": {B: spmd.serve(mesh, device, job)
                        for B, job in case["jobs"].items()}}
        if case["moe_x"] is not None:
            job = next(iter(case["jobs"].values()))
            model = build_model(job.cfg, torch.load(case["params"]),
                                device=device, mesh=mesh)
            x = case["moe_x"]
            lo, hi = spmd.batch_rows(model.ctx, x.shape[0])
            y = moe.moe_apply(model.layers[0].moe, x[lo:hi], job.cfg,
                              model.ctx)
            res["moe"] = ((lo, hi), y)
        out[name] = res
    return out


def probe_transposes(mesh):
    """Each collective's autograd pair on a rank-tagged [1, 4, 2, 3] block
    (rank r: its elements plus 100 r) with the cotangent the matching
    ``jax.vjp`` is fed: per rank ``{kind: (output, input cotangent)}``.
    The cotangent is ``ct`` (rank-tagged, 1000 + the elements plus 10 r)
    where the output differs across the line's ranks, and ``ct``'s block
    of this rank's data index, whole over ``model``, where the output is
    replicated over ``model`` (``gather_block``, ``all_reduce``)."""
    from repro_torch.distributed.sharding import ShardingCtx
    ctx = ShardingCtx(mesh)
    tp = mesh.axis_sizes[1]
    base = torch.arange(24, dtype=torch.float32).reshape(1, 4, 2, 3)
    out = {}
    for kind in ("gather_sum", "gather_block", "all_reduce", "enter",
                 "all_to_all", "reduce_scatter", "all_reduce_max"):
        x = (base + 100 * mesh.rank).requires_grad_(True)
        if kind == "gather_sum":
            y = C.all_gather(x, "tp", 2, ctx)
        elif kind == "gather_block":
            y = C.all_gather(x, "tp", 2, ctx, grad="block")
        elif kind == "all_reduce":
            y = C.all_reduce_sum(x, "tp", ctx)
        elif kind == "enter":
            x = (base + 100 * mesh.coords[0]).requires_grad_(True)
            y = C.enter(x, "tp", ctx) * 1.0
        elif kind == "all_to_all":
            y = C.all_to_all(x, "exp", 1, 2, ctx)
        elif kind == "reduce_scatter":
            y = C.reduce_scatter(x, "tp", 1, ctx)
        else:
            out[kind] = (C.all_reduce_max(x, "tp", ctx), None)
            continue
        if kind in ("gather_block", "all_reduce"):
            who = mesh.coords[0] * tp
        else:
            who = mesh.rank
        ct = torch.arange(y.numel(), dtype=torch.float32).reshape(
            y.shape) + 1000 + 10 * who
        y.backward(ct)
        out[kind] = (y.detach(), x.grad)
    return out


def probe_int8(mesh, cfg):
    """int8 compression of this rank's blocks of a gradient tree (the
    model's weights drawn from seed 0, times 1e-3) with a zero residual:
    the decompressed blocks and the new residual's."""
    from repro_torch.training.optimizer import OptConfig, adamw_init, \
        compress_grads
    from repro_torch.tree import tree_map
    model = build_model(cfg, device="cpu", seed=0, mesh=mesh)
    grads = tree_map(lambda p: p * 1e-3, model.param_tree())
    state = adamw_init(grads, "int8")
    q, state = compress_grads(grads, state, OptConfig(compression="int8"),
                              model.ctx, model.placements())
    return q, state["ef"]


def train_record(mesh, device, job):
    """:func:`spmd.train` of ``job`` on this rank, its gradient and
    parameter blocks on the CPU."""
    from repro_torch.tree import tree_map
    rec = spmd.train(mesh, device, job)
    for key in spmd.TREES:
        rec[key] = tree_map(lambda t: t.detach().cpu(), rec[key])
    return rec


def run_train_cases(mesh, device, cases, int8_cfg=None):
    """Every training case of one mesh: ``cases`` ``{key:
    spmd.TrainJob}``; returns ``{key: record}`` (:func:`spmd.train`'s,
    with its ``grad_loss`` and ``grads`` at the starting weights), the
    transposes' probe and, for ``int8_cfg``, :func:`probe_int8`'s."""
    out = {"rank": mesh.rank, "probe": probe_transposes(mesh)}
    if int8_cfg is not None:
        out["int8"] = probe_int8(mesh, int8_cfg)
    for key, job in cases.items():
        out[key] = spmd.train(mesh, device, job)
    return out


# ---------------------------------------------------------------------------
# test_torch_mesh_families.py: every family's serving and training, and the
# faults it plants
# ---------------------------------------------------------------------------

def _gated_norm_local(y, z, scale, cfg, ctx=None):
    """The planted fault: the gated norm's variance over this rank's
    channels alone."""
    import torch.nn.functional as F
    from repro_torch.models.common import rms_norm
    return rms_norm(y * F.silu(z), scale, cfg.norm_eps)


def _pre_wb_not_summed(p, x, cfg, ctx=None):
    """The planted fault: ``mamba2._pre`` with ``wB`` not entering the
    rank's heads, so its gradient is this rank's part alone."""
    import torch.nn.functional as F
    from repro_torch.models import mamba2 as M2
    from repro_torch.models.common import rms_norm
    s = cfg.ssm
    H = p["wdt"].shape[1]
    h = C.enter(rms_norm(x, p["ln"], cfg.norm_eps), "tp", ctx)
    Bm = (h @ p["wB"]).reshape(*h.shape[:-1], s.n_groups, s.d_state)
    Cm = (h @ C.enter(p["wC"], "tp", ctx)).reshape(
        *h.shape[:-1], s.n_groups, s.d_state)
    dt = F.softplus((h @ p["wdt"]).float() + p["dt_bias"])
    return (h @ p["wx"], h @ p["wz"], M2._groups(Bm, H, cfg, ctx),
            M2._groups(Cm, H, cfg, ctx), dt)


def _attn_full_kv_src_not_summed(p, x, cfg, positions, kv_src=None,
                                 causal=True, ctx=None):
    """The planted fault: ``layers.attn_full`` with the cross source not
    entering the rank's heads, so the encoder's output gets this rank's
    part of its gradient alone."""
    from repro_torch.kernels import ops
    from repro_torch.models.common import rms_norm
    if kv_src is None:
        return _ATTN_FULL(p, x, cfg, positions, causal=causal, ctx=ctx)
    h = C.enter(rms_norm(x, p["ln"], cfg.norm_eps), "tp", ctx)
    q, k, v = L._project_qkv(p, h, kv_src, cfg, True, ctx)
    o = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal)
    o = o.reshape(*x.shape[:-1], q.shape[-2] * cfg.head_dim_)
    return C.all_reduce_sum(o @ p["wo"], "tp", ctx), k, v


# the repaired function, which the planted one calls for self-attention
_ATTN_FULL = L.attn_full
# fault -> (module, attribute, planted version)
FAULTS = {"gated_norm_local": ("repro_torch.models.mamba2", "gated_norm",
                               _gated_norm_local),
          "wB_grad_not_summed": ("repro_torch.models.mamba2", "_pre",
                                 _pre_wb_not_summed),
          "kv_src_grad_not_summed": ("repro_torch.models.layers",
                                     "attn_full",
                                     _attn_full_kv_src_not_summed)}


@dataclasses.dataclass
class Cell:
    """A train cell of ``training.build_cell``: ``cfg`` at ``shape``, the
    weights and the batch drawn from ``seed``, ``steps`` AdamW steps."""
    cfg: Any
    shape: Any
    seed: int = 0
    steps: int = 2


def cell_steps(mesh, device, cell):
    """Each step's metrics (loss, grad norm) of ``cell`` on this rank."""
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_step import build_cell
    model = build_model(cell.cfg, device=device, seed=cell.seed,
                        trainable=True, mesh=mesh)
    step, args = build_cell(model, cell.shape,
                            OptConfig(lr=1e-2, warmup_steps=1),
                            generator=torch.Generator().manual_seed(
                                cell.seed))
    out = []
    for _ in range(cell.steps):
        _, _, metrics = step(*args)
        out.append({k: float(v) for k, v in metrics.items()})
    return out


def run_family_cases(mesh, device, cases):
    """Every case of one mesh: ``cases`` ``{key: (spmd.Job,
    spmd.TrainJob or Cell, fault or None, wide)}``; returns ``{key:
    record}`` (:func:`spmd.serve`'s, :func:`spmd.train`'s or
    :func:`cell_steps`'), each faulty case run with its :data:`FAULTS`
    entry planted and then removed, and each
    ``wide`` case (a float64 copy of a model) with the port's float32 cast
    points (``Tensor.float``, ``torch.float32``) widened to float64."""
    import importlib
    out = {}
    for key, (job, fault, wide) in cases.items():
        patches = []
        if fault is not None:
            name, attr, planted = FAULTS[fault]
            patches.append((importlib.import_module(name), attr, planted))
        if wide:
            patches += [(torch.Tensor, "float", torch.Tensor.double),
                        (torch, "float32", torch.float64)]
        saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
        for obj, attr, new in patches:
            setattr(obj, attr, new)
        try:
            if isinstance(job, Cell):
                out[key] = cell_steps(mesh, device, job)
            elif isinstance(job, spmd.TrainJob):
                out[key] = spmd.train(mesh, device, job)
            else:
                out[key] = spmd.serve(mesh, device, job)
        finally:
            for obj, attr, old in saved:
                setattr(obj, attr, old)
    return out


# ---------------------------------------------------------------------------
# test_torch_dryrun_mesh.py: a rank's count of build_cell's step
# ---------------------------------------------------------------------------

def count_step(mesh, device, cfg, shape, seed=0, mode="tp_sp"):
    """``training.build_cell``'s step of ``cfg`` at ``shape`` on this rank
    (weights and batch drawn from ``seed``) in sharding mode ``mode``, run
    once under ``launch.counter.Counter``: its cost, memory, kernels and
    collectives (``collectives.stats()`` of the step)."""
    from repro_torch.launch.counter import Counter
    from repro_torch.training.train_step import build_cell
    train = shape["kind"] == "train"
    model = build_model(cfg, device=device, seed=seed, trainable=train,
                        mesh=mesh, mode=mode)
    step, args = build_cell(model, shape,
                            generator=torch.Generator().manual_seed(seed))
    C.reset_stats()
    c = Counter()
    with torch.set_grad_enabled(train):
        mem = c.run(step, *args)
    return dict(cost=c.cost(), memory=mem, collectives=C.stats(),
                kernels={k: dict(v) for k, v in sorted(c.kernels.items())})


def count_cells(mesh, device, cases):
    """:func:`count_step` of each case ``{key: (cfg, shape[, mode])}`` on
    this rank."""
    return {key: count_step(mesh, device, *case[:2], mode=(
        case[2] if len(case) > 2 else "tp_sp")) for key, case in cases.items()}


# ---------------------------------------------------------------------------
# test_torch_mesh_modes.py: the sharding modes' serving and collective plans
# ---------------------------------------------------------------------------

@torch.no_grad()
def mode_plan(mesh, device, job):
    """One prefill of ``job`` (its rows of the prompts, in its mode), the
    move of its K/V into the decode cache, then one decode step: per phase
    (``"prefill"``, ``"decode"``) the collectives (``collectives.stats()``)
    and the shapes of every all-gather whose input is a parameter of the
    model (a weight gathered)."""
    model = build_model(job.cfg, torch.load(job.params), device=device,
                        mesh=mesh, mode=job.mode)
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    gathered = []
    gather = C._gather

    def spy(x, line, dim, backward=False):
        if x.untyped_storage().data_ptr() in params:
            gathered.append(tuple(x.shape))
        return gather(x, line, dim, backward)

    B, S = job.tokens.shape
    lo, hi = spmd.batch_rows(model.ctx, B)
    out = {}
    C._gather = spy
    try:
        C.reset_stats()
        logits, k, v, state = model.prefill_with_state(job.tokens[lo:hi])
        out["prefill"] = (C.stats(), list(gathered))
        cache = model.cache(hi - lo, S + 1)
        model.fill_cache(cache, k, v, state)
        C.reset_stats()
        gathered.clear()
        model.decode_step(cache, logits.argmax(-1).int()[:, None],
                          torch.full((hi - lo,), S, dtype=torch.int32),
                          global_rows=B)
        out["decode"] = (C.stats(), list(gathered))
    finally:
        C._gather = gather
    return out


def run_mode_cases(mesh, device, jobs, plans):
    """Each ``spmd.Job`` of ``jobs`` (``{key: Job}``) served, and
    :func:`mode_plan` of each of ``plans`` (``{key: Job}``)."""
    return {"jobs": {k: spmd.serve(mesh, device, j) for k, j in jobs.items()},
            "plans": {k: mode_plan(mesh, device, j)
                      for k, j in plans.items()}}
