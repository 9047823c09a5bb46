"""The rank side of ``test_torch_mesh.py``: what each spawned rank runs.

Imports the port alone (a rank must load neither JAX nor the JAX
package), so that ``torch.multiprocessing``'s spawn can unpickle
:func:`run_cases` in a fresh process.
"""
import torch

from repro_torch.distributed import collectives as C
from repro_torch.launch import spmd
from repro_torch.models import build_model, moe


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
