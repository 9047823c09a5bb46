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
