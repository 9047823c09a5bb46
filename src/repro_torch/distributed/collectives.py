"""The model's collectives over the axes of a live mesh: the only calls
into ``torch.distributed`` that the model and the optimizer make.

Each takes the tensor, the logical axis it runs over (``"fsdp"`` /
``"batch"`` over data, ``"tp"`` / ``"exp"`` over model; see
:mod:`repro_torch.distributed.sharding`) and the context that maps it to
this rank's process group. On an axis of one rank (no mesh, a 1 x 1 mesh,
or the other axis's line), or on a mesh that is data, each returns its
input and makes no call.

Under autograd (grad enabled and an input that requires it) each runs as a
``torch.autograd.Function`` whose backward is its transpose. Which
transpose is right depends on whether the cotangent differs across the
line's ranks, so the call site says:

- :func:`all_gather` of a ZeRO-3 weight block (``grad="sum"``): the
  ranks' cotangents differ (each saw its own rows), and the backward is the
  reduce-scatter of their sum. Of blocks whose downstream is replicated
  over the line (``grad="block"``: the MoE output's sequence blocks, the
  logits), every rank holds the whole cotangent, and the backward keeps
  this rank's block; a reduce-scatter would multiply it by the line's
  size.
- :func:`all_reduce_sum` (a row-parallel product's partial sums, the
  vocab-parallel lookup and loss): the output is replicated, so is its
  cotangent, and the backward is the identity.
- :func:`enter`: the identity forward, where a tensor replicated over the
  line enters a computation that differs across its ranks (a
  column-parallel product, this rank's block of the sequence, a weight
  applied to this rank's heads or tokens); the backward is the all-reduce
  sum of the ranks' partial cotangents.
- :func:`all_to_all`: the backward is the reverse all-to-all.
- :func:`reduce_scatter`: the backward is the all-gather.
- :func:`all_reduce_max` has no gradient (the loss's row max, the int8
  compression's scale).

Without autograd the all-reduces reduce into their input where it is
contiguous and return it.

:func:`stats` counts the calls and payload bytes by kind and mesh axis:
the all-gather's output, the reduce-scatter's and the all-reduces'
input, the all-to-all's input, on this rank. A call made by a backward
pass counts under the kind it runs (an all-gather's backward is a
``reduce_scatter``) and also in ``"backward"``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch

_stats: Dict[str, Dict[str, Dict[str, int]]] = defaultdict(
    lambda: defaultdict(lambda: {"calls": 0, "bytes": 0, "backward": 0}))


def stats() -> Dict[str, Dict[str, Dict[str, int]]]:
    """``{kind: {mesh axis: {"calls", "bytes", "backward"}}}`` since the
    last :func:`reset_stats`, as plain dicts."""
    return {k: {a: dict(v) for a, v in by.items()} for k, by in
            _stats.items()}


def reset_stats() -> None:
    _stats.clear()


def _line(ctx, logical: str):
    """(process group, ranks on it, mesh axis, this rank's index on it) of
    ``logical``'s line through this rank, or None where the line is this
    rank alone (or the mesh is data: the dry run's production meshes)."""
    if ctx is None or not ctx.live or ctx.axis_size(logical) == 1:
        return None
    return (ctx.group(logical), ctx.axis_size(logical), ctx.rules[logical],
            ctx.index(logical))


def _count(kind: str, axis: str, t: torch.Tensor, backward: bool) -> None:
    s = _stats[kind][axis]
    s["calls"] += 1
    s["bytes"] += t.numel() * t.element_size()
    s["backward"] += int(backward)


def _autograd(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ---------------------------------------------------------------------------
# The calls themselves, on a line of more than one rank
# ---------------------------------------------------------------------------

def _gather(x, line, dim, backward=False):
    import torch.distributed as dist
    group, n, axis, _ = line
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    out = torch.cat(parts, dim=dim)
    _count("all_gather", axis, out, backward)
    return out


def _reduce(x, line, backward=False, kind="all_reduce"):
    """The sum (or, ``kind="all_reduce_max"``, the max) over the line,
    into ``x`` where it is contiguous."""
    import torch.distributed as dist
    group, _, axis, _ = line
    x = x.contiguous()
    op = dist.ReduceOp.MAX if kind == "all_reduce_max" else dist.ReduceOp.SUM
    dist.all_reduce(x, op=op, group=group)
    _count(kind, axis, x, backward)
    return x


def _scatter(x, line, dim, backward=False):
    """The sum over the line, cut along ``dim``; this rank's block
    (``reduce_scatter_tensor``, which gloo takes for CPU and CUDA tensors
    alike)."""
    import torch.distributed as dist
    group, n, axis, _ = line
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter over {n} ranks cannot split dim "
                         f"{dim} of {tuple(x.shape)}")
    size = x.shape[dim] // n
    _count("reduce_scatter", axis, x, backward)
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((size, *xs.shape[1:]))
    dist.reduce_scatter_tensor(out, xs, group=group)
    return out.movedim(0, dim).contiguous()


def _exchange(x, line, split_axis, concat_axis, backward=False):
    import torch.distributed as dist
    group, n, axis, _ = line
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all over {n} ranks cannot split dim "
                         f"{split_axis} of {tuple(x.shape)}")
    xs = x.movedim(split_axis, 0)
    send = xs.reshape(n, xs.shape[0] // n, *xs.shape[1:]).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    _count("all_to_all", axis, send, backward)
    return torch.cat([recv[j].movedim(0, split_axis) for j in range(n)],
                     dim=concat_axis)


def _block(g, line, dim):
    """This rank's block along ``dim`` of a tensor replicated over the
    line."""
    _, n, _, me = line
    size = g.shape[dim] // n
    return g.narrow(dim, me * size, size).contiguous()


# ---------------------------------------------------------------------------
# Their autograd pairs
# ---------------------------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, line, dim, grad):
        fctx.line, fctx.dim, fctx.grad = line, dim, grad
        return _gather(x, line, dim)

    @staticmethod
    def backward(fctx, g):
        if fctx.grad == "sum":
            g = _scatter(g, fctx.line, fctx.dim, backward=True)
        else:
            g = _block(g, fctx.line, fctx.dim)
        return g, None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, line):
        return _reduce(x.clone(memory_format=torch.contiguous_format), line)

    @staticmethod
    def backward(fctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, line):
        fctx.line = line
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return _reduce(g, fctx.line, backward=True), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, line, split_axis, concat_axis):
        fctx.line, fctx.axes = line, (split_axis, concat_axis)
        return _exchange(x, line, split_axis, concat_axis)

    @staticmethod
    def backward(fctx, g):
        split_axis, concat_axis = fctx.axes
        return (_exchange(g, fctx.line, concat_axis, split_axis,
                          backward=True), None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, line, dim):
        fctx.line, fctx.dim = line, dim
        return _scatter(x, line, dim)

    @staticmethod
    def backward(fctx, g):
        return _gather(g, fctx.line, fctx.dim, backward=True), None, None


# ---------------------------------------------------------------------------
# What the model calls
# ---------------------------------------------------------------------------

def all_gather(x: torch.Tensor, logical: str, dim: int, ctx,
               grad: str = "sum") -> torch.Tensor:
    """The blocks of ``x`` on the ranks of ``logical``'s line,
    concatenated along ``dim`` in rank order (``lax.all_gather(...,
    tiled=True)``). Backward: ``grad="sum"`` the reduce-scatter of the
    ranks' cotangents (a ZeRO-3 weight gather); ``grad="block"`` this
    rank's block of a cotangent replicated over the line."""
    if grad not in ("sum", "block"):
        raise ValueError(f"grad={grad!r}: 'sum' or 'block'")
    line = _line(ctx, logical)
    if line is None:
        return x
    if _autograd(x):
        return _AllGather.apply(x, line, dim, grad)
    return _gather(x, line, dim)


def all_reduce_sum(x: torch.Tensor, logical: str, ctx) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``logical``'s line (``lax.psum``):
    every rank gets the same bits. Backward: the identity."""
    line = _line(ctx, logical)
    if line is None:
        return x
    if _autograd(x):
        return _AllReduceSum.apply(x, line)
    return _reduce(x, line)


def enter(x: torch.Tensor, logical: str, ctx) -> torch.Tensor:
    """``x`` itself, replicated over ``logical``'s line, entering a
    computation that differs across its ranks. Backward: the all-reduce
    sum of the ranks' cotangents. No call without autograd."""
    line = _line(ctx, logical)
    if line is None or not _autograd(x):
        return x
    return _Enter.apply(x, line)


def all_to_all(x: torch.Tensor, logical: str, split_axis: int,
               concat_axis: int, ctx) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``x`` cut into ``n`` equal blocks along ``split_axis``, block ``j``
    sent to the line's ``j``-th rank, and the blocks received
    concatenated along ``concat_axis`` in source-rank order. Backward: the
    all-to-all with the two axes swapped."""
    line = _line(ctx, logical)
    if line is None:
        return x
    if _autograd(x):
        return _AllToAll.apply(x, line, split_axis, concat_axis)
    return _exchange(x, line, split_axis, concat_axis)


def reduce_scatter(x: torch.Tensor, logical: str, dim: int,
                   ctx) -> torch.Tensor:
    """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
    the sum of ``x`` over the line, this rank's block of it along ``dim``.
    Backward: the all-gather."""
    line = _line(ctx, logical)
    if line is None:
        return x
    if _autograd(x):
        return _ReduceScatter.apply(x, line, dim)
    return _scatter(x, line, dim)


def all_reduce_max(x: torch.Tensor, logical: str, ctx) -> torch.Tensor:
    """The elementwise max of ``x`` over the line (``lax.pmax``), into a
    copy, with no gradient."""
    line = _line(ctx, logical)
    if line is None:
        return x.detach()
    return _reduce(x.detach().clone(memory_format=torch.contiguous_format),
                   line, kind="all_reduce_max")
