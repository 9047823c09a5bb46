"""The model's collectives over the axes of a live mesh: the only calls
into ``torch.distributed`` that the model makes.

Each takes the tensor, the logical axis it runs over (``"fsdp"`` /
``"batch"`` over data, ``"tp"`` / ``"exp"`` over model; see
:mod:`repro_torch.distributed.sharding`) and the context that maps it to
this rank's process group. On an axis of one rank (no mesh, a 1 x 1 mesh,
or the other axis's line), or on a mesh that is data, each returns its
input and makes no call.

Each is a function of its input alone, returning a new tensor (the
all-reduce reduces into its input where that is contiguous and returns
it), so that a later autograd wrapper can pair it with its transpose
(all-gather with reduce-scatter, all-to-all with the reverse all-to-all).

:func:`stats` counts the calls and payload bytes by kind and mesh axis:
the all-gather's output, the all-reduce's tensor and the all-to-all's
input, on this rank.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch

_stats: Dict[str, Dict[str, Dict[str, int]]] = defaultdict(
    lambda: defaultdict(lambda: {"calls": 0, "bytes": 0}))


def stats() -> Dict[str, Dict[str, Dict[str, int]]]:
    """``{kind: {mesh axis: {"calls", "bytes"}}}`` since the last
    :func:`reset_stats`, as plain dicts."""
    return {k: {a: dict(v) for a, v in by.items()} for k, by in
            _stats.items()}


def reset_stats() -> None:
    _stats.clear()


def _line(ctx, logical: str):
    """(process group, ranks on it, mesh axis) of ``logical``'s line
    through this rank, or None where the line is this rank alone (or the
    mesh is data: the dry run's production meshes)."""
    if ctx is None or not ctx.live or ctx.axis_size(logical) == 1:
        return None
    return ctx.group(logical), ctx.axis_size(logical), ctx.rules[logical]


def _count(kind: str, axis: str, t: torch.Tensor) -> None:
    s = _stats[kind][axis]
    s["calls"] += 1
    s["bytes"] += t.numel() * t.element_size()


def all_gather(x: torch.Tensor, logical: str, dim: int,
               ctx) -> torch.Tensor:
    """The blocks of ``x`` on the ranks of ``logical``'s line,
    concatenated along ``dim`` in rank order (``lax.all_gather(...,
    tiled=True)``)."""
    line = _line(ctx, logical)
    if line is None:
        return x
    group, n, axis = line
    import torch.distributed as dist
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    out = torch.cat(parts, dim=dim)
    _count("all_gather", axis, out)
    return out


def all_reduce_sum(x: torch.Tensor, logical: str, ctx) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``logical``'s line (``lax.psum``):
    every rank gets the same bits."""
    line = _line(ctx, logical)
    if line is None:
        return x
    group, _, axis = line
    import torch.distributed as dist
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    _count("all_reduce", axis, x)
    return x


def all_to_all(x: torch.Tensor, logical: str, split_axis: int,
               concat_axis: int, ctx) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``x`` cut into ``n`` equal blocks along ``split_axis``, block ``j``
    sent to the line's ``j``-th rank, and the blocks received
    concatenated along ``concat_axis`` in source-rank order."""
    line = _line(ctx, logical)
    if line is None:
        return x
    group, n, axis = line
    import torch.distributed as dist
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all over {n} ranks cannot split dim "
                         f"{split_axis} of {tuple(x.shape)}")
    xs = x.movedim(split_axis, 0)
    send = xs.reshape(n, xs.shape[0] // n, *xs.shape[1:]).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    _count("all_to_all", axis, send)
    return torch.cat([recv[j].movedim(0, split_axis) for j in range(n)],
                     dim=concat_axis)
