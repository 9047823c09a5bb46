"""Roofline terms of a step, and the cost of each hand kernel: the port of
``repro/launch/roofline.py``.

Three terms per (arch x shape x mesh) cell, in seconds:

    compute    = flops_per_device        / peak_flops
    memory     = ideal_bytes_per_device  / hbm_bw
    collective = sum over mesh axes of that axis's link traffic per device
                 over its rate: NVLink for a line inside one node, the
                 network for one that leaves it

The counts come from :mod:`repro_torch.launch.counter` (the reference reads
XLA's ``cost_analysis`` and parses the optimized HLO for collectives; the
port has no HLO, so it has no HLO parsers). A collective term the port has
no source for is None: it is left out of the bound, which stays a lower
bound.

Hardware model: :data:`H100`, one NVIDIA H100 SXM -- 989 TFLOP/s dense
bf16, 3.35 TB/s HBM3, 80 GB, NVLink 450 GB/s a direction (NVIDIA data
sheet) -- in a DGX H100 node of 8 GPUs, each with one 400 Gb/s ConnectX-7
port to the network: 50 GB/s a direction (NVIDIA DGX H100 user guide).
A line of ranks within one node runs at NVLink's rate, one that leaves
it at the network's: the counterpart of the reference's ``ICI_BW``. On the
production meshes (16 x 16, rank ``d * 16 + m``) every ``model`` line and
every ``data`` line leaves its node; the ranks sharing a replicated KV
head (2 or 4 consecutive) do not.

The kernels' cost functions (``paged_cost``, ``chunk_cost``,
``flash_cost``, ``bwd_cost``, ``ssd_cost``, ``ssd_bwd_cost``) live beside
the kernels, in :mod:`repro_torch.kernels.cost`, and are re-exported here;
:func:`bound` turns a cost into the least time the card could take.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

from repro_torch.kernels.cost import (bwd_cost, chunk_cost,  # noqa: F401
                                      flash_cost, paged_cost, ssd_bwd_cost,
                                      ssd_cost)


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float   # dense bf16 per device, FLOP/s
    hbm_bw: float       # bytes/s per device
    hbm_cap: float      # bytes per device
    link_bw: float      # bytes/s per device and direction, within a node
    node_devices: int = 8       # devices a node holds (ranks r // 8 share)
    net_bw: float = 50e9        # bytes/s per device and direction, across

    def line_bw(self, ranks: Sequence[int]) -> float:
        """The rate of a line of ``ranks``: the link's where they share a
        node, the network's otherwise."""
        one_node = len({r // self.node_devices for r in ranks}) <= 1
        return self.link_bw if one_node else self.net_bw


H100 = Hardware("NVIDIA H100 SXM", peak_flops=989e12, hbm_bw=3.35e12,
                hbm_cap=80e9, link_bw=450e9, node_devices=8, net_bw=50e9)


def bound(n_bytes: float, n_flops: float, peak_flops: float = H100.peak_flops,
          hw: Hardware = H100):
    """(milliseconds, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the flops over ``peak_flops``."""
    t_bytes = n_bytes / hw.hbm_bw * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ step roofline
def _traffic(kind: str, out_bytes: int, n: int) -> float:
    """Per-device link bytes for ring algorithms.

    all-gather     : each device receives (n-1)/n of the gathered output
    all-reduce     : ring AR moves 2*(n-1)/n of the buffer through each
    reduce-scatter : each device receives its 1/n after (n-1)/n passes ~
                     out*(n-1) (out is the per-device scattered result)
    all-to-all     : (n-1)/n of the buffer leaves the device
    collective-permute : the whole buffer crosses one link
    """
    if kind == "collective-permute":
        return float(out_bytes)
    if n <= 1:
        return 0.0
    f = (n - 1) / n
    if kind == "all-gather":
        return out_bytes * f
    if kind == "all-reduce":
        return 2 * out_bytes * f
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)
    if kind in ("all-to-all", "ragged-all-to-all"):
        return out_bytes * f
    return 0.0


def model_flops(cfg, shape: Dict[str, Any]) -> float:
    """Useful model FLOPs for the cell: 6*N_active*tokens (train),
    2*N_active*tokens (prefill), 2*N_active*new_tokens (decode)."""
    n_active = cfg.active_param_count()
    b, s = shape["global_batch"], shape["seq_len"]
    if shape["kind"] == "train":
        return 6.0 * n_active * b * s
    if shape["kind"] == "prefill":
        return 2.0 * n_active * b * s
    return 2.0 * n_active * b  # decode: one new token per sequence


def roofline_terms(cost: Dict[str, float],
                   collectives: Optional[Dict[str, Dict]], n_chips: int,
                   cfg=None, shape=None, hw: Hardware = H100,
                   by_axis: Optional[Dict[str, Dict[str, Dict]]] = None,
                   lines: Optional[Dict[str, Sequence[int]]] = None
                   ) -> Dict[str, Any]:
    """The reference's terms on ``hw``. ``cost`` holds per-device
    ``flops``, ``bytes accessed`` and ``ideal_bytes``; ``collectives``
    per-kind ``traffic``, or None where the collective term is unknown
    (then ``collective_s`` is None and the bound is over the other two).
    Given ``by_axis`` (per mesh axis, per-kind ``traffic``) and ``lines``
    (per axis, the ranks of a line along it), the collective term is each
    axis's traffic over :meth:`Hardware.line_bw` of its line, summed
    (``collective_s_by_axis``); else all traffic over ``link_bw``."""
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    ideal = float(cost.get("ideal_bytes", bytes_acc))
    traffic = (None if collectives is None
               else sum(d["traffic"] for d in collectives.values()))
    coll_s = None if traffic is None else traffic / hw.link_bw
    per_axis = None
    if by_axis is not None:
        per_axis = {a: sum(d["traffic"] for d in kinds.values())
                    / hw.line_bw(lines[a]) for a, kinds in by_axis.items()}
        coll_s = sum(per_axis.values())
    terms = {
        "compute_s": flops / hw.peak_flops,
        "memory_s": ideal / hw.hbm_bw,
        "memory_s_unfused_bound": bytes_acc / hw.hbm_bw,
        "collective_s": coll_s,
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": bytes_acc,
        "ideal_bytes_per_chip": ideal,
        "collective_traffic_per_chip": traffic,
    }
    if per_axis is not None:
        terms["collective_s_by_axis"] = per_axis
    known = [k for k in ("compute_s", "memory_s", "collective_s")
             if terms[k] is not None]
    dom = max(known, key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    total = max(terms[k] for k in known)
    terms["step_s_lower_bound"] = total
    if cfg is not None and shape is not None:
        mf = model_flops(cfg, shape)
        terms["model_flops_global"] = mf
        global_hlo = flops * n_chips
        terms["useful_flop_ratio"] = mf / global_hlo if global_hlo else 0.0
        if total > 0:
            terms["roofline_fraction"] = mf / (n_chips * hw.peak_flops
                                               * total)
    return terms
