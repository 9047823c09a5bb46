"""The node signal the cross-cluster fitness router reads (§III.D); the
port's copy of ``NodeSignal`` from ``repro/core/sched/fitness.py``. The
router itself (Eq. 5-6, Alg. 3) comes with the gateway."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass
class NodeSignal:
    """What each node runtime periodically reports to the global scheduler."""
    node_id: int
    cluster_id: int
    headroom: float                    # R_kv_head(N)
    queue_delay_s: float               # EWMA'd T_q
    warm_models: Dict[str, float]      # model -> T_act seconds (Eq. 6)
    supports_vmm: bool = True          # elastic-KV capability signal
    total_hbm: float = 80e9            # one H100's HBM
    # most-recent prefix-page digests held by the node's prefix index
    # (compact content summary; rides the existing signal snapshot)
    prefix_digests: Tuple[str, ...] = ()
