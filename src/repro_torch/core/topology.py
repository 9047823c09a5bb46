"""Canonical cross-cluster network topology shared by BOTH planes; the
port's copy of ``repro/core/topology.py``.

One RTT matrix drives the trace simulator, the live gateway and every
benchmark, so the controlled policy comparison never diverges on network
assumptions. ``rtt[c1, c2]`` is the round-trip time in seconds between
clusters c1 and c2.
"""
from __future__ import annotations

import numpy as np

# Fig. 4-style regime: two same-region clusters + one remote (seconds)
DEFAULT_RTT = np.array([[0.0005, 0.003, 0.060],
                        [0.003, 0.0005, 0.080],
                        [0.060, 0.080, 0.0005]])

# Table VIII hybrid regime: clusters 0/1 local, cluster 2 far remote
HYBRID_RTT = np.array([[0.0005, 0.002, 0.120],
                       [0.002, 0.0005, 0.140],
                       [0.120, 0.140, 0.0005]])


def validate_rtt(rtt: np.ndarray) -> np.ndarray:
    """Sanity-check and normalize an RTT matrix (square, symmetric, >= 0)."""
    rtt = np.asarray(rtt, float)
    if rtt.ndim != 2 or rtt.shape[0] != rtt.shape[1]:
        raise ValueError(f"RTT matrix must be square, got {rtt.shape}")
    if (rtt < 0).any():
        raise ValueError("RTT entries must be non-negative")
    if not np.allclose(rtt, rtt.T):
        raise ValueError("RTT matrix must be symmetric")
    return rtt
