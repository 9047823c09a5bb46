"""Adaptive KV safety margin rho (§III.D).

R_need(T) = (1 + rho) * R_kv_hat(T), where rho tracks a high quantile of the
relative underestimation e = max(0, R_kv / R_kv_hat - 1) over a sliding
window, EWMA-smoothed. In practice rho lands in [0.1, 0.3].
"""
from __future__ import annotations

import collections
from typing import Deque

import numpy as np


class RhoEstimator:
    def __init__(self, quantile: float = 0.9, window: int = 512,
                 ewma: float = 0.2, rho_min: float = 0.05,
                 rho_max: float = 1.0, rho_init: float = 0.2):
        self.q = quantile
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.ewma = ewma
        self.lo, self.hi = rho_min, rho_max
        self.rho = rho_init

    def observe(self, actual_kv: float, predicted_kv: float) -> None:
        e = max(0.0, actual_kv / max(predicted_kv, 1e-9) - 1.0)
        self.window.append(e)
        if len(self.window) >= 8:
            q = float(np.quantile(np.asarray(self.window), self.q))
            self.rho = (1 - self.ewma) * self.rho + self.ewma * q
            self.rho = min(max(self.rho, self.lo), self.hi)

    def r_need(self, r_kv_hat: float) -> float:
        return (1.0 + self.rho) * r_kv_hat
