"""Isotonic regression (pool-adjacent-violators) — calibrates the tool-intent
classifier's scores so predicted confidence matches empirical frequency
(§III.B, Eq. 1)."""
from __future__ import annotations

import numpy as np


class IsotonicCalibrator:
    def __init__(self):
        self.x_: np.ndarray = np.array([0.0, 1.0])
        self.y_: np.ndarray = np.array([0.0, 1.0])

    def fit(self, scores: np.ndarray, labels: np.ndarray) -> "IsotonicCalibrator":
        order = np.argsort(scores, kind="stable")
        x = np.asarray(scores, np.float64)[order]
        y = np.asarray(labels, np.float64)[order]
        # PAVA with block weights
        vals = list(y)
        wts = [1.0] * len(y)
        starts = list(range(len(y)))
        i = 0
        out_v, out_w, out_s = [], [], []
        for v, w, s in zip(vals, wts, starts):
            out_v.append(v)
            out_w.append(w)
            out_s.append(s)
            while len(out_v) > 1 and out_v[-2] > out_v[-1]:
                v2, w2 = out_v.pop(), out_w.pop()
                out_s.pop()
                out_v[-1] = (out_v[-1] * out_w[-1] + v2 * w2) / (out_w[-1] + w2)
                out_w[-1] += w2
        # expand blocks to breakpoints
        xs, ys = [], []
        bounds = out_s + [len(y)]
        for b in range(len(out_v)):
            lo, hi = bounds[b], bounds[b + 1]
            xs.append(x[lo])
            ys.append(out_v[b])
            xs.append(x[hi - 1])
            ys.append(out_v[b])
        self.x_ = np.array(xs)
        self.y_ = np.array(ys)
        return self

    def transform(self, scores: np.ndarray) -> np.ndarray:
        return np.interp(np.asarray(scores, np.float64), self.x_, self.y_,
                         left=self.y_[0], right=self.y_[-1])
