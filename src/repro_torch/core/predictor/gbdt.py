"""Histogram gradient-boosted decision trees (LightGBM stand-in, pure numpy).

Same algorithm class as the paper's predictor: leaf-wise growth with a
max-leaves budget, 256-bin feature histograms, second-order (grad/hess)
splits with L2 regularization, early stopping on a validation split.
Supports squared-error regression and binary logloss classification.

The histogram trick: per node, one vectorized bincount over (feature, bin)
pairs; sibling histograms obtained by parent - left subtraction.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class GBDTConfig:
    n_trees: int = 150
    learning_rate: float = 0.1
    max_leaves: int = 31
    min_child_weight: float = 5.0
    reg_lambda: float = 1.0
    n_bins: int = 256
    early_stopping: int = 20
    objective: str = "l2"          # l2 | logloss
    min_gain: float = 1e-6
    seed: int = 0


class _Binner:
    def __init__(self, n_bins: int):
        self.n_bins = n_bins
        self.edges: List[np.ndarray] = []

    def fit(self, X: np.ndarray) -> "_Binner":
        qs = np.linspace(0, 1, self.n_bins + 1)[1:-1]
        for j in range(X.shape[1]):
            e = np.unique(np.quantile(X[:, j], qs))
            self.edges.append(e)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        out = np.empty(X.shape, np.uint8)
        for j, e in enumerate(self.edges):
            out[:, j] = np.searchsorted(e, X[:, j], side="right")
        return out


@dataclasses.dataclass
class _Node:
    feature: int = -1
    bin_thresh: int = -1
    left: int = -1
    right: int = -1
    value: float = 0.0


class _Tree:
    """One leaf-wise-grown tree over pre-binned features."""

    def __init__(self, cfg: GBDTConfig):
        self.cfg = cfg
        self.nodes: List[_Node] = []

    def _hist(self, B: np.ndarray, idx: np.ndarray, g: np.ndarray,
              h: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(F, n_bins) grad/hess histograms for the rows in idx."""
        n, F = len(idx), B.shape[1]
        nb = self.cfg.n_bins
        flat = (B[idx].astype(np.int32)
                + np.arange(F, dtype=np.int32)[None, :] * nb).ravel()
        gh = np.bincount(flat, weights=np.repeat(g[idx], F), minlength=F * nb)
        hh = np.bincount(flat, weights=np.repeat(h[idx], F), minlength=F * nb)
        return gh.reshape(F, nb), hh.reshape(F, nb)

    def _best_split(self, gh: np.ndarray, hh: np.ndarray,
                    g_sum: float, h_sum: float):
        """Best (feature, bin) split from histograms; returns (gain, f, b)."""
        lam = self.cfg.reg_lambda
        gl = np.cumsum(gh, axis=1)
        hl = np.cumsum(hh, axis=1)
        gr = g_sum - gl
        hr = h_sum - hl
        ok = (hl >= self.cfg.min_child_weight) & (hr >= self.cfg.min_child_weight)
        gain = (gl ** 2 / (hl + lam) + gr ** 2 / (hr + lam)
                - g_sum ** 2 / (h_sum + lam))
        gain = np.where(ok, gain, -np.inf)
        f, b = np.unravel_index(np.argmax(gain), gain.shape)
        return gain[f, b], int(f), int(b)

    def fit(self, B: np.ndarray, g: np.ndarray, h: np.ndarray) -> "_Tree":
        cfg = self.cfg
        root_idx = np.arange(len(g))
        self.nodes = [_Node()]
        gh, hh = self._hist(B, root_idx, g, h)
        # candidate leaves: (gain, node_id, idx, hists, gsum, hsum, split)
        import heapq
        heap = []
        counter = 0

        def push(node_id, idx, gh, hh):
            nonlocal counter
            gs, hs = gh.sum(), hh.sum()
            gain, f, b = self._best_split(gh, hh, gs, hs)
            self.nodes[node_id].value = -gs / (hs + cfg.reg_lambda)
            if np.isfinite(gain) and gain > cfg.min_gain:
                heapq.heappush(heap, (-gain, counter, node_id, idx, gh, hh, f, b))
                counter += 1

        push(0, root_idx, gh, hh)
        n_leaves = 1
        while heap and n_leaves < cfg.max_leaves:
            _, _, node_id, idx, gh, hh, f, b = heapq.heappop(heap)
            mask = B[idx, f] <= b
            li, ri = idx[mask], idx[~mask]
            if len(li) == 0 or len(ri) == 0:
                continue
            ghl, hhl = self._hist(B, li, g, h)
            ghr, hhr = gh - ghl, hh - hhl        # sibling subtraction
            ln, rn = len(self.nodes), len(self.nodes) + 1
            self.nodes.append(_Node())
            self.nodes.append(_Node())
            nd = self.nodes[node_id]
            nd.feature, nd.bin_thresh, nd.left, nd.right = f, b, ln, rn
            push(ln, li, ghl, hhl)
            push(rn, ri, ghr, hhr)
            n_leaves += 1
        return self

    def predict_binned(self, B: np.ndarray) -> np.ndarray:
        out = np.empty(len(B), np.float64)
        node_of = np.zeros(len(B), np.int32)
        active = np.arange(len(B))
        while len(active):
            nid = node_of[active]
            nd_feat = np.array([self.nodes[i].feature for i in nid])
            leaf = nd_feat < 0
            if leaf.any():
                rows = active[leaf]
                out[rows] = [self.nodes[i].value for i in node_of[rows]]
            rest = active[~leaf]
            if not len(rest):
                break
            nid = node_of[rest]
            feats = np.array([self.nodes[i].feature for i in nid])
            ths = np.array([self.nodes[i].bin_thresh for i in nid])
            goleft = B[rest, feats] <= ths
            node_of[rest] = np.where(
                goleft,
                [self.nodes[i].left for i in nid],
                [self.nodes[i].right for i in nid])
            active = rest
        return out


class GBDT:
    """Boosted ensemble; classification via sigmoid(logit)."""

    def __init__(self, cfg: Optional[GBDTConfig] = None, **kw):
        self.cfg = cfg or GBDTConfig(**kw)
        self.trees: List[_Tree] = []
        self.binner: Optional[_Binner] = None
        self.base: float = 0.0

    def _grad_hess(self, y, pred):
        if self.cfg.objective == "l2":
            return pred - y, np.ones_like(y)
        p = 1.0 / (1.0 + np.exp(-pred))
        return p - y, np.maximum(p * (1 - p), 1e-6)

    def _loss(self, y, pred):
        if self.cfg.objective == "l2":
            return float(np.mean((pred - y) ** 2))
        p = np.clip(1.0 / (1.0 + np.exp(-pred)), 1e-12, 1 - 1e-12)
        return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))

    def fit(self, X: np.ndarray, y: np.ndarray,
            X_val: Optional[np.ndarray] = None,
            y_val: Optional[np.ndarray] = None) -> "GBDT":
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float64)
        self.binner = _Binner(self.cfg.n_bins).fit(X)
        B = self.binner.transform(X)
        if self.cfg.objective == "l2":
            self.base = float(np.mean(y))
        else:
            p = np.clip(np.mean(y), 1e-6, 1 - 1e-6)
            self.base = float(np.log(p / (1 - p)))
        pred = np.full(len(y), self.base)
        Bv = pv = None
        if X_val is not None and len(X_val):
            Bv = self.binner.transform(np.asarray(X_val, np.float32))
            pv = np.full(len(y_val), self.base)
        best_loss, best_n, since = np.inf, 0, 0
        for _ in range(self.cfg.n_trees):
            g, h = self._grad_hess(y, pred)
            t = _Tree(self.cfg).fit(B, g, h)
            self.trees.append(t)
            pred += self.cfg.learning_rate * t.predict_binned(B)
            if Bv is not None:
                pv += self.cfg.learning_rate * t.predict_binned(Bv)
                vl = self._loss(np.asarray(y_val, np.float64), pv)
                if vl < best_loss - 1e-9:
                    best_loss, best_n, since = vl, len(self.trees), 0
                else:
                    since += 1
                    if since >= self.cfg.early_stopping:
                        break
        if Bv is not None and best_n:
            self.trees = self.trees[:best_n]
        return self

    def raw_predict(self, X: np.ndarray) -> np.ndarray:
        B = self.binner.transform(np.asarray(X, np.float32))
        out = np.full(len(B), self.base)
        for t in self.trees:
            out += self.cfg.learning_rate * t.predict_binned(B)
        return out

    def predict(self, X: np.ndarray) -> np.ndarray:
        raw = self.raw_predict(X)
        if self.cfg.objective == "logloss":
            return 1.0 / (1.0 + np.exp(-raw))
        return raw
