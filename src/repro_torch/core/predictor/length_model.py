"""Output-length prediction (§III.B) — Maestro-Pred and the paper's baselines.

Maestro-Pred (two-phase):
  1. tool-intent classifier (GBDT on structured + semantic features),
     isotonic-calibrated -> p_tool(T)  (Eq. 1)
  2. length regressors on log1p(L): per-role when the role has enough
     training data, else a shared global model; p_tool is an input feature.

Baselines (§IV.A):
  Linear    — prompt-length-only least squares
  BERT-MLP  — semantic embedding + MLP, single stage
  Magnus    — semantic embedding + GBDT regression, single stage
Ablations: w/o C (no classifier), w/o BERT (no semantic features).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.predictor.features import (N_STRUCT, StageObservation,
                                           featurize_batch)
from repro_torch.core.predictor.gbdt import GBDT, GBDTConfig
from repro_torch.core.predictor.isotonic import IsotonicCalibrator

MIN_ROLE_SAMPLES = 200


@dataclasses.dataclass
class PredictorConfig:
    use_classifier: bool = True       # ablation: w/o C
    use_semantic: bool = True         # ablation: w/o BERT
    per_role: bool = True
    cls: GBDTConfig = dataclasses.field(default_factory=lambda: GBDTConfig(
        objective="logloss", n_trees=120, max_leaves=31))
    reg: GBDTConfig = dataclasses.field(default_factory=lambda: GBDTConfig(
        objective="l2", n_trees=150, max_leaves=31))


class MaestroPred:
    """Two-phase agent-aware cost predictor."""

    def __init__(self, cfg: Optional[PredictorConfig] = None):
        self.cfg = cfg or PredictorConfig()
        self.clf: Optional[GBDT] = None
        self.cal: Optional[IsotonicCalibrator] = None
        self.regs: Dict[int, GBDT] = {}       # per-role; -1 = global
        self._roles: List[int] = []

    # -- phase 1 -------------------------------------------------------
    def predict_tool(self, X: np.ndarray, tools_avail: np.ndarray) -> np.ndarray:
        if self.clf is None:
            return np.zeros(len(X))
        p = self.clf.predict(X)
        if self.cal is not None:
            p = self.cal.transform(p)
        return np.where(tools_avail > 0, p, 0.0)  # no tools => p_tool = 0

    # -- training ------------------------------------------------------
    def fit(self, observations: List[StageObservation], lengths: np.ndarray,
            tool_labels: np.ndarray, val_frac: float = 0.15) -> "MaestroPred":
        X = featurize_batch(observations, semantic=self.cfg.use_semantic)
        y = np.log1p(np.asarray(lengths, np.float64))
        roles = np.array([o.role for o in observations])
        tools_avail = np.array([o.tools_available for o in observations])
        n = len(X)
        n_val = max(1, int(n * val_frac))
        tr, va = slice(0, n - n_val), slice(n - n_val, n)  # temporal split

        if self.cfg.use_classifier:
            self.clf = GBDT(self.cfg.cls).fit(
                X[tr], tool_labels[tr], X[va], tool_labels[va])
            raw = self.clf.predict(X[va])
            self.cal = IsotonicCalibrator().fit(raw, tool_labels[va])
            p_tool = self.predict_tool(X, tools_avail)
            Xr = np.concatenate([X, p_tool[:, None]], axis=1)
        else:
            Xr = X

        self.regs[-1] = GBDT(self.cfg.reg).fit(Xr[tr], y[tr], Xr[va], y[va])
        if self.cfg.per_role:
            for r in np.unique(roles):
                m = roles == r
                mt = m.copy()
                mt[va] = False
                mv = m.copy()
                mv[tr] = False
                if mt.sum() >= MIN_ROLE_SAMPLES:
                    self.regs[int(r)] = GBDT(self.cfg.reg).fit(
                        Xr[mt], y[mt],
                        Xr[mv] if mv.sum() else None,
                        y[mv] if mv.sum() else None)
        self._roles = sorted(k for k in self.regs if k >= 0)
        return self

    # -- inference -----------------------------------------------------
    def predict(self, observations: List[StageObservation]) -> Dict[str, np.ndarray]:
        X = featurize_batch(observations, semantic=self.cfg.use_semantic)
        roles = np.array([o.role for o in observations])
        tools_avail = np.array([o.tools_available for o in observations])
        p_tool = (self.predict_tool(X, tools_avail)
                  if self.cfg.use_classifier else np.zeros(len(X)))
        Xr = (np.concatenate([X, p_tool[:, None]], axis=1)
              if self.cfg.use_classifier else X)
        out = np.empty(len(X))
        done = np.zeros(len(X), bool)
        for r in self._roles:
            m = (roles == r) & ~done
            if m.any():
                out[m] = self.regs[r].raw_predict(Xr[m])
                done |= m
        if (~done).any():
            out[~done] = self.regs[-1].raw_predict(Xr[~done])
        return {"length": np.expm1(out).clip(1, None), "p_tool": p_tool}

    def predict_one(self, obs: StageObservation) -> Dict[str, float]:
        r = self.predict([obs])
        return {"length": float(r["length"][0]), "p_tool": float(r["p_tool"][0])}


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

class LinearBaseline:
    """Prompt-length-only OLS (the paper's 'Linear')."""

    def fit(self, observations, lengths, tool_labels=None):
        x = np.array([o.prompt_len for o in observations], np.float64)
        y = np.asarray(lengths, np.float64)
        A = np.stack([x, np.ones_like(x)], axis=1)
        self.w, *_ = np.linalg.lstsq(A, y, rcond=None)
        return self

    def predict(self, observations):
        x = np.array([o.prompt_len for o in observations], np.float64)
        return {"length": (self.w[0] * x + self.w[1]).clip(1, None)}


class MLP:
    """Small numpy MLP (Adam, ReLU) — backbone of the BERT-MLP baseline and
    the neural tool-intent baselines in Table III."""

    def __init__(self, hidden=(64, 32), lr=1e-3, epochs=60, batch=256,
                 classifier=False, seed=0):
        self.hidden, self.lr, self.epochs = hidden, lr, epochs
        self.batch, self.classifier = batch, classifier
        self.rng = np.random.default_rng(seed)
        self.Ws: List[np.ndarray] = []
        self.bs: List[np.ndarray] = []

    def _init(self, d_in):
        dims = [d_in, *self.hidden, 1]
        self.Ws = [self.rng.normal(0, np.sqrt(2.0 / dims[i]),
                                   (dims[i], dims[i + 1]))
                   for i in range(len(dims) - 1)]
        self.bs = [np.zeros(dims[i + 1]) for i in range(len(dims) - 1)]

    def _forward(self, X):
        acts = [X]
        h = X
        for i, (W, b) in enumerate(zip(self.Ws, self.bs)):
            h = h @ W + b
            if i < len(self.Ws) - 1:
                h = np.maximum(h, 0)
            acts.append(h)
        return acts

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64).reshape(-1, 1)
        self.mu, self.sd = X.mean(0), X.std(0) + 1e-8
        X = (X - self.mu) / self.sd
        self._init(X.shape[1])
        mW = [np.zeros_like(W) for W in self.Ws]
        vW = [np.zeros_like(W) for W in self.Ws]
        mb = [np.zeros_like(b) for b in self.bs]
        vb = [np.zeros_like(b) for b in self.bs]
        t = 0
        for _ in range(self.epochs):
            order = self.rng.permutation(len(X))
            for s in range(0, len(X), self.batch):
                idx = order[s:s + self.batch]
                acts = self._forward(X[idx])
                out = acts[-1]
                if self.classifier:
                    p = 1 / (1 + np.exp(-out))
                    delta = (p - y[idx]) / len(idx)
                else:
                    delta = (out - y[idx]) / len(idx)
                t += 1
                for i in reversed(range(len(self.Ws))):
                    gW = acts[i].T @ delta
                    gb = delta.sum(0)
                    if i > 0:
                        delta = (delta @ self.Ws[i].T) * (acts[i] > 0)
                    for g, w, m, v in ((gW, self.Ws[i], mW[i], vW[i]),
                                       (gb, self.bs[i], mb[i], vb[i])):
                        m *= 0.9
                        m += 0.1 * g
                        v *= 0.999
                        v += 0.001 * g * g
                        mh = m / (1 - 0.9 ** t)
                        vh = v / (1 - 0.999 ** t)
                        w -= self.lr * mh / (np.sqrt(vh) + 1e-8)
        return self

    def predict(self, X):
        X = (np.asarray(X, np.float64) - self.mu) / self.sd
        out = self._forward(X)[-1][:, 0]
        if self.classifier:
            return 1 / (1 + np.exp(-out))
        return out


class BertMLPBaseline:
    """Semantic embedding + single-stage MLP regression on log1p(L)."""

    def __init__(self, hidden=(64, 32)):
        self.mlp = MLP(hidden=hidden)

    def fit(self, observations, lengths, tool_labels=None):
        X = featurize_batch(observations, semantic=True)
        self.mlp.fit(X, np.log1p(np.asarray(lengths, np.float64)))
        return self

    def predict(self, observations):
        X = featurize_batch(observations, semantic=True)
        return {"length": np.expm1(self.mlp.predict(X)).clip(1, None)}


class MagnusBaseline:
    """Semantic embedding + single-stage GBDT regression (Magnus-style)."""

    def __init__(self, cfg: Optional[GBDTConfig] = None):
        self.reg = GBDT(cfg or GBDTConfig(objective="l2", n_trees=150))

    def fit(self, observations, lengths, tool_labels=None, val_frac=0.15):
        X = featurize_batch(observations, semantic=True)
        y = np.log1p(np.asarray(lengths, np.float64))
        n_val = max(1, int(len(X) * val_frac))
        self.reg.fit(X[:-n_val], y[:-n_val], X[-n_val:], y[-n_val:])
        return self

    def predict(self, observations):
        X = featurize_batch(observations, semantic=True)
        return {"length": np.expm1(self.reg.raw_predict(X)).clip(1, None)}


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def regression_metrics(y_true, y_pred) -> Dict[str, float]:
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    mae = float(np.mean(np.abs(y_true - y_pred)))
    ss_res = float(np.sum((y_true - y_pred) ** 2))
    ss_tot = float(np.sum((y_true - y_true.mean()) ** 2))
    return {"mae": mae, "r2": 1.0 - ss_res / max(ss_tot, 1e-12)}


def classification_metrics(y_true, p) -> Dict[str, float]:
    y = np.asarray(y_true, np.float64)
    p = np.clip(np.asarray(p, np.float64), 1e-12, 1 - 1e-12)
    # AUC via rank statistic
    order = np.argsort(p)
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    n1, n0 = y.sum(), (1 - y).sum()
    auc = ((ranks[y == 1].sum() - n1 * (n1 + 1) / 2) / max(n1 * n0, 1e-12))
    pred = (p >= 0.5).astype(float)
    acc = float(np.mean(pred == y))
    tp = float(((pred == 1) & (y == 1)).sum())
    fp = float(((pred == 1) & (y == 0)).sum())
    fn = float(((pred == 0) & (y == 1)).sum())
    tn = float(((pred == 0) & (y == 0)).sum())
    prec1 = tp / max(tp + fp, 1e-12)
    rec1 = tp / max(tp + fn, 1e-12)
    f1_1 = 2 * prec1 * rec1 / max(prec1 + rec1, 1e-12)
    prec0 = tn / max(tn + fn, 1e-12)
    rec0 = tn / max(tn + fp, 1e-12)
    f1_0 = 2 * prec0 * rec0 / max(prec0 + rec0, 1e-12)
    return {
        "auc": float(auc), "acc": acc, "f1_macro": (f1_1 + f1_0) / 2,
        "mse": float(np.mean((p - y) ** 2)),
        "logloss": float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p))),
        "neg_recall": rec0,
    }
