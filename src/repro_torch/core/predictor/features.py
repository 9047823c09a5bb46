"""Agent-context observation -> feature vectors (§III.A/B).

``x(T)`` concatenates structured features (agent role, workflow position,
invocation index, tool availability, reasoning mode, prompt length) with a
semantic embedding of the input text.

Semantic encoder: the paper uses a sliding-window MiniLM; no pretrained
checkpoints exist offline, so we keep the exact interface and structure
(sliding windows -> per-window embedding -> mean pooling) with a hashed
n-gram projection as the window encoder. The ablation direction
(w/o semantic features degrades R^2 — Table VII) is preserved.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

SEM_DIM = 64
WINDOW = 32
STRIDE = 16


@dataclasses.dataclass
class StageObservation:
    """Compact descriptor captured when a stage is created (§III.A)."""
    app: int                 # application / workflow template id
    role: int                # agent role id
    position: float          # fractional position in the workflow [0,1]
    invocation_idx: int      # how many LLM calls this job has made so far
    tools_available: int     # number of tools the agent may call
    cot: bool                # chain-of-thought / thinking mode enabled
    prompt_len: int          # prompt tokens
    model_id: int            # which model serves this stage
    text: str = ""           # input context (for the semantic encoder)
    src_cluster: int = 0


def _hash_embed(tokens: Sequence[str], dim: int = SEM_DIM) -> np.ndarray:
    """Signed feature hashing of unigrams+bigrams."""
    v = np.zeros(dim, np.float32)
    prev = None
    for t in tokens:
        for gram in ((t,) if prev is None else ((t,), (prev, t))):
            h = hash(gram)
            v[h % dim] += 1.0 if (h >> 31) & 1 else -1.0
        prev = t
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def semantic_embedding(text: str, dim: int = SEM_DIM) -> np.ndarray:
    """Sliding-window encoding + mean pooling (MiniLM stand-in)."""
    toks = text.split()
    if not toks:
        return np.zeros(dim, np.float32)
    wins = []
    for s in range(0, max(1, len(toks) - WINDOW + 1), STRIDE):
        wins.append(_hash_embed(toks[s:s + WINDOW], dim))
        if s + WINDOW >= len(toks):
            break
    return np.mean(wins, axis=0)


N_STRUCT = 8


def structured_features(obs: StageObservation) -> np.ndarray:
    return np.array([
        obs.app, obs.role, obs.position, obs.invocation_idx,
        obs.tools_available, float(obs.cot), np.log1p(obs.prompt_len),
        obs.model_id,
    ], np.float32)


def featurize(obs: StageObservation, semantic: bool = True) -> np.ndarray:
    xs = structured_features(obs)
    if not semantic:
        return xs
    return np.concatenate([xs, semantic_embedding(obs.text)])


def featurize_batch(observations: List[StageObservation],
                    semantic: bool = True) -> np.ndarray:
    return np.stack([featurize(o, semantic) for o in observations])
