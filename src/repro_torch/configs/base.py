"""Architecture configuration of the PyTorch port.

The port's own copy of ``repro.configs.base.ArchConfig``, restricted to the
dense self-attention family that this package serves: every field keeps its
meaning and default, and ``dtype`` is a ``torch.dtype``. The SSM, hybrid,
MoE, cross-attention and encoder fields arrive with those families.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense (the only family the port serves)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 => d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    ffn_gelu: bool = False       # 2-matrix GELU MLP instead of SwiGLU
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    max_seq_len: int = 1 << 20
    dtype: torch.dtype = torch.bfloat16
    source: str = ""

    # ----- derived ---------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def layer_pattern_period(self) -> int:
        """Smallest repeating layer pattern. Every layer of a dense stack is
        the same (attention + FFN), so the period is 1."""
        return 1

    @property
    def n_attn_layers(self) -> int:
        return self.n_layers

    def param_count(self) -> int:
        """Total parameters (embedding included), as the reference counts
        them for a dense stack."""
        d, hd = self.d_model, self.head_dim_
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
        if self.qkv_bias:
            qkv += (self.n_heads + 2 * self.n_kv_heads) * hd
        attn = qkv + (self.n_heads * hd) * d + d
        if self.qk_norm:
            attn += 2 * hd
        ffn = (2 if self.ffn_gelu else 3) * d * self.d_ff + d
        return total + self.n_layers * (attn + ffn) + d

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """alpha(M) of Eq. 3 — per-token KV footprint."""
        return (self.n_attn_layers * 2 * self.n_kv_heads * self.head_dim_
                * dtype_bytes)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: the reference's widths, in float32."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 * self.layer_pattern_period),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=32,
            d_ff=256,
            vocab=512,
            dtype=torch.float32,
            max_seq_len=4096,
        )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ArchConfig] = {}

_ARCH_MODULES = ["qwen3_8b", "starcoder2_15b"]


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    import importlib
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def dtype_bytes(dtype: Any) -> int:
    return torch.empty((), dtype=dtype).element_size()
