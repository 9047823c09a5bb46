"""Architecture configuration of the PyTorch port.

The port's own copy of ``repro.configs.base.ArchConfig`` and ``SSMConfig``,
restricted to the two families this package serves: dense self-attention
stacks and attention-free Mamba2 (SSD) stacks. Every field keeps its
meaning and default, and ``dtype`` is a ``torch.dtype``. The hybrid, MoE,
cross-attention and encoder fields arrive with those families.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    n_groups: int = 1  # B/C shared across heads per group (Mamba2 default)
    conv_dim: int = 4  # depthwise causal conv width

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | ssm (the families the port serves)
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
    ssm: Optional[SSMConfig] = None
    max_seq_len: int = 1 << 20
    dtype: torch.dtype = torch.bfloat16
    source: str = ""

    # ----- derived ---------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def is_attn_layer(self, idx: int) -> bool:
        return self.family != "ssm"

    @property
    def layer_pattern_period(self) -> int:
        """Smallest repeating layer pattern. Every layer of a dense or a
        pure-SSM stack is the same, so the period is 1."""
        return 1

    @property
    def n_attn_layers(self) -> int:
        return sum(1 for i in range(self.n_layers) if self.is_attn_layer(i))

    def param_count(self) -> int:
        """Total parameters (embedding included), counted as the reference
        counts them."""
        d, hd = self.d_model, self.head_dim_
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            if self.is_attn_layer(i):
                qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                if self.qkv_bias:
                    qkv += (self.n_heads + 2 * self.n_kv_heads) * hd
                total += qkv + (self.n_heads * hd) * d + d
                if self.qk_norm:
                    total += 2 * hd
                total += (2 if self.ffn_gelu else 3) * d * self.d_ff + d
            else:                       # the Mamba2 block subsumes the FFN
                total += _ssm_params(self.ssm, d)
        return total + d

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """alpha(M) of Eq. 3 — per-token KV footprint (ssm: 0, its state
        is O(1))."""
        return (self.n_attn_layers * 2 * self.n_kv_heads * self.head_dim_
                * dtype_bytes)

    def ssm_state_bytes(self, dtype_bytes: int = 4) -> int:
        """Constant per-sequence recurrent state of the SSM layers."""
        if self.ssm is None:
            return 0
        n_ssm = self.n_layers - self.n_attn_layers
        h = self.ssm.n_heads(self.d_model)
        return n_ssm * h * self.ssm.head_dim * self.ssm.d_state * dtype_bytes

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: the reference's widths, in float32."""
        changes: Dict[str, Any] = dict(
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
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=32)
        return dataclasses.replace(self, **changes)


def _ssm_params(s: SSMConfig, d: int) -> int:
    di, h = s.d_inner(d), s.n_heads(d)
    in_proj = d * (2 * di + 2 * s.n_groups * s.d_state + h)  # x, z, B, C, dt
    out_proj = di * d
    extras = di * s.conv_dim + 3 * h + di + d  # conv, A/dt_bias/D, norms
    return in_proj + out_proj + extras


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ArchConfig] = {}

_ARCH_MODULES = ["qwen3_8b", "starcoder2_15b", "mamba2_2_7b"]


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
