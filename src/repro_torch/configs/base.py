"""Architecture configuration of the PyTorch port.

The port's own copy of ``repro.configs.base.ArchConfig``, ``MoEConfig``,
``SSMConfig``, ``CrossAttnConfig`` and ``EncoderConfig``, for the six
families of the reference:

  dense   -- decoder-only transformer (GQA, optional qk_norm / qkv bias)
  moe     -- the dense skeleton with MoE FFN layers
  ssm     -- attention-free Mamba2 (SSD) stack
  hybrid  -- interleaved Mamba2 + attention (+ optional MoE)
  encdec  -- encoder-decoder (Whisper-style): an encoder over precomputed
             frame embeddings (the conv frontend is a stub) and a
             cross-attention sub-layer in every decoder layer
  vlm     -- decoder with interleaved cross-attention layers over
             precomputed patch embeddings (the vision tower is a stub)

Every field keeps its meaning and default, and ``dtype`` is a
``torch.dtype``. The shape suite (``SHAPES``, ``input_specs``,
``all_cells``) is the reference's; ``input_specs`` gives
:class:`TensorSpec` records (shape, ``torch.dtype``), never tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Shape suite: every LM arch is paired with these four shapes (the
# reference's, unchanged).
# ---------------------------------------------------------------------------

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    # MoE FFN on the layers where (layer_idx % every) == offset
    every: int = 1
    offset: int = 0
    capacity_factor: float = 1.25


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
class CrossAttnConfig:
    """Interleaved cross-attention (vlm) or enc-dec cross-attention."""
    every: int = 5            # a cross-attention layer every `every` (vlm)
    offset: int = 0
    n_ctx_tokens: int = 1601  # patch / frame embedding count
    ctx_dim: int = 0          # 0 => d_model


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int = 24
    n_frames: int = 1500      # precomputed frame embeddings (stub frontend)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
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
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    cross_attn: Optional[CrossAttnConfig] = None
    encoder: Optional[EncoderConfig] = None
    # hybrid: attention on layers where (idx % attn_every) == attn_offset,
    # Mamba2 elsewhere. attn_every=1 => all attention.
    attn_every: int = 1
    attn_offset: int = 0
    max_seq_len: int = 1 << 20
    dtype: torch.dtype = torch.bfloat16
    source: str = ""

    # ----- derived ---------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def is_attn_layer(self, idx: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return idx % self.attn_every == self.attn_offset
        return True

    def is_moe_layer(self, idx: int) -> bool:
        if self.moe is None:
            return False
        return idx % self.moe.every == self.moe.offset

    def is_cross_layer(self, idx: int) -> bool:
        """An interleaved (vlm) cross-attention layer. False for encdec,
        whose every decoder layer holds a cross-attention sub-layer of its
        own (``models.common.layer_specs``), as the reference counts it."""
        if self.cross_attn is None or self.family == "encdec":
            return False
        return idx % self.cross_attn.every == self.cross_attn.offset

    @property
    def layer_pattern_period(self) -> int:
        """Smallest period covering the layer heterogeneity: the lcm of the
        hybrid's attention period, the MoE period and the vlm's
        cross-attention period."""
        p = 1
        if self.family == "hybrid":
            p = math.lcm(p, self.attn_every)
        if self.moe is not None:
            p = math.lcm(p, self.moe.every)
        if self.cross_attn is not None and self.family != "encdec":
            p = math.lcm(p, self.cross_attn.every)
        return p

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
            elif self.ssm is not None:
                total += _ssm_params(self.ssm, d)
            if self.is_cross_layer(i):
                cd = self.cross_attn.ctx_dim or d
                total += (d * (self.n_heads * hd)
                          + 2 * cd * (self.n_kv_heads * hd)
                          + (self.n_heads * hd) * d + d)
            total += _ffn_params(self, i, d)
        total += d                                  # final norm
        if self.encoder is not None:
            # encoder layers: q/k/v/o, the GELU FFN and two norms
            total += self.encoder.n_layers * (
                4 * d * (self.n_heads * hd) + 2 * d * self.d_ff + 2 * d)
            # one cross-attention block per decoder layer, its final norm
            total += self.n_layers * (
                2 * d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                + d) + d
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token: all but the experts a token is not
        routed to."""
        if self.moe is None:
            return self.param_count()
        per_expert = 3 * self.d_model * self.moe.d_ff_expert
        n_moe = sum(1 for i in range(self.n_layers) if self.is_moe_layer(i))
        return self.param_count() - (
            n_moe * (self.moe.n_experts - self.moe.top_k) * per_expert)

    def weight_bytes(self, dtype_bytes: int = 2) -> int:
        return self.param_count() * dtype_bytes

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence handling => long_500k applicable."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    def applicable_shapes(self) -> List[str]:
        names = ["train_4k", "prefill_32k", "decode_32k"]
        if self.supports_long_context:
            names.append("long_500k")
        return names

    def skipped_shapes(self) -> Dict[str, str]:
        if self.supports_long_context:
            return {}
        return {"long_500k": "pure full-attention arch: O(L^2)/dense-KV at "
                             "512k is out of contract (see DESIGN.md §4)"}

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """alpha(M) of Eq. 3 — per-token KV footprint (hybrid: attention
        layers only; ssm: 0, its state is O(1))."""
        return (self.n_attn_layers * 2 * self.n_kv_heads * self.head_dim_
                * dtype_bytes)

    def ssm_state_bytes(self, dtype_bytes: int = 4) -> int:
        """Constant per-sequence recurrent state of the SSM layers (ssm and
        hybrid)."""
        if self.ssm is None:
            return 0
        n_ssm = self.n_layers - self.n_attn_layers
        h = self.ssm.n_heads(self.d_model)
        return n_ssm * h * self.ssm.head_dim * self.ssm.d_state * dtype_bytes

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant of the same family: the reference's widths, in
        float32."""
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
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2), d_ff_expert=128)
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=32)
        if self.cross_attn is not None:
            changes["cross_attn"] = dataclasses.replace(
                self.cross_attn, n_ctx_tokens=24, ctx_dim=0)
        if self.encoder is not None:
            changes["encoder"] = dataclasses.replace(
                self.encoder, n_layers=2, n_frames=24)
        return dataclasses.replace(self, **changes)

    @property
    def n_ctx(self) -> int:
        """Context rows a cross-attention layer reads: the encoder's frames
        (encdec) or the patch embeddings (vlm); 0 without either."""
        if self.encoder is not None:
            return self.encoder.n_frames
        if self.cross_attn is not None:
            return self.cross_attn.n_ctx_tokens
        return 0

    @property
    def ctx_key(self) -> str:
        """The ``extras`` key of what the cross-attention layers read:
        ``"frames"`` (encdec: the encoder runs over them) or
        ``"ctx_embeds"`` (vlm: the patch embeddings); "" without either."""
        if self.encoder is not None:
            return "frames"
        return "ctx_embeds" if self.cross_attn is not None else ""

    @property
    def ctx_width(self) -> int:
        """The row width of :attr:`ctx_key`'s input [B, n_ctx, width]: the
        model width for frames, ``ctx_dim`` (or the model width) for patch
        embeddings; 0 without either."""
        if self.encoder is not None:
            return self.d_model
        if self.cross_attn is not None:
            return self.cross_attn.ctx_dim or self.d_model
        return 0


def _ffn_params(cfg: ArchConfig, idx: int, d: int) -> int:
    if cfg.is_moe_layer(idx):
        m = cfg.moe
        return m.n_experts * 3 * d * m.d_ff_expert + d * m.n_experts + d
    if not cfg.is_attn_layer(idx):
        return 0              # the Mamba2 block subsumes the FFN role
    if cfg.ffn_gelu:
        return 2 * d * cfg.d_ff + d         # GELU: up + down, + norm
    return 3 * d * cfg.d_ff + d             # SwiGLU: gate + up + down, + norm


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

_ARCH_MODULES = [
    "qwen3_32b", "starcoder2_15b", "qwen3_8b", "qwen1_5_110b",
    "whisper_medium", "llama3_2_vision_11b", "mamba2_2_7b",
    "moonshot_v1_16b_a3b", "llama4_scout_17b_a16e", "jamba_v0_1_52b",
]


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


def list_configs() -> List[str]:
    _load_all()
    return sorted(_REGISTRY)


def all_cells() -> List[Tuple[str, str]]:
    """Every (arch, shape) cell of the suite, the skip-annotated ones
    included."""
    return [(name, shape) for name in list_configs() for shape in SHAPES]


# ---------------------------------------------------------------------------
# input_specs: shape and dtype records of a cell's batch (nothing allocated)
# ---------------------------------------------------------------------------

class TensorSpec(NamedTuple):
    """A tensor's shape and dtype, the port's ``jax.ShapeDtypeStruct``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * dtype_bytes(self.dtype)


def shape_of(shape) -> Dict[str, Any]:
    """A shape of the suite by name, or a shape dict with the same three
    keys (``kind``, ``seq_len``, ``global_batch``) as it is."""
    if isinstance(shape, str):
        return SHAPES[shape]
    return {k: shape[k] for k in ("kind", "seq_len", "global_batch")}


def input_specs(cfg: ArchConfig, shape) -> Dict[str, TensorSpec]:
    """The batch of an (arch, shape) cell, as the reference's
    ``input_specs``: train -> tokens/labels [B, S]; prefill -> tokens
    [B, S]; decode -> tokens [B, 1] and positions [B] (the cache is a
    separate argument, ``Model.cache_specs``). The modality inputs are the
    stubs' embeddings: ``ctx_embeds`` [B, n_ctx, ctx_dim] for a vlm,
    ``frames`` [B, n_frames, D] for an encdec model. ``shape`` is a name
    of :data:`SHAPES` or a dict with its keys."""
    sh = shape_of(shape)
    b, s = sh["global_batch"], sh["seq_len"]
    i32 = torch.int32
    if sh["kind"] == "train":
        out = {"tokens": TensorSpec((b, s), i32),
               "labels": TensorSpec((b, s), i32)}
    elif sh["kind"] == "prefill":
        out = {"tokens": TensorSpec((b, s), i32)}
    else:  # decode: one new token against a cache of length s
        out = {"tokens": TensorSpec((b, 1), i32),
               "positions": TensorSpec((b,), i32)}
    if cfg.cross_attn is not None and cfg.family == "vlm":
        cd = cfg.cross_attn.ctx_dim or cfg.d_model
        out["ctx_embeds"] = TensorSpec((b, cfg.cross_attn.n_ctx_tokens, cd),
                                       cfg.dtype)
    if cfg.encoder is not None:
        out["frames"] = TensorSpec((b, cfg.encoder.n_frames, cfg.d_model),
                                   cfg.dtype)
    return out


def dtype_bytes(dtype: Any) -> int:
    return torch.empty((), dtype=dtype).element_size()
