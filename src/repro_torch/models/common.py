"""Common model machinery: parameter initialisation, norms, RoPE.

Parameters are a nested dict of tensors in the reference's layout
(``x @ W`` with ``W`` of shape ``[in, out]``), one entry per layer instead
of the reference's stacked ``groups``::

    {"embed": [Vp, D], "final_ln": [D], "lm_head": [D, Vp],
     "layers": [{"attn": {"ln", "wq", "wk", "wv", "wo", ("bq", "bk", "bv"),
                          ("qn", "kn")},
                 "ffn": {"ln", "w_up", "w_down", ("w_gate")}}, ...]}

A Mamba2 layer holds ``{"ssm": {"ln", "wx", "wz", "wB", "wC", "wdt",
"conv", "A_log", "dt_bias", "D_skip", "gn", "wout"}}`` in place of
``attn``; its ``A_log``, ``dt_bias`` and ``D_skip`` are float32 whatever
the config's dtype, as in the reference's ``ssm_defs``. A MoE layer holds
``{"moe": {"ln", "router" [D,E], "w_gate", "w_up" [E,D,F], "w_down"
[E,F,D]}}`` in place of ``ffn``; an SSM layer of a hybrid or pure-SSM
stack has no FFN part at all (:func:`layer_specs`). A cross-attention layer
(every decoder layer of an encdec model, the interleaved ones of a vlm)
also holds ``{"cross": {"ln", "wq", "wk", "wv", "wo"}}``, its ``wk``/``wv``
of ``ctx_dim`` rows where the config sets one. An encdec model has
``{"encoder": {"layers": [{"attn", "ffn" (GELU)}, ...], "ln": [D]}}``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig


class Spec(NamedTuple):
    """One parameter leaf: its shape, its init ("normal" | "zeros" |
    "ones"), the multiplier of the normal std, and its dtype (None: the
    config's)."""
    shape: Tuple[int, ...]
    init: str = "normal"
    scale: float = 1.0
    dtype: Optional[torch.dtype] = None


def pad_vocab(vocab: int, multiple: int = 512) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


def attn_specs(cfg: ArchConfig, cross: bool = False) -> Dict[str, Spec]:
    """Self-attention, or (``cross``) cross-attention: k/v projected from
    ``ctx_dim`` rows where the config sets one, no bias, no qk-norm."""
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    d_ctx = D
    if cross and cfg.cross_attn is not None and cfg.cross_attn.ctx_dim:
        d_ctx = cfg.cross_attn.ctx_dim
    specs: Dict[str, Spec] = {
        "ln": Spec((D,), "ones"),
        "wq": Spec((D, H * hd), "normal"),
        "wk": Spec((d_ctx, Hkv * hd), "normal"),
        "wv": Spec((d_ctx, Hkv * hd), "normal"),
        "wo": Spec((H * hd, D), "normal"),
    }
    if cfg.qkv_bias and not cross:
        specs["bq"] = Spec((H * hd,), "zeros")
        specs["bk"] = Spec((Hkv * hd,), "zeros")
        specs["bv"] = Spec((Hkv * hd,), "zeros")
    if cfg.qk_norm and not cross:
        specs["qn"] = Spec((hd,), "ones")
        specs["kn"] = Spec((hd,), "ones")
    return specs


def ffn_specs(cfg: ArchConfig, gelu: Optional[bool] = None
              ) -> Dict[str, Spec]:
    """SwiGLU, or the GELU MLP where ``gelu`` (default ``cfg.ffn_gelu``;
    the encoder's is always GELU)."""
    D, F = cfg.d_model, cfg.d_ff
    specs: Dict[str, Spec] = {
        "ln": Spec((D,), "ones"),
        "w_up": Spec((D, F), "normal"),
        "w_down": Spec((F, D), "normal"),
    }
    if not (cfg.ffn_gelu if gelu is None else gelu):  # SwiGLU
        specs["w_gate"] = Spec((D, F), "normal")
    return specs


def ssm_specs(cfg: ArchConfig) -> Dict[str, Spec]:
    s = cfg.ssm
    D = cfg.d_model
    di, H = s.d_inner(D), s.n_heads(D)
    GN = s.n_groups * s.d_state
    f32 = torch.float32
    return {
        "ln": Spec((D,), "ones"),
        "wx": Spec((D, di)),
        "wz": Spec((D, di)),
        "wB": Spec((D, GN)),
        "wC": Spec((D, GN)),
        "wdt": Spec((D, H)),
        "conv": Spec((s.conv_dim, di), scale=0.5),
        "A_log": Spec((H,), "zeros", dtype=f32),
        "dt_bias": Spec((H,), "zeros", dtype=f32),
        "D_skip": Spec((H,), "ones", dtype=f32),
        "gn": Spec((di,), "ones"),
        "wout": Spec((di, D)),
    }


def moe_specs(cfg: ArchConfig) -> Dict[str, Spec]:
    m = cfg.moe
    D, E, F = cfg.d_model, m.n_experts, m.d_ff_expert
    return {
        "ln": Spec((D,), "ones"),
        "router": Spec((D, E)),
        "w_gate": Spec((E, D, F)),
        "w_up": Spec((E, D, F)),
        "w_down": Spec((E, F, D)),
    }


def layer_specs(cfg: ArchConfig, idx: int) -> Dict[str, Dict[str, Spec]]:
    """Layer ``idx``'s parts, as the reference's ``slot_kinds`` gives them:
    the mixer (``attn`` or ``ssm``), the ``cross`` attention of a vlm's
    cross layer and of every encdec decoder layer, then the FFN: ``moe`` on
    a MoE layer, none on an SSM layer of a pure-SSM or hybrid stack, else
    ``ffn``."""
    attn = cfg.is_attn_layer(idx)
    specs = {"attn": attn_specs(cfg)} if attn else {"ssm": ssm_specs(cfg)}
    if cfg.is_cross_layer(idx) or cfg.family == "encdec":
        specs["cross"] = attn_specs(cfg, cross=True)
    if cfg.is_moe_layer(idx):
        specs["moe"] = moe_specs(cfg)
    elif attn:
        specs["ffn"] = ffn_specs(cfg)
    return specs


def encoder_layer_specs(cfg: ArchConfig) -> Dict[str, Dict[str, Spec]]:
    """One encoder layer's parts: self-attention and the GELU FFN."""
    return {"attn": attn_specs(cfg), "ffn": ffn_specs(cfg, gelu=True)}


def _init_leaf(spec: Spec, dtype: torch.dtype, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    shape, init, scale, own_dtype = spec
    dtype = own_dtype or dtype
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random parameters drawn from the reference's ``init_tree``
    distribution (normal with std = scale / sqrt(fan_in), drawn in f32 and
    cast; ones and zeros where it has them; its leaf dtypes) — the same
    distribution, not the same bits. ``generator`` must live on
    ``device``."""
    from repro_torch import resolve_device
    device = resolve_device(device)
    dt = cfg.dtype
    Vp = pad_vocab(cfg.vocab, 256)
    D = cfg.d_model
    params: Dict[str, Any] = {
        "embed": _init_leaf(Spec((Vp, D)), dt, generator, device),
        "final_ln": _init_leaf(Spec((D,), "ones"), dt, generator, device),
    }
    layers: List[Dict[str, Dict[str, torch.Tensor]]] = []
    for i in range(cfg.n_layers):
        layers.append({
            part: {k: _init_leaf(s, dt, generator, device)
                   for k, s in specs.items()}
            for part, specs in layer_specs(cfg, i).items()})
    params["layers"] = layers
    if not cfg.tie_embeddings:
        params["lm_head"] = _init_leaf(Spec((D, Vp)), dt,
                                       generator, device)
    if cfg.encoder is not None:
        params["encoder"] = {
            "layers": [{part: {k: _init_leaf(s, dt, generator, device)
                               for k, s in specs.items()}
                        for part, specs in encoder_layer_specs(cfg).items()}
                       for _ in range(cfg.encoder.n_layers)],
            "ln": _init_leaf(Spec((D,), "ones"), dt, generator, device)}
    return params


# ---------------------------------------------------------------------------
# Numeric helpers (f32 inside, input dtype out — the reference's cast points)
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """[head_dim/2] inverse frequencies."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., seq, heads, head_dim]; positions broadcastable to [..., seq]."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs           # [..., seq, half]
    cos = torch.cos(angles)[..., None, :]                   # [..., seq, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
