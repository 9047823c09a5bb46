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

:func:`param_specs` gives the same tree as :class:`Spec` leaves (shape,
init, dtype, logical sharding axes), which three walkers read, as the
reference's ``Leaf`` trees are read: :func:`init_params` (real tensors),
:func:`abstract_tree` (``meta`` tensors: the dry run) and
:func:`pspec_tree` (partition specs); :func:`tree_bytes` and
:func:`tree_params` count it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig


class Spec(NamedTuple):
    """One parameter leaf: its shape, its init ("normal" | "zeros" |
    "ones"), the multiplier of the normal std, its dtype (None: the
    config's) and its logical sharding axes, one per dim (``"fsdp"``,
    ``"tp"``, ``"exp"`` or None: see
    :mod:`repro_torch.distributed.sharding`). A leaf's axes are the
    reference's stacked leaf's without its leading ``"stack"``."""
    shape: Tuple[int, ...]
    init: str = "normal"
    scale: float = 1.0
    dtype: Optional[torch.dtype] = None
    axes: Tuple[Optional[str], ...] = ()


def pad_vocab(vocab: int, multiple: int = 512) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


def _norm(n: int, axes=(None,)) -> Spec:
    return Spec((n,), "ones", axes=axes)


def attn_specs(cfg: ArchConfig, cross: bool = False) -> Dict[str, Spec]:
    """Self-attention, or (``cross``) cross-attention: k/v projected from
    ``ctx_dim`` rows where the config sets one, no bias, no qk-norm."""
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    d_ctx = D
    if cross and cfg.cross_attn is not None and cfg.cross_attn.ctx_dim:
        d_ctx = cfg.cross_attn.ctx_dim
    col, row = ("fsdp", "tp"), ("tp", "fsdp")
    specs: Dict[str, Spec] = {
        "ln": _norm(D),
        "wq": Spec((D, H * hd), axes=col),
        "wk": Spec((d_ctx, Hkv * hd), axes=col),
        "wv": Spec((d_ctx, Hkv * hd), axes=col),
        "wo": Spec((H * hd, D), axes=row),
    }
    if cfg.qkv_bias and not cross:
        specs["bq"] = Spec((H * hd,), "zeros", axes=("tp",))
        specs["bk"] = Spec((Hkv * hd,), "zeros", axes=("tp",))
        specs["bv"] = Spec((Hkv * hd,), "zeros", axes=("tp",))
    if cfg.qk_norm and not cross:
        specs["qn"] = _norm(hd)
        specs["kn"] = _norm(hd)
    return specs


def ffn_specs(cfg: ArchConfig, gelu: Optional[bool] = None
              ) -> Dict[str, Spec]:
    """SwiGLU, or the GELU MLP where ``gelu`` (default ``cfg.ffn_gelu``;
    the encoder's is always GELU)."""
    D, F = cfg.d_model, cfg.d_ff
    specs: Dict[str, Spec] = {
        "ln": _norm(D),
        "w_up": Spec((D, F), axes=("fsdp", "tp")),
        "w_down": Spec((F, D), axes=("tp", "fsdp")),
    }
    if not (cfg.ffn_gelu if gelu is None else gelu):  # SwiGLU
        specs["w_gate"] = Spec((D, F), axes=("fsdp", "tp"))
    return specs


def ssm_specs(cfg: ArchConfig) -> Dict[str, Spec]:
    s = cfg.ssm
    D = cfg.d_model
    di, H = s.d_inner(D), s.n_heads(D)
    GN = s.n_groups * s.d_state
    f32 = torch.float32
    return {
        "ln": _norm(D),
        "wx": Spec((D, di), axes=("fsdp", "tp")),
        "wz": Spec((D, di), axes=("fsdp", "tp")),
        "wB": Spec((D, GN), axes=("fsdp", None)),
        "wC": Spec((D, GN), axes=("fsdp", None)),
        "wdt": Spec((D, H), axes=("fsdp", "tp")),
        "conv": Spec((s.conv_dim, di), scale=0.5, axes=(None, "tp")),
        "A_log": Spec((H,), "zeros", dtype=f32, axes=("tp",)),
        "dt_bias": Spec((H,), "zeros", dtype=f32, axes=("tp",)),
        "D_skip": Spec((H,), "ones", dtype=f32, axes=("tp",)),
        "gn": _norm(di, ("tp",)),
        "wout": Spec((di, D), axes=("tp", "fsdp")),
    }


def moe_specs(cfg: ArchConfig) -> Dict[str, Spec]:
    m = cfg.moe
    D, E, F = cfg.d_model, m.n_experts, m.d_ff_expert
    return {
        "ln": _norm(D),
        "router": Spec((D, E), axes=("fsdp", None)),
        "w_gate": Spec((E, D, F), axes=("exp", "fsdp", None)),
        "w_up": Spec((E, D, F), axes=("exp", "fsdp", None)),
        "w_down": Spec((E, F, D), axes=("exp", None, "fsdp")),
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


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """The :class:`Spec` of every parameter, in :func:`init_params`' layout
    and in the order it draws them (a dict's insertion order), each with
    its dtype resolved (the config's where the leaf names none): the
    reference's ``Model.param_defs`` tree, per layer."""
    return _map_specs(lambda s: s._replace(dtype=s.dtype or cfg.dtype),
                      _raw_specs(cfg))


def _raw_specs(cfg: ArchConfig) -> Dict[str, Any]:
    Vp, D = pad_vocab(cfg.vocab, 256), cfg.d_model
    specs: Dict[str, Any] = {
        "embed": Spec((Vp, D), axes=("tp", "fsdp")),
        "final_ln": _norm(D),
        "layers": [layer_specs(cfg, i) for i in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = Spec((D, Vp), axes=("fsdp", "tp"))
    if cfg.encoder is not None:
        specs["encoder"] = {
            "layers": [encoder_layer_specs(cfg)
                       for _ in range(cfg.encoder.n_layers)],
            "ln": _norm(D)}
    return specs


def _map_specs(fn, tree):
    """``fn`` over the Specs of a :func:`param_specs` tree, visited in
    insertion order."""
    if isinstance(tree, Spec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return [_map_specs(fn, v) for v in tree]


def _spec_leaves(tree) -> List[Spec]:
    out: List[Spec] = []
    _map_specs(out.append, tree)
    return out


def _init_leaf(spec: Spec, dtype: torch.dtype, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    shape, init, scale, own_dtype, _ = spec
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
                device=None, ctx=None) -> Dict[str, Any]:
    """Random parameters drawn from the reference's ``init_tree``
    distribution (normal with std = scale / sqrt(fan_in), drawn in f32 and
    cast; ones and zeros where it has them; its leaf dtypes) — the same
    distribution, not the same bits. ``generator`` must live on
    ``device``.

    With a live ``ctx`` (:class:`~repro_torch.distributed.sharding.
    ShardingCtx`) each leaf is drawn whole and cut to this rank's block
    (:meth:`~repro_torch.distributed.sharding.ShardingCtx.local_block`)
    before the next is drawn, from the same generator in the same order:
    the blocks of the whole tree's draw, while the device holds the
    blocks so far and one whole leaf, never the whole tree."""
    from repro_torch import resolve_device
    device = resolve_device(device)
    specs = param_specs(cfg)

    def draw(s):
        return _init_leaf(s, cfg.dtype, generator, device)
    if ctx is None or not ctx.live:
        return _map_specs(draw, specs)
    return _zip_specs(lambda s, spec, name: ctx.local_block(draw(s), spec,
                                                            name),
                      specs, pspec_tree(specs, ctx.rules))


def _zip_specs(fn, tree, other, path: str = ""):
    """``fn(spec, other's entry, path)`` over the Specs of a
    :func:`param_specs` tree in insertion order, beside a tree ``other``
    of its layout (``"/layers/0/attn/wq"`` the path of a leaf)."""
    if isinstance(tree, Spec):
        return fn(tree, other, path)
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, other[k], f"{path}/{k}")
                for k, v in tree.items()}
    return [_zip_specs(fn, v, o, f"{path}/{i}")
            for i, (v, o) in enumerate(zip(tree, other))]


def abstract_tree(specs, dtype_override=None) -> Dict[str, Any]:
    """A :func:`param_specs` tree as ``meta`` tensors of the leaves' shapes
    and dtypes: nothing is allocated (the reference's ``abstract_tree``)."""
    return _map_specs(lambda s: torch.empty(
        s.shape, dtype=dtype_override or s.dtype, device="meta"), specs)


def pspec_tree(specs, rules: Dict[Optional[str], Any]):
    """The partition spec of every leaf of a :func:`param_specs` tree: a
    tuple holding, per dim, the mesh axes its logical axis maps to under
    ``rules`` (:func:`repro_torch.distributed.sharding.mesh_rules`)."""
    return _map_specs(lambda s: tuple(rules.get(a) for a in s.axes), specs)


def tree_bytes(specs) -> int:
    """Bytes of every leaf of a :func:`param_specs` tree in its dtype."""
    from repro_torch.configs.base import dtype_bytes
    return sum(math.prod(s.shape) * dtype_bytes(s.dtype)
               for s in _spec_leaves(specs))


def tree_params(specs) -> int:
    """Elements of every leaf of a :func:`param_specs` tree."""
    return sum(math.prod(s.shape) for s in _spec_leaves(specs))


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
