"""jamba-v0.1-52b — hybrid, 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.

Mamba+attention 1:7 interleave (1 attention layer per period of 8), MoE 16e top-2
every other layer. Sub-quadratic overall: long_500k applies.
[arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, register

JAMBA_V0_1_52B = register(ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    attn_every=8,          # 1:7 attention:mamba
    attn_offset=4,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, every=2, offset=1),
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, chunk=256),
    source="arXiv:2403.19887; hf",
))
