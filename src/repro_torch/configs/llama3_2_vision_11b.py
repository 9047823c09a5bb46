"""llama-3.2-vision-11b — vlm, 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256.

A cross-attention image layer every 5th layer (offset 3); the vision tower
is a stub: the cross layers read precomputed patch embeddings (batch, 1601,
d_model). [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.configs.base import ArchConfig, CrossAttnConfig, register

LLAMA32_VISION_11B = register(ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    rope_theta=5e5,
    cross_attn=CrossAttnConfig(every=5, offset=3, n_ctx_tokens=1601,
                               ctx_dim=0),
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
))
