"""mamba2-2.7b — attention-free SSM, 64L d_model=2560 vocab=50280, ssm_state=128.

SSD (state-space duality): d_inner 5120, 80 heads of 64, one B/C group,
conv width 4, chunk 256; tied embeddings. [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

MAMBA2_2_7B = register(ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,           # attention-free
    n_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
))
