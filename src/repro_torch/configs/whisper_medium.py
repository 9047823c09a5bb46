"""whisper-medium — audio enc-dec, 24L d_model=1024 16H (kv=16) d_ff=4096
vocab=51865.

The conv frontend is a stub: the encoder reads precomputed frame embeddings
(batch, 1500, d_model). [arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ArchConfig, EncoderConfig, register

WHISPER_MEDIUM = register(ArchConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,          # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    rope_theta=1e4,       # whisper uses learned positions; rope stands in
    encoder=EncoderConfig(n_layers=24, n_frames=1500),
    source="arXiv:2212.04356; unverified",
))
