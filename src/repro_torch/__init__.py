"""PyTorch/CUDA port of the Maestro serving engine.

Mirrors the module layout of the JAX package ``repro`` (the reference it is
held against) but imports none of it. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on CUDA tensors the kernels (paged,
chunked-prefill and flash attention, the Mamba2 SSD scan) are the
hand-written Hopper kernels under ``csrc/``, on CPU tensors their plain
PyTorch versions in ``kernels/ref.py``.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Asking for CUDA on a machine without it raises — the port never
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
