"""PyTorch/CUDA port of the Maestro serving engine.

Mirrors the module layout of the JAX package ``repro`` (the reference it is
held against) but imports none of it. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on CUDA tensors the kernels (paged,
chunked-prefill and flash attention, the Mamba2 SSD scan) are the
hand-written Hopper kernels under ``csrc/``, on CPU tensors their plain
PyTorch versions in ``kernels/ref.py``.
"""
import importlib
import sys
import threading

import torch


def foreign_modules():
    """The loaded modules of JAX or of the JAX package ``repro`` (a
    process of the port may load none)."""
    return sorted(k for k in sys.modules
                  if k.split(".")[0] in ("jax", "jaxlib", "repro"))


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


def import_dynamo() -> None:
    """Import ``torch._dynamo``, once, on a thread of its own.
    ``torch.utils.checkpoint`` and a ``TorchDispatchMode``'s dispatch import
    it on their first call, and that import leaves a reference cycle
    through a frame (``torch.fx``'s ``wrap`` keeps its caller's frame),
    which holds every frame of the calling stack, and every tensor those
    frames hold, until Python's cyclic collector happens to run. A
    thread's stack holds no frame of the caller's: call this before
    either."""
    if "torch._dynamo" in sys.modules:
        return
    t = threading.Thread(target=importlib.import_module,
                         args=("torch._dynamo",))
    t.start()
    t.join()
