"""Quickstart: build any of the 10 assigned architectures, run a few train
steps, then serve a few requests through the continuous-batching engine
with Maestro's memory accounting. The port of ``examples/quickstart.py``.

  PYTHONPATH=src python -m repro_torch.examples.quickstart --arch qwen3-8b \\
      [--steps 5] [--device cpu]

Runs on ``cuda`` unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_configs
from repro_torch.core.runtime.accounting import MemoryAccountant
from repro_torch.models import build_model
from repro_torch.serving.engine import Engine, Request
from repro_torch.training import OptConfig, adamw_init, make_train_step


def make_batch(cfg, device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The reference's batch: 4 x 64 tokens below the vocabulary, labels
    the tokens rolled by one, standard-normal frames (encdec) or patch
    embeddings (vlm) of the model width; drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (4, 64), generator=gen,
                         dtype=torch.int32, device=device)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    if cfg.encoder is not None:
        n = cfg.encoder.n_frames
    elif cfg.cross_attn is not None and cfg.family == "vlm":
        n = cfg.cross_attn.n_ctx_tokens
    else:
        return batch
    batch[cfg.ctx_key] = torch.randn((4, n, cfg.d_model), generator=gen,
                                     device=device).to(cfg.dtype)
    return batch


def main(argv=None, params: Optional[Dict[str, Any]] = None,
         batch: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """``params`` (the reduced model's weights in the port's layout) and
    ``batch`` replace the weights drawn from seed 0 and
    :func:`make_batch`'s batch. Returns the losses and grad norms of the
    steps, each request's tokens, the accountant's headroom and its
    invariant."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list_configs())
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cuda unless another device is named")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    print(f"[quickstart] {cfg.name}: {cfg.param_count()/1e9:.1f}B params "
          f"({cfg.family}); running the REDUCED smoke config on "
          f"{device.type}")
    cfg = cfg.reduced()
    model = build_model(cfg, params, device=device, trainable=True)
    n = sum(p.numel() for p in model.parameters())
    print(f"[quickstart] reduced model: {n/1e6:.1f}M params")

    # --- a few train steps -------------------------------------------------
    if batch is None:
        batch = make_batch(cfg, device)
    batch = {k: v.to(device) for k, v in batch.items()}
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    step = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=1))
    tree = model.param_tree()
    opt = adamw_init(tree)
    losses, gnorms = [], []
    with torch.enable_grad():      # a caller under no_grad trains too
        for i in range(args.steps):
            tree, opt, m = step(tree, opt, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            print(f"  step {i}: loss={losses[-1]:.4f} "
                  f"gnorm={gnorms[-1]:.3f}")

    # --- serve through the engine (the trained weights, frozen) ------------
    server = build_model(cfg, model.param_tree(), device=device)
    acc = MemoryAccountant(m_total=256e6)
    eng = Engine(server, acc, max_slots=2, s_max=96, device=device)
    rng = np.random.default_rng(0)
    for i in range(4):
        eng.submit(Request(req_id=i, extras=extras and {
            k: v[:1] for k, v in extras.items()},
            tokens=[int(t) for t in rng.integers(0, cfg.vocab, 12)],
            max_new=8))
    done = eng.drain()
    for r in done:
        print(f"  request {r.req_id}: generated {r.out}")
    ok = acc.check_invariant()
    print(f"[quickstart] OK — KV accountant headroom "
          f"{acc.headroom/1e6:.0f}MB, invariant={ok}")
    return {"losses": losses, "grad_norms": gnorms,
            "tokens": {r.req_id: list(r.out) for r in done},
            "headroom": acc.headroom, "invariant": ok}


if __name__ == "__main__":
    main()
