"""End-to-end training driver: train a small (27M-parameter) qwen3-family
model on synthetic token data with the full loop -- AdamW, microbatching,
checkpoint and restart (kill and resume), and straggler detection.

    PYTHONPATH=src python -m repro_torch.training.train_lm --device cuda \
        --steps 200 --batch 8 --seq 129 --n-micro 2 --ckpt build/train_lm_ckpt

The port of ``examples/train_lm.py``. One difference: a checkpoint is
named by the number of steps it holds (the reference saves the state after
step ``s`` under ``s`` and resumes by running step ``s`` again), so a run
resumed from any checkpoint equals the uninterrupted run. On the card
that needs deterministic kernels: :func:`main` turns on
``torch.use_deterministic_algorithms`` and cuBLAS's fixed workspace
(``CUBLAS_WORKSPACE_CONFIG=:4096:8``, unless the caller set one) for the
run, and the flash backward sums without atomics.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from pathlib import Path

import torch

from repro_torch.checkpoint.checkpoint import latest_step, restore, save
from repro_torch.configs import get_config
from repro_torch.distributed.fault import StragglerDetector
from repro_torch.models import build_model
from repro_torch.training import OptConfig, adamw_init, make_train_step
from repro_torch.tree import leaves

DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "train_lm_ckpt"


def synthetic_batch(step: int, vocab: int, batch: int, seq: int,
                    device) -> dict:
    """Markov-ish synthetic LM data, next token = (x + 7) % vocab but for
    5% noise, drawn on the host from a generator seeded with ``step`` (the
    same batch on every device)."""
    gen = torch.Generator().manual_seed(step)
    base = torch.randint(0, vocab, (batch, 1), generator=gen)
    toks = (base * 3 + 7 * torch.arange(seq)[None, :]) % vocab
    noise = torch.rand(toks.shape, generator=gen) < 0.05
    rand = torch.randint(0, vocab, toks.shape, generator=gen)
    toks = torch.where(noise, rand, toks).to(torch.int32).to(device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def default_config():
    """The reference's small config: the qwen3 family, scaled down, f32."""
    return dataclasses.replace(
        get_config("qwen3-8b"), n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, head_dim=64, d_ff=1536, vocab=2048,
        dtype=torch.float32, name="qwen3-100m")


@contextlib.contextmanager
def deterministic(device: str):
    """On ``cuda``, deterministic algorithms for the block (restored after)
    and a fixed cuBLAS workspace, set before cuBLAS first runs in a fresh
    process; on the CPU nothing changes."""
    if device != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def main(argv=None, cfg=None) -> dict:
    """Trains ``cfg`` (:func:`default_config` unless given) from the last
    checkpoint under ``--ckpt`` (or from step 0) to ``--steps``, saving
    asynchronously every ``--ckpt-every`` steps and at the end. Returns the
    last step's metrics as floats, with the step it started from."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=129)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--ckpt-every", type=int, default=100)
    args = ap.parse_args(argv)
    with deterministic(args.device):
        return _train(args, cfg or default_config())


def _train(args, cfg) -> dict:
    model = build_model(cfg, device=args.device, seed=0, trainable=True)
    print(f"[train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{args.steps} steps, microbatch x{args.n_micro}, {args.device}")
    params = model.param_tree()
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=20)
    opt = adamw_init(params)
    start = 0
    if latest_step(args.ckpt) is not None:   # fault-tolerant restart
        (saved, opt), extra = restore(args.ckpt, (params, opt))
        with torch.no_grad():
            for p, s in zip(leaves(params), leaves(saved)):
                p.copy_(s)
        start = extra["step"]
        print(f"[train] resumed from checkpoint at step {start}")

    step_fn = make_train_step(model, opt_cfg, n_micro=args.n_micro)
    sd = StragglerDetector()
    writers = []
    m = {}
    t_start = time.time()
    try:
        for step in range(start, args.steps):
            batch = synthetic_batch(step, cfg.vocab, args.batch, args.seq,
                                    args.device)
            t0 = time.time()
            params, opt, m = step_fn(params, opt, batch)
            loss = float(m["loss"])     # waits for the step
            sd.observe(0, time.time() - t0)
            if step % 25 == 0 or step == args.steps - 1:
                print(f"  step {step:4d}: loss={loss:.4f} "
                      f"lr={float(m['lr']):.5f} "
                      f"({(time.time() - t0) * 1e3:.0f}ms/step)")
            done = step + 1
            if done % args.ckpt_every == 0 and done < args.steps:
                writers.append(save(args.ckpt, (params, opt), step=done,
                                    extra={"step": done}, async_=True))
        save(args.ckpt, (params, opt), step=args.steps,
             extra={"step": args.steps})
    finally:
        for w in writers:
            w.join()
    tput = args.batch * (args.seq - 1) * (args.steps - start) \
        / max(time.time() - t_start, 1e-9)
    metrics = {k: float(v) for k, v in m.items()}
    print(f"[train] done: final loss {metrics.get('loss', float('nan')):.4f},"
          f" {tput:.0f} tok/s on {args.device}; checkpoint at {args.ckpt}")
    return {**metrics, "start": start}


if __name__ == "__main__":
    main()
