#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line (and failing the run on any error):

1. device    -- the card's name and power limit, as ``nvidia-smi`` prints them;
2. build     -- the four CUDA kernels compiled from ``src/repro_torch/csrc``,
                all ``nvcc`` processes at once;
3. kernels   -- each kernel against its plain PyTorch version on the card, at
                the main paths' shapes (bf16) and at a small size (f32); the
                decode splice bitwise equal to a scatter, and the decode
                split plan at the main shapes; the chunk kernel, its pad
                rows finite; the SSD scan at the 8 prompt lengths (one
                prime) with its final state, y also by each head's error
                over that head's magnitude; flash causal at the 8 prompt
                lengths plus a non-causal cross-length case; chunk and flash
                in bf16 also by each row's error over its magnitude; the
                bf16 checks of chunk, flash and SSD through their wgmma
                variants and the f32 ones through the simt variants; then
                each kernel, its plain version and, where one exists, the
                one PyTorch call computing the same function timed with CUDA
                events (each kernel also without the device spin, and its
                wrapper's host time per call);
4. reference -- reduced models served on the card (kernels) and on the CPU
                (plain versions) from the same weights: identical greedy
                tokens, for qwen3-8b with chunked and with monolithic prefill
                and for mamba2-2.7b;
5. main      -- full-width qwen3-8b (36 layers, bf16, random weights from the
                seed) serving 8 requests of 200-1500 prompt tokens, 64 new
                tokens each, with chunked prefill (256) and a decode horizon
                of 8, every chunk-prefill launch through the wgmma variant;
                then the same requests at horizon 1 must give identical
                tokens;
6. profile   -- device time by kernel (torch.profiler) over the first
                prefill-chunk step and one pure-decode horizon launch of the
                same configuration, with the chunk kernel's share of the
                first and the paged kernels' share of the horizon launch;
7. dense_monolithic -- the same model and requests with monolithic prefill
                (``prefill_chunk_tokens=0``), every prompt's attention in the
                flash kernel's wgmma variant; its tokens against the chunked
                run's, or the first difference with its logit gap; flash's
                share of the first step's device time;
8. ssm_main  -- full-width mamba2-2.7b (64 layers, bf16, random weights from
                the seed) serving 8 requests of the same lengths, every
                prefill's scan in the SSD kernel's wgmma variant; the chunk
                and horizon knobs (256, 8) must degrade to 0 and 1; then a
                profile of its first step (the prefills), with the SSD
                kernel's share, and of one decode step.

Each serving path zeroes the launch counts just before it runs and reads
them just after: every kernel of that path must have launched and no plain
version may have run.

The last lines are the ``nvidia-smi`` line, the ``kernels`` JSON line (each
kernel with its launches by variant on its path) and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository around it, the script exits non-zero and prints no result. TF32
stays off throughout (``torch.backends.cuda.matmul.allow_tf32 = False``).
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak

MAIN = dict(model="qwen3-8b", max_slots=8, s_max=2048, page_tokens=16,
            prefill_chunk_tokens=256, decode_horizon=8, n_requests=8,
            prompt_min=200, prompt_max=1500, max_new=64)
SSM_MODEL = "mamba2-2.7b"


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def reset_peak(torch) -> None:
    """Free what earlier phases left behind (an engine and its arena hold
    each other, so they go only at a collection) and zero the peak."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


SPIN_CYCLES = 1_000_000       # torch.cuda._sleep: about 0.5 ms of device


def time_ms(fn, reps: int = 20, warmup: int = 3, spin: bool = True) -> float:
    """Median device time of one call, by CUDA events, with L2 flushed
    (a 64 MiB write; the H100's L2 is 50 MB) before each call. With
    ``spin``, a spin of the device after the flush keeps it busy while the
    host enqueues the call, so the interval between the events holds the
    call's kernels and not the host's time to launch them; without it, the
    interval also holds the host's time to enqueue the call, which bounds
    a short kernel's time when the device is otherwise idle."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median host time of one call (a wrapper's checks, allocations and
    launches), with the device kept busy by a spin so no call waits on
    it."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def kernel_times(fn) -> dict:
    """A kernel wrapper's device time (``ms``), its time without the spin
    (``ms_no_spin``) and its host time per call (``host_ms``)."""
    return dict(ms=time_ms(fn), ms_no_spin=time_ms(fn, spin=False),
                host_ms=host_ms(fn))


def bound(n_bytes: float, n_flops: float, peak_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- inputs
def paged_inputs(torch, gen, seq_lens, H, Hkv, hd, page, W, n_rows, dtype):
    """Decode-kernel inputs: each sequence's pages are distinct random rows
    of a plane layer with ``n_rows`` rows."""
    B = len(seq_lens)
    dev = "cuda"
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n_rows, page, Hkv, hd), generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn((n_rows, page, Hkv, hd), generator=gen,
                     device=dev).to(dtype)
    perm = torch.randperm(n_rows - 1, generator=gen, device=dev) + 1
    bt = perm[:B * W].reshape(B, W).int()
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    return q, kp, vp, bt, sl


def chunk_positions(torch, prompt_lens, C):
    """Positions of each prompt's last full chunk (the costliest chunk call
    of the main path), or of its only chunk when the prompt is shorter than
    C, as the engine lays them out: pad columns repeat position 0."""
    pos = torch.zeros((len(prompt_lens), C), dtype=torch.int32)
    for b, P in enumerate(prompt_lens):
        p0 = max(P // C - 1, 0) * C
        n = min(C, P - p0)
        pos[b, :n] = torch.arange(p0, p0 + n, dtype=torch.int32)
    return pos.cuda()


def paged_cost(seq_lens, H, Hkv, hd, W, esize):
    tokens = sum(max(s, 1) for s in seq_lens)
    B = len(seq_lens)
    n_bytes = (2 * tokens * Hkv * hd * esize        # K and V, read once
               + 2 * B * H * hd * esize             # q in, out
               + B * W * 4 + B * 4)                 # block table, seq_lens
    return n_bytes, 4 * tokens * H * hd             # QK^T and PV products


def chunk_cost(pos, H, Hkv, hd, W, esize):
    B, C = pos.shape
    k_lens = (pos.amax(dim=1) + 1).tolist()
    visible = int((pos.long() + 1).sum())           # causal keys per row
    n_bytes = (2 * sum(k_lens) * Hkv * hd * esize
               + 2 * B * C * H * hd * esize + B * C * 4 + B * W * 4)
    return n_bytes, 4 * visible * H * hd


def flash_cost(Sq, Sk, H, Hkv, hd, causal, esize):
    """Bytes (q, k, v in, out written) and flops of one sequence's dense
    attention: 4 * hd per visible (query, key) pair and head."""
    if causal:
        visible = sum(min(i + 1, Sk) for i in range(Sq))
    else:
        visible = Sq * Sk
    n_bytes = (2 * Sq * H * hd + 2 * Sk * Hkv * hd) * esize
    return n_bytes, 4 * visible * H * hd


def ssd_cost(S, H, P, N, Q, esize):
    """Bytes (x, B, C, y in the I/O dtype; dt, A and the final state in
    f32) and flops of one sequence's chunked SSD scan with chunks of Q: per
    chunk of n tokens and head, the masked C B^T and its product with x dt
    over the n(n+1)/2 visible pairs, the carried state's term and the state
    update (2 * N * P each per token)."""
    n_bytes = (2 * S * H * P * esize + 2 * S * H * N * esize
               + S * H * 4 + H * 4 + H * N * P * 4)
    flops = 0
    for c0 in range(0, S, Q):
        n = min(Q, S - c0)
        flops += H * (n * (n + 1) * (N + P) + 4 * n * N * P)
    return n_bytes, flops


def next_prime(n: int) -> int:
    while n < 2 or any(n % d == 0 for d in range(2, int(n ** 0.5) + 1)):
        n += 1
    return n


# ---------------------------------------------------------------- phases
def check_flash(torch, gen, prompt_lens):
    """The flash kernel against its plain version at qwen3-8b's heads:
    causal at each prompt length (bf16, held at f32 on the same values, as
    the plain version takes its score dot in the I/O dtype), one non-causal
    cross-length case, and an f32 case at a small size; then timed at the
    longest prompt beside SDPA."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    cfg = get_config(MAIN["model"])
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    bf16 = torch.bfloat16

    def inputs(Sq, Sk, h, hkv, d, dtype):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for shape in ((1, Sq, h, d), (1, Sk, hkv, d), (1, Sk, hkv, d))]

    def err(got, q, k, v, causal):
        """Largest absolute error, and largest error of a row (one query
        and head) over that row's largest magnitude."""
        want = ref.blockwise_attention(q.float(), k.float(), v.float(),
                                       causal=causal)
        diff = (got.float() - want).abs()
        row = diff.amax(-1) / want.abs().amax(-1).clamp_min(1e-30)
        return float(diff.max()), float(row.max())

    ops.reset_counts()
    errs = []
    for S in prompt_lens:
        q, k, v = inputs(S, S, H, Hkv, hd, bf16)
        errs.append(err(fa.flash_attention(q, k, v, causal=True), q, k, v,
                        True))
    q, k, v = inputs(300, max(prompt_lens), H, Hkv, hd, bf16)
    err_cross = err(fa.flash_attention(q, k, v, causal=False), q, k, v, False)
    qs, ks, vs = inputs(77, 77, 8, 2, 64, torch.float32)
    err32 = err(fa.flash_attention(qs, ks, vs, causal=True), qs, ks, vs,
                True)[0]
    qs, ks, vs = inputs(50, 131, 8, 1, 128, torch.float32)
    err32 = max(err32, err(fa.flash_attention(qs, ks, vs, causal=False),
                           qs, ks, vs, False)[0])
    max_err = max(e[0] for e in errs + [err_cross])
    row_err = max(e[1] for e in errs + [err_cross])
    require(max_err <= 2e-2, f"flash_attention bf16 max_abs_err {max_err}")
    # bf16 rounding of P and of the output gives about 5e-3 of a row's
    # magnitude; a K/V tile dropped or misplaced gives tenths
    require(row_err <= 2e-2, f"flash_attention bf16 row-scaled err {row_err}")
    require(err32 <= 1e-5, f"flash_attention f32 max_abs_err {err32}")
    # the bf16 checks at qwen3-8b's heads took the wgmma variant, the f32
    # ones the simt variant
    checked = dict(fa.launches_by_variant)
    require(checked == {"wgmma": len(prompt_lens) + 1, "simt": 2},
            f"flash_attention variants of the checks: {checked}")
    S = max(prompt_lens)
    q, k, v = inputs(S, S, H, Hkv, hd, bf16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    n_bytes, n_flops = flash_cost(S, S, H, Hkv, hd, True, 2)
    b_ms, b_by = bound(n_bytes, n_flops, BF16_FLOPS)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    return dict(
        variant=fa.variant(bf16, hd), check_launches_by_variant=checked,
        max_abs_err=max_err, row_scaled_err=row_err, max_abs_err_f32=err32,
        max_abs_err_noncausal_cross=err_cross[0],
        **kernel_times(lambda: fa.flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: ref.blockwise_attention(q, k, v, True),
                         reps=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(sdpa),
        library_ms_no_spin=time_ms(sdpa, spin=False),
        shapes=dict(q=[1, S, H, hd], kv=[1, S, Hkv, hd],
                    causal_lens=list(prompt_lens), cross=[300, S]))


def check_ssd(torch, gen, prompt_lens):
    """The SSD kernel against its plain version at mamba2-2.7b's heads, one
    call per prompt length as each prefill makes it (bf16 x/B/C, f32
    dt/A), through its wgmma variant: y and the final state, each held by
    its largest error over its largest magnitude (1e-2 for the bf16 y, one
    rounding; 1e-4 for the f32 state, sums in another order over other
    chunk lengths), y also by each head's error over that head's magnitude
    (1e-2), so a dropped chunk cannot hide behind one large head; an f32
    case at a small, prime length through the simt variant; then timed at
    the longest prompt."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_chunk as ssd

    cfg = get_config(SSM_MODEL)
    s = cfg.ssm
    H, P, N = s.n_heads(cfg.d_model), s.head_dim, s.d_state

    def inputs(S, h, p, n, dtype):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        return (rnd(1, S, h, p).to(dtype),
                torch.nn.functional.softplus(rnd(1, S, h)),
                -torch.exp(rnd(h) * 0.3),
                rnd(1, S, h, n).to(dtype), rnd(1, S, h, n).to(dtype))

    def scaled(got, want):
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max())

    def per_head(got, want):
        """The largest error of a head over that head's magnitude."""
        diff = (got.float() - want.float()).abs().amax(dim=(0, 1, 3))
        mag = want.float().abs().amax(dim=(0, 1, 3)).clamp_min(1e-30)
        return float((diff / mag).max())

    ops.reset_counts()
    y_errs, head_errs, st_errs, abs_errs = [], [], [], []
    for S in prompt_lens:
        args = inputs(S, H, P, N, torch.bfloat16)
        y, st = ssd.ssd_chunk(*args, s.chunk)
        y_ref, st_ref = ref.ssd_chunk_scan(*args, s.chunk)
        y_errs.append(scaled(y, y_ref))
        head_errs.append(per_head(y, y_ref))
        st_errs.append(scaled(st, st_ref))
        abs_errs.append(float((y.float() - y_ref.float()).abs().max()))
    args32 = inputs(67, 4, 16, 16, torch.float32)
    y, st = ssd.ssd_chunk(*args32, 32)
    y_ref, st_ref = ref.ssd_chunk_scan(*args32, 32)
    err32 = max(scaled(y, y_ref), scaled(st, st_ref))
    require(max(y_errs) <= 1e-2 and max(st_errs) <= 1e-4,
            f"ssd_chunk bf16 scaled errors y {y_errs} state {st_errs}")
    # bf16 rounding of y gives up to 2^-7 of a head's magnitude; a chunk
    # dropped or misplaced gives the size of that chunk's share of y
    require(max(head_errs) <= 1e-2,
            f"ssd_chunk bf16 per-head y errors {head_errs}")
    require(err32 <= 1e-4, f"ssd_chunk f32 scaled error {err32}")
    checked = dict(ssd.launches_by_variant)
    require(checked == {"wgmma": len(prompt_lens), "simt": 1},
            f"ssd_chunk variants of the checks: {checked}")
    S = max(prompt_lens)
    args = inputs(S, H, P, N, torch.bfloat16)
    n_bytes, n_flops = ssd_cost(S, H, P, N, min(s.chunk, ssd.MAX_CHUNK), 2)
    b_ms, b_by = bound(n_bytes, n_flops, BF16_FLOPS)
    return dict(
        variant=ssd.variant(torch.bfloat16, N, P, s.chunk),
        check_launches_by_variant=checked,
        max_abs_err=max(abs_errs), y_scaled_err=max(y_errs),
        y_head_scaled_err=max(head_errs),
        state_scaled_err=max(st_errs), scaled_err_f32=err32,
        **kernel_times(lambda: ssd.ssd_chunk(*args, s.chunk)),
        plain_ms=time_ms(lambda: ref.ssd_chunk_scan(*args, s.chunk), reps=3,
                         warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        # no single PyTorch call computes the scan
        library_ms=None,
        shapes=dict(x=[1, S, H, P], bc=[1, S, H, N], lens=list(prompt_lens),
                    prime_lens=[n for n in prompt_lens
                                if n == next_prime(n)]))


def phase_kernels(torch, args, prompt_lens):
    """Each kernel against its plain version, then both timed."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import chunk_prefill as cp
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa

    cfg = get_config(MAIN["model"])
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    page, C = MAIN["page_tokens"], MAIN["prefill_chunk_tokens"]
    W = -(-MAIN["s_max"] // page)
    n_rows = MAIN["max_slots"] * W + 1
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    bf16, f32 = torch.bfloat16, torch.float32
    results = {}

    # -- paged decode at the main path's shapes: every request mid-decode
    seq_lens = [P + MAIN["max_new"] // 2 for P in prompt_lens]
    q, kp, vp, bt, sl = paged_inputs(torch, gen, seq_lens, H, Hkv, hd, page,
                                     W, n_rows, bf16)
    got = pa.paged_attention(q, kp, vp, bt, sl)
    want = ref.paged_attention_ref(q, kp, vp, bt, sl)
    err = float((got.float() - want.float()).abs().max())
    require(err <= 2e-2, f"paged_attention bf16 max_abs_err {err} > 2e-2")
    # splice: bitwise equal to scattering k_new/v_new first
    k_new = torch.randn((len(seq_lens), Hkv, hd), generator=gen,
                        device="cuda").to(bf16)
    v_new = torch.randn((len(seq_lens), Hkv, hd), generator=gen,
                        device="cuda").to(bf16)
    w = (sl - 1).long()
    rows = bt[torch.arange(len(seq_lens), device="cuda"), w // page].long()
    kp_sc, vp_sc = kp.clone(), vp.clone()
    kp_sc[rows, w % page] = k_new
    vp_sc[rows, w % page] = v_new
    spliced = pa.paged_attention(q, kp, vp, bt, sl, k_new=k_new, v_new=v_new)
    require(torch.equal(spliced, pa.paged_attention(q, kp_sc, vp_sc, bt, sl)),
            "paged_attention splice differs from scatter-then-attend")
    # f32 at a small size, tight
    qs, kps, vps, bts, sls = paged_inputs(torch, gen, [1, 37, 64, 5], 8, 2,
                                          64, 16, 4, 20, f32)
    err32 = float((pa.paged_attention(qs, kps, vps, bts, sls)
                   - ref.paged_attention_ref(qs, kps, vps, bts, sls))
                  .abs().max())
    require(err32 <= 1e-5, f"paged_attention f32 max_abs_err {err32}")
    n_bytes, n_flops = paged_cost(seq_lens, H, Hkv, hd, W, 2)
    b_ms, b_by = bound(n_bytes, n_flops, BF16_FLOPS)
    results["paged_attention"] = dict(
        max_abs_err=err, max_abs_err_f32=err32, splice_bitwise=True,
        split=dict(zip(("n_split", "span"),
                       pa.split_plan(len(seq_lens), Hkv, W, page))),
        **kernel_times(lambda: pa.paged_attention(q, kp, vp, bt, sl)),
        plain_ms=time_ms(lambda: ref.paged_attention_ref(q, kp, vp, bt, sl)),
        bound_ms=b_ms, bound_by=b_by,
        shapes=dict(q=list(q.shape), pages=list(kp.shape), seq_lens=seq_lens))
    emit("kernel_check", name="paged_attention",
         **{k: v for k, v in results["paged_attention"].items()})
    del q, kp, vp, kp_sc, vp_sc

    # -- chunked prefill at the main path's shapes: each prompt's last full
    # chunk
    ops.reset_counts()
    pos = chunk_positions(torch, prompt_lens, C)
    B = len(prompt_lens)
    q = torch.randn((B, C, H, hd), generator=gen, device="cuda").to(bf16)
    _, kp, vp, bt, _ = paged_inputs(torch, gen, [1] * B, H, Hkv, hd, page, W,
                                    n_rows, bf16)
    got = cp.chunk_prefill_attention(q, kp, vp, bt, pos)
    # the plain version takes its score dot in the I/O dtype; held at f32
    # on the same bf16-valued inputs
    want = ref.chunk_prefill_attention_ref(q.float(), kp.float(), vp.float(),
                                           bt, pos)
    diff = (got.float() - want).abs()
    err = float(diff.max())
    require(err <= 2e-2, f"chunk_prefill bf16 max_abs_err {err} > 2e-2")
    # each row's error over its magnitude, as flash's: the rounding of P and
    # of the output gives about 5e-3, a dropped or misplaced 64-key tile
    # tenths
    row_err = float((diff.amax(-1) / want.abs().amax(-1).clamp_min(1e-30))
                    .max())
    require(row_err <= 2e-2, f"chunk_prefill bf16 row-scaled err {row_err}")
    pad_finite = bool(torch.isfinite(got).all())
    require(pad_finite, "chunk_prefill output (pad rows included) not finite")
    qs = torch.randn((3, 8, 6, 16), generator=gen, device="cuda")
    _, kps, vps, bts, _ = paged_inputs(torch, gen, [1] * 3, 6, 2, 16, 8, 3,
                                       12, f32)
    poss = (torch.tensor([[0], [5], [13]]) + torch.arange(8)).int().cuda()
    err32 = float((cp.chunk_prefill_attention(qs, kps, vps, bts, poss)
                   - ref.chunk_prefill_attention_ref(qs, kps, vps, bts, poss))
                  .abs().max())
    require(err32 <= 1e-5, f"chunk_prefill f32 max_abs_err {err32}")
    # the bf16 check at qwen3-8b's heads took the wgmma variant, the f32
    # one (hd 16) the simt variant
    checked = dict(cp.launches_by_variant)
    require(checked == {"wgmma": 1, "simt": 1},
            f"chunk_prefill variants of the checks: {checked}")
    n_bytes, n_flops = chunk_cost(pos, H, Hkv, hd, W, 2)
    b_ms, b_by = bound(n_bytes, n_flops, BF16_FLOPS)
    results["chunk_prefill_attention"] = dict(
        variant=cp.variant(bf16, hd, page), check_launches_by_variant=checked,
        max_abs_err=err, row_scaled_err=row_err, max_abs_err_f32=err32,
        pad_rows_finite=pad_finite,
        **kernel_times(lambda: cp.chunk_prefill_attention(q, kp, vp, bt,
                                                          pos)),
        plain_ms=time_ms(lambda: ref.chunk_prefill_attention_ref(
            q, kp, vp, bt, pos), reps=5),
        bound_ms=b_ms, bound_by=b_by,
        shapes=dict(q=list(q.shape), pages=list(kp.shape),
                    k_lens=(pos.amax(dim=1) + 1).tolist()))
    emit("kernel_check", name="chunk_prefill_attention",
         **{k: v for k, v in results["chunk_prefill_attention"].items()})
    del q, kp, vp
    for name, check in (("flash_attention", check_flash),
                        ("ssd_chunk", check_ssd)):
        results[name] = check(torch, gen, prompt_lens)
        emit("kernel_check", name=name, **results[name])
    return results


def serve(torch, model, prompts, *, device, arena_rows=None, **kw):
    """Drain ``prompts`` through a fresh engine. Returns the engine, the
    finished requests by id, and per step (wall seconds, prefill tokens,
    decode tokens)."""
    from repro_torch.core.runtime.accounting import MemoryAccountant
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.kv_arena import KVArena

    arena = (KVArena(kw["page_tokens"], init_rows=arena_rows, device=device)
             if arena_rows else None)
    eng = Engine(model, MemoryAccountant(m_total=60e9), arena=arena,
                 device=device, **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(req_id=i, tokens=list(p), max_new=MAIN["max_new"]))
    steps = []
    while eng.waiting or eng.active:
        pre, dec = eng.stat_prefill_tokens, eng.stat_decode_tokens
        t0 = time.perf_counter()
        eng.step()
        if device != "cpu":
            torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0,
                      eng.stat_prefill_tokens - pre,
                      eng.stat_decode_tokens - dec))
        require(len(steps) < 10_000, "engine stalled")
    done = {r.req_id: r for r in eng.finished}
    require(eng.arena.mapped_pages() == 0 and eng.arena.check_mirror(),
            "KV pages leaked")
    return eng, done, steps


# the device kernels of each wrapper, by a part of their names (the wgmma
# variants of chunk and flash share one kernel template, told apart by its
# K/V source)
KERNEL_NAMES = {
    "paged_attention": ("paged_attention",),
    "chunk_prefill_attention": ("chunk_prefill_kernel", "PagedKV"),
    "flash_attention": ("flash_attention_kernel", "DenseKV"),
    "ssd_chunk": ("ssd_chunk",),
}


def profile_step(torch, eng):
    """Device time by kernel over one engine step (torch.profiler), and the
    share of the step's device time in each hand kernel (by kernel name).
    The profiled step's wall time includes the profiler's own overhead, so
    its idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kernels.append((us / 1e3, ev.key, ev.count))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    share = {k: sum(ms for ms, name, _ in kernels
                    if any(part in name for part in parts)) / busy_ms
             for k, parts in KERNEL_NAMES.items()}
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=1 - busy_ms / wall_ms, device_share=share,
                top=[dict(kernel=name[:90], ms=ms, calls=n)
                     for ms, name, n in kernels[:8]])


def phase_profile(torch, model, prompts, rows, kw):
    """Profile the first step (every prompt's first 256-token chunk) and
    one pure-decode horizon launch of the main path's configuration."""
    from repro_torch.core.runtime.accounting import MemoryAccountant
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.kv_arena import KVArena

    eng = Engine(model, MemoryAccountant(m_total=60e9),
                 arena=KVArena(kw["page_tokens"], init_rows=rows,
                               device="cuda"),
                 decode_horizon=MAIN["decode_horizon"], device="cuda", **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(req_id=i, tokens=list(p), max_new=MAIN["max_new"]))
    chunk = profile_step(torch, eng)
    while eng._prefill_pos:
        eng.step()
    require(len(eng.active) == len(prompts), "a request ended in prefill")
    horizon = profile_step(torch, eng)
    require(eng.stat_horizon_steps == 1, "profiled step was not a horizon")
    eng.drain()
    emit("profile", chunk_step=chunk, decode_horizon_step=horizon,
         chunk_share_of_chunk_step=chunk["device_share"][
             "chunk_prefill_attention"],
         paged_share_of_horizon=horizon["device_share"]["paged_attention"])


def phase_reference(torch, args):
    """Reduced models: kernels on the card vs plain versions on the CPU,
    same weights, identical greedy tokens — qwen3-8b with chunked prefill
    (the paged kernels) and with monolithic prefill (flash), mamba2-2.7b
    (the SSD scan; its chunk and horizon knobs degrade)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, init_params

    cases = (("qwen3-8b", 16, (3, 17, 40, 9, 25, 33)),
             ("qwen3-8b", 0, (3, 17, 40, 9, 25, 33)),
             (SSM_MODEL, 16, (3, 17, 41, 9, 25, 33)))
    for name, chunk, lens in cases:
        cfg = get_config(name).reduced()
        params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                             "cpu")
        cpu = build_model(cfg, params, device="cpu")
        gpu = build_model(cfg, params, device="cuda")
        rng = np.random.default_rng(args.seed)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
                   for n in lens]
        kw = dict(max_slots=4, s_max=128, page_tokens=8,
                  prefill_chunk_tokens=chunk, decode_horizon=4)
        _, want, _ = serve(torch, cpu, prompts, device="cpu", **kw)
        ops.reset_counts()
        _, got, _ = serve(torch, gpu, prompts, device="cuda", **kw)
        launches = launch_counts()
        same = all(got[i].out == want[i].out for i in want)
        require(same, f"reduced {name} (chunk {chunk}): card tokens differ "
                f"from the CPU's")
        require(not any(ops.plain_calls.values()),
                f"reduced {name}: a plain version ran on the card")
        emit("reference", model=cfg.name, prefill_chunk_tokens=chunk,
             requests=len(prompts), identical_tokens=same,
             launches={k: n for k, n in launches.items() if n})


def launch_counts():
    """Each kernel wrapper's launches since the last ``ops.reset_counts``."""
    from repro_torch.kernels import chunk_prefill as cp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_chunk as ssd
    return {"paged_attention": pa.launches,
            "chunk_prefill_attention": cp.launches,
            "flash_attention": fa.launches, "ssd_chunk": ssd.launches}


def variant_counts():
    """Launches by variant since the last ``ops.reset_counts``, for the
    kernels that have variants."""
    from repro_torch.kernels import chunk_prefill as cp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_chunk as ssd
    return {"chunk_prefill_attention": dict(cp.launches_by_variant),
            "flash_attention": dict(fa.launches_by_variant),
            "ssd_chunk": dict(ssd.launches_by_variant)}


def require_all_wgmma(name: str, n: int, by_variant: dict) -> None:
    require(n > 0 and by_variant == {"simt": 0, "wgmma": n},
            f"{name} launched {n} times, by variant {by_variant}: not all "
            f"through wgmma")


def phase_main(torch, args, prompts):
    """Full-width qwen3-8b, chunked prefill and the decode horizon. Returns
    the model (the monolithic phase reuses it), this path's launches and
    its tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    cfg = get_config(MAIN["model"])
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    W = -(-MAIN["s_max"] // MAIN["page_tokens"])
    kw = {k: MAIN[k] for k in ("max_slots", "s_max", "page_tokens",
                               "prefill_chunk_tokens")}
    rows = MAIN["max_slots"] * W + 1            # the peak: no regrowth

    reset_peak(torch)
    ops.reset_counts()
    eng, done, steps = serve(torch, model, prompts, device="cuda",
                             arena_rows=rows,
                             decode_horizon=MAIN["decode_horizon"], **kw)
    launches = {k: n for k, n in launch_counts().items()
                if k in ("paged_attention", "chunk_prefill_attention")}
    chunk_variants = variant_counts()["chunk_prefill_attention"]
    plain = dict(ops.plain_calls)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(len(done) == len(prompts), "not every request finished")
    for i, r in done.items():
        require(len(r.out) == MAIN["max_new"] and not r.truncated,
                f"request {i} emitted {len(r.out)} tokens")
        require(all(0 <= t < model.vocab_padded for t in r.out),
                f"request {i} emitted a token outside the vocabulary")
    require(all(n > 0 for n in launches.values()),
            f"a kernel never launched on the main path: {launches}")
    require_all_wgmma("chunk_prefill_attention",
                      launches["chunk_prefill_attention"], chunk_variants)
    require(not any(plain.values()),
            f"a plain version ran on the main path: {plain}")
    stats = dict(stat_steps=eng.stat_steps,
                 stat_horizon_steps=eng.stat_horizon_steps,
                 stat_decode_syncs=eng.stat_decode_syncs,
                 stat_fused_steps=eng.stat_fused_steps,
                 stat_prefill_tokens=eng.stat_prefill_tokens,
                 stat_decode_tokens=eng.stat_decode_tokens)
    rates = serving_rates(done, steps)
    tokens_h8 = {i: r.out for i, r in done.items()}
    arena_gb = rows * eng.binding.plane.spec.row_bytes / 1e9
    del eng
    torch.cuda.empty_cache()

    # finite logits of the expected shape on a short prompt
    logits, _, _ = model.prefill(torch.tensor([prompts[0][:64]],
                                              device="cuda"))
    require(tuple(logits.shape) == (1, model.vocab_padded)
            and bool(torch.isfinite(logits).all()),
            "prefill logits not finite or misshapen")

    ops.reset_counts()
    eng1, done1, _ = serve(torch, model, prompts, device="cuda",
                           arena_rows=rows, decode_horizon=1, **kw)
    same = all(done1[i].out == tokens_h8[i] for i in tokens_h8)
    require(same, "horizon 8 tokens differ from horizon 1")
    launches_h1 = {k: launch_counts()[k] for k in launches}
    syncs_h1 = eng1.stat_decode_syncs
    del eng1
    torch.cuda.empty_cache()
    emit("main", model=cfg.name, params=n_params,
         weights_gb=n_params * 2 / 1e9, model_build_s=build_s,
         prompt_lens=[len(p) for p in prompts], max_new=MAIN["max_new"],
         config={**kw, "decode_horizon": MAIN["decode_horizon"]},
         arena_rows=rows, arena_gb=arena_gb, launches=launches,
         chunk_launches_by_variant=chunk_variants,
         plain_calls=plain, **rates, peak_mem_gb=peak_gb, **stats,
         horizon1=dict(identical_tokens=same, launches=launches_h1,
                       stat_decode_syncs=syncs_h1))
    phase_profile(torch, model, prompts, rows, kw)
    return (model, launches, {"chunk_prefill_attention": chunk_variants},
            tokens_h8)


def serving_rates(done, steps):
    """Decode tokens/s over the pure-decode steps (no prefill in them),
    and TTFT."""
    decode_s = sum(dt for dt, pre, _ in steps if not pre)
    decode_tok = sum(dec for _, pre, dec in steps if not pre)
    ttft = sorted(r.ttft_s for r in done.values())
    return dict(decode_tok_s=decode_tok / decode_s if decode_s else None,
                decode_tokens=decode_tok, decode_wall_s=decode_s,
                total_wall_s=sum(dt for dt, _, _ in steps),
                ttft_s=dict(min=ttft[0], median=statistics.median(ttft),
                            max=ttft[-1]))


def first_difference(torch, model, prompts, want, got):
    """The first token where ``got`` leaves ``want`` (request by request),
    with the logit gap between the two candidates there, from a monolithic
    prefill of the prompt and the common prefix; None when they agree."""
    for i in sorted(want):
        a, b = want[i], got[i]
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        ctx = torch.tensor([prompts[i] + a[:j]], device="cuda")
        logits = model.prefill(ctx)[0][0].float()
        top2 = logits.topk(2).values
        return dict(request=i, index=j, chunked=a[j], monolithic=b[j],
                    logit_gap=float(logits[a[j]] - logits[b[j]]),
                    top2_margin=float(top2[0] - top2[1]))
    return None


def phase_dense_monolithic(torch, model, prompts, tokens_chunked):
    """The main path's model and requests with monolithic prefill: every
    prompt's attention in the flash kernel (36 layers x 8 prompts)."""
    from repro_torch.kernels import ops

    kw = {k: MAIN[k] for k in ("max_slots", "s_max", "page_tokens")}
    rows = MAIN["max_slots"] * -(-MAIN["s_max"] // MAIN["page_tokens"]) + 1
    reset_peak(torch)
    ops.reset_counts()
    eng, done, steps = serve(torch, model, prompts, device="cuda",
                             arena_rows=rows, prefill_chunk_tokens=0,
                             decode_horizon=MAIN["decode_horizon"], **kw)
    from repro_torch.kernels import flash_attention as fa
    launches = {k: n for k, n in launch_counts().items()
                if k in ("flash_attention", "paged_attention")}
    by_variant = dict(fa.launches_by_variant)
    plain = dict(ops.plain_calls)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = model.cfg.n_layers * len(prompts)
    require(launches["flash_attention"] == expected,
            f"flash_attention launched {launches['flash_attention']} times, "
            f"not {expected}")
    require(by_variant["wgmma"] == expected,
            f"flash_attention launches by variant {by_variant}: not all "
            f"{expected} through wgmma")
    require(launches["paged_attention"] > 0, "paged decode never launched")
    require(not any(plain.values()),
            f"a plain version ran on the monolithic path: {plain}")
    for i, r in done.items():
        require(len(r.out) == MAIN["max_new"] and not r.truncated,
                f"request {i} emitted {len(r.out)} tokens")
    rates = serving_rates(done, steps)
    tokens = {i: r.out for i, r in done.items()}
    diff = first_difference(torch, model, prompts, tokens_chunked, tokens)
    prof = profile_first_step(torch, model, prompts, rows=rows,
                              prefill_chunk_tokens=0,
                              decode_horizon=MAIN["decode_horizon"], **kw)
    emit("dense_monolithic", model=model.cfg.name,
         config={**kw, "prefill_chunk_tokens": 0,
                 "decode_horizon": MAIN["decode_horizon"]},
         launches=launches, flash_launches_by_variant=by_variant,
         plain_calls=plain, **rates, peak_mem_gb=peak_gb,
         identical_to_chunked=diff is None, first_difference=diff,
         flash_share_of_first_step=prof["first_step"]["device_share"][
             "flash_attention"],
         profile_first_step=prof)
    return launches, by_variant


def profile_first_step(torch, model, prompts, rows=None, **kw):
    """Device time by kernel over a fresh engine's first step: every
    prompt's monolithic prefill and the first decode token."""
    from repro_torch.core.runtime.accounting import MemoryAccountant
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.kv_arena import KVArena

    arena = (KVArena(kw["page_tokens"], init_rows=rows, device="cuda")
             if rows else None)
    eng = Engine(model, MemoryAccountant(m_total=60e9), arena=arena,
                 device="cuda", **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(req_id=i, tokens=list(p), max_new=MAIN["max_new"]))
    first = profile_step(torch, eng)
    decode = profile_step(torch, eng)
    for rid in list(eng.active):
        eng.evict(rid)
    return dict(first_step=first, decode_step=decode)


def phase_ssm_main(torch, args, prompt_lens):
    """Full-width mamba2-2.7b serving 8 requests: every prefill's scan in
    the SSD kernel (64 layers x 8 prompts); the chunk and horizon knobs
    degrade to 0 and 1."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    from repro_torch.configs import dtype_bytes

    cfg = get_config(SSM_MODEL)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(args.seed + 1)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in prompt_lens]
    kw = {k: MAIN[k] for k in ("max_slots", "s_max", "page_tokens",
                               "prefill_chunk_tokens", "decode_horizon")}
    reset_peak(torch)
    ops.reset_counts()
    eng, done, steps = serve(torch, model, prompts, device="cuda", **kw)
    launches = {"ssd_chunk": launch_counts()["ssd_chunk"]}
    by_variant = variant_counts()["ssd_chunk"]
    plain = dict(ops.plain_calls)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(eng.chunk_tokens == 0 and eng.horizon == 1 and not eng.paged,
            f"knobs did not degrade: chunk {eng.chunk_tokens}, horizon "
            f"{eng.horizon}")
    expected = cfg.n_layers * len(prompts)
    require(launches["ssd_chunk"] == expected,
            f"ssd_chunk launched {launches['ssd_chunk']} times, not "
            f"{expected}")
    require_all_wgmma("ssd_chunk", expected, by_variant)
    require(not any(plain.values()),
            f"a plain version ran on the SSM path: {plain}")
    require(len(done) == len(prompts), "not every request finished")
    for i, r in done.items():
        require(len(r.out) == MAIN["max_new"] and not r.truncated,
                f"request {i} emitted {len(r.out)} tokens")
        require(all(0 <= t < model.vocab_padded for t in r.out),
                f"request {i} emitted a token outside the vocabulary")
    state_bytes = eng._state_bytes
    require(state_bytes == kw["max_slots"] * (
        cfg.ssm_state_bytes() + cfg.n_layers * (cfg.ssm.conv_dim - 1)
        * cfg.ssm.d_inner(cfg.d_model) * dtype_bytes(cfg.dtype)),
        f"state cache of {state_bytes} bytes")
    stats = dict(stat_steps=eng.stat_steps,
                 stat_decode_syncs=eng.stat_decode_syncs,
                 stat_horizon_steps=eng.stat_horizon_steps,
                 stat_prefill_tokens=eng.stat_prefill_tokens,
                 stat_decode_tokens=eng.stat_decode_tokens)
    rates = serving_rates(done, steps)
    del eng
    logits, _, _ = model.prefill(torch.tensor([prompts[0][:64]],
                                              device="cuda"))
    require(tuple(logits.shape) == (1, model.vocab_padded)
            and bool(torch.isfinite(logits).all()),
            "mamba2 prefill logits not finite or misshapen")
    prof = profile_first_step(torch, model, prompts, **kw)
    emit("ssm_main", model=cfg.name, params=n_params,
         weights_gb=n_params * 2 / 1e9, model_build_s=build_s,
         prompt_lens=list(prompt_lens), max_new=MAIN["max_new"],
         config=kw, degraded=dict(prefill_chunk_tokens=0, decode_horizon=1),
         state_cache_gb=state_bytes / 1e9, launches=launches,
         ssd_launches_by_variant=by_variant,
         plain_calls=plain, **rates, peak_mem_gb=peak_gb, **stats,
         ssd_share_of_first_step=prof["first_step"]["device_share"][
             "ssd_chunk"],
         profile_first_step=prof)
    return launches, by_variant


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, prompts and kernel inputs")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script "
              f"(src/repro_torch): {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)

    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    t0 = time.perf_counter()
    _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[str(_build._target(n).relative_to(ROOT))
                    for n in _build.SOURCES])

    rng = np.random.default_rng(args.seed)
    vocab = 151936
    prompt_lens = [int(n) for n in rng.integers(
        MAIN["prompt_min"], MAIN["prompt_max"] + 1, MAIN["n_requests"])]
    # one prime length: the SSD kernel's ragged last chunk on a main path
    prompt_lens[-1] = next_prime(prompt_lens[-1])
    prompts = [[int(t) for t in rng.integers(0, vocab, n)]
               for n in prompt_lens]

    checks = phase_kernels(torch, args, prompt_lens)
    phase_reference(torch, args)
    model, launches, variants, tokens_chunked = phase_main(torch, args,
                                                           prompts)
    # the paged kernels' launches are the chunked main path's; flash's the
    # monolithic path's
    mono, variants["flash_attention"] = phase_dense_monolithic(
        torch, model, prompts, tokens_chunked)
    launches["flash_attention"] = mono["flash_attention"]
    del model
    ssm, variants["ssd_chunk"] = phase_ssm_main(torch, args, prompt_lens)
    launches.update(ssm)

    sources = {
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:146"),
        "chunk_prefill_attention": ("src/repro_torch/csrc/chunk_prefill.cu",
                                    "src/repro/kernels/chunk_prefill.py:124"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:88"),
        "ssd_chunk": ("src/repro_torch/csrc/ssd_chunk.cu",
                      "src/repro/kernels/ssd_chunk.py:85"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        c = checks[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=c["max_abs_err"],
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"],
            # SDPA for flash; None where no single PyTorch call computes
            # the function (the paged kernels would need their pages
            # gathered first, and nothing computes the SSD scan)
            library_ms=c.get("library_ms"),
            # launches on the path by variant; the decode kernel has one
            variants=variants.get(name)))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
