#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --mesh-controls   # the mesh limits' readings

Phases, each printing one JSON line (and failing the run on any error):

1. device    -- the card's name and power limit, as ``nvidia-smi`` prints them;
2. build     -- the six CUDA kernel libraries compiled from
                ``src/repro_torch/csrc``, all ``nvcc`` processes at once;
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
                wrapper's host time per call); the chunk kernel also at a
                prefix-cache hit's shape (B=1, the workflow's median suffix
                after the 1024-token context);
4. reference -- reduced models served on the card (kernels) and on the CPU
                (plain versions) from the same weights: identical greedy
                tokens, for qwen3-8b with chunked and with monolithic prefill
                and for mamba2-2.7b; then reduced qwen3-8b with the prefix
                cache on (``prefix_reference``), chunked and monolithic,
                serving the workflow of phase 8: identical tokens, prefill
                avoided, aliased pages, copies and mirror check;
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
7b. dense_kv -- the same model and requests through the Engine's dense KV
                backend (``kv_backend="dense"``: a dense [8, 2048, 8, 128]
                cache per attention layer, no arena plane, monolithic
                prefill, one token per decode step read by the paged
                kernel over the cache viewed as pages): tokens equal to
                dense_monolithic's, decode tokens/s, TTFT, the cache's
                bytes, launches, no plain call;
8. prefix    -- qwen3-8b at its widths and 3 of its 36 layers (the main
                path's weights, shared) serving one multi-agent workflow
                (a 1024-token shared context; stage 0 with 211 own tokens,
                served alone first; stages 1-7 with own suffixes of 64-500
                tokens, one sharing stage 0's first 8 own tokens, one all
                of its full pages; 64 new tokens each), chunked and
                monolithic, with the prefix cache off and on: prefill
                avoided, aliased pages, copies, the hit stages' TTFT and the
                device time of their prefill (profiled) off against on, the
                first-token logits of the hit stages on against off
                (monolithic: the suffix in the chunk kernel's wgmma variant,
                the whole prompt in flash), the first differing token;
9. ssm_main  -- full-width mamba2-2.7b (64 layers, bf16, random weights from
                the seed) serving 8 requests of the same lengths, every
                prefill's scan in the SSD kernel's wgmma variant; the chunk
                and horizon knobs (256, 8) must degrade to 0 and 1; then a
                profile of its first step (the prefills), with the SSD
                kernel's share, and of one decode step;
9b. launch   -- the dry run (``repro_torch.launch``) held to the card: at
                qwen3-8b whole decoding 8 x 4,096 (the dense cache read
                by the paged kernel), prefilling 1 x 4,096 (flash) and
                mamba2-2.7b whole prefilling 1 x 4,096 (the SSD scan),
                each cell counted on ``meta`` (``--mesh local``) and then
                run through ``build_cell``'s step on the models already
                built: argument bytes equal to the byte, the predicted
                peak within 0.75-1.25 of the step's (the arguments plus
                what the step allocated above what was resident), the
                lower bound at most 1.05 of the median CUDA-event step
                time (``bound_share``), ``mfu``, the kernels launched, no
                plain call, one step's idle share under the profiler;
                ``train_main`` prints the same line for its own step;
10. node     -- a ``NodeRuntime`` on the card holding both models at their
                widths, cut to 18 of qwen3-8b's 36 and 32 of mamba2's 64
                layers (the main paths' weights), under a 14 GB budget
                (its GPU tier holds either model's weights, not both), prefix cache on, chunk 256, horizon 8:
                a qwen3-8b batch, a ``make_room`` that must trim prefix pins
                and sleep nobody, a mamba2 batch (qwen3 offloaded), qwen3
                again (mamba2 offloaded, qwen3 back from pinned host memory,
                the same tokens as before): each activation's seconds against
                the residency model's, each offload's drop in allocated
                memory against the weight bytes dropped (>= 95%), the pinned
                host-to-device rate, the residency events, ``kv_stats()`` and
                ``signal()``;
11. gateway_reference -- the reduced default zoo (f32) on two nodes in
                clusters 0 and 1 under the ``ClusterGateway``'s virtual clock,
                serving a generated trace of 6 jobs under maestro and fcfs,
                once on the card (hand kernels) and once on the CPU (plain
                versions) from the same weights: every stage on the same
                node with the same tokens and the same ready, dispatch,
                submit and finish times, and the same metrics but the TTFT
                percentiles;
12. gateway  -- two ``NodeRuntime``s on the card (clusters 0 and 1), each
                with qwen3-8b and mamba2-2.7b at their widths and 3 of 36 /
                8 of 64 layers under a 5.0 GB budget (GPU tier: either
                model, not both) over one pinned host copy per model (the
                node phase's, cut), serving a generated trace of 16
                multi-agent jobs
                (76 stages; the length predictor trained as
                ``examples/serve_multi_agent.py`` trains it) under the wall
                clock, by fcfs and then maestro on fresh nodes: every job
                must finish inside ``max_run_s``, the paged, chunk (wgmma)
                and SSD (wgmma) kernels launch and no plain version runs;
                per policy the SLO attainment, the interactive queue delay,
                latencies, makespan, TTFT, cold starts, each activation's
                measured seconds beside the ``t_act`` the gateway waited
                for, each offload's freed memory (>= 95% of the weight
                bytes), peak memory and launches; then the maestro-vs-fcfs
                interactive queue delay line ``benchmarks/gateway.py``
                prints;
13. sim      -- the port's trace-driven simulator (host numpy, no card;
                simulated seconds) over ``generate_trace(600, rate=2.0,
                batch_ratio=0.8)`` on ``SimConfig()`` (3 clusters, 5 nodes)
                under fcfs, edf and maestro (the predictor of phase 12):
                one ``SimResult`` row per policy, every job finished, and
                maestro - edf;
13b. examples -- ``repro_torch.examples`` on the card: quickstart
                (reduced, 5 train steps, 4 requests through ``Engine``)
                for qwen3-8b, mamba2-2.7b, moonshot-v1-16b-a3b and
                whisper-medium (losses finite, their kernels launched, no
                plain call), then serve_multi_agent (2 jobs in process,
                every job finished);
14. worker_reference -- phase 11's fleet with each node a worker process
                on the card (``WorkerSpec.device="cuda"``): maestro and fcfs
                on the process backend, maestro on the socket backend, each
                equal to phase 11's card run in every stage and every metric
                but the backend-only keys; the children's ``records()``:
                paged and chunk (simt) launches summing to the in-process
                run's, no plain call, no JAX module;
15. worker_fault -- phase 11's fleet on the socket backend under the wall
                clock, 12 jobs under maestro, with a ``FaultPlan`` that
                SIGKILLs node 1's worker once it holds a submitted stage:
                one death, every job finished, the evacuated stages on node
                0, ``close_fleet`` safe, and the card's free memory back
                within 1 GB of its value before the boot;
16. gateway_process -- phase 12's fleet (3 / 8 layers under 5.0 GB),
                each node a
                freshly booted worker process (``reduced=False``: each child
                draws both models on the card, cut to those depths, and
                keeps its own pinned host
                copies), the same 16 jobs under maestro and the wall clock,
                the workers free-running: every job finished, tokens inside
                the vocabulary, paged launches in the fleet and kernels in
                each child, chunk and SSD all ``wgmma``, no plain call,
                offloads freeing >= 95%,
                peak allocated within 1.1 x the budget; printed beside
                phase 12's maestro run with boot seconds, host
                ``MemAvailable`` around the boot, busy fractions, the
                overlap factor and the IPC counters;
17. kernels_zoo -- paged decode, the chunk kernel and flash (both wgmma)
                in bf16 at the (H, Hkv) of the MoE and large dense configs
                -- (16, 16), (40, 8), (64, 8), hd 128 -- against their
                plain versions at the main path's shapes, each timed beside
                its bound (flash beside SDPA); the SSD scan at jamba's
                widths (N 16, P 64, 128 heads, bf16: the simt variant) at
                the 8 prompt lengths with its final state; then flash
                (wgmma) at the shapes of the cross-attention paths:
                whisper's encoder (1,500 x 1,500, 16/16, hd 64), whisper's
                causal decoder prefill of its shortest and longest prompt,
                the cross prefill of the longest prompt over whisper's
                1,500 frames and vision's 1,601 patches (32/8, hd 128),
                and the cross decode of 8 lanes (one query row each) over
                each, timed beside its bound and SDPA; and paged decode at
                whisper's heads (16/16, hd 64) with its 8 lanes
                mid-decode, timed beside its bound;
18. zoo_reference -- reduced moonshot-v1-16b-a3b and llama4-scout-17b-a16e
                (chunked and monolithic), qwen3-32b, qwen1.5-110b (random
                non-zero q/k/v biases) and jamba-v0.1-52b (knobs degrade)
                served on the card and the CPU from the same weights:
                identical greedy tokens;
19. moe_main -- moonshot-v1-16b-a3b at its widths and 12 of its 48
                layers (64 experts top 6, bf16) serving the main path's 8
                requests chunked (256)
                at horizon 8, then at horizon 1 (identical tokens), then
                monolithic (flash; its tokens against the chunked run's or
                the first difference); a profile of the first chunk step
                and one horizon launch with each kernel's share and the
                MoE's (routing: router product, top-k, argsorts, gathers;
                the expert products), and the expert bytes one decode
                iteration reads (every expert's, the dense bucket) against
                those of the experts routed to;
20. moe_llama4 -- llama4-scout-17b-a16e at its published widths, 8 of 48
                layers (top-1 of 16, GQA 5), the same requests chunked;
21. dense_large -- full-width qwen3-32b (64 layers) with 4 of the requests
                and 32 new tokens each, chunked at horizon 8; then
                qwen1.5-110b at its widths, 8 of 80 layers, with random
                non-zero biases;
22. hybrid_main -- jamba-v0.1-52b at its published widths, 16 of 32 layers
                (2 attention, 14 Mamba2, 8 MoE): the 8 prompt lengths, the
                chunk and horizon knobs degrading to 0 and 1, every prefill
                through flash and the SSD scan (simt), decode through paged
                attention and the state cache; a profile of its first step
                with the SSD, flash and MoE shares;
23. cross_reference -- reduced whisper-medium and llama-3.2-vision-11b
                served on the card and the CPU from the same weights, each
                request with the same frames or patch embeddings: identical
                greedy tokens, the knobs degrading;
24. encdec_main -- full-width whisper-medium at 12 of its 24 decoder and
                12 of its 24 encoder layers (bf16; cut in depth, PERF.md
                section 4) serving the 8 prompt lengths, scaled into
                its 448-token decoder context less the 64 new tokens,
                without extras (the engine's stub frames, 1,500 x 1,024):
                the knobs (256, 8) degrade to 0 and 1; paged decode and
                flash (wgmma) the
                only kernels, flash once per prompt for every self,
                encoder and cross layer and once per decode step for every
                cross layer; decode tokens/s, TTFT, peak memory; the cross
                cache's bytes against the formula; a profile of the first
                step with the encoder's and the cross prefill's shares, and
                of one decode step with the cross decode's;
25. vlm_main -- the same for full-width llama-3.2-vision-11b at 20 of its
                40 layers (4 cross; cut in depth, PERF.md section 4),
                1,601 x 4,096 stub patch embeddings.

26. kernels_train -- the SSD scan's backward (``csrc/ssd_chunk_bwd.cu``)
                against its plain version (``ref.ssd_chunk_bwd``) at
                mamba2-2.7b's and jamba's training microbatch (2 x 4,096,
                bf16), a prime length with and without the final state's
                gradient and an f32 case: each gradient's error, two runs
                bitwise equal, the variant that ran (bf16 at mamba2's N
                128 the wgmma variant, jamba's N 16 and f32 simt), the
                time beside the bound and the plain version, and ptxas's
                registers and spills of the backward's kernels; and flash's
                training forward (which also writes each
                row's log-sum-exp) and the flash backward
                (``csrc/flash_attention_bwd.cu``) against their plain
                versions at the training paths' shapes: qwen3-8b causal
                4,096 (32/8, hd 128, bf16), whisper's encoder, causal
                decoder and cross attention, vision's cross attention over
                1,601 rows, and two small f32 cases of ragged lengths: the
                forward's output bitwise the serving forward's, lse, dq,
                dk and dv within limits, two backward runs bitwise equal,
                bf16 through the backward's wgmma variant and f32 through
                simt; each bf16 shape timed (backward, forward + backward)
                beside its bound and SDPA's, with the share of the bound
                reached (``bound_share``) and the time over SDPA's
                backward (``library_ratio``);
27. train_reference -- reduced qwen3-8b, moonshot-v1-16b-a3b,
                whisper-medium, mamba2-2.7b and jamba-v0.1-52b in f32: the
                loss and every gradient leaf on the card (the kernels)
                against the CPU (plain versions);
28. train_main -- full-width qwen3-8b in bf16: at 2 layers and 4,096
                tokens the loss and every gradient leaf with the kernels
                against the plain attention on the card; then at 3 of its
                36 layers 12 AdamW steps on one batch of 4 x 4,096 tokens
                (2 microbatches) under deterministic algorithms: the loss
                below half its first value; an asynchronous checkpoint
                after step 6, restored into a fresh model and optimizer,
                finishes the run with the same losses and parameters, bit
                for bit; step time, tokens/s, MFU, peak memory, the
                checkpoint's bytes and seconds, a profiled step with the
                flash backward's share and its time by device kernel;
29. train_whisper -- whisper-medium whole (24 + 24 layers, bf16) a few
                steps on stub frames and 448-token decoder sequences: the
                loss falls;
30. train_mamba2 -- mamba2-2.7b (32 of 64 layers, bf16): at 2 layers the
                loss and every gradient leaf with the SSD kernels against
                the plain scan on the card; then train_main's batch (4 x
                4,096 tokens in 2 microbatches, AdamW, the cyclic batch, 12
                steps) under deterministic algorithms, the loss below half
                its first value; step time, tokens/s, MFU, peak memory, the
                SSD backward's and forward's shares of a profiled step;
31. mesh     -- first flash, paged decode and the SSD scan against their
                plain versions at the shapes each rank of a 1 x 2 job
                launches them (``kernel_check_mesh`` lines: half of each
                config's heads, the full-head checks' limits); then the
                model across a (data, model) mesh of two ranks sharing
                the card over gloo (``repro_torch.launch.spmd``, one spawn
                per mesh, a file store, for the serving and the training
                jobs), every family at its published widths, cut in depth
                (``MESH_LAYERS``), each rank drawing its blocks leaf by
                leaf: qwen3-8b (2 layers, bf16) on 1 x 2 (tensor
                parallel: heads, d_ff and the vocabulary split) and 2 x 1
                (ZeRO-3: every leaf's D gathered before use), a prefill of
                2 x 1,024 through flash then decode steps through paged
                attention over the dense cache split by KV heads (4 on
                1 x 2; 1 on 2 x 1, where every step all-gathers the whole
                weights through the host); mamba2-2.7b (2 of 64 layers,
                bf16: the SSM's heads and d_inner split, the gated norm's
                sum of squares all-reduced) on 1 x 2 and 2 x 1, 2 x 1,024,
                the SSD scan's wgmma variant at 40 / 80 heads; moonshot (2
                layers, f32: routing must not flip on bf16 reduction
                order; capacity factor E / K, dropless) on 1 x 2 (expert
                parallel: two all-to-alls), 2 x 512; jamba-v0.1-52b (one
                period: 8 of 32 layers, 7 SSM, 1 attention, 4 MoE; f32,
                dropless) on 1 x 2, 2 x 512, each rank's peak (its
                26.6 GB block) and the one process's (53 GB) printed
                beside the card's memory; whisper-medium (2 of 24 decoder
                and 2 of 24 encoder layers, bf16, 1,500 frames: the
                encoder's heads and the cross K/V split) on 1 x 2, 2 x
                256; llama-3.2-vision-11b (one period: 5 of 40 layers,
                the cross layer 3, bf16, 1,601 patch rows) on 1 x 2,
                2 x 1,024; 4 decode steps on 1 x 2, 1 on 2 x 1. Each held
                against the same model in this process fed the ranks'
                tokens: logits within 2e-2 of each row's magnitude, the
                greedy tokens equal but where the one-process top-2 gap
                is under that, the ranks of a data index bitwise equal,
                the path's kernels (flash and paged for attention, the
                SSD scan for SSM layers) launched on every rank through
                the one process's variants, no plain call, no pair
                dropped on either side, no ``jax`` or ``repro`` module in
                a rank; per rank its launches by variant,
                ``collectives.stats()`` and peak memory. Then, in the same
                spawns, the ``mesh_train`` lines: qwen3-8b (2 layers,
                bf16) on 1 x 2 (tensor parallel, a vocab-parallel loss)
                and 2 x 1 (ZeRO-3: each gather reduce-scatters its
                weight's gradient; data parallel), mamba2-2.7b (2 layers,
                bf16) on both, and in f32 on 1 x 2 as well, 2 x 1,024;
                moonshot (2 layers, f32, dropless) on 1 x 2 (the
                all-to-alls reversed in the backward), 2 x 512;
                whisper-medium (2 + 2 layers, bf16) on 1 x 2, 2 x 256 with
                its frames; the gradient at the starting weights, then 2
                AdamW steps each (lr 1e-4, no warmup) from an AdamW state
                3 steps in (``spmd.warm_state``), held against the same
                in one process with no mesh (run in rank 0's process,
                which receives the other ranks' blocks over gloo): each
                step's loss and grad norm, and the
                gradients and parameters put back together from the
                ranks' blocks, within ``spmd.train_limits`` (PERF.md),
                every rank's losses and leaf replicas equal, flash's
                training forward and backward and the SSD scan and its
                backward launched on every rank with the one process's
                variants, no plain call, no pair dropped; per rank its
                collectives by kind (backward calls and the
                reduce-scatters' bytes among them). Its seconds are a
                gloo run's, which stages every collective through the
                host: they show no collective speed. Then, in the same
                spawns, the ``mesh_dryrun`` lines: ``build_cell``'s step
                of qwen3-8b (2 layers, bf16) on 1 x 2 and 2 x 1 and of
                moonshot (2 layers, f32, dropless) on 1 x 2, at a 2 x 512
                prefill and a 2 x 512 train step, run on each rank once
                more with its peak reset, held to the dry run's count of
                the same rank's step in a world of the ``fake`` backend
                of the same mesh (``launch.mesh.counting_mesh``; counted
                in this process before the spawns): the collectives'
                calls and bytes by kind and axis and the argument bytes
                equal, each rank's peak within ``LAUNCH``'s 0.75-1.25 of
                the predicted. The reference's other sharding modes:
                first flash with its ``q_offset`` (0 and S/2, every
                head, ``wgmma`` in bf16 and ``simt`` in f32) and paged
                attention with its row log-sum-exp (a lane of length 0
                among them) at an ``fsdp_cp`` 1 x 2 rank's shapes, held
                to their plain versions and timed (the ``kernels`` line's
                ``mode_shapes``); then in the same spawns qwen3-8b (2
                layers, bf16, 2 x 1,024, 4 decode steps on 1 x 2, 1 on
                2 x 1) in ``tp_sp_opt`` and ``fsdp_cp`` on 1 x 2 and
                2 x 1 and moonshot (f32,
                dropless, 2 x 512) in ``fsdp_cp`` on 1 x 2, each held as
                the ``tp_sp`` jobs are, and ``mesh_dryrun`` lines of their
                prefill and decode cells (qwen3-8b ``tp_sp_opt`` 1 x 2,
                ``fsdp_cp`` 1 x 2 and 2 x 1). Their training: the flash
                backward with its ``q_offset`` (0 and 512 at an
                ``fsdp_cp`` 1 x 2 rank of qwen3-8b, 512 query rows over
                1,024 keys; and 375, 125 rows over 1,000 keys, a rank of
                a model axis of 8, whose diagonal cuts the 64-row tiles),
                in bf16 (``wgmma``) and f32 (``simt``), against its plain
                version and timed beside SDPA with the offset's boolean
                mask (the ``kernels`` line's ``mode_shapes`` of
                ``flash_attention_bwd``); in the same spawns the
                ``mesh_train`` jobs of qwen3-8b (2 layers, bf16, 2 x
                1,024) in ``tp_sp_opt`` and ``fsdp_cp`` and of moonshot
                (f32, dropless, 2 x 512) in ``fsdp_cp``, on 1 x 2, held
                as the ``tp_sp`` train jobs are, rank 1 of an ``fsdp_cp``
                job launching every flash training forward and backward
                with the offset; and ``mesh_dryrun`` lines of a 2 x 512
                train cell of qwen3-8b in ``tp_sp_opt`` and ``fsdp_cp``
                on 1 x 2.

The models of phases 19-25 are drawn on the card one at a time, each
freed before the next; so are the training phases' models. Every
training path launches flash's training forward and its backward for
attention, the SSD scan and its backward for SSM layers: no serving
attention, no plain version.

Each serving path zeroes the launch counts just before it runs and reads
them just after: every kernel of that path must have launched and no plain
version may have run. The kernels line gives each kernel's launches on the
main paths and, under ``launches_by_path``, on the later paths, and under
``zoo_shapes`` its numbers at phase 17's shapes.

A ``timing`` line gives each phase's wall seconds. The last lines are the
``nvidia-smi`` line, the ``kernels`` JSON line (each kernel with its
launches by variant on its path) and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the repository around it, the script
exits non-zero and prints no result. TF32 stays off throughout
(``torch.backends.cuda.matmul.allow_tf32 = False``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

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
    from repro_torch.launch import roofline as rl
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
    n_bytes, n_flops = rl.flash_cost(S, S, H, Hkv, hd, True, 2)
    b_ms, b_by = rl.bound(n_bytes, n_flops, rl.H100.peak_flops)

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


def ssd_inputs(torch, gen, S, h, p, n, dtype, B=1):
    """``B`` sequences' SSD inputs: x, B and C in ``dtype``, dt and A in
    f32."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return (rnd(B, S, h, p).to(dtype),
            torch.nn.functional.softplus(rnd(B, S, h)),
            -torch.exp(rnd(h) * 0.3),
            rnd(B, S, h, n).to(dtype), rnd(B, S, h, n).to(dtype))


def scaled_err(got, want) -> float:
    """The largest error over the largest magnitude."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def head_scaled_err(got, want) -> float:
    """The largest error of a head over that head's magnitude ([B, S, H,
    P])."""
    diff = (got.float() - want.float()).abs().amax(dim=(0, 1, 3))
    mag = want.float().abs().amax(dim=(0, 1, 3)).clamp_min(1e-30)
    return float((diff / mag).max())


def ssd_errors(torch, gen, lens, where: str, model: str = SSM_MODEL) -> dict:
    """The SSD kernel against its plain version at ``model``'s heads
    (mamba2-2.7b's by default), one bf16 call (B = 1) per length in
    ``lens``: y and the final state, each
    held by its largest error over its largest magnitude (1e-2 for the bf16
    y, one rounding; 1e-4 for the f32 state, sums in another order over
    other chunk lengths), y also by each head's error over that head's
    magnitude (1e-2), so a dropped chunk cannot hide behind one large
    head."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as ssd

    cfg = get_config(model)
    s = cfg.ssm
    H, P, N = s.n_heads(cfg.d_model), s.head_dim, s.d_state
    y_errs, head_errs, st_errs, abs_errs = [], [], [], []
    for S in lens:
        args = ssd_inputs(torch, gen, S, H, P, N, torch.bfloat16)
        y, st = ssd.ssd_chunk(*args, s.chunk)
        y_ref, st_ref = ref.ssd_chunk_scan(*args, s.chunk)
        y_errs.append(scaled_err(y, y_ref))
        head_errs.append(head_scaled_err(y, y_ref))
        st_errs.append(scaled_err(st, st_ref))
        abs_errs.append(float((y.float() - y_ref.float()).abs().max()))
    require(max(y_errs) <= 1e-2 and max(st_errs) <= 1e-4,
            f"ssd_chunk bf16 at the {where}'s lengths {list(lens)}: scaled "
            f"errors y {y_errs} state {st_errs}")
    # bf16 rounding of y gives up to 2^-7 of a head's magnitude; a chunk
    # dropped or misplaced gives the size of that chunk's share of y
    require(max(head_errs) <= 1e-2,
            f"ssd_chunk bf16 at the {where}'s lengths {list(lens)}: "
            f"per-head y errors {head_errs}")
    return dict(max_abs_err=max(abs_errs), y_scaled_err=max(y_errs),
                y_head_scaled_err=max(head_errs),
                state_scaled_err=max(st_errs))


def chunk_errors(got, want) -> tuple:
    """An attention kernel's largest error, and each row's (one query
    token's head) error over that row's magnitude (the rounding of P and
    of the output gives about 5e-3, a dropped or misplaced tile or page,
    or one kv group's share read from another, tenths); ``want`` is f32."""
    diff = (got.float() - want).abs()
    row = (diff.amax(-1) / want.abs().amax(-1).clamp_min(1e-30)).max()
    return float(diff.max()), float(row)


def check_ssd(torch, gen, prompt_lens):
    """The SSD kernel against its plain version at mamba2-2.7b's heads, one
    call per prompt length as each prefill makes it, through its wgmma
    variant (:func:`ssd_errors`); an f32 case at a small, prime length
    through the simt variant; then timed at the longest prompt."""
    from repro_torch.launch import roofline as rl
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_chunk as ssd

    cfg = get_config(SSM_MODEL)
    s = cfg.ssm
    H, P, N = s.n_heads(cfg.d_model), s.head_dim, s.d_state

    ops.reset_counts()
    errs = ssd_errors(torch, gen, prompt_lens, "main path")
    args32 = ssd_inputs(torch, gen, 67, 4, 16, 16, torch.float32)
    y, st = ssd.ssd_chunk(*args32, 32)
    y_ref, st_ref = ref.ssd_chunk_scan(*args32, 32)
    err32 = max(scaled_err(y, y_ref), scaled_err(st, st_ref))
    require(err32 <= 1e-4, f"ssd_chunk f32 scaled error {err32}")
    checked = dict(ssd.launches_by_variant)
    require(checked == {"wgmma": len(prompt_lens), "simt": 1},
            f"ssd_chunk variants of the checks: {checked}")
    S = max(prompt_lens)
    args = ssd_inputs(torch, gen, S, H, P, N, torch.bfloat16)
    n_bytes, n_flops = rl.ssd_cost(S, H, P, N, min(s.chunk, ssd.MAX_CHUNK),
                                   2)
    b_ms, b_by = rl.bound(n_bytes, n_flops, rl.H100.peak_flops)
    return dict(
        variant=ssd.variant(torch.bfloat16, N, P, s.chunk),
        check_launches_by_variant=checked, **errs, scaled_err_f32=err32,
        **kernel_times(lambda: ssd.ssd_chunk(*args, s.chunk)),
        plain_ms=time_ms(lambda: ref.ssd_chunk_scan(*args, s.chunk), reps=3,
                         warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        # no single PyTorch call computes the scan
        library_ms=None,
        shapes=dict(x=[1, S, H, P], bc=[1, S, H, N], lens=list(prompt_lens),
                    prime_lens=[n for n in prompt_lens
                                if n == next_prime(n)]))


def check_gateway_shapes(torch, gen, shapes) -> dict:
    """The paged, chunk and SSD kernels against their plain versions at the
    shapes the gateway phase's short prompts give them (see
    :func:`gateway_shapes`), under the main path's limits: paged decode of
    ``max_slots`` lanes at the trace's sequence lengths, one chunk call of
    ``max_slots`` lanes whose valid rows start at position 0, and mamba2's
    whole-prompt SSD prefills. Each check reports the variant it took; the
    bf16 chunk and SSD calls must take ``wgmma``, as on the path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import chunk_prefill as cp
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_chunk as ssd

    cfg = get_config(MAIN["model"])
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    page = 16       # NodeRuntime's default, which the gateway's nodes keep
    C = GATEWAY["prefill_chunk_tokens"]
    W = -(-GATEWAY["s_max"] // page)
    n_rows = GATEWAY["max_slots"] * W + 1
    bf16 = torch.bfloat16
    out = {}

    def taken(mod):
        return {k: v for k, v in mod.launches_by_variant.items() if v}

    ops.reset_counts()
    lens = shapes["decode_lens"]
    q, kp, vp, bt, sl = paged_inputs(torch, gen, lens, H, Hkv, hd, page, W,
                                     n_rows, bf16)
    err = float((pa.paged_attention(q, kp, vp, bt, sl).float()
                 - ref.paged_attention_ref(q, kp, vp, bt, sl).float())
                .abs().max())
    require(err <= 2e-2, f"paged_attention bf16 at the gateway's lengths "
            f"{lens}: max_abs_err {err} > 2e-2")
    out["paged_attention"] = dict(
        seq_lens=lens, max_abs_err=err, launches=pa.launches,
        split=dict(zip(("n_split", "span"),
                       pa.split_plan(len(lens), Hkv, W, page))))
    del q, kp, vp

    lens = shapes["chunk_lens"]
    pos = chunk_positions(torch, lens, C)
    q = torch.randn((len(lens), C, H, hd), generator=gen,
                    device="cuda").to(bf16)
    _, kp, vp, bt, _ = paged_inputs(torch, gen, [1] * len(lens), H, Hkv, hd,
                                    page, W, n_rows, bf16)
    got = cp.chunk_prefill_attention(q, kp, vp, bt, pos)
    want = ref.chunk_prefill_attention_ref(q.float(), kp.float(), vp.float(),
                                           bt, pos)
    err, row = chunk_errors(got, want)
    require(err <= 2e-2 and row <= 2e-2,
            f"chunk_prefill bf16 at the gateway's prompts {lens}: err {err}, "
            f"row {row}")
    out["chunk_prefill_attention"] = dict(
        valid_rows=lens, C=C, max_abs_err=err, row_scaled_err=row,
        launches_by_variant=taken(cp))
    require(out["chunk_prefill_attention"]["launches_by_variant"]
            == {"wgmma": 1}, f"chunk_prefill at the gateway's prompts: "
            f"{out['chunk_prefill_attention']['launches_by_variant']}")
    del q, kp, vp, got, want

    lens = shapes["ssd_lens"]
    out["ssd_chunk"] = dict(lens=lens, **ssd_errors(torch, gen, lens,
                                                    "gateway"),
                            launches_by_variant=taken(ssd))
    require(out["ssd_chunk"]["launches_by_variant"] == {"wgmma": len(lens)},
            f"ssd_chunk at the gateway's prompts: "
            f"{out['ssd_chunk']['launches_by_variant']}")
    return out


def phase_kernels(torch, args, prompt_lens, suffix_shape, gw_shapes):
    """Each kernel against its plain version, then both timed; the chunk
    kernel also at ``suffix_shape`` = (M, C), a prefix-cache hit's suffix
    of C tokens after M cached ones (B = 1); the paged, chunk and SSD
    kernels also at the gateway's shapes (:func:`check_gateway_shapes`)."""
    from repro_torch.launch import roofline as rl
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
    want = ref.paged_attention_ref(q.float(), kp.float(), vp.float(), bt, sl)
    err, row_err = chunk_errors(got, want)
    require(err <= 2e-2 and row_err <= 2e-2,
            f"paged_attention bf16: max_abs_err {err}, row-scaled {row_err}")
    del want
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
    n_bytes, n_flops = rl.paged_cost(seq_lens, H, Hkv, hd, W, 2)
    b_ms, b_by = rl.bound(n_bytes, n_flops, rl.H100.peak_flops)
    results["paged_attention"] = dict(
        max_abs_err=err, row_scaled_err=row_err, max_abs_err_f32=err32,
        splice_bitwise=True,
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
    err, row_err = chunk_errors(got, want)
    require(err <= 2e-2, f"chunk_prefill bf16 max_abs_err {err} > 2e-2")
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
    # a hit's suffix: one sequence, C rows from position M on, read through
    # its table with the cached prefix before them
    M, Cs = suffix_shape
    pos1 = torch.arange(M, M + Cs, dtype=torch.int32, device="cuda")[None]
    q1 = torch.randn((1, Cs, H, hd), generator=gen, device="cuda").to(bf16)
    _, kp1, vp1, bt1, _ = paged_inputs(torch, gen, [1], H, Hkv, hd, page, W,
                                       n_rows, bf16)
    got1 = cp.chunk_prefill_attention(q1, kp1, vp1, bt1, pos1)
    want1 = ref.chunk_prefill_attention_ref(q1.float(), kp1.float(),
                                            vp1.float(), bt1, pos1)
    err1, row1 = chunk_errors(got1, want1)
    require(err1 <= 2e-2 and row1 <= 2e-2,
            f"chunk_prefill at the suffix shape: err {err1}, row {row1}")
    n_bytes, n_flops = rl.chunk_cost(pos1, H, Hkv, hd, W, 2)
    b1_ms, b1_by = rl.bound(n_bytes, n_flops, rl.H100.peak_flops)
    suffix = dict(
        M=M, C=Cs, variant=cp.variant(bf16, hd, page), max_abs_err=err1,
        row_scaled_err=row1,
        **kernel_times(lambda: cp.chunk_prefill_attention(q1, kp1, vp1, bt1,
                                                          pos1)),
        plain_ms=time_ms(lambda: ref.chunk_prefill_attention_ref(
            q1, kp1, vp1, bt1, pos1), reps=5),
        bound_ms=b1_ms, bound_by=b1_by)
    del q1, kp1, vp1
    n_bytes, n_flops = rl.chunk_cost(pos, H, Hkv, hd, W, 2)
    b_ms, b_by = rl.bound(n_bytes, n_flops, rl.H100.peak_flops)
    results["chunk_prefill_attention"] = dict(suffix_shape=suffix,
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
    for name, got in check_gateway_shapes(torch, gen, gw_shapes).items():
        results[name]["gateway_shapes"] = got
        emit("kernel_check_gateway", name=name, **got)
    return results


def serve(torch, model, prompts, *, device, arena_rows=None,
          max_new=MAIN["max_new"], extras=None, **kw):
    """Drain ``prompts`` through a fresh engine, ``max_new`` tokens each;
    ``extras``: request i's frames or patch embeddings, row i of each
    numpy array (None: the engine's stub). Returns the engine, the finished
    requests by id, and per step (wall seconds, prefill tokens, decode
    tokens)."""
    from repro_torch.core.runtime.accounting import MemoryAccountant
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.kv_arena import KVArena

    arena = (KVArena(kw["page_tokens"], init_rows=arena_rows, device=device)
             if arena_rows else None)
    eng = Engine(model, MemoryAccountant(m_total=60e9), arena=arena,
                 device=device, **kw)
    for i, p in enumerate(prompts):
        ex = None if extras is None else {
            k: torch.from_numpy(a[i:i + 1]).to(device, model.cfg.dtype)
            for k, a in extras.items()}
        eng.submit(Request(req_id=i, tokens=list(p), max_new=max_new,
                           extras=ex))
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
    "ssd_chunk_bwd": ("repro_ssd_bwd::",),
}


def profile_step(torch, eng):
    """Device time by kernel over one engine step (torch.profiler), and the
    share of the step's device time in each hand kernel (by kernel name).
    The profiled step's wall time includes the profiler's own overhead, so
    its idle share is an upper bound."""
    return profile_steps(torch, eng, lambda: False)


def profile_steps(torch, eng, more):
    """:func:`profile_step` over one engine step and the further steps
    taken while ``more()`` holds."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        n += 1
        while more():
            eng.step()
            n += 1
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, ranges = [], {}
    for ev in prof.key_averages():
        group, sep, label = ev.key.partition("::")
        if sep and group in RANGE_GROUPS:
            # a range of moe_ranges or cross_ranges: its kernels' time, from
            # the host side (the device side's annotation is not a kernel)
            if not str(ev.device_type).endswith("CUDA"):
                ranges.setdefault(group, {})[label] = (
                    ev.device_time_total / 1e3)
            continue
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
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms, steps=n,
               idle_share=1 - busy_ms / wall_ms, device_share=share,
               top=[dict(kernel=name[:90], ms=ms, calls=n)
                    for ms, name, n in kernels[:8]])
    for group, ms in ranges.items():
        out[f"{group}_ms"] = ms
        out[f"{group}_share"] = {k: t / busy_ms for k, t in ms.items()}
    return out


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
    from repro_torch.kernels import ops
    return ops.counts()["launches"]


def variant_counts():
    """Launches by variant since the last ``ops.reset_counts``, for the
    kernels that have variants."""
    from repro_torch.kernels import ops
    return ops.counts()["launches_by_variant"]


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
    return launches, by_variant, tokens


def phase_dense_kv(torch, model, prompts, tokens_mono):
    """The main path's model and requests through the Engine's dense KV
    backend (``kv_backend="dense"``: each attention layer's K/V in a dense
    [max_slots, s_max, Hkv, hd] cache, no arena plane, monolithic prefill,
    one token per decode step). The decode reads the dense cache through
    the paged kernel, the cache viewed as pages; the greedy tokens must
    equal the monolithic paged path's. Returns the launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    cfg = model.cfg
    kw = {k: MAIN[k] for k in ("max_slots", "s_max", "page_tokens")}
    reset_peak(torch)
    ops.reset_counts()
    eng, done, steps = serve(torch, model, prompts, device="cuda",
                             kv_backend="dense", **kw)
    launches = {k: n for k, n in launch_counts().items() if n}
    by_variant = dict(fa.launches_by_variant)
    plain = dict(ops.plain_calls)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(eng.kv_backend == "dense" and not eng.paged
            and eng.binding.plane is None and eng.chunk_tokens == 0
            and eng.horizon == 1, "the dense engine did not degrade")
    expected = cfg.n_layers * len(prompts)
    require(set(launches) == {"flash_attention", "paged_attention"}
            and launches["flash_attention"] == expected
            and by_variant["wgmma"] == expected,
            f"dense KV path launches {launches}, flash by variant "
            f"{by_variant}: not flash (wgmma) per prompt and layer and the "
            f"paged decode")
    require(launches["paged_attention"]
            == cfg.n_layers * eng.stat_decode_syncs,
            f"paged_attention launched {launches['paged_attention']} times "
            f"over {eng.stat_decode_syncs} decode steps")
    require(not any(plain.values()),
            f"a plain version ran on the dense KV path: {plain}")
    for i, r in done.items():
        require(len(r.out) == MAIN["max_new"] and not r.truncated,
                f"request {i} emitted {len(r.out)} tokens")
    tokens = {i: r.out for i, r in done.items()}
    diff = first_difference(torch, model, prompts, tokens_mono, tokens)
    require(diff is None, f"dense KV tokens differ from the monolithic "
            f"paged path's: {diff}")
    S = eng.cache["k"].shape[2]
    kv_bytes = 2 * (cfg.n_layers * kw["max_slots"] * S * cfg.n_kv_heads
                    * cfg.head_dim_ * 2)
    require(eng._state_bytes == kv_bytes,
            f"dense cache of {eng._state_bytes} bytes, not {kv_bytes}")
    emit("dense_kv", model=cfg.name, config={**kw, "kv_backend": "dense"},
         launches=launches, flash_launches_by_variant=by_variant,
         plain_calls=plain, **serving_rates(done, steps),
         stat_decode_syncs=eng.stat_decode_syncs,
         dense_cache_gb=kv_bytes / 1e9, peak_mem_gb=peak_gb,
         identical_to_monolithic=True)
    del eng
    torch.cuda.empty_cache()
    return launches


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
    degrade to 0 and 1. Returns this path's launches and the model (the
    node phase reuses it)."""
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
    return launches, by_variant, model


# ------------------------------------------------- launch: the dry run
# the card shapes the dry run (repro_torch.launch) is held to: the model,
# the cell, the kernels its step must launch
LAUNCH_SHAPES = {
    "decode": (MAIN["model"], dict(kind="decode", global_batch=8,
                                   seq_len=4096), ("paged_attention",)),
    "prefill": (MAIN["model"], dict(kind="prefill", global_batch=1,
                                    seq_len=4096), ("flash_attention",)),
    "ssm_prefill": (SSM_MODEL, dict(kind="prefill", global_batch=1,
                                    seq_len=4096), ("ssd_chunk",)),
}
# timed steps after warm-up; the predicted peak's window around the
# measured one; the largest share of the measured time the lower bound may
# take (above it the count is wrong)
LAUNCH = dict(warmup=2, reps=5, peak_window=(0.75, 1.25), max_share=1.05)


def dry_run(cfg, shape, **kw) -> dict:
    """The dry run's record of one cell on one card (``--mesh local``)."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(cfg.name, shape, "local", cfg=cfg, **kw)
    require(rec["status"] == "ok", f"dry run of {cfg.name} {shape}: {rec}")
    return rec


def hold_launch(label: str, cfg, shape: dict, rec: dict, meas: dict,
                kernels) -> dict:
    """Emit the ``launch`` line of a card shape: the dry run's argument
    bytes, peak and step lower bound against the card's (``meas``:
    ``argument_bytes``, ``peak_bytes``, ``max_memory_allocated``,
    ``step_s``, ``step_s_all``, ``launches``, ``plain_calls``), and fail on
    any argument byte of difference, a peak outside ``LAUNCH``'s window, a
    bound over ``max_share`` of the step, a plain call, or a kernel of the
    shape that did not launch."""
    from repro_torch.launch import roofline as rl
    mem, rf = rec["memory"], rec["roofline"]
    bound_s = rf["step_s_lower_bound"]
    peak_ratio = mem["peak_bytes_per_device"] / meas["peak_bytes"]
    line = dict(
        card_shape=label, model=cfg.name, n_layers=cfg.n_layers, **shape,
        predicted_argument_bytes=mem["argument_bytes"],
        measured_argument_bytes=meas["argument_bytes"],
        predicted_peak_bytes=mem["peak_bytes_per_device"],
        measured_peak_bytes=meas["peak_bytes"],
        max_memory_allocated=meas["max_memory_allocated"],
        predicted_over_measured_peak=peak_ratio,
        predicted_temp_bytes=mem["temp_bytes"],
        step_s_lower_bound=bound_s, bottleneck=rf["bottleneck"],
        compute_s=rf["compute_s"], memory_s=rf["memory_s"],
        counted_flops=rec["cost"]["flops"],
        counted_ideal_bytes=rec["cost"]["ideal_bytes"],
        measured_step_s=meas["step_s"], step_s_all=meas["step_s_all"],
        bound_share=bound_s / meas["step_s"],
        model_flops=rl.model_flops(cfg, shape),
        mfu=rl.model_flops(cfg, shape) / (rl.H100.peak_flops
                                          * meas["step_s"]),
        predicted_kernel_calls={k: v["calls"]
                                for k, v in rec["kernels"].items()},
        launches=meas["launches"], plain_calls=meas["plain_calls"],
        count_s=rec["count_s"], profile_step=meas.get("profile_step"))
    emit("launch", **line)
    lo, hi = LAUNCH["peak_window"]
    require(mem["argument_bytes"] == meas["argument_bytes"],
            f"launch {label}: predicted argument bytes "
            f"{mem['argument_bytes']}, the card's {meas['argument_bytes']}")
    require(lo <= peak_ratio <= hi,
            f"launch {label}: predicted peak {mem['peak_bytes_per_device']}"
            f" is {peak_ratio:.3f} x the measured {meas['peak_bytes']}")
    require(line["bound_share"] <= LAUNCH["max_share"],
            f"launch {label}: the lower bound {bound_s} s is "
            f"{line['bound_share']:.3f} of the measured {meas['step_s']} s")
    require(not any(meas["plain_calls"].values()),
            f"launch {label}: a plain version ran: {meas['plain_calls']}")
    for k in kernels:
        require(meas["launches"].get(k, 0) > 0,
                f"launch {label}: {k} did not launch: {meas['launches']}")
    return line


def device_busy(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time, the
    device's busy time (kernels' self device time), the idle share and the
    four costliest kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", None)
            kernels.append(((ev.self_cuda_time_total if us is None else us)
                            / 1e3, ev.key, ev.count))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=1 - busy / wall_ms,
                top=[dict(kernel=name[:80], ms=ms, calls=n)
                     for ms, name, n in kernels[:4]])


def card_step(torch, model, shape: dict, seed: int) -> dict:
    """One card shape through ``build_cell``'s step on ``model`` (on the
    card): its arguments' bytes; the peak of one step, as the arguments
    plus the most the step allocated above what was resident before it
    (what else lives on the card is not the step's); the launches and
    plain calls of that step; then the median of CUDA-event intervals over
    ``LAUNCH["reps"]`` steps after ``LAUNCH["warmup"]``, and one step
    under the profiler (:func:`device_busy`)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.counter import tensor_bytes
    from repro_torch.training.train_step import build_cell
    gen = torch.Generator(device="cuda").manual_seed(seed)
    step, args = build_cell(model, shape, generator=gen)
    arg_bytes = tensor_bytes(args)
    for _ in range(LAUNCH["warmup"]):
        step(*args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    out = step(*args)
    torch.cuda.synchronize()
    launches = {k: n for k, n in launch_counts().items() if n}
    plain = dict(ops.plain_calls)
    max_alloc = torch.cuda.max_memory_allocated()
    del out
    times = []
    for _ in range(LAUNCH["reps"]):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        step(*args)
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / 1e3)
    prof = device_busy(torch, lambda: step(*args))
    del args
    return dict(profile_step=prof, argument_bytes=arg_bytes,
                peak_bytes=arg_bytes + max_alloc - base,
                max_memory_allocated=max_alloc, step_s=statistics.median(
                    times), step_s_all=times, launches=launches,
                plain_calls=plain)


def phase_launch(torch, args, models: dict) -> dict:
    """The dry run held to the card at ``LAUNCH_SHAPES``: each shape's
    config counted on ``meta`` (``--mesh local``), then its step run on the
    card in bf16 at full width on the model already built (``models`` by
    name). Returns each shape's kernel launches."""
    out = {}
    for label, (name, shape, kernels) in LAUNCH_SHAPES.items():
        model = models[name]
        rec = dry_run(model.cfg, shape)
        meas = card_step(torch, model, shape, args.seed)
        hold_launch(label, model.cfg, shape, rec, meas, kernels)
        out[f"launch_{label}"] = meas["launches"]
        reset_peak(torch)
    return out


# ----------------------------------------------- the examples' entry points
EXAMPLE_ARCHS = (MAIN["model"], SSM_MODEL, "moonshot-v1-16b-a3b",
                 "whisper-medium")


def phase_examples(torch) -> dict:
    """``repro_torch.examples`` on the card: quickstart (reduced, 5 train
    steps, 4 requests through ``Engine``) for qwen3-8b, mamba2-2.7b,
    moonshot-v1-16b-a3b and whisper-medium, each with finite losses, its
    attention (flash forward with lse, backward, serving forward, paged
    decode) or scan (forward, backward) launched and no plain version; then
    serve_multi_agent (2 jobs, its predictor trained on 40) in process on
    the card, every job finished. Returns the launches of each run."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.examples import quickstart, serve_multi_agent
    from repro_torch.kernels import ops
    out = {}
    for arch in EXAMPLE_ARCHS:
        ops.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            r = quickstart.main(["--arch", arch])
        wall = time.perf_counter() - t0
        launches = {k: n for k, n in launch_counts().items() if n}
        plain = dict(ops.plain_calls)
        want = (("ssd_chunk", "ssd_chunk_bwd")
                if get_config(arch).family == "ssm" else
                ("flash_attention_lse", "flash_attention_bwd",
                 "flash_attention", "paged_attention"))
        require(all(math.isfinite(x) for x in r["losses"] + r["grad_norms"])
                and len(r["losses"]) == 5,
                f"examples quickstart {arch}: losses {r['losses']}")
        require(not any(plain.values()),
                f"examples quickstart {arch}: a plain version ran: {plain}")
        require(all(launches.get(k, 0) > 0 for k in want),
                f"examples quickstart {arch}: launches {launches}, not all "
                f"of {want}")
        require(r["invariant"] and len(r["tokens"]) == 4,
                f"examples quickstart {arch}: {r}")
        emit("examples", example="quickstart", arch=arch, wall_s=wall,
             losses=r["losses"], grad_norms=r["grad_norms"],
             tokens=r["tokens"], headroom=r["headroom"],
             invariant=r["invariant"], launches=launches, plain_calls=plain)
        out[f"examples_quickstart_{arch}"] = launches
    ops.reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        m = serve_multi_agent.main(n_jobs=2, train_jobs=40)
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in launch_counts().items() if n}
    plain = dict(ops.plain_calls)
    require(m.finished_jobs == 2 and m.dropped_jobs == 0
            and m.run_outcome == "completed",
            f"examples serve_multi_agent: {m.finished_jobs} of 2 jobs "
            f"({m.run_outcome})")
    require(not any(plain.values()) and launches,
            f"examples serve_multi_agent: plain calls {plain}, launches "
            f"{launches}")
    emit("examples", example="serve_multi_agent", n_jobs=2, train_jobs=40,
         wall_s=wall, finished_jobs=m.finished_jobs,
         slo_attainment=m.slo_attainment, makespan_s=m.makespan_s,
         generated_tokens=m.generated_tokens, launches=launches,
         plain_calls=plain)
    out["examples_serve_multi_agent"] = launches
    reset_peak(torch)
    return out


# ------------------------------------------------------------ prefix cache
# one multi-agent workflow: a shared context (the team's system prompt and
# the upstream turns), stage 0 with its own 211 tokens, then 7 stages with
# own suffixes of 64-500 tokens; stage 1 repeats stage 0's first 8 own
# tokens (a hit that ends mid-page: copy on write), stage 2 all of stage
# 0's full pages before it diverges
WORKFLOW = dict(context=1024, own0=211, own_min=64, own_max=500, stages=8,
                partial_stage=1, partial_tokens=8, full_stage=2)


def workflow(rng, vocab: int, page: int = 16):
    """The workflow's prompts and each stage's expected prefix-cache match
    (0 for stage 0, which is prefilled alone first). Each stage's own
    tokens differ from stage 0's right after what they share, so the match
    is exactly the one constructed."""
    W = WORKFLOW

    def rand(n):
        return [int(t) for t in rng.integers(0, vocab, n)]

    ctx, own0 = rand(W["context"]), rand(W["own0"])
    prompts, matched = [ctx + own0], [0]
    full0 = (len(prompts[0]) // page) * page - W["context"]
    for s in range(1, W["stages"]):
        own = rand(int(rng.integers(W["own_min"], W["own_max"] + 1)))
        shared = {W["partial_stage"]: W["partial_tokens"],
                  W["full_stage"]: full0}.get(s, 0)
        if len(own) <= shared + page:
            own += rand(shared + page + 1 - len(own))
        own[:shared] = own0[:shared]
        if own[shared] == own0[shared]:
            own[shared] = (own0[shared] + 1) % vocab
        prompts.append(ctx + own)
        matched.append(W["context"] + shared)
    return prompts, matched


@contextlib.contextmanager
def first_tokens(torch, model, eng):
    """Records, for each request ``eng`` gives its first token, that
    token's logits (f32) and the K/V of its prompt as the sequence's pages
    hold them at that moment ([L, P, Hkv, hd] each), by request id."""
    calls, seen = ("prefill_with_state", "prefill_suffix",
                   "prefill_chunk"), {}
    out = {}
    for name in calls:
        def rec(*a, _orig=getattr(model, name), **k):
            res = _orig(*a, **k)
            seen["logits"] = res[0] if isinstance(res, tuple) else res
            return res
        setattr(model, name, rec)        # shadows the method
    first_token = eng._first_token

    def rec_first(req, tok):
        rid, P, page = req.req_id, len(req.tokens), eng.page_tokens
        row = eng.slot_of[rid] if eng.chunk_tokens else 0
        rows = torch.from_numpy(
            eng.binding.row_table(rid)[:-(-P // page)]).to(eng.device)
        plane = eng.binding.plane
        out[rid] = dict(
            logits=seen["logits"][row].float().clone(),
            **{n: t[:, rows].flatten(1, 2)[:, :P].clone()
               for n, t in (("k", plane.k), ("v", plane.v))})
        first_token(req, tok)
    eng._first_token = rec_first
    try:
        yield out
    finally:
        for name in calls:
            delattr(model, name)


def run_workflow(torch, model, flow, *, device, chunk, prefix, rows=None,
                 profile=False, fault=None):
    """Stage 0 alone to its end, then stages 1-7 together, on a fresh
    engine (``max_slots=8, s_max=2048, page 16``, horizon 8); ``fault``,
    if given, is called with the engine between the two parts. Returns the
    engine, the finished requests by id, each request's first token's
    logits and prompt K/V (``first_tokens``), and per step of the second
    part (wall seconds, prefill tokens, decode tokens); with ``profile``,
    the second part only runs until every stage has its first token,
    under the profiler, and its device time by kernel is returned instead
    of the steps, with nothing recorded."""
    from repro_torch.core.runtime.accounting import MemoryAccountant
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.kv_arena import KVArena

    page = MAIN["page_tokens"]
    arena = (KVArena(page, init_rows=rows, device=device) if rows
             else None)
    eng = Engine(model, MemoryAccountant(m_total=60e9),
                 max_slots=MAIN["max_slots"], s_max=MAIN["s_max"],
                 page_tokens=page, arena=arena, prefix_cache=prefix,
                 prefill_chunk_tokens=chunk,
                 decode_horizon=MAIN["decode_horizon"], device=device)
    n_new = MAIN["max_new"]
    if profile:
        first = {}
        recorder = contextlib.nullcontext(first)
    else:
        recorder = first_tokens(torch, model, eng)
    with recorder as first:
        eng.submit(Request(req_id=0, tokens=list(flow[0]), max_new=n_new))
        done = {r.req_id: r for r in eng.drain()}
        if fault is not None:
            fault(eng)
        for i, p in enumerate(flow[1:], 1):
            eng.submit(Request(req_id=i, tokens=list(p), max_new=n_new))
        if profile:
            prof = profile_steps(torch, eng, lambda: any(
                not r.out for r in list(eng.active.values())
                + list(eng.waiting)))
            for rid in list(eng.active):
                eng.evict(rid)
            return eng, done, first, prof
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
    done.update({r.req_id: r for r in eng.finished})
    require(eng.arena.mapped_pages() == 0 and eng.arena.check_mirror(),
            "KV pages leaked or the arena's mirror broke")
    return eng, done, first, steps


def phase_prefix_reference(torch, args):
    """Reduced qwen3-8b (f32) with the prefix cache on, chunked (256) and
    monolithic, horizon 8, the workflow at the reduced vocabulary: the
    card and the CPU must give identical tokens, hits and counters
    (matching is host-side: tokens and page size alone decide it)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, init_params

    cfg = get_config(MAIN["model"]).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(args.seed), "cpu")
    flow, matched = workflow(np.random.default_rng(args.seed + 3), cfg.vocab)
    for chunk in (MAIN["prefill_chunk_tokens"], 0):
        out = {}
        for device in ("cpu", "cuda"):
            model = build_model(cfg, params, device=device)
            ops.reset_counts()
            eng, done, _, _ = run_workflow(torch, model, flow,
                                           device=device, chunk=chunk,
                                           prefix=True)
            out[device] = dict(
                tokens={i: r.out for i, r in done.items()},
                prefill_avoided=[done[i].prefill_avoided
                                 for i in sorted(done)],
                pages_aliased=eng.arena.pages_aliased,
                cow_copies=eng.arena.cow_copies,
                check_mirror=eng.arena.check_mirror())
            launches = launch_counts()
        cpu, card = out["cpu"], out["cuda"]
        require(card == cpu, f"reduced prefix path (chunk {chunk}): the "
                f"card differs from the CPU")
        require(cpu["prefill_avoided"] == matched,
                f"prefill avoided {cpu['prefill_avoided']}, not {matched}")
        require(not any(ops.plain_calls.values()),
                "a plain version ran on the card")
        require(launches["chunk_prefill_attention"] > 0
                and launches["paged_attention"] > 0,
                f"reduced prefix path launches {launches}")
        emit("prefix_reference", model=cfg.name, prefill_chunk_tokens=chunk,
             identical_tokens=True,
             **{k: card[k] for k in ("prefill_avoided", "pages_aliased",
                                     "cow_copies", "check_mirror")},
             launches={k: n for k, n in launches.items() if n})


# limits of a hit stage's cache-on run against its cache-off run, each
# scaled to the cache-off values' magnitude: the first token's logits, and
# every page of the cached prefix (positions below the match) as the
# sequence reads it. The monolithic cache-on run is repeated once with
# the pinned row of context page FAULT_PAGE overwritten by the next
# page's K/V (a stale page), which both checks must flag, the page check
# on that page alone. On the H100 the sound runs read at most 1.8e-2
# (logits; a 17-row suffix through other GEMM shapes) and 0 (pages); the
# stale page 0.14-0.18 (logits) and 1.4 (its page)
LOGITS_LIMIT, KV_LIMIT, FAULT_PAGE = 0.05, 0.1, 32


def hit_errors(torch, off, on, matched, hit):
    """Per hit stage, the cache-on run's first-token logits and cached
    prefix pages against the cache-off run's (``first_tokens``): the
    logits' largest error and each page's, scaled to the magnitude of the
    cache-off logits and K/V (per K and V), and the pages over
    ``KV_LIMIT``."""
    page = MAIN["page_tokens"]
    out = dict(logits={}, kv={}, pages_over={})
    for i in hit:
        a, b, M = off[i], on[i], matched[i]
        out["logits"][i] = float((b["logits"] - a["logits"]).abs().max()
                                 / a["logits"].abs().max())
        err = torch.zeros(-(-M // page), device=a["k"].device)
        for n in ("k", "v"):
            want = a[n][:, :M].float()
            d = (b[n][:, :M].float() - want).abs().amax(dim=(0, 2, 3))
            d = torch.nn.functional.pad(d, (0, err.numel() * page - M))
            err = torch.maximum(err, d.view(-1, page).amax(1)
                                / want.abs().max())
        out["kv"][i] = float(err.max())
        out["pages_over"][i] = [int(j) for j in
                                torch.nonzero(err > KV_LIMIT).flatten()]
    return out


def stale_page(flow):
    """A fault for ``run_workflow``: the pinned row of stage 0's context
    page ``FAULT_PAGE`` takes the next page's K/V, in every layer."""
    from repro_torch.serving.prefix_cache import page_digests

    def fault(eng):
        digs = page_digests(flow[0], eng.page_tokens, eng._pc_ns)
        dst, src = (eng._pc.entries[digs[j]].row
                    for j in (FAULT_PAGE, FAULT_PAGE + 1))
        plane = eng.binding.plane
        plane.k[:, dst] = plane.k[:, src]
        plane.v[:, dst] = plane.v[:, src]
    return fault


PREFIX_LAYERS = 3     # of qwen3-8b's 36: the phase's depth, cut for time


def shallow(model, n_layers: int):
    """A model over the first ``n_layers`` layers of ``model`` (its
    embedding, final norm and head too), sharing its weights: no copy."""
    from repro_torch.models import build_model
    tree = model.param_tree()
    tree["layers"] = tree["layers"][:n_layers]
    return build_model(dataclasses.replace(model.cfg, n_layers=n_layers),
                       tree, device="cuda")


def phase_prefix(torch, model, flow, matched):
    """qwen3-8b at its widths and ``PREFIX_LAYERS`` layers (a cut of the
    main path's model, sharing its weights) serving the workflow, chunked
    (256) and monolithic, with the prefix cache off and on. The hit
    stages' suffixes run the chunk kernel (monolithic: one call per layer
    and stage, all wgmma), their decode the paged kernel over aliased
    rows. Each hit stage's first-token logits and cached prefix pages
    must agree with the cache-off run's; a planted stale page must be
    caught."""
    from repro_torch.kernels import ops

    model = shallow(model, PREFIX_LAYERS)
    rows = 2 * (MAIN["max_slots"] * -(-MAIN["s_max"] // MAIN["page_tokens"])
                + 1)                              # live rows + the pins
    hit = list(range(1, len(flow)))
    prompt_tokens = sum(len(p) for p in flow)
    result, launches_on = {}, {}
    for chunk in (MAIN["prefill_chunk_tokens"], 0):
        mode = "chunked" if chunk else "monolithic"
        runs = {}
        for prefix in (False, True):
            reset_peak(torch)
            ops.reset_counts()
            eng, done, first, _ = run_workflow(torch, model, flow,
                                               device="cuda", chunk=chunk,
                                               prefix=prefix, rows=rows)
            launches = launch_counts()
            variants = variant_counts()
            plain = dict(ops.plain_calls)
            require(not any(plain.values()),
                    f"a plain version ran on the prefix path: {plain}")
            for i, r in done.items():
                require(len(r.out) == MAIN["max_new"] and not r.truncated
                        and all(0 <= t < model.vocab_padded for t in r.out),
                        f"prefix path request {i}: {len(r.out)} tokens")
            _, _, _, prof = run_workflow(torch, model, flow, device="cuda",
                                         chunk=chunk, prefix=prefix,
                                         rows=rows, profile=True)
            runs[prefix] = dict(
                eng=eng, done=done, first=first, launches=launches,
                variants=variants, plain=plain, profile=prof,
                ttft=statistics.median(done[i].ttft_s for i in hit))
            del eng
        off, on = runs[False], runs[True]
        avoided = [on["done"][i].prefill_avoided for i in sorted(on["done"])]
        require(avoided == matched,
                f"{mode}: prefill avoided {avoided}, not {matched}")
        require(all(r.prefill_avoided == 0 for r in off["done"].values()),
                f"{mode}: the cache-off run avoided prefill")
        eng = on["eng"]
        require(eng.arena.cow_copies >= 1 and eng.arena.pages_aliased > 0,
                f"{mode}: cow_copies {eng.arena.cow_copies}, pages_aliased "
                f"{eng.arena.pages_aliased}")
        lo = on["launches"]
        require(lo["chunk_prefill_attention"] > 0 and lo["paged_attention"]
                > 0, f"{mode}: a kernel of the prefix path never ran: {lo}")
        require_all_wgmma("chunk_prefill_attention",
                          lo["chunk_prefill_attention"],
                          on["variants"]["chunk_prefill_attention"])
        first_diff = {}
        for i in hit:
            a, b = off["done"][i].out, on["done"][i].out
            first_diff[i] = next((j for j, (x, y) in enumerate(zip(a, b))
                                  if x != y), None)
        entry = dict(
            prompt_tokens=prompt_tokens, prefill_avoided=sum(avoided),
            prefill_avoided_share=sum(avoided) / prompt_tokens,
            prefill_avoided_by_stage=avoided,
            pages_aliased=eng.arena.pages_aliased,
            cow_copies=eng.arena.cow_copies,
            prefix_stats=eng._pc.stats(),
            check_mirror_after_drain=eng.arena.check_mirror(),
            ttft_median_hit_stages_s=dict(off=off["ttft"], on=on["ttft"]),
            hit_prefill_device_ms=dict(
                off=off["profile"]["device_busy_ms"],
                on=on["profile"]["device_busy_ms"]),
            hit_prefill_wall_ms=dict(off=off["profile"]["wall_ms"],
                                     on=on["profile"]["wall_ms"]),
            hit_prefill_steps=dict(off=off["profile"]["steps"],
                                   on=on["profile"]["steps"]),
            launches=dict(off=off["launches"], on=on["launches"]),
            launches_by_variant=dict(off=off["variants"],
                                     on=on["variants"]),
            plain_calls=on["plain"],
            first_differing_token=first_diff,
            identical_tokens=all(v is None for v in first_diff.values()),
            profile_top_on=on["profile"]["top"])
        errs = hit_errors(torch, off["first"], on["first"], matched, hit)
        entry.update(first_logits_scaled_err=dict(
            max=max(errs["logits"].values()), by_stage=errs["logits"]),
            prefix_kv_scaled_err=dict(max=max(errs["kv"].values()),
                                      by_stage=errs["kv"]),
            limits=dict(logits=LOGITS_LIMIT, kv=KV_LIMIT))
        require(max(errs["kv"].values()) <= KV_LIMIT,
                f"{mode}: cached prefix pages differ from the cache-off "
                f"run's: {errs['kv']}, pages {errs['pages_over']}")
        require(max(errs["logits"].values()) <= LOGITS_LIMIT,
                f"{mode}: hit-stage first-token logits differ by "
                f"{errs['logits']} of their magnitude")
        if not chunk:
            reset_peak(torch)
            _, _, bad, _ = run_workflow(torch, model, flow, device="cuda",
                                        chunk=chunk, prefix=True, rows=rows,
                                        fault=stale_page(flow))
            caught = hit_errors(torch, off["first"], bad, matched, hit)
            entry["planted_stale_page"] = dict(
                page=FAULT_PAGE, pages_over=caught["pages_over"],
                prefix_kv_scaled_err=caught["kv"],
                first_logits_scaled_err=caught["logits"])
            require(all(p == [FAULT_PAGE]
                        for p in caught["pages_over"].values()),
                    f"the planted stale page {FAULT_PAGE} was not caught "
                    f"alone: {caught['pages_over']}")
            require(min(caught["logits"].values()) > LOGITS_LIMIT,
                    f"the planted stale page moved the first-token logits "
                    f"only {caught['logits']}: the logits limit "
                    f"{LOGITS_LIMIT} would pass it")
            del bad
            n_hits, L = len(hit), model.cfg.n_layers
            require(lo["chunk_prefill_attention"] == L * n_hits,
                    f"monolithic hits: chunk launched "
                    f"{lo['chunk_prefill_attention']}, not {L * n_hits}")
            require(lo["flash_attention"] == L,
                    f"monolithic hits: flash launched "
                    f"{lo['flash_attention']}, not {L} (stage 0 only)")
        result[mode] = entry
        launches_on[mode] = lo
        emit("prefix", model=model.cfg.name, n_layers=model.cfg.n_layers,
             mode=mode,
             config=dict(max_slots=MAIN["max_slots"], s_max=MAIN["s_max"],
                         page_tokens=MAIN["page_tokens"],
                         prefill_chunk_tokens=chunk,
                         decode_horizon=MAIN["decode_horizon"],
                         max_new=MAIN["max_new"], workflow=WORKFLOW),
             prompt_lens=[len(p) for p in flow], **entry)
        del runs, off, on, eng
    reset_peak(torch)
    return launches_on


# -------------------------------------------------------------------- node
# the node's models at their widths, cut in depth for the smoke's clock
# (whole until the mesh phase came), under a budget cut with them: its GPU
# tier (0.8 of it, 11.2 GB) holds qwen3-8b's 18 layers (9.4 GB) or
# mamba2-2.7b's 32 (2.8 GB), not both, as 24 GB does the whole models
NODE_LAYERS = {MAIN["model"]: 18, SSM_MODEL: 32}
NODE = dict(hbm_budget=14e9, max_slots=8, s_max=2048, page_tokens=16,
            prefill_chunk_tokens=256, decode_horizon=8, requests=4)


def h2d_rate(torch, n_bytes: int = 1 << 30, reps: int = 5) -> float:
    """Pinned host-to-device copy rate in GB/s (median of ``reps`` copies of
    ``n_bytes``, CUDA events)."""
    src = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(n_bytes, dtype=torch.uint8, device="cuda")
    dst.copy_(src, non_blocking=True)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return n_bytes / statistics.median(times) / 1e9


def phase_node(torch, qwen, mamba, flow):
    """A NodeRuntime on the card co-locating qwen3-8b and mamba2-2.7b at
    their widths and ``NODE_LAYERS`` layers (the models given) under a
    14 GB budget, whose GPU tier (0.8 of it) holds either model's weights
    but not both: a qwen3 batch, a mamba2 batch
    (which puts qwen3 to sleep), then qwen3 again (which puts mamba2 to
    sleep and brings qwen3 back from pinned host memory). Each activation's
    measured seconds stand beside the residency model's prediction, each
    offload's drop in allocated device memory beside the weight bytes the
    accountant let go."""
    from repro_torch.core.runtime.residency import RETRACE_COST_S
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Request
    from repro_torch.serving.node_runtime import NodeRuntime

    q, m = MAIN["model"], SSM_MODEL
    reset_peak(torch)                 # the earlier phases' arenas go first
    models = {q: qwen, m: mamba}
    weight_bytes = {n: sum(p.nbytes for p in mdl.parameters())
                    for n, mdl in models.items()}
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    # one pinned host copy per model: the node keeps these tensors as its
    # host tier, and the gateway phase's fleet shares them
    host = {n: pinned_tree(torch, mdl.param_tree())
            for n, mdl in models.items()}
    node = NodeRuntime(0, 0, dict(models), host, device="cuda",
                       prefix_cache=True,
                       **{k: v for k, v in NODE.items() if k != "requests"})
    torch.cuda.synchronize()
    build = dict(seconds=time.perf_counter() - t0,
                 freed=allocated - torch.cuda.memory_allocated(),
                 weight_bytes=sum(weight_bytes.values()),
                 host_pinned=all(t.is_pinned() for w in
                                 node.host_params.values()
                                 for t in w.values()))
    require(build["host_pinned"], "the host tier is not pinned")
    require(build["freed"] >= 0.95 * build["weight_bytes"],
            f"building the node freed {build['freed']} of "
            f"{build['weight_bytes']} weight bytes")
    require(all(node.profiles[n].weight_bytes == weight_bytes[n]
                for n in models), "profiled weight bytes differ from the "
            "models' own")

    activations = []

    def activate(name):
        """``node.activate``; its record holds the seconds with and
        without the offloads it ran, the latter the model's own activation,
        which ``t_act`` predicts."""
        node.activate(name)
        a = node.activations[-1]
        own = a.seconds - a.offload_s
        activations.append(dict(
            model=name, state_before=a.state_before, predicted_s=a.t_act_s,
            measured_s=own, with_offloads_s=a.seconds, offloads_s=a.offload_s,
            weight_bytes=weight_bytes[name],
            weights_gb_per_s=weight_bytes[name] / own / 1e9))

    def serve_batch(name, prompts, rid0):
        """The first prompt to its end, then the others together."""
        out = {}
        for part, i0 in ((prompts[:1], rid0), (prompts[1:], rid0 + 1)):
            for i, p in enumerate(part, i0):
                node.submit(name, Request(req_id=i, tokens=list(p),
                                          max_new=MAIN["max_new"]))
            for _ in range(10_000):
                if not node.has_work():
                    break
                for reqs in node.step().values():
                    out.update({r.req_id: r.out for r in reqs})
            require(not node.has_work(), f"{name}: the node stalled")
        require(len(out) == len(prompts) and all(
            len(o) == MAIN["max_new"] for o in out.values()),
            f"{name}: {len(out)} of {len(prompts)} requests finished")
        return out

    n = NODE["requests"]
    q_prompts = flow[:n]
    m_prompts = [[t % mamba.cfg.vocab for t in p] for p in flow[n:2 * n]]
    ops.reset_counts()
    t_path = time.perf_counter()
    activate(q)                                   # cold: from host memory
    first = serve_batch(q, q_prompts, 0)
    # Algorithm 2's level 0: room for a request that fits once about half
    # the prefix pins go must come from the index, with no model asleep
    idx = node.arena.prefix_index
    pinned, entries = node.acc.ctx["prefix-cache"], len(idx.entries)
    states = {k: s.value for k, s in node.residency.state.items()}
    need = node.acc.headroom + pinned / 2
    node.make_room(need)
    make_room = dict(r_need=need, pinned_before=pinned,
                     entries_before=entries, entries_after=len(idx.entries),
                     pinned_after=node.acc.ctx.get("prefix-cache", 0.0),
                     states_before=states,
                     states_after={k: s.value for k, s in
                                   node.residency.state.items()},
                     fits=node.acc.can_admit(need))
    require(make_room["entries_after"] < entries and make_room["fits"]
            and make_room["states_after"] == states,
            f"make_room did not trim prefix pins first: {make_room}")
    activate(m)                                   # qwen3 goes to sleep
    require(node.residency.state[q].value == "sleeping",
            f"qwen3 is {node.residency.state[q].value} after mamba2 came")
    serve_batch(m, m_prompts, 100)
    activate(q)                                   # mamba2 sleeps, warm qwen3
    require(node.residency.state[m].value == "sleeping",
            f"mamba2 is {node.residency.state[m].value} after qwen3 came")
    again = serve_batch(q, q_prompts, 0)
    path_s = time.perf_counter() - t_path
    launches = launch_counts()
    plain = dict(ops.plain_calls)
    require(again == first, "qwen3 after a sleep and a reactivation emits "
            "other tokens")
    require(not any(plain.values()),
            f"a plain version ran on the node path: {plain}")
    for k in ("paged_attention", "chunk_prefill_attention", "ssd_chunk"):
        require(launches[k] > 0, f"{k} never launched on the node path")
    require(len(node.activations) == len(activations),
            f"the node ran {len(node.activations)} activations, "
            f"{len(activations)} asked for")
    offloads = offload_rows({node.node_id: node_records(node)})
    require([o["model"] for o in offloads] == [q, m],
            f"offloads {[o['model'] for o in offloads]}")
    for o in offloads:
        require(o["freed_share"] is not None and o["freed_share"] >= 0.95,
                f"offloading {o['model']} freed {o['freed_bytes']} of "
                f"{o['weight_bytes']} weight bytes")
    cold, warm = activations[0]["measured_s"], activations[2]["measured_s"]
    sig = node.signal()
    emit("node", models=list(models), config=NODE,
         n_layers={n: mdl.cfg.n_layers for n, mdl in models.items()},
         hw=dataclasses.asdict(node.profiles[q].hw),
         build=build, activations=activations, offloads=offloads,
         h2d_pinned_gb_per_s=h2d_rate(torch),
         cold_activation_s=cold, warm_activation_s=warm,
         cold_minus_warm_s=cold - warm, retrace_cost_s_model=RETRACE_COST_S,
         make_room=make_room,
         residency_events=[dataclasses.asdict(e)
                           for e in node.residency.events],
         residency={k: s.value for k, s in node.residency.state.items()},
         kv_stats=node.kv_stats(), signal=dataclasses.asdict(sig),
         launches={k: v for k, v in launches.items() if v},
         launches_by_variant=variant_counts(), plain_calls=plain,
         identical_tokens_after_reactivation=True, path_s=path_s,
         check_mirror=node.arena.check_mirror())
    return {k: v for k, v in launches.items() if v}, host


def node_records(node) -> dict:
    """A node's records as plain data: its activations and offloads, read
    from an in-process node or through a worker's ``records()`` (which
    also holds the child's launches, plain calls, peak memory and foreign
    modules)."""
    if hasattr(node, "records"):
        return node.records()
    return dict(activations=[dataclasses.asdict(a) for a in node.activations],
                offloads=[dataclasses.asdict(o) for o in node.offloads])


def offload_rows(records: dict) -> list:
    """Each node's offloads (``records``: node id -> ``node_records``),
    with the share of the weight bytes the accountant let go that left
    allocated device memory."""
    return [dict(node=nid, **o,
                 freed_share=(o["freed_bytes"] / o["weight_bytes"]
                              if o["freed_bytes"] is not None
                              and o["weight_bytes"] else None))
            for nid, r in records.items() for o in r["offloads"]]


def pinned_tree(torch, tree):
    """A copy of a parameter tree in pinned host memory."""
    if isinstance(tree, dict):
        return {k: pinned_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [pinned_tree(torch, v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype,
                       pin_memory=True).copy_(tree)


def tree_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in tree_tensors(v)]
    return [tree]


# ----------------------------------------------------------------- gateway
def train_predictor(n_jobs: int = 300, seed: int = 9):
    """The length predictor trained as ``examples/serve_multi_agent.py``
    trains it (a recorded trace of 300 jobs, seed 9)."""
    from repro_torch.core.predictor import MaestroPred, PredictorConfig
    from repro_torch.core.predictor.gbdt import GBDTConfig
    from repro_torch.data.tracegen import (generate_trace,
                                           stratified_temporal_split)
    train, _ = stratified_temporal_split(generate_trace(n_jobs, seed=seed))
    cfg = PredictorConfig(
        cls=GBDTConfig(objective="logloss", n_trees=30, max_leaves=7),
        reg=GBDTConfig(n_trees=40, max_leaves=15))
    return MaestroPred(cfg).fit(
        [s.obs for s in train], np.array([s.true_len for s in train], float),
        np.array([float(s.tool_call) for s in train]))


def gateway_jobs(seed: int):
    """The gateway phase's traffic: ``generate_trace(16, rate=1.5, seed)``
    through ``jobs_from_trace`` with token ids below the smallest
    vocabulary in the fleet (mamba2's 50,280 embedding rows), so any stage
    can run on either model. Returns the jobs and that vocabulary."""
    from repro_torch.configs import get_config
    from repro_torch.data.tracegen import generate_trace
    from repro_torch.serving import cluster

    vocab = min(get_config(n).vocab for n in (MAIN["model"], SSM_MODEL))
    trace = generate_trace(GATEWAY["jobs"], rate=GATEWAY["rate"], seed=seed)
    return cluster.jobs_from_trace(
        trace, vocab=vocab, prompt_cap=GATEWAY["prompt_cap"],
        gen_cap=GATEWAY["gen_cap"], n_clusters=2, seed=seed), vocab


def gateway_shapes(jobs) -> dict:
    """The kernel shapes the gateway's stages give: ``max_slots`` prompt
    lengths spread from the shortest to the longest (one chunk call's valid
    rows), ``max_slots`` sequence lengths from the shortest prompt's first
    decode token to the longest prompt plus budget (a decode launch's
    lanes), and the shortest, median and longest prompt, the longest one
    inside one SSD chunk and one a token short of a chunk (mamba2's
    whole-prompt prefills)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_chunk import MAX_CHUNK

    lanes = GATEWAY["max_slots"]
    prompts = sorted(len(s.tokens) for j in jobs for s in j.stages)
    seqs = sorted({len(s.tokens) + n for j in jobs for s in j.stages
                   for n in (1, s.max_new)})

    def spread(xs):
        return [xs[round(i * (len(xs) - 1) / (lanes - 1))]
                for i in range(lanes)]

    # the scan's chunk as the kernel takes it
    chunk = min(get_config(SSM_MODEL).ssm.chunk, MAX_CHUNK)
    inside = [p for p in prompts if p < chunk]
    # the longest prompt inside one chunk, and one token short of a full
    # chunk where the prompts reach past it
    ssd_lens = sorted({prompts[0], prompts[len(prompts) // 2], prompts[-1]}
                      | set(inside[-1:])
                      | ({chunk - 1} if prompts[-1] >= chunk else set()))
    return dict(chunk_lens=spread(prompts), decode_lens=spread(seqs),
                ssd_lens=ssd_lens)


def serve_gateway(torch, fleet, jobs, pred, policy, cfg=None,
                  fault_plan=None):
    """One gateway run over ``fleet`` (in-process nodes or worker handles).
    Returns the gateway, its metrics, each stage's (model, tokens,
    truncated) as the nodes hand its request back (a node's ``step``, a
    worker handle's ``step_recv`` and ``drain_ready``), each node's record
    of its activations beside the ``t_act`` the gateway waited for before
    submitting the stages each served (from the gateway's telemetry; None
    where a stage was preempted later, since the telemetry keeps only its
    last dispatch), each node's record of its offloads, and each live
    node's ``node_records``."""
    from repro_torch.core.topology import DEFAULT_RTT
    from repro_torch.serving.gateway import ClusterGateway

    gw = ClusterGateway(fleet, DEFAULT_RTT[:2, :2].copy(), predictor=pred,
                        policy=policy, cfg=cfg)
    tokens = {}
    for node in fleet:
        for name in (("step_recv", "drain_ready")
                     if hasattr(node, "step_send") else ("step",)):
            def collect(inner=getattr(node, name)):
                out = inner()
                for model, reqs in out.items():
                    tokens.update({r.req_id: (model, list(r.out),
                                              r.truncated) for r in reqs})
                return out
            setattr(node, name, collect)
    m = gw.run(jobs, fault_plan=fault_plan)
    events = gw.telemetry.events
    records = {nid: node_records(node) for nid, node in gw.fleet.items()}
    activations = []
    for nid, r in records.items():
        for a in r["activations"]:
            waited = [events[i].t_act_s for i in a["req_ids"]
                      if i in events and not events[i].preemptions]
            activations.append(dict(
                node=nid, **a, measured_s=a["seconds"] - a["offload_s"],
                t_act_waited_s=(max(waited) if a["req_ids"]
                                and len(waited) == len(a["req_ids"])
                                else None)))
    return gw, m, tokens, activations, offload_rows(records), records


def stage_rows(gw, tokens):
    """Per stage: node, tokens, and its ready, dispatch, submit and finish
    times on the gateway's clock."""
    return {sid: dict(node=e.node_id, tokens=tokens.get(sid),
                      ready_t=e.ready_t, dispatch_t=e.dispatch_t,
                      start_t=e.start_t, finish_t=e.finish_t)
            for sid, e in gw.telemetry.events.items()}


def gateway_state(gw) -> dict:
    """What holds the unfinished stages: the queue, the stages in flight
    (node, model, submitted, tokens so far of their budget) and each node's
    engines (waiting, active), deferred requests and residency."""
    return dict(
        queued=sorted(gw._queued),
        inflight={sid: (r.node_id, r.model, r.submitted, len(r.req.out),
                        r.stage.max_new) for sid, r in gw.inflight.items()},
        nodes={nid: dict(engines={k: (len(e.waiting), len(e.active))
                                  for k, e in n.engines.items()},
                         deferred={k: len(q) for k, q in n.deferred.items()},
                         residency={k: v.value for k, v in
                                    n.residency.state.items()})
               for nid, n in gw.fleet.items()})


# the metrics measured on the host's clock
WALL_SIDE = ("ttft_p50_s", "ttft_p95_s")


def phase_gateway_reference(torch, args, pred):
    """The reduced default zoo (f32) on two nodes in clusters 0 and 1,
    under the virtual clock: a small generated trace served under maestro
    and fcfs with the nodes on the card (the hand kernels' simt variants)
    and on the CPU (the plain versions), from the same weights. Every
    stage must run on the same node, emit the same tokens and be ready,
    dispatched, submitted and finished at the same times, and the metrics
    must be equal but for the TTFT percentiles (host time). Returns the
    card's runs by policy: stage rows, metrics and launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving import cluster

    spec = reference_spec()
    names = spec.model_names
    # the zoo a worker of this fleet builds from the same seed
    zoo, host = cluster.build_zoo(names, seed=args.seed)
    trace = reference_trace(args.seed)
    launches, card = {}, {}
    for policy in ("maestro", "fcfs"):
        runs = {}
        for device in ("cpu", "cuda"):
            fleet = cluster.build_fleet(spec, zoo=zoo, host=host,
                                        device=device)
            jobs = reference_jobs(trace, args.seed)
            ops.reset_counts()
            gw, m, tokens, _, _, _ = serve_gateway(torch, fleet, jobs,
                                                   pred, policy)
            runs[device] = (stage_rows(gw, tokens), m.row())
            if device == "cuda":
                launches[policy] = {k: n for k, n in launch_counts().items()
                                    if n}
                plain = dict(ops.plain_calls)
            del gw, fleet
        (cpu_rows, cpu_m), (gpu_rows, gpu_m) = runs["cpu"], runs["cuda"]
        differ = sorted(s for s in cpu_rows if gpu_rows.get(s) != cpu_rows[s])
        metrics_differ = sorted(k for k in cpu_m if k not in WALL_SIDE
                                and gpu_m[k] != cpu_m[k])
        require(not differ and set(gpu_rows) == set(cpu_rows),
                f"gateway_reference {policy}: stages {differ} differ "
                f"between the card and the CPU")
        require(not metrics_differ, f"gateway_reference {policy}: metrics "
                f"{metrics_differ} differ between the card and the CPU")
        require(not any(plain.values()),
                f"gateway_reference {policy}: a plain version ran on the "
                f"card: {plain}")
        require(cpu_m["finished_jobs"] == len(trace),
                f"gateway_reference {policy}: {cpu_m['finished_jobs']} of "
                f"{len(trace)} jobs finished")
        for k in ("paged_attention", "chunk_prefill_attention", "ssd_chunk"):
            require(launches[policy].get(k, 0) > 0,
                    f"gateway_reference {policy}: {k} never launched")
        emit("gateway_reference", policy=policy, models=list(names),
             jobs=len(trace), stages=len(cpu_rows),
             identical_stages=len(cpu_rows), identical_metrics=True,
             finished_jobs=cpu_m["finished_jobs"],
             makespan_virtual_s=cpu_m["makespan_s"],
             cold_starts=cpu_m["cold_starts"],
             preemptions=cpu_m["preemptions"],
             generated_tokens=cpu_m["generated_tokens"],
             launches=launches[policy], plain_calls=plain)
        card[policy] = (gpu_rows, gpu_m, launches[policy])
    reset_peak(torch)
    return card


GATEWAY_REFERENCE = dict(jobs=6, prompt_cap=16, gen_cap=12)


def reference_spec():
    """The reduced default zoo (f32) on two nodes in clusters 0 and 1,
    chunk 8, horizon 4 (phases gateway_reference, worker_reference and
    worker_fault)."""
    from repro_torch.serving import cluster

    knobs = dict(max_slots=2, prefill_chunk_tokens=8, decode_horizon=4)
    return cluster.ClusterSpec(
        nodes=(cluster.NodeSpec(0, **knobs),
               cluster.NodeSpec(1, hbm_budget=0.8e9, **knobs)),
        model_names=cluster.DEFAULT_ZOO)


def reference_trace(seed: int, n_jobs: int = GATEWAY_REFERENCE["jobs"],
                    rate: float = 2.0):
    from repro_torch.data.tracegen import generate_trace
    return generate_trace(n_jobs, rate=rate, seed=seed)


def reference_jobs(trace, seed: int):
    """Live jobs of ``trace`` at the reduced zoo's short prompts."""
    from repro_torch.serving import cluster
    return cluster.jobs_from_trace(
        trace, n_clusters=2, prompt_cap=GATEWAY_REFERENCE["prompt_cap"],
        gen_cap=GATEWAY_REFERENCE["gen_cap"], seed=seed)
GATEWAY = dict(jobs=16, rate=1.5, hbm_budget=24e9, max_slots=8, s_max=2048,
               prefill_chunk_tokens=256, decode_horizon=8, prompt_cap=512,
               gen_cap=64, max_run_s=240.0, reject_limit=1_000_000)
# the in-process gateway's models at their published widths, cut in depth
# for time, under a budget cut with them: its GPU tier (0.8 of it, 4.0 GB)
# holds qwen3-8b's 3 layers (3.65 GB) or mamba2-2.7b's 8 (0.90 GB), not
# both, as the full budget does the whole models
GATEWAY_LAYERS = {MAIN["model"]: 3, SSM_MODEL: 8}
GATEWAY_CUT_BUDGET = 5.0e9


def phase_gateway(torch, args, host, pred):
    """qwen3-8b and mamba2-2.7b at their published widths and
    ``GATEWAY_LAYERS`` layers on two ``NodeRuntime``s that share the card,
    in clusters 0 and 1 (RTT ``DEFAULT_RTT[:2, :2]``), each under a
    budget (``GATEWAY_CUT_BUDGET``) whose GPU tier holds either model's
    weights but not both, with one pinned host copy per model for the
    whole fleet (the node phase's, cut).
    A generated multi-agent trace (16 jobs) served under the wall clock by
    fcfs, then by maestro, each on fresh nodes: every job must finish
    inside ``max_run_s``, no plain version may run, the paged, chunk
    (wgmma) and SSD (wgmma) kernels must launch, and every offload must
    free at least 95% of the weight bytes it drops. Both runs raise the
    gateway's ``reject_limit`` so that no job is dropped; a third run, fcfs
    at the default limit, may drop jobs (a node refuses admissions while it
    drains for a deferred activation) and reports how many. Returns each
    run's launches and the maestro run's numbers."""
    import types

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving import cluster
    from repro_torch.serving.gateway import GatewayConfig

    spec = gateway_spec(GATEWAY_CUT_BUDGET)
    names = spec.model_names
    zoo = {n: types.SimpleNamespace(cfg=dataclasses.replace(
        get_config(n), n_layers=GATEWAY_LAYERS[n])) for n in names}
    # the whole models' pinned host trees, cut: the same tensors
    host = {n: {**host[n], "layers": host[n]["layers"][:GATEWAY_LAYERS[n]]}
            for n in names}
    pinned_ptrs = {n: {t.data_ptr() for t in tree_tensors(host[n])}
                   for n in names}
    pinned_bytes = sum(t.nbytes for n in names
                       for t in tree_tensors(host[n]))
    launches, results = {}, {}
    default_limit = GatewayConfig().reject_limit
    for run, policy, limit in (
            ("fcfs", "fcfs", GATEWAY["reject_limit"]),
            ("maestro", "maestro", GATEWAY["reject_limit"]),
            ("fcfs_default_reject_limit", "fcfs", default_limit)):
        reset_peak(torch)
        fleet = cluster.build_fleet(spec, zoo=zoo, host=host, device="cuda")
        shared = all(t.data_ptr() in pinned_ptrs[n] and t.is_pinned()
                     for node in fleet for n in names
                     for t in node.host_params[n].values())
        require(shared, "a node made its own host copy of the weights")
        jobs, vocab = gateway_jobs(args.seed)
        cfg = GatewayConfig(clock="wall", max_run_s=GATEWAY["max_run_s"],
                            reject_limit=limit)
        ops.reset_counts()
        t0 = time.perf_counter()
        gw, m, tokens, acts, offs, _ = serve_gateway(torch, fleet, jobs,
                                                     pred, policy, cfg)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = launch_counts()
        by_variant = variant_counts()
        plain = dict(ops.plain_calls)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_stages = sum(len(j.stages) for j in jobs)
        require(m.run_outcome != "deadline_exceeded",
                f"gateway {run}: the run passed max_run_s "
                f"({m.run_deadline}; preemptions {m.preemptions}, "
                f"rejections {m.admission_rejections}; {gateway_state(gw)})")
        # at the default limit a job may be dropped; every other ends
        may_drop = limit == default_limit
        require(m.finished_jobs + m.dropped_jobs == len(jobs)
                and (may_drop or m.dropped_jobs == 0),
                f"gateway {run}: {m.finished_jobs} of {len(jobs)} jobs "
                f"finished, {m.dropped_jobs} dropped")
        require((may_drop or len(tokens) == n_stages)
                and m.truncated_stages == 0,
                f"gateway {run}: {len(tokens)} of {n_stages} stages "
                f"finished, {m.truncated_stages} truncated")
        require_tokens_in_vocab(f"gateway {run}", tokens)
        require(not any(plain.values()),
                f"gateway {run}: a plain version ran: {plain}")
        require(counts["paged_attention"] > 0,
                f"gateway {run}: paged_attention never launched")
        require_all_wgmma("chunk_prefill_attention",
                          counts["chunk_prefill_attention"],
                          by_variant["chunk_prefill_attention"])
        require_all_wgmma("ssd_chunk", counts["ssd_chunk"],
                          by_variant["ssd_chunk"])
        for o in offs:
            require(o["freed_share"] is not None and o["freed_share"] >= 0.95,
                    f"gateway {run}: offloading {o['model']} on node "
                    f"{o['node']} freed {o['freed_bytes']} of "
                    f"{o['weight_bytes']} weight bytes")
        launches[run] = {k: n for k, n in counts.items() if n}
        by_submit = [a for a in acts if a["cause"] == "submit"
                     and a["t_act_waited_s"] is not None]
        results[run] = dict(
            finished_jobs=m.finished_jobs, dropped_jobs=m.dropped_jobs,
            jobs=len(jobs), stages=n_stages,
            interactive_jobs=sum(j.interactive for j in jobs),
            slo_attainment=m.slo_attainment,
            interactive_queue_delay_s=m.interactive_queue_delay_s,
            batch_queue_delay_s=m.batch_queue_delay_s,
            mean_latency_s=m.mean_latency_s, p95_latency_s=m.p95_latency_s,
            makespan_s=m.makespan_s, wall_makespan_s=m.wall_makespan_s,
            ttft_p50_s=m.ttft_p50_s, ttft_p95_s=m.ttft_p95_s,
            cold_starts=m.cold_starts, preemptions=m.preemptions,
            admission_rejections=m.admission_rejections,
            generated_tokens=m.generated_tokens,
            node_busy_frac=m.node_busy_frac,
            overlap_factor=m.overlap_factor,
            stages_by_model=m.stages_by_model,
            tokens_by_model=m.tokens_by_model,
            run_outcome=m.run_outcome, run_wall_s=wall_s,
            activations=acts, offloads=offs,
            deferred_activations=sum(a["cause"] == "deferred"
                                     for a in acts),
            t_act_waited_by_submit_s=sum(a["t_act_waited_s"]
                                         for a in by_submit),
            activation_measured_by_submit_s=sum(a["measured_s"]
                                                for a in by_submit),
            peak_mem_gb=peak_gb, launches=launches[run],
            launches_by_variant=by_variant, plain_calls=plain,
            engine_steps=m.engine_steps,
            engine_horizon_steps=m.engine_horizon_steps,
            host_syncs_per_token=m.host_syncs_per_token)
        emit("gateway", run=run, policy=policy, reject_limit=limit,
             models=list(names), n_layers=GATEWAY_LAYERS,
             config=dict(GATEWAY, hbm_budget=GATEWAY_CUT_BUDGET,
                         vocab=vocab), clock=m.clock,
             pinned_host_bytes=pinned_bytes, host_shared=shared,
             **results[run])
        del gw, fleet
    reset_peak(torch)
    gain = (results["fcfs"]["interactive_queue_delay_s"]
            - results["maestro"]["interactive_queue_delay_s"])
    emit("gateway_comparison",
         fcfs_interactive_queue_delay_s=results["fcfs"][
             "interactive_queue_delay_s"],
         maestro_interactive_queue_delay_s=results["maestro"][
             "interactive_queue_delay_s"],
         maestro_minus_fcfs_interactive_qd_s=-gain,
         verdict="better" if gain > 0 else "worse",
         fcfs_default_reject_limit=dict(
             reject_limit=default_limit,
             dropped_jobs=results["fcfs_default_reject_limit"][
                 "dropped_jobs"],
             admission_rejections=results["fcfs_default_reject_limit"][
                 "admission_rejections"],
             fcfs_admission_rejections=results["fcfs"][
                 "admission_rejections"]))
    return launches, results["maestro"]


def gateway_spec(hbm_budget: float = GATEWAY["hbm_budget"]):
    """The gateway phases' fleet: two nodes in clusters 0 and 1, each with
    qwen3-8b and mamba2-2.7b under ``hbm_budget`` (24 GB for the whole
    models), chunk 256, horizon 8."""
    from repro_torch.serving import cluster

    node_kw = {k: GATEWAY[k] for k in ("max_slots", "s_max",
                                       "prefill_chunk_tokens",
                                       "decode_horizon")}
    node_kw["hbm_budget"] = hbm_budget
    return cluster.ClusterSpec(
        nodes=(cluster.NodeSpec(0, **node_kw), cluster.NodeSpec(1, **node_kw)),
        model_names=(MAIN["model"], SSM_MODEL))


def require_tokens_in_vocab(where: str, tokens: dict) -> None:
    """Every finished stage emitted at least one token, each inside its
    model's padded vocabulary."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import pad_vocab

    for sid, (model, out, _) in tokens.items():
        padded = pad_vocab(get_config(model).vocab, 256)
        require(0 < len(out) and all(0 <= t < padded for t in out),
                f"{where}: stage {sid} emitted {out[:8]}")


# ------------------------------------------------------------ simulator
SIM = dict(jobs=600, rate=2.0, batch_ratio=0.8,
           policies=("fcfs", "edf", "maestro"))


def phase_sim(args, pred):
    """The port's trace-driven simulator over ``generate_trace(600,
    rate=2.0, batch_ratio=0.8, seed)`` on ``SimConfig()`` (3 clusters, 5
    nodes, the modelled A100 profiles of ``default_profiles``) under fcfs,
    edf and maestro (the smoke's trained predictor): each policy's
    ``SimResult`` row, every job finished, then maestro - edf. Host numpy
    only: the seconds are simulated, not measured on the card."""
    from repro_torch.core.sched.policies import make_policy
    from repro_torch.data.tracegen import generate_trace
    from repro_torch.sim.simulator import SimConfig, Simulator

    rows = {}
    for name in SIM["policies"]:
        jobs = generate_trace(SIM["jobs"], rate=SIM["rate"],
                              batch_ratio=SIM["batch_ratio"], seed=args.seed)
        t0 = time.perf_counter()
        r = Simulator(jobs, make_policy(name, predictor=pred),
                      SimConfig()).run()
        host_s = time.perf_counter() - t0
        require(r.finished_jobs == len(jobs),
                f"sim {name}: {r.finished_jobs} of {len(jobs)} jobs finished")
        rows[name] = r.row()
        emit("sim", device="none (host numpy; simulated seconds)",
             jobs=len(jobs), stages=sum(len(j.stages) for j in jobs),
             config=dict(SIM, policies=None, sim=dataclasses.asdict(
                 SimConfig())),
             host_seconds=host_s, **rows[name])
    m, e, f = rows["maestro"], rows["edf"], rows["fcfs"]
    emit("sim_comparison", device="none (host numpy; simulated seconds)",
         maestro_minus_edf_slo_attainment=m["slo_attainment"]
         - e["slo_attainment"],
         maestro_minus_fcfs_slo_attainment=m["slo_attainment"]
         - f["slo_attainment"],
         maestro_minus_edf_interactive_queue_delay_s=(
             m["interactive_queue_delay_s"] - e["interactive_queue_delay_s"]),
         maestro_minus_edf_mean_latency_s=(m["mean_latency_s"]
                                           - e["mean_latency_s"]))


# --------------------------------------------------------------- workers
# the GatewayMetrics keys a worker fleet may differ in (those of
# tests/test_worker.py), and the jit-compile count the port reports as 0
BACKEND_ONLY = ("node_backend", "ipc_calls", "ipc_wall_s",
                "worker_step_wall_s", "worker_stats", "rpc_bytes_sent",
                "rpc_bytes_recv", "ttft_p50_s", "ttft_p95_s",
                "engine_prefill_compiles")
WORKER_REFERENCE = (("maestro", "process"), ("fcfs", "process"),
                    ("maestro", "socket"))


def child_launches(records: dict) -> tuple:
    """Per child and summed over the children: the nonzero launches, the
    launches by variant, and the plain calls, from ``records()``."""
    per_child, total, by_variant = {}, {}, {}
    for nid, r in records.items():
        per_child[nid] = {k: n for k, n in r["launches"].items() if n}
        for k, n in per_child[nid].items():
            total[k] = total.get(k, 0) + n
        for k, v in r["launches_by_variant"].items():
            acc = by_variant.setdefault(k, {})
            for var, n in v.items():
                acc[var] = acc.get(var, 0) + n
    return per_child, total, by_variant


def require_clean_children(where: str, records: dict) -> None:
    """No plain version ran in any child, and no child loaded JAX or the
    JAX package."""
    for nid, r in records.items():
        require(not any(r["plain_calls"].values()),
                f"{where}: a plain version ran in node {nid}'s worker: "
                f"{r['plain_calls']}")
        require(not r["foreign_modules"],
                f"{where}: node {nid}'s worker loaded "
                f"{r['foreign_modules']}")


def phase_worker_reference(torch, args, pred, card):
    """The fleet of phase gateway_reference (reduced zoo, f32, two nodes,
    chunk 8, horizon 4, virtual clock, its 6 jobs) with each node in a
    worker process of its own on the card: maestro and fcfs on the process
    backend, maestro on the socket backend. Each run must equal the card's
    in-process run of gateway_reference: every stage's node, tokens and
    times, and every metric but the backend-only keys. The children's
    records must show the paged and chunk kernels (simt), their launches
    summed over the children equal to the in-process run's, no plain call
    and no JAX module. Returns each run's launches, summed and per
    child."""
    from repro_torch.serving import cluster
    from repro_torch.serving.gateway import GatewayConfig
    from repro_torch.serving.worker import close_fleet

    spec = reference_spec()
    trace = reference_trace(args.seed)
    paths = {}
    for policy, backend in WORKER_REFERENCE:
        where = f"worker_reference {policy} {backend}"
        want_rows, want_m, want_launches = card[policy]
        t0 = time.perf_counter()
        fleet = cluster.build_fleet(spec, seed=args.seed, backend=backend,
                                    device="cuda")
        boot_s = time.perf_counter() - t0
        try:
            for node in fleet:
                node.reset_records()
            gw, m, tokens, _, _, records = serve_gateway(
                torch, fleet, reference_jobs(trace, args.seed), pred,
                policy, GatewayConfig(node_backend=backend))
            rows = stage_rows(gw, tokens)
        finally:
            close_fleet(fleet)
        row = m.row()
        differ = sorted(s for s in want_rows if rows.get(s) != want_rows[s])
        metrics_differ = sorted(k for k in want_m if k not in BACKEND_ONLY
                                and row[k] != want_m[k])
        require(not differ and set(rows) == set(want_rows),
                f"{where}: stages {differ} differ from the in-process run")
        require(not metrics_differ, f"{where}: metrics {metrics_differ} "
                f"differ from the in-process run")
        require_clean_children(where, records)
        per_child, total, by_variant = child_launches(records)
        chunk = by_variant["chunk_prefill_attention"]
        require(total.get("paged_attention", 0) > 0
                and chunk["simt"] > 0 and chunk["wgmma"] == 0,
                f"{where}: paged {total.get('paged_attention', 0)}, chunk "
                f"by variant {chunk}")
        require(total == want_launches, f"{where}: the children launched "
                f"{total}, the in-process fleet {want_launches}")
        emit("worker_reference", policy=policy, backend=backend,
             jobs=len(trace), stages=len(rows), identical_stages=len(rows),
             identical_metrics=True, finished_jobs=m.finished_jobs,
             makespan_virtual_s=m.makespan_s, boot_s=boot_s,
             ipc_calls=m.ipc_calls, ipc_wall_s=m.ipc_wall_s,
             worker_step_wall_s=m.worker_step_wall_s,
             rpc_bytes_sent=m.rpc_bytes_sent, rpc_bytes_recv=m.rpc_bytes_recv,
             launches=total, launches_by_child=per_child,
             launches_by_variant=by_variant, inproc_launches=want_launches,
             foreign_modules=sorted({k for r in records.values()
                                     for k in r["foreign_modules"]}))
        run = f"worker_reference_{policy}_{backend}"
        paths[run] = total
        paths.update({f"{run}_node{nid}": n for nid, n in per_child.items()})
    reset_peak(torch)
    return paths


WORKER_FAULT = dict(jobs=12, rate=4.0, max_run_s=120.0, heartbeat_s=0.05,
                    victim=1, memory_slack_bytes=1e9, memory_wait_s=30.0)


def free_device_bytes(torch) -> int:
    """Free bytes of the card as ``torch.cuda.mem_get_info`` reports
    them, after this process returned its own cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0]


def phase_worker_fault(torch, args, pred):
    """The reduced fleet of gateway_reference on the socket backend (each
    node a worker process on the card) under the wall clock, serving 12
    jobs under maestro with a ``FaultPlan`` that SIGKILLs node 1's worker
    once node 1 holds a submitted stage (its model's weights and KV on the
    card): one node death, every job finished, node 1's evacuated stages
    finished on node 0, ``close_fleet`` safe twice, and the card's free
    memory, read after the fleet is closed, back within 1 GB of its value
    before the boot."""
    from repro_torch.serving import cluster
    from repro_torch.serving.faultplan import FaultPlan, KillWorker
    from repro_torch.serving.gateway import GatewayConfig
    from repro_torch.serving.worker import close_fleet

    @dataclasses.dataclass
    class KillWhenBusy(KillWorker):
        """``KillWorker`` that waits, re-checking every ``poll_s``, until
        its node holds a submitted stage."""
        poll_s: float = 0.01
        outcome: str = ""
        killed_at: float = -1.0

        def fire(self, gw, now):
            if not any(r.submitted and r.node_id == self.node_id
                       for r in gw.inflight.values()):
                gw.clock.call_at(now + self.poll_s,
                                 lambda t: self.fire(gw, t))
                return f"kill node {self.node_id}: waiting for a stage"
            self.killed_at = now
            self.outcome = KillWorker.fire(self, gw, now)
            return self.outcome

    victim = WORKER_FAULT["victim"]
    reset_peak(torch)
    free_before = free_device_bytes(torch)
    fleet = cluster.build_fleet(reference_spec(), seed=args.seed,
                                backend="socket", device="cuda")
    free_booted = free_device_bytes(torch)
    kill = KillWhenBusy(at_s=0.0, node_id=victim)
    trace = reference_trace(args.seed, WORKER_FAULT["jobs"],
                            WORKER_FAULT["rate"])
    cfg = GatewayConfig(node_backend="socket", clock="wall",
                        heartbeat_s=WORKER_FAULT["heartbeat_s"],
                        max_run_s=WORKER_FAULT["max_run_s"],
                        reject_limit=GATEWAY["reject_limit"])
    try:
        gw, m, tokens, _, _, records = serve_gateway(
            torch, fleet, reference_jobs(trace, args.seed), pred, "maestro",
            cfg, fault_plan=FaultPlan([kill]))
    finally:
        close_fleet(fleet)
        close_fleet(fleet)                 # safe twice, after a death
    t0 = time.perf_counter()
    free_after = free_device_bytes(torch)
    while (free_before - free_after > WORKER_FAULT["memory_slack_bytes"]
           and time.perf_counter() - t0 < WORKER_FAULT["memory_wait_s"]):
        time.sleep(0.5)
        free_after = free_device_bytes(torch)
    returned_s = time.perf_counter() - t0
    n_stages = sum(len(j.stages) for j in trace)
    require("SIGKILL" in kill.outcome,
            f"worker_fault: node {victim} was not killed ({kill.outcome!r})")
    require(m.node_deaths == 1 and m.death_events[0].node_id == victim,
            f"worker_fault: {m.node_deaths} node deaths")
    death = m.death_events[0]
    require(m.run_outcome == "completed" and m.finished_jobs == len(trace)
            and m.finished_stages == n_stages,
            f"worker_fault: {m.finished_jobs} of {len(trace)} jobs, "
            f"{m.finished_stages} of {n_stages} stages ({m.run_outcome})")
    require(death.requeued_stages and all(
        gw.telemetry.events[s].node_id != victim
        and gw.telemetry.events[s].finish_t > 0
        for s in death.requeued_stages),
        f"worker_fault: evacuated stages {death.requeued_stages} not "
        f"finished on a survivor")
    require_tokens_in_vocab("worker_fault", tokens)
    require_clean_children("worker_fault", records)
    require(free_before - free_after <= WORKER_FAULT["memory_slack_bytes"],
            f"worker_fault: {(free_before - free_after) / 1e9:.3f} GB of "
            f"the card's memory not returned {returned_s:.1f} s after "
            f"close_fleet")
    emit("worker_fault", policy="maestro", backend="socket", clock="wall",
         config=WORKER_FAULT, jobs=len(trace), stages=n_stages,
         finished_jobs=m.finished_jobs, node_deaths=m.node_deaths,
         killed_at_s=kill.killed_at, kill=kill.outcome,
         requeued_stages=list(death.requeued_stages),
         recovery_time_s=m.recovery_time_s, liveness=m.liveness,
         makespan_s=m.makespan_s, run_outcome=m.run_outcome,
         free_gb_before_boot=free_before / 1e9,
         free_gb_booted=free_booted / 1e9,
         free_gb_after_close=free_after / 1e9,
         not_returned_gb=(free_before - free_after) / 1e9,
         seconds_to_return=returned_s,
         survivor_launches=child_launches(records)[0])


def mem_available_gb() -> float:
    """The host's ``MemAvailable`` in GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def phase_gateway_process(torch, args, pred, inproc: dict):
    """Phase gateway's fleet -- two nodes, qwen3-8b and mamba2-2.7b at
    their widths and ``GATEWAY_LAYERS`` layers under
    ``GATEWAY_CUT_BUDGET`` -- with each node a worker process of its own on
    the card (``reduced=False``: each child draws both models on the card,
    cut to those depths, and keeps one pinned host copy of each), freshly
    booted, serving the same 16 jobs under maestro and the wall clock with
    the raised ``reject_limit``; the workers free-run. Every job finished,
    every token inside its vocabulary; the paged kernel launched, each
    child launched kernels, every chunk and SSD launch took ``wgmma``, no
    plain version
    ran, no JAX module loaded, every offload freed at least 95% of its
    weight bytes and the peak allocated memory stayed within 1.1 times the
    node's budget. Printed beside phase gateway's maestro run (``inproc``):
    the same fleet in one process. Returns the launches, summed and per
    child."""
    from repro_torch.serving import cluster
    from repro_torch.serving.gateway import GatewayConfig
    from repro_torch.serving.worker import NodeHandle, close_fleet, spawn_fleet

    spec = gateway_spec(GATEWAY_CUT_BUDGET)
    specs = cluster.worker_specs(spec, seed=args.seed, device="cuda",
                                 reduced=False, n_layers=GATEWAY_LAYERS)
    host_empty = (getattr(torch.accelerator, "empty_host_cache", None)
                  or getattr(torch._C, "_host_emptyCache", None))
    if host_empty is not None:
        host_empty()              # the earlier phases' pinned host blocks
    reset_peak(torch)
    host_before = mem_available_gb()
    # each child's ready time as the parent sees it (spawn_fleet starts
    # every child, then waits on each in turn)
    ready_s, wait_ready = {}, NodeHandle.wait_ready

    def timed_wait_ready(self):
        out = wait_ready(self)
        ready_s.setdefault(self.node_id, time.perf_counter() - t0)
        return out

    NodeHandle.wait_ready = timed_wait_ready
    t0 = time.perf_counter()
    try:
        fleet = spawn_fleet(specs, backend="process")
    finally:
        NodeHandle.wait_ready = wait_ready
    boot_s = time.perf_counter() - t0
    host_after = mem_available_gb()
    jobs, vocab = gateway_jobs(args.seed)
    cfg = GatewayConfig(clock="wall", max_run_s=GATEWAY["max_run_s"],
                        reject_limit=GATEWAY["reject_limit"],
                        node_backend="process")
    try:
        for node in fleet:
            node.reset_records()
        t0 = time.perf_counter()
        gw, m, tokens, acts, offs, records = serve_gateway(
            torch, fleet, jobs, pred, "maestro", cfg)
        wall_s = time.perf_counter() - t0
    finally:
        close_fleet(fleet)
    host_closed = mem_available_gb()
    n_stages = sum(len(j.stages) for j in jobs)
    require(m.run_outcome == "completed" and m.finished_jobs == len(jobs)
            and len(tokens) == n_stages and m.truncated_stages == 0,
            f"gateway_process: {m.finished_jobs} of {len(jobs)} jobs, "
            f"{len(tokens)} of {n_stages} stages, {m.truncated_stages} "
            f"truncated ({m.run_outcome})")
    require_tokens_in_vocab("gateway_process", tokens)
    require_clean_children("gateway_process", records)
    per_child, total, by_variant = child_launches(records)
    budget = GATEWAY_CUT_BUDGET
    # each child serves what the router sends it: under the cut budget a
    # node's tier holds one model, so a child may serve only mamba2's
    # stages (no paged launch); the fleet serves both
    require(total.get("paged_attention", 0) > 0,
            f"gateway_process: paged_attention never launched: {per_child}")
    for nid, r in records.items():
        v = r["launches_by_variant"]
        require(sum(per_child[nid].values()) > 0,
                f"gateway_process: node {nid}'s worker launched nothing")
        require(v["chunk_prefill_attention"]["simt"] == 0
                and v["ssd_chunk"]["simt"] == 0,
                f"gateway_process: node {nid}'s worker took simt: {v}")
        require(r["max_memory_allocated"] <= 1.1 * budget,
                f"gateway_process: node {nid}'s worker peaked at "
                f"{r['max_memory_allocated'] / 1e9:.2f} GB, over 1.1 x its "
                f"{budget / 1e9:.0f} GB budget")
    require_all_wgmma("chunk_prefill_attention",
                      total.get("chunk_prefill_attention", 0),
                      by_variant["chunk_prefill_attention"])
    require_all_wgmma("ssd_chunk", total.get("ssd_chunk", 0),
                      by_variant["ssd_chunk"])
    for o in offs:
        require(o["freed_share"] is not None and o["freed_share"] >= 0.95,
                f"gateway_process: offloading {o['model']} on node "
                f"{o['node']} freed {o['freed_bytes']} of "
                f"{o['weight_bytes']} weight bytes")
    by_submit = [a for a in acts if a["cause"] == "submit"
                 and a["t_act_waited_s"] is not None]
    process = dict(
        finished_jobs=m.finished_jobs, jobs=len(jobs), stages=n_stages,
        slo_attainment=m.slo_attainment,
        interactive_queue_delay_s=m.interactive_queue_delay_s,
        batch_queue_delay_s=m.batch_queue_delay_s,
        mean_latency_s=m.mean_latency_s, p95_latency_s=m.p95_latency_s,
        makespan_s=m.makespan_s, ttft_p50_s=m.ttft_p50_s,
        ttft_p95_s=m.ttft_p95_s, cold_starts=m.cold_starts,
        preemptions=m.preemptions,
        admission_rejections=m.admission_rejections,
        generated_tokens=m.generated_tokens,
        node_busy_frac=m.node_busy_frac,
        node_busy_frac_sum=sum(m.node_busy_frac.values()),
        overlap_factor=m.overlap_factor, ipc_calls=m.ipc_calls,
        ipc_wall_s=m.ipc_wall_s, worker_step_wall_s=m.worker_step_wall_s,
        run_outcome=m.run_outcome, run_wall_s=wall_s,
        activations=acts, offloads=offs,
        deferred_activations=sum(a["cause"] == "deferred" for a in acts),
        t_act_waited_by_submit_s=sum(a["t_act_waited_s"]
                                     for a in by_submit),
        activation_measured_by_submit_s=sum(a["measured_s"]
                                            for a in by_submit),
        peak_allocated_gb={nid: r["max_memory_allocated"] / 1e9
                           for nid, r in records.items()},
        reserved_gb={nid: r["memory_reserved"] / 1e9
                     for nid, r in records.items()},
        launches=total, launches_by_child=per_child,
        launches_by_variant=by_variant)
    emit("gateway_process", policy="maestro", backend="process",
         clock=m.clock, models=list(spec.model_names),
         n_layers=GATEWAY_LAYERS,
         config=dict(GATEWAY, hbm_budget=GATEWAY_CUT_BUDGET, vocab=vocab),
         boot_s=boot_s,
         ready_s_by_child=ready_s,
         host_cache_emptied_by=getattr(host_empty, "__name__", None),
         host_mem_available_gb_before=host_before,
         host_mem_available_gb_after=host_after,
         host_mem_available_gb_after_close=host_closed, **process)
    emit("gateway_process_comparison", policy="maestro",
         **{f"{k}_{side}": run[k] for side, run in (("inproc", inproc),
                                                     ("process", process))
            for k in ("makespan_s", "interactive_queue_delay_s",
                      "mean_latency_s", "slo_attainment", "cold_starts",
                      "node_busy_frac", "overlap_factor")},
         process_over_inproc_makespan=process["makespan_s"]
         / inproc["makespan_s"])
    reset_peak(torch)
    return {"gateway_process": total,
            **{f"gateway_process_node{nid}": n
               for nid, n in per_child.items()}}


# ------------------------------------------ MoE, hybrid and large dense
ZOO = dict(moe="moonshot-v1-16b-a3b", llama4="llama4-scout-17b-a16e",
           qwen32="qwen3-32b", qwen110="qwen1.5-110b",
           hybrid="jamba-v0.1-52b")
# layers run on the card at the published widths: llama4-scout,
# qwen1.5-110b and jamba where all of them would not fit one card's 80 GB,
# moonshot (which would) cut to 12 of 48 for the smoke's clock (24 until
# the mesh phase came); qwen3-32b runs whole
ZOO_LAYERS = {ZOO["llama4"]: 8, ZOO["qwen110"]: 8, ZOO["hybrid"]: 16,
              ZOO["moe"]: 12}
# (H, Hkv) of moonshot (g = 1), llama4-scout (g = 5), qwen3-32b and
# qwen1.5-110b (g = 8); hd 128 in all
ZOO_HEADS = ((16, 16), (40, 8), (64, 8))
DENSE_LARGE = dict(n_requests=4, max_new=32)
# profiler ranges (``group::label``) that profile_steps reads
RANGE_GROUPS = ("moe", "cross")
# the port's MoE functions under each profiler range of moe_ranges
MOE_RANGES = {"routing": ("_route_and_bucket", "_combine"),
              "experts": ("_expert_ffn",)}


def zoo_config(name: str):
    """``name``'s config at its published widths, cut to the layers of
    :data:`ZOO_LAYERS` where it has an entry."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    n = ZOO_LAYERS.get(name)
    return dataclasses.replace(cfg, n_layers=n) if n else cfg


def random_biases(torch, tree, seed: int) -> None:
    """Draw non-zero q/k/v biases into a parameter tree in place (``init``
    draws them as zeros, as the reference does, which would leave the bias
    branch idle)."""
    gen = None
    for lp in tree["layers"]:
        attn = lp.get("attn") or {}
        for k in ("bq", "bk", "bv"):
            if k not in attn:
                continue
            t = attn[k]
            if gen is None:
                gen = torch.Generator(device=t.device).manual_seed(seed)
            t.copy_(0.5 * torch.randn(t.shape, generator=gen,
                                      device=t.device))


def path_kernels(model, chunk: int) -> set:
    """The kernels a serving path of ``model`` must launch: paged decode
    and the chunk kernel (chunked) or flash (monolithic) for a model with
    attention layers, the SSD scan for one with SSM layers. A
    cross-attention model does not chunk: flash runs its prefill, its
    encoder, its cross prefill and its cross decode."""
    names = set()
    if model.paged_kv_layout()[0]:
        names.add("paged_attention")
        names.add("chunk_prefill_attention"
                  if chunk and model.supports_chunked_prefill
                  else "flash_attention")
    if model.n_ssm_layers:
        names.add("ssd_chunk")
    return names


def require_path(where: str, model, chunk: int) -> dict:
    """After a path: each of its kernels launched, no other kernel and no
    plain version. Returns the launches of its kernels."""
    from repro_torch.kernels import ops
    launches = launch_counts()
    want = path_kernels(model, chunk)
    got = {k for k, n in launches.items() if n}
    require(got == want, f"{where}: kernels launched {sorted(got)}, the "
            f"path's are {sorted(want)}")
    require(not any(ops.plain_calls.values()),
            f"{where}: a plain version ran on the card: {ops.plain_calls}")
    return {k: launches[k] for k in sorted(want)}


@contextlib.contextmanager
def moe_ranges(torch):
    """The port's MoE routing (router product, top-k, argsorts, gathers)
    and expert products each under a profiler range (``moe::routing``,
    ``moe::experts``), so :func:`profile_steps` gives their device time."""
    from repro_torch.models import moe
    saved = {}
    for label, fns in MOE_RANGES.items():
        for fn in fns:
            saved[fn] = getattr(moe, fn)

            def ranged(*a, _orig=saved[fn], _label=f"moe::{label}", **k):
                with torch.profiler.record_function(_label):
                    return _orig(*a, **k)
            setattr(moe, fn, ranged)
    try:
        yield
    finally:
        for fn, orig in saved.items():
            setattr(moe, fn, orig)


def expert_use(torch, eng) -> dict:
    """One engine step with the distinct experts of each MoE call counted:
    the bytes of expert weights a step reads (every expert's, the dense
    bucket) against those of the experts its rows were routed to."""
    from repro_torch.models import moe
    orig, used = moe._route_and_bucket, []

    def counting(xt, router, E, K, C):
        buf, info = orig(xt, router, E, K, C)
        used.append(int(torch.unique(info[0]).numel()))
        return buf, info

    moe._route_and_bucket = counting
    try:
        eng.step()
    finally:
        moe._route_and_bucket = orig
    cfg = eng.model.cfg
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert * 2
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    iters = len(used) // n_moe
    return dict(calls=len(used), iterations=iters,
                distinct_experts_mean=statistics.mean(used),
                distinct_experts_max=max(used),
                bytes_read_per_iteration=n_moe * m.n_experts * per_expert,
                bytes_routed_per_iteration=sum(used) * per_expert / iters)


def check_zoo_kernels(torch, gen, prompt_lens) -> dict:
    """Paged decode, the chunk kernel (wgmma) and flash (wgmma) at each
    (H, Hkv) of :data:`ZOO_HEADS` against their plain versions, at the main
    path's shapes (paged: 8 lanes mid-decode; chunk: each prompt's last
    full 256-row chunk; flash: the shortest, prime and longest prompt),
    each timed at its widest shape beside its bound; then the SSD scan at
    jamba's widths (N 16, P 64, H 128, bf16: the simt variant) at the 8
    prompt lengths with its final state."""
    from repro_torch.launch import roofline as rl
    import torch.nn.functional as F
    from repro_torch.kernels import chunk_prefill as cp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_chunk as ssd

    hd, page, C = 128, MAIN["page_tokens"], MAIN["prefill_chunk_tokens"]
    W = -(-MAIN["s_max"] // page)
    n_rows = MAIN["max_slots"] * W + 1
    bf16 = torch.bfloat16
    seq_lens = [P + MAIN["max_new"] // 2 for P in prompt_lens]
    pos = chunk_positions(torch, prompt_lens, C)
    flash_lens = sorted({min(prompt_lens), max(prompt_lens)}
                        | {n for n in prompt_lens if n == next_prime(n)})
    out = {k: {} for k in ("paged_attention", "chunk_prefill_attention",
                           "flash_attention")}
    ops.reset_counts()
    for H, Hkv in ZOO_HEADS:
        key = f"{H}/{Hkv}"
        q, kp, vp, bt, sl = paged_inputs(torch, gen, seq_lens, H, Hkv, hd,
                                         page, W, n_rows, bf16)
        err, row_err = chunk_errors(
            pa.paged_attention(q, kp, vp, bt, sl),
            ref.paged_attention_ref(q.float(), kp.float(), vp.float(), bt,
                                    sl))
        require(err <= 2e-2 and row_err <= 2e-2,
                f"paged_attention at heads {key}: max_abs_err {err}, "
                f"row-scaled {row_err}")
        b_ms, b_by = rl.bound(*rl.paged_cost(seq_lens, H, Hkv, hd, W, 2),
                              rl.H100.peak_flops)
        out["paged_attention"][key] = dict(
            max_abs_err=err, row_scaled_err=row_err,
            split=pa.split_plan(len(seq_lens), Hkv, W, page),
            **kernel_times(lambda: pa.paged_attention(q, kp, vp, bt, sl)),
            plain_ms=time_ms(lambda: ref.paged_attention_ref(q, kp, vp, bt,
                                                             sl)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        qc = torch.randn((len(prompt_lens), C, H, hd), generator=gen,
                         device="cuda").to(bf16)
        got = cp.chunk_prefill_attention(qc, kp, vp, bt, pos)
        want = ref.chunk_prefill_attention_ref(qc.float(), kp.float(),
                                               vp.float(), bt, pos)
        err, row_err = chunk_errors(got, want)
        require(err <= 2e-2 and row_err <= 2e-2
                and bool(torch.isfinite(got).all()),
                f"chunk_prefill at heads {key}: err {err}, row {row_err}")
        b_ms, b_by = rl.bound(*rl.chunk_cost(pos, H, Hkv, hd, W, 2),
                              rl.H100.peak_flops)
        out["chunk_prefill_attention"][key] = dict(
            max_abs_err=err, row_scaled_err=row_err,
            variant=cp.variant(bf16, hd, page),
            **kernel_times(lambda: cp.chunk_prefill_attention(qc, kp, vp, bt,
                                                              pos)),
            plain_ms=time_ms(lambda: ref.chunk_prefill_attention_ref(
                qc, kp, vp, bt, pos), reps=5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del q, kp, vp, qc, got, want
        errs = []
        for S in flash_lens:
            qf, kf, vf = (torch.randn((1, S, h, hd), generator=gen,
                                      device="cuda").to(bf16)
                          for h in (H, Hkv, Hkv))
            got = fa.flash_attention(qf, kf, vf, causal=True)
            want = ref.blockwise_attention(qf.float(), kf.float(),
                                           vf.float(), True)
            errs.append(chunk_errors(got, want))
        err, row_err = max(e[0] for e in errs), max(e[1] for e in errs)
        require(err <= 2e-2 and row_err <= 2e-2,
                f"flash_attention at heads {key}: err {err}, row {row_err}")
        qt, kt, vt = (t.transpose(1, 2) for t in (qf, kf, vf))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        b_ms, b_by = rl.bound(*rl.flash_cost(S, S, H, Hkv, hd, True, 2),
                              rl.H100.peak_flops)
        out["flash_attention"][key] = dict(
            max_abs_err=err, row_scaled_err=row_err, lens=flash_lens,
            variant=fa.variant(bf16, hd),
            **kernel_times(lambda: fa.flash_attention(qf, kf, vf,
                                                      causal=True)),
            plain_ms=time_ms(lambda: ref.blockwise_attention(qf, kf, vf,
                                                             True), reps=3),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(sdpa),
            library_ms_no_spin=time_ms(sdpa, spin=False))
        del qf, kf, vf, qt, kt, vt
        for name in out:
            emit("kernel_check_zoo", name=name, heads=key, **out[name][key])
    variants = variant_counts()
    for name in ("chunk_prefill_attention", "flash_attention"):
        require(variants[name]["simt"] == 0 and variants[name]["wgmma"],
                f"{name} at the zoo's heads by variant: {variants[name]}")

    cfg = zoo_config(ZOO["hybrid"])
    s = cfg.ssm
    Hs, P, N = s.n_heads(cfg.d_model), s.head_dim, s.d_state
    ops.reset_counts()
    errs = ssd_errors(torch, gen, prompt_lens, "jamba", model=ZOO["hybrid"])
    checked = variant_counts()["ssd_chunk"]
    require(checked == {"simt": len(prompt_lens), "wgmma": 0},
            f"ssd_chunk at jamba's widths by variant: {checked}")
    S = max(prompt_lens)
    args = ssd_inputs(torch, gen, S, Hs, P, N, bf16)
    b_ms, b_by = rl.bound(*rl.ssd_cost(S, Hs, P, N,
                                       min(s.chunk, ssd.MAX_CHUNK), 2),
                          rl.H100.peak_flops)
    out["ssd_chunk"] = {f"N{N}/P{P}/H{Hs}": dict(
        variant=ssd.variant(bf16, N, P, s.chunk), lens=list(prompt_lens),
        **errs, **kernel_times(lambda: ssd.ssd_chunk(*args, s.chunk)),
        plain_ms=time_ms(lambda: ref.ssd_chunk_scan(*args, s.chunk),
                         reps=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)}
    emit("kernel_check_zoo", name="ssd_chunk", heads=f"N{N}/P{P}/H{Hs}",
         **out["ssd_chunk"][f"N{N}/P{P}/H{Hs}"])
    return out


def phase_zoo_reference(torch, args):
    """The reduced models of the five new configs served on the card
    (kernels) and on the CPU (plain versions) from the same weights:
    identical greedy tokens; the MoE configs chunked and monolithic,
    qwen1.5-110b with non-zero biases, jamba with its knobs degrading."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, init_params
    from repro_torch.configs import get_config

    lens = (3, 17, 40, 9, 25, 33)
    cases = ((ZOO["moe"], 16), (ZOO["moe"], 0), (ZOO["llama4"], 16),
             (ZOO["llama4"], 0), (ZOO["qwen32"], 16), (ZOO["qwen110"], 16),
             (ZOO["hybrid"], 16))
    for name, chunk in cases:
        cfg = get_config(name).reduced()
        params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                             "cpu")
        if cfg.qkv_bias:
            random_biases(torch, params, args.seed)
        cpu = build_model(cfg, params, device="cpu")
        gpu = build_model(cfg, params, device="cuda")
        rng = np.random.default_rng(args.seed)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
                   for n in lens]
        kw = dict(max_slots=4, s_max=128, page_tokens=8,
                  prefill_chunk_tokens=chunk, decode_horizon=4)
        _, want, _ = serve(torch, cpu, prompts, device="cpu", **kw)
        ops.reset_counts()
        eng, got, _ = serve(torch, gpu, prompts, device="cuda", **kw)
        launches = require_path(f"reduced {name} (chunk {chunk})", gpu,
                                chunk)
        same = all(got[i].out == want[i].out for i in want)
        require(same, f"reduced {name} (chunk {chunk}): card tokens differ "
                f"from the CPU's")
        emit("zoo_reference", model=cfg.name, prefill_chunk_tokens=chunk,
             engine_chunk=eng.chunk_tokens, engine_horizon=eng.horizon,
             nonzero_biases=cfg.qkv_bias, requests=len(prompts),
             identical_tokens=same, launches=launches)


def build_timed(torch, cfg, seed: int, biases: bool = False):
    """The model drawn on the card from ``seed``; its build seconds."""
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=seed)
    if biases:
        random_biases(torch, model.param_tree(), seed)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def check_outputs(where: str, model, done, n: int, max_new: int) -> None:
    require(len(done) == n, f"{where}: {len(done)} of {n} requests finished")
    for i, r in done.items():
        require(len(r.out) == max_new and not r.truncated,
                f"{where}: request {i} emitted {len(r.out)} tokens")
        require(all(0 <= t < model.vocab_padded for t in r.out),
                f"{where}: request {i} emitted a token outside the "
                f"vocabulary")


def check_prefill_logits(torch, where: str, model, prompt,
                         extras=None) -> None:
    logits, _, _ = model.prefill(torch.tensor([prompt[:64]], device="cuda"),
                                 extras)
    require(tuple(logits.shape) == (1, model.vocab_padded)
            and bool(torch.isfinite(logits).all()),
            f"{where}: prefill logits not finite or misshapen")


def serve_path(torch, where, model, prompts, *, chunk, horizon,
               max_new=MAIN["max_new"], arena_rows=None):
    """One serving path on the card between a reset of the counts and the
    peak and a read of both: the engine, its requests, and the path's
    numbers (launches by kernel and variant, rates, peak memory, engine
    counters)."""
    from repro_torch.kernels import ops
    kw = {k: MAIN[k] for k in ("max_slots", "s_max", "page_tokens")}
    reset_peak(torch)
    ops.reset_counts()
    eng, done, steps = serve(torch, model, prompts, device="cuda",
                             arena_rows=arena_rows, max_new=max_new,
                             prefill_chunk_tokens=chunk,
                             decode_horizon=horizon, **kw)
    launches = require_path(where, model, chunk)
    by_variant = {k: v for k, v in variant_counts().items()
                  if k in launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_outputs(where, model, done, len(prompts), max_new)
    numbers = dict(
        config={**kw, "prefill_chunk_tokens": chunk,
                "decode_horizon": horizon, "max_new": max_new},
        engine_chunk=eng.chunk_tokens, engine_horizon=eng.horizon,
        launches=launches, launches_by_variant=by_variant,
        **serving_rates(done, steps), peak_mem_gb=peak_gb,
        stat_steps=eng.stat_steps, stat_decode_syncs=eng.stat_decode_syncs,
        stat_horizon_steps=eng.stat_horizon_steps,
        stat_prefill_tokens=eng.stat_prefill_tokens,
        stat_decode_tokens=eng.stat_decode_tokens)
    return eng, done, numbers


def phase_moe_main(torch, args, prompts):
    """moonshot-v1-16b-a3b at its widths and ``ZOO_LAYERS`` (12 of its 48)
    layers, bf16: the main path's 8
    requests chunked (256) at horizon 8, then at horizon 1 (identical
    tokens), then monolithic (flash); a profile of the first chunk step
    and one horizon launch with each kernel's and the MoE's share; the
    expert bytes one decode iteration reads against those routed to.
    Returns this slice's launches by path and the chunk kernel's
    variants."""
    cfg = zoo_config(ZOO["moe"])
    model, build_s = build_timed(torch, cfg, args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    W = -(-MAIN["s_max"] // MAIN["page_tokens"])
    rows = MAIN["max_slots"] * W + 1
    C, Hz = MAIN["prefill_chunk_tokens"], MAIN["decode_horizon"]
    eng, done, chunked = serve_path(torch, "moe_main", model, prompts,
                                    chunk=C, horizon=Hz, arena_rows=rows)
    require_all_wgmma("chunk_prefill_attention",
                      chunked["launches"]["chunk_prefill_attention"],
                      chunked["launches_by_variant"][
                          "chunk_prefill_attention"])
    tokens = {i: r.out for i, r in done.items()}
    arena_gb = rows * eng.binding.plane.spec.row_bytes / 1e9
    del eng
    check_prefill_logits(torch, "moe_main", model, prompts[0])
    eng1, done1, h1 = serve_path(torch, "moe_main horizon 1", model,
                                 prompts, chunk=C, horizon=1,
                                 arena_rows=rows)
    same = all(done1[i].out == tokens[i] for i in tokens)
    require(same, "moe_main: horizon 8 tokens differ from horizon 1")
    del eng1
    engm, donem, mono = serve_path(torch, "moe_main monolithic", model,
                                   prompts, chunk=0, horizon=Hz,
                                   arena_rows=rows)
    expected = cfg.n_layers * len(prompts)
    require(mono["launches"]["flash_attention"] == expected,
            f"moe_main monolithic: flash launched "
            f"{mono['launches']['flash_attention']} times, not {expected}")
    require_all_wgmma("flash_attention", expected,
                      mono["launches_by_variant"]["flash_attention"])
    del engm
    diff = first_difference(torch, model, prompts, tokens,
                            {i: r.out for i, r in donem.items()})
    kw = {k: MAIN[k] for k in ("max_slots", "s_max", "page_tokens",
                               "prefill_chunk_tokens")}
    with moe_ranges(torch):
        prof, use = profile_moe(torch, model, prompts, rows, kw)
    emit("moe_main", model=cfg.name, n_layers=cfg.n_layers, params=n_params,
         weights_gb=n_params * 2 / 1e9, model_build_s=build_s,
         prompt_lens=[len(p) for p in prompts], arena_rows=rows,
         arena_gb=arena_gb, **chunked,
         horizon1=dict(identical_tokens=same, launches=h1["launches"],
                       stat_decode_syncs=h1["stat_decode_syncs"],
                       decode_tok_s=h1["decode_tok_s"]),
         profile=prof, expert_use=use)
    emit("moe_monolithic", model=cfg.name, **mono,
         identical_to_chunked=diff is None, first_difference=diff)
    del model
    reset_peak(torch)
    return ({"moe_main_chunked": chunked["launches"],
             "moe_main_horizon1": h1["launches"],
             "moe_main_monolithic": mono["launches"]},
            chunked["launches_by_variant"]["chunk_prefill_attention"])


def profile_moe(torch, model, prompts, rows, kw):
    """The first step (every prompt's first chunk) and one pure-decode
    horizon launch under the profiler, then :func:`expert_use` over the
    next horizon launch."""
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
    use = expert_use(torch, eng)
    for rid in list(eng.active):
        eng.evict(rid)
    return dict(chunk_step=chunk, decode_horizon_step=horizon), use


def phase_moe_llama4(torch, args, prompts):
    """llama4-scout-17b-a16e at its published widths, 8 of 48 layers (top-1
    of 16 experts, g = 5), the main path's requests chunked at horizon 8.
    Returns its launches."""
    cfg = zoo_config(ZOO["llama4"])
    model, build_s = build_timed(torch, cfg, args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    eng, _, num = serve_path(torch, "moe_llama4", model, prompts,
                             chunk=MAIN["prefill_chunk_tokens"],
                             horizon=MAIN["decode_horizon"])
    require_all_wgmma("chunk_prefill_attention",
                      num["launches"]["chunk_prefill_attention"],
                      num["launches_by_variant"]["chunk_prefill_attention"])
    del eng
    check_prefill_logits(torch, "moe_llama4", model, prompts[0])
    emit("moe_llama4", model=cfg.name, n_layers=cfg.n_layers,
         params=n_params, weights_gb=n_params * 2 / 1e9,
         model_build_s=build_s, **num)
    del model
    reset_peak(torch)
    return num["launches"]


def phase_dense_large(torch, args, prompts):
    """Full-width qwen3-32b (64 layers) serving 4 of the main path's
    requests, 32 new tokens each, chunked at horizon 8; then qwen1.5-110b
    at its widths, 8 of 80 layers, with non-zero q/k/v biases, the same
    way. Returns the launches by model."""
    out = {}
    for key in ("qwen32", "qwen110"):
        cfg = zoo_config(ZOO[key])
        model, build_s = build_timed(torch, cfg, args.seed,
                                     biases=cfg.qkv_bias)
        n_params = sum(p.numel() for p in model.parameters())
        reqs = prompts[:DENSE_LARGE["n_requests"]]
        eng, _, num = serve_path(torch, f"dense_large {cfg.name}", model,
                                 reqs, chunk=MAIN["prefill_chunk_tokens"],
                                 horizon=MAIN["decode_horizon"],
                                 max_new=DENSE_LARGE["max_new"])
        require_all_wgmma("chunk_prefill_attention",
                          num["launches"]["chunk_prefill_attention"],
                          num["launches_by_variant"][
                              "chunk_prefill_attention"])
        del eng
        check_prefill_logits(torch, f"dense_large {cfg.name}", model,
                             reqs[0])
        emit("dense_large", model=cfg.name, n_layers=cfg.n_layers,
             params=n_params, weights_gb=n_params * 2 / 1e9,
             nonzero_biases=cfg.qkv_bias, model_build_s=build_s, **num)
        out[cfg.name] = num["launches"]
        del model
        reset_peak(torch)
    return out


def phase_hybrid_main(torch, args, prompt_lens):
    """jamba-v0.1-52b at its published widths, 16 of 32 layers (2
    attention, 14 Mamba2, 8 MoE), serving the main path's 8 prompt lengths:
    the chunk and horizon knobs (256, 8) degrade to 0 and 1; every prefill
    runs flash on the attention layers and the SSD scan (simt at N = 16)
    on the SSM layers; decode runs paged attention and steps the state
    cache. Then a profile of its first step (the prefills) and of one
    decode step, with the SSD, flash and MoE shares. Returns its
    launches."""
    from repro_torch.configs import dtype_bytes

    cfg = zoo_config(ZOO["hybrid"])
    model, build_s = build_timed(torch, cfg, args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(args.seed + 3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in prompt_lens]
    eng, _, num = serve_path(torch, "hybrid_main", model, prompts,
                             chunk=MAIN["prefill_chunk_tokens"],
                             horizon=MAIN["decode_horizon"])
    require(eng.chunk_tokens == 0 and eng.horizon == 1 and eng.paged,
            f"hybrid knobs did not degrade: chunk {eng.chunk_tokens}, "
            f"horizon {eng.horizon}")
    n_attn = cfg.n_attn_layers
    want = dict(flash_attention=n_attn * len(prompts),
                ssd_chunk=(cfg.n_layers - n_attn) * len(prompts))
    for k, n in want.items():
        require(num["launches"][k] == n,
                f"hybrid_main: {k} launched {num['launches'][k]} times, "
                f"not {n}")
    require(num["launches_by_variant"]["ssd_chunk"] == {
        "simt": want["ssd_chunk"], "wgmma": 0},
        f"hybrid_main: ssd_chunk by variant "
        f"{num['launches_by_variant']['ssd_chunk']}")
    require_all_wgmma("flash_attention", want["flash_attention"],
                      num["launches_by_variant"]["flash_attention"])
    s = cfg.ssm
    state_bytes = eng._state_bytes
    require(state_bytes == MAIN["max_slots"] * (
        cfg.ssm_state_bytes() + (cfg.n_layers - n_attn) * (s.conv_dim - 1)
        * s.d_inner(cfg.d_model) * dtype_bytes(cfg.dtype)),
        f"hybrid state cache of {state_bytes} bytes")
    del eng
    check_prefill_logits(torch, "hybrid_main", model, prompts[0])
    kw = {k: MAIN[k] for k in ("max_slots", "s_max", "page_tokens",
                               "prefill_chunk_tokens", "decode_horizon")}
    with moe_ranges(torch):
        prof = profile_first_step(torch, model, prompts, **kw)
    first = prof["first_step"]
    emit("hybrid_main", model=cfg.name, n_layers=cfg.n_layers,
         attn_layers=n_attn, params=n_params, weights_gb=n_params * 2 / 1e9,
         model_build_s=build_s, prompt_lens=list(prompt_lens),
         degraded=dict(prefill_chunk_tokens=0, decode_horizon=1),
         state_cache_gb=state_bytes / 1e9, **num,
         ssd_share_of_first_step=first["device_share"]["ssd_chunk"],
         flash_share_of_first_step=first["device_share"]["flash_attention"],
         moe_share_of_first_step=first.get("moe_share"),
         profile_first_step=prof)
    del model
    reset_peak(torch)
    return num["launches"]


# ------------------------------------------- encoder-decoder and vlm
CROSS = dict(encdec="whisper-medium", vlm="llama-3.2-vision-11b")
# the cross paths' depth: half of each model's layers (whisper's decoder
# and encoder alike; vision's 4 of 8 periods), cut to pay for the mesh
# phase's SSM, hybrid and cross-attention jobs; every mechanism (the
# encoder, the cross prefill, the cross decode) runs at the published
# widths all the same
CROSS_LAYERS = {"whisper-medium": 12, "llama-3.2-vision-11b": 20}


def cross_config(name: str):
    """``name`` at its widths and ``CROSS_LAYERS[name]`` layers (an
    encoder's too)."""
    from repro_torch.configs import get_config
    n = CROSS_LAYERS[name]
    cfg = dataclasses.replace(get_config(name), n_layers=n)
    if cfg.encoder is not None:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, n_layers=n))
    return cfg
# a decoder's published context where the main path's prompts exceed it:
# Whisper's n_text_ctx, 448 tokens in every published Whisper model
TEXT_CTX = {"whisper-medium": 448}


def cross_prompt_lens(name: str, prompt_lens) -> list:
    """``name``'s prompt lengths on its main path: the main path's, scaled
    into the decoder's context less the new tokens where the model has a
    short one (whisper: 448 - 64 = 384 at the longest)."""
    ctx = TEXT_CTX.get(name)
    if ctx is None:
        return list(prompt_lens)
    cap = ctx - MAIN["max_new"]
    return [max(1, P * cap // MAIN["prompt_max"]) for P in prompt_lens]


def cross_flash_shapes(prompt_lens) -> dict:
    """The flash kernel's shapes on the cross-attention paths, by label:
    (B, Sq, Sk, H, Hkv, hd, causal). Whisper's encoder self-attention over
    its frames; whisper's causal decoder prefill of its shortest and
    longest prompt (vision's decoder has qwen3-8b's heads: the main
    path's check); each model's cross prefill of its longest prompt over
    its context; each model's cross decode, one query row per lane of the
    main path's 8."""
    from repro_torch.configs import get_config
    B = MAIN["max_slots"]
    out = {}
    w = get_config(CROSS["encdec"])
    n, heads = w.n_ctx, f"{w.n_heads}/{w.n_kv_heads} hd{w.head_dim_}"
    out[f"encoder {n}x{n} {heads}"] = (
        1, n, n, w.n_heads, w.n_kv_heads, w.head_dim_, False)
    lens = cross_prompt_lens(w.name, prompt_lens)
    for S in sorted({min(lens), max(lens)}):
        out[f"decoder prefill {S} {heads} causal"] = (
            1, S, S, w.n_heads, w.n_kv_heads, w.head_dim_, True)
    for key in ("encdec", "vlm"):
        c = get_config(CROSS[key])
        P = max(cross_prompt_lens(c.name, prompt_lens))
        heads = f"{c.n_heads}/{c.n_kv_heads} hd{c.head_dim_}"
        out[f"cross prefill {P}x{c.n_ctx} {heads}"] = (
            1, P, c.n_ctx, c.n_heads, c.n_kv_heads, c.head_dim_, False)
        out[f"cross decode {B}x1x{c.n_ctx} {heads}"] = (
            B, 1, c.n_ctx, c.n_heads, c.n_kv_heads, c.head_dim_, False)
    return out


def check_cross_kernels(torch, gen, prompt_lens) -> dict:
    """Flash (wgmma, bf16) at each shape of :func:`cross_flash_shapes`, and
    paged decode (bf16) at whisper's heads (16/16, hd 64) with the 8 lanes
    of its main path mid-decode, each against its plain version, timed
    beside its bound (flash beside SDPA). Returns both kernels' numbers by
    label."""
    from repro_torch.launch import roofline as rl
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    bf16 = torch.bfloat16
    out = {"flash_attention": {}, "paged_attention": {}}
    for label, (B, Sq, Sk, H, Hkv, hd, causal) in cross_flash_shapes(
            prompt_lens).items():
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(bf16)
                   for shape in ((B, Sq, H, hd), (B, Sk, Hkv, hd),
                                 (B, Sk, Hkv, hd)))
        require(fa.variant(bf16, hd) == "wgmma",
                f"flash_attention at {label}: the {fa.variant(bf16, hd)} "
                f"variant")
        got = fa.flash_attention(q, k, v, causal=causal)
        want = ref.blockwise_attention(q.float(), k.float(), v.float(),
                                       causal)
        err, row_err = chunk_errors(got, want)
        require(err <= 2e-2 and row_err <= 2e-2,
                f"flash_attention at {label}: err {err}, row {row_err}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa(qt=qt, kt=kt, vt=vt, causal=causal):
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal,
                                                  enable_gqa=True)

        n_bytes, n_flops = rl.flash_cost(Sq, Sk, H, Hkv, hd, causal, 2)
        b_ms, b_by = rl.bound(B * n_bytes, B * n_flops, rl.H100.peak_flops)
        out["flash_attention"][label] = dict(
            max_abs_err=err, row_scaled_err=row_err,
            shape=dict(B=B, Sq=Sq, Sk=Sk, H=H, Hkv=Hkv, hd=hd,
                       causal=causal),
            variant=fa.variant(bf16, hd),
            **kernel_times(lambda: fa.flash_attention(q, k, v,
                                                      causal=causal)),
            plain_ms=time_ms(lambda: ref.blockwise_attention(q, k, v,
                                                             causal),
                             reps=3),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(sdpa),
            library_ms_no_spin=time_ms(sdpa, spin=False))
        emit("kernel_check_zoo", name="flash_attention", heads=label,
             **out["flash_attention"][label])
        del q, k, v, qt, kt, vt, got, want

    w = get_config(CROSS["encdec"])
    H, Hkv, hd = w.n_heads, w.n_kv_heads, w.head_dim_
    page = MAIN["page_tokens"]
    W = -(-MAIN["s_max"] // page)
    n_rows = MAIN["max_slots"] * W + 1
    seq_lens = [P + MAIN["max_new"] // 2
                for P in cross_prompt_lens(w.name, prompt_lens)]
    label = f"whisper decode {len(seq_lens)} lanes {H}/{Hkv} hd{hd}"
    q, kp, vp, bt, sl = paged_inputs(torch, gen, seq_lens, H, Hkv, hd, page,
                                     W, n_rows, bf16)
    err, row_err = chunk_errors(
        pa.paged_attention(q, kp, vp, bt, sl),
        ref.paged_attention_ref(q.float(), kp.float(), vp.float(), bt, sl))
    require(err <= 2e-2 and row_err <= 2e-2,
            f"paged_attention at {label}: max_abs_err {err}, row-scaled "
            f"{row_err}")
    b_ms, b_by = rl.bound(*rl.paged_cost(seq_lens, H, Hkv, hd, W, 2),
                          rl.H100.peak_flops)
    out["paged_attention"][label] = dict(
        max_abs_err=err, row_scaled_err=row_err, seq_lens=seq_lens,
        split=pa.split_plan(len(seq_lens), Hkv, W, page),
        **kernel_times(lambda: pa.paged_attention(q, kp, vp, bt, sl)),
        plain_ms=time_ms(lambda: ref.paged_attention_ref(q, kp, vp, bt,
                                                         sl)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    emit("kernel_check_zoo", name="paged_attention", heads=label,
         **out["paged_attention"][label])
    return out


def cross_extras(cfg, n: int, seed: int) -> dict:
    """Frames or patch embeddings for ``n`` requests, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return {cfg.ctx_key: rng.standard_normal((n, cfg.n_ctx, cfg.ctx_width),
                                             np.float32)}


def phase_cross_reference(torch, args):
    """Reduced whisper-medium and llama-3.2-vision-11b served on the card
    (kernels) and on the CPU (plain versions) from the same weights, each
    request with the same frames or patch embeddings on both: identical
    greedy tokens, the knobs degrading to 0 and 1."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, init_params

    lens = (3, 17, 40, 9, 25, 33)
    for name in CROSS.values():
        cfg = get_config(name).reduced()
        params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                             "cpu")
        cpu = build_model(cfg, params, device="cpu")
        gpu = build_model(cfg, params, device="cuda")
        rng = np.random.default_rng(args.seed)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
                   for n in lens]
        extras = cross_extras(cfg, len(prompts), args.seed + 6)
        kw = dict(max_slots=4, s_max=128, page_tokens=8,
                  prefill_chunk_tokens=16, decode_horizon=4, extras=extras)
        _, want, _ = serve(torch, cpu, prompts, device="cpu", **kw)
        ops.reset_counts()
        eng, got, _ = serve(torch, gpu, prompts, device="cuda", **kw)
        launches = require_path(f"reduced {name}", gpu, 16)
        require(eng.chunk_tokens == 0 and eng.horizon == 1,
                f"reduced {name}: knobs did not degrade")
        same = all(got[i].out == want[i].out for i in want)
        require(same, f"reduced {name}: card tokens differ from the CPU's")
        emit("cross_reference", model=cfg.name, requests=len(prompts),
             engine_chunk=eng.chunk_tokens, engine_horizon=eng.horizon,
             identical_tokens=same, launches=launches)


@contextlib.contextmanager
def cross_ranges(torch):
    """The encoder (``cross::encoder``), each cross prefill sub-layer
    (``cross::prefill``: projections, flash and output product) and each
    cross decode sub-layer (``cross::decode``) under a profiler range, so
    :func:`profile_steps` gives their device time."""
    from repro_torch.models import layers
    from repro_torch.models.transformer import Model
    rf = torch.profiler.record_function
    encode, full = Model.encode, layers.attn_full
    dec = layers.attn_decode_cross

    def ranged_encode(*a, **k):
        with rf("cross::encoder"):
            return encode(*a, **k)

    def ranged_full(*a, **k):
        if k.get("kv_src") is None:
            return full(*a, **k)
        with rf("cross::prefill"):
            return full(*a, **k)

    def ranged_decode(*a, **k):
        with rf("cross::decode"):
            return dec(*a, **k)

    Model.encode, layers.attn_full = ranged_encode, ranged_full
    layers.attn_decode_cross = ranged_decode
    try:
        yield
    finally:
        Model.encode, layers.attn_full = encode, full
        layers.attn_decode_cross = dec


def phase_cross_main(torch, args, key: str, prompt_lens):
    """Full-width whisper-medium (``key`` encdec: 12 of its 24 decoder and
    12 of its 24 encoder layers) or llama-3.2-vision-11b (vlm: 20 of its
    40 layers, 4 cross), bf16 (:func:`cross_config`): the main path's 8
    prompt lengths (whisper's scaled into
    its 448-token decoder context: :func:`cross_prompt_lens`), 64 new
    tokens each, without extras (the engine's stub: 1,500 x 1,024 frames,
    or 1,601 x 4,096 patch embeddings); the chunk and horizon knobs (256,
    8) degrade to 0 and 1; paged decode and flash, all wgmma, are the only
    kernels: flash once per prompt for every self-attention, encoder and
    cross layer and once per decode step for every cross layer. Then the
    cross cache's bytes against the formula, and a profile of the first
    step (the prefills and a decode) with the encoder's and the cross
    sub-layers' shares, and of one decode step with the cross decode's.
    Returns the path's launches."""
    cfg = cross_config(CROSS[key])
    where = f"{key}_main"
    prompt_lens = cross_prompt_lens(cfg.name, prompt_lens)
    model, build_s = build_timed(torch, cfg, args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(args.seed + 4)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in prompt_lens]
    eng, done, num = serve_path(torch, where, model, prompts,
                                chunk=MAIN["prefill_chunk_tokens"],
                                horizon=MAIN["decode_horizon"])
    require(eng.chunk_tokens == 0 and eng.horizon == 1 and eng.paged,
            f"{where}: knobs did not degrade: chunk {eng.chunk_tokens}, "
            f"horizon {eng.horizon}")
    n_enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    n_cross = len(model.cross_layer)
    steps = eng.stat_decode_syncs
    want = dict(flash_attention=len(prompts) * (cfg.n_layers + n_cross
                                                + n_enc) + steps * n_cross,
                paged_attention=steps * cfg.n_layers)
    for k, n in want.items():
        require(num["launches"][k] == n,
                f"{where}: {k} launched {num['launches'][k]} times, not {n}")
    require_all_wgmma("flash_attention", want["flash_attention"],
                      num["launches_by_variant"]["flash_attention"])
    cross_bytes = eng._state_bytes
    formula = (n_cross * 2 * MAIN["max_slots"] * cfg.n_ctx * cfg.n_kv_heads
               * cfg.head_dim_ * 2)
    require(cross_bytes == formula,
            f"{where}: cross cache of {cross_bytes} bytes, not {formula}")
    extras = eng._modal_extras
    stub = next(iter(extras.values()))
    require(tuple(stub.shape) == (1, cfg.n_ctx, cfg.ctx_width)
            and stub.dtype == torch.bfloat16, f"{where}: stub {stub.shape}")
    del eng
    check_prefill_logits(torch, where, model, prompts[0], extras)
    kw = {k: MAIN[k] for k in ("max_slots", "s_max", "page_tokens",
                               "prefill_chunk_tokens", "decode_horizon")}
    with cross_ranges(torch):
        prof = profile_first_step(torch, model, prompts, **kw)
    first, dec = prof["first_step"], prof["decode_step"]
    emit(where, model=cfg.name, n_layers=cfg.n_layers, encoder_layers=n_enc,
         cross_layers=n_cross, params=n_params,
         weights_gb=n_params * 2 / 1e9, model_build_s=build_s,
         prompt_lens=list(prompt_lens), stub_shape=list(stub.shape),
         degraded=dict(prefill_chunk_tokens=0, decode_horizon=1),
         cross_cache_bytes=cross_bytes, cross_cache_bytes_formula=formula,
         **num,
         encoder_share_of_first_step=first.get("cross_share", {}).get(
             "encoder"),
         cross_prefill_share_of_first_step=first.get("cross_share", {}).get(
             "prefill"),
         flash_share_of_first_step=first["device_share"]["flash_attention"],
         cross_decode_share_of_decode_step=dec.get("cross_share", {}).get(
             "decode"),
         paged_share_of_decode_step=dec["device_share"]["paged_attention"],
         profile_first_step=prof)
    del model, extras, stub
    reset_peak(torch)
    return num["launches"]


def zoo_phases(torch, args, prompt_lens, prompts, mark):
    """The phases of the MoE, hybrid, large dense and cross-attention
    configs. Returns the kernel checks at their shapes, their launches by
    path, and the chunk kernel's variants on moe_main."""
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 5)
    checks = check_zoo_kernels(torch, gen, prompt_lens)
    for name, by_label in check_cross_kernels(torch, gen,
                                              prompt_lens).items():
        checks[name].update(by_label)
    mark("kernels_zoo")
    phase_zoo_reference(torch, args)
    mark("zoo_reference")
    by_path, moe_variants = phase_moe_main(torch, args, prompts)
    mark("moe_main")
    by_path["moe_llama4"] = phase_moe_llama4(torch, args, prompts)
    mark("moe_llama4")
    for name, n in phase_dense_large(torch, args, prompts).items():
        by_path[f"dense_large_{name}"] = n
    mark("dense_large")
    by_path["hybrid_main"] = phase_hybrid_main(torch, args, prompt_lens)
    mark("hybrid_main")
    phase_cross_reference(torch, args)
    mark("cross_reference")
    for key in CROSS:
        by_path[f"{key}_main"] = phase_cross_main(torch, args, key,
                                                  prompt_lens)
        mark(f"{key}_main")
    return checks, by_path, moe_variants


# ------------------------------------------------- training and checkpoints
TRAIN = dict(model="qwen3-8b", layers=3, batch=4, n_micro=2, seq=4096,
             period=256, steps=12, ckpt_at=6, lr=5e-4, warmup=2,
             grad_layers=2, grad_batch=2)
WHISPER_TRAIN = dict(batch=4, seq=448, steps=6, lr=1e-3, warmup=2)
# the backward's device kernels: the D pre-pass, then both passes of each
# variant
BWD_NAMES = ("delta_kernel", "dkdv_wgmma", "dq_wgmma", "dkdv_simt",
             "dq_simt")
# the SSD backward's device kernels, in launch order: the wgmma variant's
# two chains, the simt variant's four passes (dA_kernel ends both)
SSD_BWD_NAMES = ("states_wgmma", "chunk_wgmma", "increments_kernel",
                 "scan_kernel", "chunk_kernel", "dA_kernel")
# mamba2-2.7b whole in training: train_main's batch shape, cyclic batch
# and steps, at 8 times its lr (at 5e-4 the loss of a freshly drawn
# mamba2-2.7b barely moves in 12 steps, with the plain scan as with the
# kernels: ``python3 chip_smoke.py --lr-witness-layers 64``; at 8e-3 the
# curve stops falling monotonically, and whether it halves by step 12
# turns on the last bits of the gradients, the plain scan's own run too;
# at 4e-3 both fall monotonically from step 5 on and halve it:
# ``--lr-witness-layers 64 --lr-witness-lr 8e-3`` or ``4e-3``)
# the training run at 32 of mamba2-2.7b's 64 layers: cut to pay for the
# mesh phase's sharding-mode jobs
MAMBA_TRAIN = dict(model=SSM_MODEL, layers=32, batch=4, n_micro=2,
                   seq=4096, period=256, steps=12, lr=4e-3, warmup=2,
                   grad_layers=2, grad_batch=2)


def bwd_ptxas(lib: str = "flash_attention_bwd") -> dict:
    """ptxas's report (registers, spills, stack, wgmma serialized) of each
    device kernel of a backward's library as this run built it, by a short
    name (``dkdv_wgmma<128>``, ``chunk_wgmma<128,64>``)."""
    import re
    from repro_torch.kernels import _build
    args = {"fE": "float", "13__nv_bfloat16E": "bf16"}
    out = {}
    for mangled, r in _build.ptxas_report(lib).items():
        m = re.match(r"_ZN\d+\w+?_bwd(\d+)", mangled)
        if not m:
            out[mangled] = r
            continue
        n = int(m.group(1))
        rest = mangled[m.end():]
        name, rest = rest[:n], rest[n:]
        if rest.startswith("I"):
            targs = re.findall(r"Li(\d+)E|(fE|13__nv_bfloat16E)",
                               rest[1:rest.index("EE") + 1])
            name += "<" + ",".join(a or args[b] for a, b in targs) + ">"
        out[name] = r
    return out


def grad_errors(got, want) -> tuple:
    """A gradient's largest error, and each row's (one token's head)
    error over the larger of that row's magnitude and 1% of the tensor's
    (a causal first row's dq is zero up to rounding, so its own magnitude
    is no scale)."""
    diff = (got.float() - want).abs()
    floor = 1e-2 * float(want.abs().max())
    row = diff.amax(-1) / want.abs().amax(-1).clamp_min(max(floor, 1e-30))
    return float(diff.max()), float(row.max())


def train_kernel_shapes() -> dict:
    """The flash shapes of the training paths, by label: (B, Sq, Sk, H,
    Hkv, hd, causal, dtype). qwen3-8b's microbatch of train_main; whisper's
    encoder, causal decoder and cross attention at train_whisper's batch;
    llama-3.2-vision's cross attention over its 1,601 rows; two small f32
    cases of ragged lengths; whisper's shapes on a rank of the mesh
    phase's 1 x 2 train job (half the heads, 2 x 256)."""
    import torch
    from repro_torch.configs import get_config
    q3, w, vis = (get_config(n) for n in (TRAIN["model"], CROSS["encdec"],
                                          CROSS["vlm"]))
    bf16, f32 = torch.bfloat16, torch.float32
    B, Bw, S, Sw = (TRAIN["batch"] // TRAIN["n_micro"],
                    WHISPER_TRAIN["batch"], TRAIN["seq"],
                    WHISPER_TRAIN["seq"])
    wh = (w.n_heads, w.n_kv_heads, w.head_dim_)
    return {
        f"qwen3-8b causal {S}": (B, S, S, q3.n_heads, q3.n_kv_heads,
                                 q3.head_dim_, True, bf16),
        f"whisper encoder {w.n_ctx}x{w.n_ctx}": (Bw, w.n_ctx, w.n_ctx, *wh,
                                                 False, bf16),
        f"whisper decoder causal {Sw}": (Bw, Sw, Sw, *wh, True, bf16),
        f"whisper cross {Sw}x{w.n_ctx}": (Bw, Sw, w.n_ctx, *wh, False, bf16),
        f"vision cross 512x{vis.n_ctx}": (1, 512, vis.n_ctx, vis.n_heads,
                                          vis.n_kv_heads, vis.head_dim_,
                                          False, bf16),
        "f32 causal ragged 77x131": (2, 77, 131, 8, 2, 64, True, f32),
        "f32 cross ragged 50x131": (2, 50, 131, 8, 1, 128, False, f32),
        # a rank's half of the heads in the mesh phase's 1 x 2 train jobs
        **{f"{k} {Sq}x{Sk}, a 1 x 2 rank": (2, Sq, Sk, h // 2, hkv // 2, d,
                                             c, bf16)
           for k, (Sq, Sk, h, hkv, d, c) in {
               "whisper encoder": (w.n_ctx, w.n_ctx, *wh, False),
               "whisper decoder causal": (256, 256, *wh, True),
               "whisper cross": (256, w.n_ctx, *wh, False)}.items()},
    }


def phase_kernels_train(torch, gen) -> dict:
    """The training forward (flash with the row log-sum-exp) and the flash
    backward against their plain versions (``ref.flash_attention_lse``,
    ``ref.flash_attention_bwd_ref``, all f32 on the same values; the plain
    backward from the kernel's o and lse) at each shape of
    :func:`train_kernel_shapes`: the forward's output bitwise equal to the
    serving forward's and held to the plain one, lse to 1e-4, dq, dk and
    dv by their largest error and row-scaled error, two backward runs
    bitwise equal;
    bf16 through the wgmma variant, f32 through simt. Then each bf16 shape
    timed: the backward alone, forward + backward, beside the bound and
    SDPA's forward + backward and backward alone, with the bound's share
    of the backward's time and the backward's time over SDPA's. Returns
    the numbers by label."""
    from repro_torch.launch import roofline as rl
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    out = {}
    for label, (B, Sq, Sk, H, Hkv, hd, causal, dt) in \
            train_kernel_shapes().items():
        q, dout = (torch.randn((B, Sq, H, hd), generator=gen,
                               device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((B, Sk, Hkv, hd), generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        same_fwd = bool(torch.equal(o, fa.flash_attention(q, k, v, causal)))
        o_ref, lse_ref = ref.flash_attention_lse(q.float(), k.float(),
                                                 v.float(), causal)
        lse_err = float((lse - lse_ref).abs().max())
        grads = fa.flash_attention_bwd(q, k, v, o, lse, dout, causal)
        again = fa.flash_attention_bwd(q, k, v, o, lse, dout, causal)
        deterministic = all(bool(torch.equal(a, b))
                            for a, b in zip(grads, again))
        o_err = chunk_errors(o, o_ref)
        # the plain backward on the same inputs: the kernel's o and lse
        want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                           o.float(), lse, dout.float(),
                                           causal)
        errs = {name: grad_errors(g, w)
                for name, g, w in zip(("dq", "dk", "dv"), grads, want)}
        del again, want, o_ref, lse_ref
        bf16 = dt == torch.bfloat16
        variant = fa.bwd_variant(dt, hd)
        require(same_fwd, f"flash_attention_fwd at {label}: its output "
                f"differs from the serving forward's")
        require(deterministic, f"flash_attention_bwd at {label}: two runs "
                f"differ")
        require(variant == ("wgmma" if bf16 else "simt"),
                f"flash_attention_bwd at {label}: the {variant} variant")
        # bf16: inputs rounded once, P and dS rounded to bf16 for their
        # products and the output once, about 1e-2 of a row; a key tile
        # dropped or a query head's share misplaced gives tenths. f32:
        # sums in another order, 1e-5
        lim_abs, lim_row = (5e-2, 3e-2) if bf16 else (1e-4, 1e-4)
        require(lse_err <= 1e-4 and o_err[0] <= lim_abs
                and o_err[1] <= lim_row, f"flash_attention_fwd at {label}: "
                f"lse error {lse_err}, output {o_err}")
        for name, (e_abs, e_row) in errs.items():
            require(e_abs <= lim_abs and e_row <= lim_row,
                    f"flash_attention_bwd at {label}: {name} error "
                    f"{e_abs}, row-scaled {e_row}")
        row = dict(shape=dict(B=B, Sq=Sq, Sk=Sk, H=H, Hkv=Hkv, hd=hd,
                              causal=causal, dtype=str(dt)),
                   variant=variant, fwd_bitwise_serving=same_fwd,
                   deterministic=deterministic, lse_max_abs_err=lse_err,
                   fwd_max_abs_err=o_err[0], fwd_row_scaled_err=o_err[1],
                   max_abs_err=max(e[0] for e in errs.values()),
                   row_scaled_err=max(e[1] for e in errs.values()),
                   errors={n: dict(max_abs=e[0], row_scaled=e[1])
                           for n, e in errs.items()})
        if bf16:
            n_bytes, n_flops = rl.bwd_cost(B, Sq, Sk, H, Hkv, hd, causal, 2)
            b_ms, b_by = rl.bound(n_bytes, n_flops, rl.H100.peak_flops)
            fb_bytes, fb_flops = rl.flash_cost(Sq, Sk, H, Hkv, hd, causal, 2)
            fb_ms, fb_by = rl.bound(n_bytes + B * fb_bytes,
                                    n_flops + B * fb_flops,
                                    rl.H100.peak_flops)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            dt_ = dout.transpose(1, 2)
            with torch.enable_grad():
                o_sdpa = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)

            def sdpa_bwd():
                torch.autograd.grad(o_sdpa, (qt, kt, vt), dt_,
                                    retain_graph=True)

            def sdpa_fwd_bwd():
                with torch.enable_grad():
                    oo = F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True)
                    torch.autograd.grad(oo, (qt, kt, vt), dt_)

            def fwd_bwd():
                oo, ll = fa.flash_attention_fwd(q, k, v, causal)
                fa.flash_attention_bwd(q, k, v, oo, ll, dout, causal)

            row.update(
                **kernel_times(lambda: fa.flash_attention_bwd(
                    q, k, v, o, lse, dout, causal)),
                plain_ms=time_ms(lambda: ref.flash_attention_bwd_ref(
                    q, k, v, o, lse, dout, causal), reps=3, warmup=1),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(sdpa_bwd),
                fwd_bwd_ms=time_ms(fwd_bwd), fwd_bwd_bound_ms=fb_ms,
                fwd_bwd_bound_by=fb_by,
                library_fwd_bwd_ms=time_ms(sdpa_fwd_bwd))
            # the share of the bound reached, and the time over SDPA's
            row.update(bound_share=b_ms / row["ms"],
                       library_ratio=row["ms"] / row["library_ms"])
            del o_sdpa, qt, kt, vt
        out[label] = row
        emit("kernel_check_train", name="flash_attention_bwd", heads=label,
             **row)
        del q, k, v, o, lse, dout, grads
    emit("ptxas", name="flash_attention_bwd", kernels=bwd_ptxas())
    reset_peak(torch)
    return out


def ssd_bwd_shapes() -> dict:
    """The SSD backward's shapes, by label: (B, S, H, P, N, dtype, with a
    final-state gradient). mamba2-2.7b's and jamba's training microbatch
    (2 x 4,096 tokens, bf16), a prime length (a ragged last chunk) at
    mamba2's heads with and without the final state's gradient, one rank's
    40 heads of a 1 x 2 mesh (2 x 1,024, bf16), and an f32 case."""
    import torch
    from repro_torch.configs import get_config
    bf16, f32 = torch.bfloat16, torch.float32
    B, S = MAMBA_TRAIN["batch"] // MAMBA_TRAIN["n_micro"], MAMBA_TRAIN["seq"]
    out = {}
    for name in (SSM_MODEL, ZOO["hybrid"]):
        cfg = get_config(name)
        s = cfg.ssm
        out[f"{name} {B}x{S}"] = (B, S, s.n_heads(cfg.d_model), s.head_dim,
                                  s.d_state, bf16, False)
    cfg = get_config(SSM_MODEL)
    s = cfg.ssm
    wide = (s.n_heads(cfg.d_model), s.head_dim, s.d_state)
    p = next_prime(1000)
    out[f"{SSM_MODEL} heads 1x{p}"] = (1, p, *wide, bf16, False)
    out[f"{SSM_MODEL} heads 1x{p}, dstate"] = (1, p, *wide, bf16, True)
    # a rank's heads in the mesh phase's 1 x 2 train job
    tp = 2
    out[f"{SSM_MODEL} 1/{tp} of the heads 2x1024"] = (
        2, 1024, wide[0] // tp, *wide[1:], bf16, False)
    out["f32 2x263, dstate"] = (2, 263, 8, 64, 128, f32, True)
    return out


def check_ssd_bwd(torch, gen) -> dict:
    """The SSD backward kernel (``csrc/ssd_chunk_bwd.cu``) against its
    plain version (``ref.ssd_chunk_bwd``, f32 on the same inputs) at each
    shape of :func:`ssd_bwd_shapes`, with the configs' chunk: each
    gradient's largest error and row-scaled error, two runs bitwise
    equal. bf16: dx, dB and dC rounded once to bf16 (2^-9 of an element),
    within 1e-2 of the tensor's largest magnitude and 3e-2 of a row's; the
    f32 outputs (every output of the f32 case, ddt and dA always) within
    1e-4 and 1e-3 (sums in another order). bf16 at N and P of 64 or 128
    takes the wgmma variant (f32 operands split into bf16 hi + lo, so the
    same limits hold), jamba's N 16 and f32 the simt one. Each shape timed
    beside its bound and the plain version; no single PyTorch call
    computes the scan's gradient (``library_ms`` None). Returns the
    numbers by label."""
    from repro_torch.launch import roofline as rl
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as ssd

    chunk = get_config(SSM_MODEL).ssm.chunk
    out = {}
    for label, (B, S, H, P, N, dt_, with_state) in ssd_bwd_shapes().items():
        x, dy = (torch.randn((B, S, H, P), generator=gen,
                             device="cuda").to(dt_) for _ in range(2))
        Bm, Cm = (torch.randn((B, S, H, N), generator=gen,
                              device="cuda").to(dt_) for _ in range(2))
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, H), generator=gen, device="cuda"))
        A = -torch.exp(0.3 * torch.randn((H,), generator=gen, device="cuda"))
        ds = (torch.randn((B, H, N, P), generator=gen, device="cuda")
              if with_state else None)
        args = (x, dt, A, Bm, Cm, dy, ds, chunk)
        got = ssd.ssd_chunk_bwd(*args)
        again = ssd.ssd_chunk_bwd(*args)
        deterministic = all(bool(torch.equal(a, b))
                            for a, b in zip(got, again))
        want = ref.ssd_chunk_bwd(x.float(), dt, A, Bm.float(), Cm.float(),
                                 dy.float(), ds, chunk)
        errs = {}
        for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
            e_abs, e_row = grad_errors(g, w)
            scaled = e_abs / max(float(w.abs().max()), 1e-30)
            errs[name] = dict(max_abs=e_abs, scaled=scaled, row_scaled=e_row)
            lim = (1e-2, 3e-2) if g.dtype == torch.bfloat16 else (1e-4, 1e-3)
            require(scaled <= lim[0] and e_row <= lim[1],
                    f"ssd_chunk_bwd at {label}: {name} error {e_abs} "
                    f"({scaled} of its magnitude, {e_row} of a row's)")
        require(deterministic, f"ssd_chunk_bwd at {label}: two runs differ")
        variant = ssd.bwd_variant(dt_, N, P, chunk)
        want_variant = ("wgmma" if dt_ == torch.bfloat16 and N >= 64
                        else "simt")
        require(variant == want_variant,
                f"ssd_chunk_bwd at {label}: the {variant} variant")
        del again, want
        n_bytes, n_flops = rl.ssd_bwd_cost(B, S, H, P, N, min(chunk, 64),
                                           x.element_size(), with_state)
        b_ms, b_by = rl.bound(n_bytes, n_flops, rl.H100.peak_flops)
        n_state = B * -(-S // min(chunk, 64)) * H * N * P * 4
        row = dict(shape=dict(B=B, S=S, H=H, P=P, N=N, dtype=str(dt_),
                              final_state_grad=with_state, chunk=chunk),
                   variant=variant, deterministic=deterministic,
                   max_abs_err=max(e["max_abs"] for e in errs.values()),
                   row_scaled_err=max(e["row_scaled"]
                                      for e in errs.values()),
                   errors=errs,
                   **kernel_times(lambda: ssd.ssd_chunk_bwd(*args)),
                   plain_ms=time_ms(lambda: ref.ssd_chunk_bwd(
                       x, dt, A, Bm, Cm, dy, ds, chunk), reps=3, warmup=1),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   bytes=n_bytes, flops=n_flops,
                   # the f32 chunk states and their gradients through
                   # device memory, by the design: wgmma writes s_in once
                   # and reads it twice, ds_out once and once; simt writes
                   # each direction's increments, scans them in place and
                   # reads them again
                   state_bytes=(5 if variant == "wgmma" else 8) * n_state)
        row["bound_share"] = b_ms / row["ms"]
        out[label] = row
        emit("kernel_check_train", name="ssd_chunk_bwd", heads=label, **row)
        del x, dy, Bm, Cm, dt, A, ds, got, args
    emit("ptxas", name="ssd_chunk_bwd", kernels=bwd_ptxas("ssd_chunk_bwd"))
    reset_peak(torch)
    return out


@contextlib.contextmanager
def plain_attention():
    """Every attention of the models in the plain version on the card
    (``ref.blockwise_attention``, differentiated by autograd): what a
    training path with the kernels is held against."""
    from repro_torch.kernels import ops, ref
    kernel = ops.flash_attention
    ops.flash_attention = ref.blockwise_attention
    try:
        yield
    finally:
        ops.flash_attention = kernel


@contextlib.contextmanager
def plain_scan():
    """Every SSD scan of the models in the plain version on the card
    (``ref.ssd_chunk_scan``, differentiated by autograd): what a training
    path with the SSD kernels is held against."""
    from repro_torch.kernels import ops, ref
    kernel = ops.ssd_chunk
    ops.ssd_chunk = ref.ssd_chunk_scan
    try:
        yield
    finally:
        ops.ssd_chunk = kernel


def train_kernels(cfg) -> set:
    """The kernels a training step of ``cfg`` launches: flash's training
    forward and backward for attention, the SSD scan and its backward for
    SSM layers."""
    attn = any(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    ssm = not all(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    return ((({"flash_attention_lse", "flash_attention_bwd"} if attn
              else set())
             | ({"ssd_chunk", "ssd_chunk_bwd"} if ssm else set())))


def loss_and_grads(torch, model, batch):
    """The model's loss and every gradient leaf, by path."""
    from repro_torch.tree import leaves_with_paths
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss = model.loss(batch["tokens"], batch["labels"],
                          {k: v for k, v in batch.items()
                           if k not in ("tokens", "labels")})
        loss.backward()
    grads = dict(leaves_with_paths(model.grad_tree()))
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def compare_grads(torch, got: dict, want: dict) -> dict:
    """Each leaf's error norm over the reference's norm, the largest
    first."""
    errs = {}
    for path, w in want.items():
        g = got[path].to(w.device).double()
        w = w.double()
        errs[path] = float((g - w).norm() / w.norm().clamp_min(1e-30))
    return dict(sorted(errs.items(), key=lambda kv: -kv[1]))


@contextlib.contextmanager
def widened(torch):
    """Every float32 cast point of the port widened to float64 (as the
    CPU parity tests widen it): a model built in float64 inside computes
    in float64 throughout. For CPU runs only."""
    cast, f32 = torch.Tensor.float, torch.float32
    torch.Tensor.float, torch.float32 = torch.Tensor.double, torch.float64
    try:
        yield
    finally:
        torch.Tensor.float, torch.float32 = cast, f32


def train_launches(where: str, cfg) -> dict:
    """After a training path on the card: the kernels of
    :func:`train_kernels` launched (flash's training forward and its
    backward, the SSD scan and its backward), the serving attention and
    no plain version did not. Returns the launches by kernel and by
    variant."""
    from repro_torch.kernels import ops
    c = ops.counts()
    launches = {k: n for k, n in c["launches"].items() if n}
    require(set(launches) == train_kernels(cfg),
            f"{where}: kernels launched {launches}")
    require(not any(ops.plain_calls.values()),
            f"{where}: a plain version ran on the card: {ops.plain_calls}")
    by_variant = {k: c["launches_by_variant"][k] for k in launches}
    return dict(launches=launches, launches_by_variant=by_variant)


def phase_train_reference(torch, args) -> dict:
    """Reduced qwen3-8b, moonshot-v1-16b-a3b, whisper-medium, mamba2-2.7b
    and jamba-v0.1-52b in f32: the loss and every gradient leaf on the card
    (the flash and SSD kernels and their backwards, simt) against the CPU
    (the plain versions), from the same weights and batch, each leaf
    within 1e-4 of its norm. jamba's float32 gradients are ill-conditioned
    (its MoE gates and the gated norm after each scan amplify rounding:
    on the CPU alone some leaves sit 3-5e-4 from the float64 gradient,
    and the card's cuBLAS products put its leaves as far from the CPU's
    with the plain versions as with the kernels), so jamba's card run is
    held instead against a witness, the same model on the card with the
    plain versions in place of the kernels: each leaf within 1e-4, and
    no farther from a float64 copy on the CPU than the witness by more
    than 1e-4. Returns the card runs' launches, summed."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, init_params
    from repro_torch.tree import tree_map

    total = {}
    for name in (TRAIN["model"], ZOO["moe"], CROSS["encdec"], SSM_MODEL,
                 ZOO["hybrid"]):
        cfg = dc.replace(get_config(name).reduced(), dtype=torch.float32)
        params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                             "cpu")
        rng = np.random.default_rng(args.seed + 11)
        toks = rng.integers(0, cfg.vocab, (2, 33))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.cross_attn is not None or cfg.encoder is not None:
            batch.update(cross_extras(cfg, 2, args.seed + 12))
        runs = {}
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, params, device=dev, trainable=True)
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            ops.reset_counts()
            runs[dev] = loss_and_grads(torch, model, b)
            if dev == "cuda":
                num = train_launches(f"train_reference {name}", cfg)
            del model
        errs = compare_grads(torch, runs["cuda"][1], runs["cpu"][1])
        worst = next(iter(errs.items()))
        loss_err = abs(runs["cuda"][0] - runs["cpu"][0])
        anchored = {}
        if name == ZOO["hybrid"]:
            with widened(torch):
                model = build_model(
                    dc.replace(cfg, dtype=torch.float64),
                    tree_map(lambda t: t.double(), params), device="cpu",
                    trainable=True)
                exact = loss_and_grads(torch, model, {
                    k: torch.as_tensor(v) for k, v in batch.items()})
                del model
            # the witness: the same f32 model on the card with the plain
            # versions in place of the kernels
            model = build_model(cfg, params, device="cuda", trainable=True)
            b = {k: torch.as_tensor(v, device="cuda")
                 for k, v in batch.items()}
            with plain_attention(), plain_scan():
                plain = loss_and_grads(torch, model, b)
            del model
            card = compare_grads(torch, runs["cuda"][1], exact[1])
            cpu = compare_grads(torch, runs["cpu"][1], exact[1])
            witness = compare_grads(torch, plain[1], exact[1])
            kernels = compare_grads(torch, runs["cuda"][1], plain[1])
            worst_kernels = next(iter(kernels.items()))
            over = {p: (e, witness[p]) for p, e in card.items()
                    if e > 1e-4 + witness[p]}
            # the kernels against the plain versions on the same card and
            # the same f32 ops around them: sums in other orders, about
            # 2e-5 of a leaf's norm measured; and no leaf farther from
            # float64 than the witness's by 1e-4. A wrong kernel gradient
            # gives its layers' leaves order one
            require(not over and worst_kernels[1] <= 1e-4
                    and loss_err <= 1e-4
                    and abs(runs["cuda"][0] - plain[0]) <= 1e-4,
                    f"train_reference {name}: loss {runs['cuda'][0]} "
                    f"against {runs['cpu'][0]} (cpu) and {plain[0]} "
                    f"(plain on the card); worst leaf against the plain "
                    f"versions on the card {worst_kernels}; leaves off the "
                    f"float64 gradient (card, witness): {over}")
            anchored = dict(
                float64_loss=exact[0], plain_card_loss=plain[0],
                card_vs_plain_card=dict(list(kernels.items())[:4]),
                card_vs_float64=dict(list(card.items())[:4]),
                plain_card_vs_float64=dict(list(witness.items())[:4]),
                cpu_vs_float64=dict(list(cpu.items())[:4]),
                plain_card_vs_cpu=dict(list(compare_grads(
                    torch, plain[1], runs["cpu"][1]).items())[:4]))
        else:
            # f32 on both: sums in other orders, about 1e-6 of a leaf's
            # norm; a wrong kernel gradient gives its layers' leaves order
            # one
            require(loss_err <= 1e-4 and worst[1] <= 1e-4,
                    f"train_reference {name}: loss {runs['cuda'][0]} "
                    f"against {runs['cpu'][0]}, worst leaf {worst}")
        for k, n in num["launches"].items():
            total[k] = total.get(k, 0) + n
        emit("train_reference", model=cfg.name, loss_card=runs["cuda"][0],
             loss_cpu=runs["cpu"][0], loss_abs_err=loss_err,
             leaves=len(errs), worst_leaf=worst[0],
             worst_leaf_rel_err=worst[1], **anchored, **num)
    return total


def synthetic_batch(torch, cfg, batch: int, seq: int, seed: int) -> dict:
    """``train_lm``'s synthetic data, ``batch`` rows of ``seq`` tokens."""
    from repro_torch.training.train_lm import synthetic_batch as draw
    return draw(seed, cfg.vocab, batch, seq + 1, "cuda")


def cyclic_batch(torch, cfg, batch: int, seq: int, period: int,
                 seed: int) -> dict:
    """``batch`` rows of ``seq`` tokens, each a cycle through the same
    ``period`` token ids (drawn from the vocabulary) from its own phase: a
    task a model can learn in a few tens of steps (its next token is a
    function of its token), whose loss starts near log(vocab)."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(cfg.vocab, period, replace=False)
    rows = [ids[(np.arange(seq + 1) + rng.integers(period)) % period]
            for _ in range(batch)]
    toks = torch.tensor(np.stack(rows), dtype=torch.int32, device="cuda")
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def train_flops(cfg, n_params: int, tokens: int, batch: int,
                seq: int) -> float:
    """Model flops of one training step: 6 x params x tokens, plus the
    attention's 3 x its forward (4 * hd per visible pair and head) in every
    attention layer."""
    from repro_torch.launch import roofline as rl
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    _, fwd = rl.flash_cost(seq, seq, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim_, True, 2)
    return 6 * n_params * tokens + 3 * fwd * batch * n_attn


def encdec_train_flops(cfg, enc_params: int, dec_params: int, batch: int,
                       seq: int) -> float:
    """Model flops of one encoder-decoder training step: 6 x parameters x
    the tokens each side runs (the encoder over its n_ctx frames, the
    decoder over ``seq`` tokens), plus 3 x the attention's forward in every
    encoder layer (frames x frames), decoder layer (causal) and cross layer
    (tokens x frames)."""
    from repro_torch.launch import roofline as rl
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    _, enc = rl.flash_cost(cfg.n_ctx, cfg.n_ctx, H, Hkv, hd, False, 2)
    _, self_ = rl.flash_cost(seq, seq, H, Hkv, hd, True, 2)
    _, cross = rl.flash_cost(seq, cfg.n_ctx, H, Hkv, hd, False, 2)
    attn = cfg.encoder.n_layers * enc + cfg.n_layers * (self_ + cross)
    return (6 * (enc_params * cfg.n_ctx + dec_params * seq) * batch
            + 3 * attn * batch)


def run_steps(torch, step_fn, params, opt, batch, steps, losses, times):
    """``steps`` train steps on one batch, each loss and wall time kept."""
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    return params, opt


def profile_train_step(torch, step_fn, params, opt, batch) -> dict:
    """Device time of one train step by kernel (torch.profiler): the flash
    backward's share and its milliseconds by device kernel, the training
    forward's share, the SSD scan's forward and backward shares and the
    backward's milliseconds by device kernel, and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", None)
            kernels.append(((ev.self_cuda_time_total if us is None else us)
                            / 1e3, ev.key, ev.count))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    bwd_by = {p: sum(ms for ms, name, _ in kernels if p in name)
              for p in BWD_NAMES}
    bwd = sum(bwd_by.values())
    fwd = sum(ms for ms, name, _ in kernels if "DenseKV" in name
              or "flash_attention_kernel" in name)
    ssd_bwd_by = {p: sum(ms for ms, name, _ in kernels
                         if f"repro_ssd_bwd::{p}" in name)
                  for p in SSD_BWD_NAMES}
    ssd_fwd = sum(ms for ms, name, _ in kernels if "repro_ssd::" in name)
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=1 - busy / wall_ms,
                flash_bwd_share=bwd / busy, flash_fwd_share=fwd / busy,
                ssd_bwd_share=sum(ssd_bwd_by.values()) / busy,
                ssd_fwd_share=ssd_fwd / busy,
                ssd_bwd_ms_by_kernel={p: ms for p, ms in ssd_bwd_by.items()
                                      if ms},
                flash_bwd_ms_by_kernel={p: ms for p, ms in bwd_by.items()
                                        if ms},
                top=[dict(kernel=name[:90], ms=ms, calls=n)
                     for ms, name, n in kernels[:8]])


def phase_train_main(torch, args) -> dict:
    """Full-width qwen3-8b in bf16. First the gradient check: at 2 layers,
    S = 4,096, the loss and every gradient leaf with the kernels against
    the same model with the plain attention on the card. Then the training
    run at ``TRAIN["layers"]`` of its 36 layers: 4 sequences of 4,096
    tokens in 2 microbatches, AdamW, on one fixed synthetic batch for
    ``TRAIN["steps"]`` steps under deterministic algorithms, a checkpoint
    after step ``TRAIN["ckpt_at"]``; the loss must fall below half its
    first value. Then the checkpoint restored into a fresh model and
    optimizer finishes the run: its losses and final parameters bitwise
    equal to the uninterrupted run's. Step time, tokens/s, MFU, peak
    memory, the checkpoint's bytes and seconds, and a profiled step.
    Returns the launches of the gradient check and of the training run."""
    from repro_torch.launch import roofline as rl
    import dataclasses as dc
    import shutil
    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.counter import tensor_bytes
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, adamw_init, make_train_step
    from repro_torch.tree import leaves, tree_map

    base_cfg = get_config(TRAIN["model"])
    # ---- gradient check: kernels against the plain attention
    cfg = dc.replace(base_cfg, n_layers=TRAIN["grad_layers"])
    model = build_model(cfg, device="cuda", seed=args.seed, trainable=True)
    batch = synthetic_batch(torch, cfg, TRAIN["grad_batch"], TRAIN["seq"],
                            args.seed)
    ops.reset_counts()
    loss_k, grads_k = loss_and_grads(torch, model, batch)
    grad_num = train_launches("train_main gradient check", cfg)
    with plain_attention():
        loss_p, grads_p = loss_and_grads(torch, model, batch)
    errs = compare_grads(torch, grads_k, grads_p)
    worst = next(iter(errs.items()))
    # bf16 gradients: P rounded at other places (the plain version rounds
    # p / l, the kernels P and dS) and sums in other orders, about 1e-2 of
    # a leaf's norm; an attention gradient gone wrong gives order one
    require(abs(loss_k - loss_p) <= 1e-2 and worst[1] <= 5e-2,
            f"train_main gradient check: loss {loss_k} against {loss_p}, "
            f"worst leaf {worst}")
    emit("train_main_gradient_check", model=cfg.name, n_layers=cfg.n_layers,
         batch=TRAIN["grad_batch"], seq=TRAIN["seq"], loss_kernels=loss_k,
         loss_plain=loss_p, leaves=len(errs), worst_leaf=worst[0],
         worst_leaf_rel_err=worst[1],
         rel_err_by_leaf=dict(list(errs.items())[:8]), **grad_num)
    del model, grads_k, grads_p, batch
    reset_peak(torch)

    # ---- the training run, then the resume from its checkpoint
    cfg = dc.replace(base_cfg, n_layers=TRAIN["layers"])
    opt_cfg = OptConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"])
    batch = cyclic_batch(torch, cfg, TRAIN["batch"], TRAIN["seq"],
                         TRAIN["period"], args.seed)
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    steps, at = TRAIN["steps"], TRAIN["ckpt_at"]
    torch.use_deterministic_algorithms(True)
    # every tensor the run allocates empty is written before it is read
    # (the kernels' outputs, the optimizer's temporaries): no NaN fill
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        t0 = time.perf_counter()
        model = build_model(cfg, device="cuda", seed=args.seed,
                            trainable=True)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        params = model.param_tree()
        opt = adamw_init(params)
        step_fn = make_train_step(model, opt_cfg, n_micro=TRAIN["n_micro"])
        losses, times = [], []
        ops.reset_counts()
        reset_peak(torch)
        params, opt = run_steps(torch, step_fn, params, opt, batch, at,
                                losses, times)
        # an asynchronous save: the host copy now, the write in a thread
        # while the run goes on
        t0 = time.perf_counter()
        writer = save(str(ckpt), (params, opt), step=at, extra={"step": at},
                      async_=True)
        snapshot_s = time.perf_counter() - t0
        params, opt = run_steps(torch, step_fn, params, opt, batch,
                                steps - at - 1, losses, times)
        # the last step alone, for the launch phase: its arguments and its
        # peak, with no checkpoint copy inside the window
        run_peak = torch.cuda.max_memory_allocated()
        arg_bytes = tensor_bytes((params, opt, batch))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params, opt = run_steps(torch, step_fn, params, opt, batch, 1,
                                losses, times)
        step_max = torch.cuda.max_memory_allocated()
        peak_gb = max(run_peak, step_max) / 1e9
        num = train_launches("train_main", cfg)
        per_step = TRAIN["n_micro"] * cfg.n_layers
        require(num["launches"] == {"flash_attention_lse": 2 * steps
                                    * per_step,
                                    "flash_attention_bwd": steps * per_step},
                f"train_main: launches {num['launches']}, not a training "
                f"forward, its recomputation and a backward per layer and "
                f"microbatch")
        require(num["launches_by_variant"] == {
            "flash_attention_lse": {"simt": 0, "wgmma": 2 * steps * per_step},
            "flash_attention_bwd": {"simt": 0, "wgmma": steps * per_step}},
            f"train_main: {num['launches_by_variant']}")
        final = [t.to("cpu", copy=True) for t in leaves(params)]
        like = tree_map(lambda t: torch.empty(
            (), dtype=t.dtype, device="cuda").expand(t.shape), (params, opt))
        prof = profile_train_step(torch, step_fn, params, opt, batch)
        del model, params, opt, step_fn
        reset_peak(torch)
        writer.join()
        save_s = time.perf_counter() - t0      # from the save to the publish
        ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*")
                         if f.is_file())

        # a fresh model and optimizer from the checkpoint finish the run
        t0 = time.perf_counter()
        (params, opt), extra = restore(str(ckpt), like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        model = build_model(cfg, params, device="cuda", trainable=True)
        params = model.param_tree()
        step_fn = make_train_step(model, opt_cfg, n_micro=TRAIN["n_micro"])
        resumed, resumed_times = [], []
        params, opt = run_steps(torch, step_fn, params, opt, batch,
                                steps - extra["step"], resumed,
                                resumed_times)
        same_losses = resumed == losses[at:]
        same_params = all(bool(torch.equal(t.cpu(), f))
                          for t, f in zip(leaves(params), final))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        shutil.rmtree(ckpt, ignore_errors=True)
    del model, params, opt, step_fn, final, like
    reset_peak(torch)
    require(losses[-1] < 0.5 * losses[0],
            f"train_main: losses {losses}: the last not below half the "
            f"first")
    require(same_losses and same_params,
            f"train_main: the resumed run differs: losses {resumed} against "
            f"{losses[at:]}, parameters equal {same_params}")
    tokens = TRAIN["batch"] * TRAIN["seq"]
    step_s = statistics.median(times[1:])
    flops = train_flops(cfg, n_params, tokens, TRAIN["batch"], TRAIN["seq"])
    # the launch phase's train shape: this step against the dry run's count
    # of it (the same n_micro, compression, dtypes and f32 sums)
    shape = dict(kind="train", global_batch=TRAIN["batch"],
                 seq_len=TRAIN["seq"])
    hold_launch("train", cfg, shape,
                dry_run(cfg, shape, opt_cfg=opt_cfg,
                        n_micro=TRAIN["n_micro"]),
                dict(argument_bytes=arg_bytes,
                     peak_bytes=arg_bytes + step_max - base,
                     max_memory_allocated=step_max, step_s=step_s,
                     step_s_all=times, profile_step=prof,
                     launches=num["launches"],
                     plain_calls={k: n for k, n in
                                  ops.counts()["plain_calls"].items()}),
                ("flash_attention_lse", "flash_attention_bwd"))
    emit("train_main", model=cfg.name, n_layers=cfg.n_layers,
         params=n_params, batch=TRAIN["batch"], n_micro=TRAIN["n_micro"],
         seq=TRAIN["seq"], steps=steps, lr=TRAIN["lr"],
         warmup_steps=TRAIN["warmup"], losses=losses,
         loss_first=losses[0], loss_last=losses[-1],
         model_build_s=build_s, first_step_s=times[0], step_s=step_s,
         step_s_all=times, tokens_per_s=tokens / step_s,
         model_tflops_per_step=flops / 1e12,
         mfu=flops / step_s / rl.H100.peak_flops, peak_gb=peak_gb,
         checkpoint_step=at, checkpoint_bytes=ckpt_bytes,
         checkpoint_snapshot_s=snapshot_s,
         checkpoint_published_after_s=save_s,
         checkpoint_restore_s=restore_s,
         resumed_steps=len(resumed), resumed_losses_bitwise=same_losses,
         resumed_params_bitwise=same_params,
         deterministic_algorithms=True, profile_step=prof, **num)
    return dict(grad_check=grad_num["launches"], main=num["launches"],
                main_variants=num["launches_by_variant"])


def lr_witness(torch, args, cfg, lr=None) -> dict:
    """``cfg`` (mamba2-2.7b at its published widths, at the gradient
    check's depth in the smoke or at ``--lr-witness-layers``) trained at
    train_main's lr and schedule on the cyclic batch,
    from the same weights, once with the SSD kernels and once with the
    plain scan on the card: each step's loss must agree within 5e-2 (the
    gradient check's bf16 rounding, carried through the steps). How far
    the loss falls at that lr is then the model's and the schedule's, not
    the kernels'. With ``lr`` (``--lr-witness-lr``) both train at that lr
    instead and are only printed: at a large lr the curves part once they
    stop falling monotonically. Returns both loss curves."""
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, adamw_init, make_train_step

    m = MAMBA_TRAIN
    batch = cyclic_batch(torch, cfg, m["batch"], m["seq"], m["period"],
                         args.seed)
    curves = {}
    for run in ("kernels", "plain"):
        model = build_model(cfg, device="cuda", seed=args.seed,
                            trainable=True)
        params = model.param_tree()
        opt = adamw_init(params)
        step_fn = make_train_step(
            model, OptConfig(lr=lr or TRAIN["lr"], warmup_steps=m["warmup"]),
            n_micro=m["n_micro"])
        losses, times = [], []
        with contextlib.ExitStack() as stack:
            if run == "plain":
                stack.enter_context(plain_scan())
            run_steps(torch, step_fn, params, opt, batch, m["steps"],
                      losses, times)
        curves[run] = dict(losses=losses, step_s=statistics.median(times))
        del model, params, opt, step_fn
        reset_peak(torch)
    gap = max(abs(a - b) for a, b in zip(curves["kernels"]["losses"],
                                         curves["plain"]["losses"]))
    emit("train_mamba2_lr_witness", model=cfg.name, n_layers=cfg.n_layers,
         lr=lr or TRAIN["lr"], steps=m["steps"], max_loss_gap=gap,
         **{f"{run}_{k}": v for run, c in curves.items()
            for k, v in c.items()},
         **{f"{run}_fall": 1 - c["losses"][-1] / c["losses"][0]
            for run, c in curves.items()})
    require(all(math.isfinite(x) for c in curves.values()
                for x in c["losses"]) and (lr is not None or gap <= 5e-2),
            f"train_mamba2 lr witness: the kernels' losses "
            f"{curves['kernels']['losses']} against the plain scan's "
            f"{curves['plain']['losses']}")
    return curves


def phase_train_mamba2(torch, args) -> dict:
    """mamba2-2.7b at its widths and 32 of its 64 layers (bf16, tied
    embeddings) in training. First the gradient check: at 2 layers and 4,096 tokens, the loss and
    every gradient leaf with the SSD kernels against the same model with
    the plain scan on the card. Then train_main's batch shape and
    schedule (4 sequences of 4,096 tokens in 2 microbatches, AdamW, the
    cyclic batch) under deterministic algorithms: the loss must fall below
    half its first value. Step time, tokens/s, MFU (6 x parameters x
    tokens plus 3 x the scans' forward flops), peak memory, a profiled
    step with the SSD backward's and forward's shares, launches by variant
    and the plain calls. Returns the launches of both runs."""
    from repro_torch.launch import roofline as rl
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, adamw_init, make_train_step

    m = MAMBA_TRAIN
    base = get_config(m["model"])
    # ---- gradient check: kernels against the plain scan
    cfg = dc.replace(base, n_layers=m["grad_layers"])
    model = build_model(cfg, device="cuda", seed=args.seed, trainable=True)
    batch = synthetic_batch(torch, cfg, m["grad_batch"], m["seq"], args.seed)
    ops.reset_counts()
    loss_k, grads_k = loss_and_grads(torch, model, batch)
    grad_num = train_launches("train_mamba2 gradient check", cfg)
    with plain_scan():
        loss_p, grads_p = loss_and_grads(torch, model, batch)
    errs = compare_grads(torch, grads_k, grads_p)
    worst = next(iter(errs.items()))
    # bf16: the forward kernel's operands rounded to bf16 for its tensor
    # core products (y within 1e-2 of its magnitude), the plain scan all
    # f32; about 1e-2 of a leaf's norm. A wrong scan gradient gives order
    # one in the SSM leaves
    require(abs(loss_k - loss_p) <= 1e-2 and worst[1] <= 5e-2,
            f"train_mamba2 gradient check: loss {loss_k} against {loss_p}, "
            f"worst leaf {worst}")
    emit("train_mamba2_gradient_check", model=cfg.name,
         n_layers=cfg.n_layers, batch=m["grad_batch"], seq=m["seq"],
         loss_kernels=loss_k, loss_plain=loss_p, leaves=len(errs),
         worst_leaf=worst[0], worst_leaf_rel_err=worst[1],
         rel_err_by_leaf=dict(list(errs.items())[:8]), **grad_num)
    del model, grads_k, grads_p, batch
    reset_peak(torch)
    lr_witness(torch, args, cfg)

    # ---- the training run
    cfg = dc.replace(base, n_layers=m["layers"])
    batch = cyclic_batch(torch, cfg, m["batch"], m["seq"], m["period"],
                         args.seed)
    torch.use_deterministic_algorithms(True)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        t0 = time.perf_counter()
        model = build_model(cfg, device="cuda", seed=args.seed,
                            trainable=True)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        params = model.param_tree()
        opt = adamw_init(params)
        step_fn = make_train_step(
            model, OptConfig(lr=m["lr"], warmup_steps=m["warmup"]),
            n_micro=m["n_micro"])
        losses, times = [], []
        ops.reset_counts()
        reset_peak(torch)
        params, opt = run_steps(torch, step_fn, params, opt, batch,
                                m["steps"], losses, times)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        num = train_launches("train_mamba2", cfg)
        per_step = m["n_micro"] * cfg.n_layers
        # the scan forward twice per layer and microbatch (the step's
        # forward and the per-layer recomputation), the backward once
        require(num["launches"] == {"ssd_chunk": 2 * m["steps"] * per_step,
                                    "ssd_chunk_bwd": m["steps"] * per_step},
                f"train_mamba2: launches {num['launches']}")
        require(num["launches_by_variant"]["ssd_chunk"]["wgmma"]
                == 2 * m["steps"] * per_step
                and num["launches_by_variant"]["ssd_chunk_bwd"]["wgmma"]
                == m["steps"] * per_step,
                f"train_mamba2: {num['launches_by_variant']}")
        plain = dict(ops.plain_calls)
        prof = profile_train_step(torch, step_fn, params, opt, batch)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    del model, params, opt, step_fn, batch
    reset_peak(torch)
    tokens = m["batch"] * m["seq"]
    step_s = statistics.median(times[1:])
    s = cfg.ssm
    _, scan_flops = rl.ssd_cost(m["seq"], s.n_heads(cfg.d_model),
                                s.head_dim, s.d_state, min(s.chunk, 64), 2)
    flops = (6 * n_params * tokens
             + 3 * scan_flops * m["batch"] * cfg.n_layers)
    emit("train_mamba2", model=cfg.name, n_layers=cfg.n_layers,
         params=n_params, batch=m["batch"], n_micro=m["n_micro"],
         seq=m["seq"], steps=m["steps"], lr=m["lr"],
         warmup_steps=m["warmup"], losses=losses, loss_first=losses[0],
         loss_last=losses[-1], model_build_s=build_s, first_step_s=times[0],
         step_s=step_s, step_s_all=times, tokens_per_s=tokens / step_s,
         model_tflops_per_step=flops / 1e12,
         mfu=flops / step_s / rl.H100.peak_flops, peak_gb=peak_gb,
         deterministic_algorithms=True, plain_calls=plain,
         profile_step=prof, **num)
    require(all(math.isfinite(x) for x in losses)
            and losses[-1] < 0.5 * losses[0],
            f"train_mamba2: losses {losses}: the last not below half the "
            f"first")
    return dict(grad_check=grad_num["launches"], main=num["launches"],
                main_variants=num["launches_by_variant"])


def phase_train_whisper(torch, args) -> dict:
    """whisper-medium whole (24 + 24 layers, bf16, 0.91 B parameters) on
    stub frames (1,500 x 1,024, drawn on the card) and 448-token decoder
    sequences: a few AdamW steps on one batch; the loss must fall. Every
    attention (encoder, decoder, cross) trains through the flash kernels.
    Step time, tokens/s, MFU, peak memory and a profiled step (the flash
    backward's share). Returns the launches."""
    from repro_torch.launch import roofline as rl
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, adamw_init, make_train_step
    from repro_torch.tree import leaves

    cfg = get_config(CROSS["encdec"])
    w = WHISPER_TRAIN
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=args.seed, trainable=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    enc_params = sum(t.numel() for t in leaves(model.param_tree()["encoder"]))
    batch = synthetic_batch(torch, cfg, w["batch"], w["seq"], args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    batch["frames"] = torch.randn((w["batch"], cfg.n_ctx, cfg.ctx_width),
                                  generator=gen, device="cuda").to(cfg.dtype)
    params = model.param_tree()
    opt = adamw_init(params)
    step_fn = make_train_step(model, OptConfig(lr=w["lr"],
                                               warmup_steps=w["warmup"]))
    losses, times = [], []
    ops.reset_counts()
    reset_peak(torch)
    params, opt = run_steps(torch, step_fn, params, opt, batch, w["steps"],
                            losses, times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    num = train_launches("train_whisper", cfg)
    n_attn = cfg.n_layers * 2 + cfg.encoder.n_layers   # self, cross, encoder
    require(num["launches"] == {"flash_attention_lse": 2 * w["steps"]
                                * n_attn,
                                "flash_attention_bwd": w["steps"] * n_attn},
            f"train_whisper: launches {num['launches']}")
    require(all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0],
            f"train_whisper: losses {losses} did not fall")
    prof = profile_train_step(torch, step_fn, params, opt, batch)
    del model, params, opt, step_fn, batch
    reset_peak(torch)
    step_s = statistics.median(times[1:])
    flops = encdec_train_flops(cfg, enc_params, n_params - enc_params,
                               w["batch"], w["seq"])
    emit("train_whisper", model=cfg.name, n_layers=cfg.n_layers,
         encoder_layers=cfg.encoder.n_layers, params=n_params,
         encoder_params=enc_params, batch=w["batch"], seq=w["seq"],
         frames=[cfg.n_ctx, cfg.ctx_width], steps=w["steps"], lr=w["lr"],
         losses=losses, model_build_s=build_s, step_s=step_s,
         step_s_all=times, tokens_per_s=w["batch"] * w["seq"] / step_s,
         model_tflops_per_step=flops / 1e12,
         mfu=flops / step_s / rl.H100.peak_flops, peak_gb=peak_gb,
         profile_step=prof, **num)
    return num["launches"]


def train_phases(torch, args, mark):
    """The training phases. Returns the flash and SSD backwards' checks by
    label, the training paths' launches, and train_main's and
    train_mamba2's launches by variant."""
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 7)
    with torch.enable_grad():
        checks = phase_kernels_train(torch, gen)
        ssd_checks = check_ssd_bwd(torch, gen)
        mark("kernels_train")
        paths = {"train_reference": phase_train_reference(torch, args)}
        mark("train_reference")
        main = phase_train_main(torch, args)
        paths["train_main_gradient_check"] = main["grad_check"]
        paths["train_main"] = main["main"]
        mark("train_main")
        paths["train_whisper"] = phase_train_whisper(torch, args)
        mark("train_whisper")
        mamba = phase_train_mamba2(torch, args)
        paths["train_mamba2_gradient_check"] = mamba["grad_check"]
        paths["train_mamba2"] = mamba["main"]
        mark("train_mamba2")
    return (checks, ssd_checks, paths,
            {**main["main_variants"], **mamba["main_variants"]})


# the mesh phase: two ranks on the one card over gloo, one spawn per mesh
# (for the mesh_train jobs too); full widths, cut in depth (MESH_LAYERS);
# prefills of 2 x S then decode steps (4 under tensor parallelism; 1 under
# ZeRO-3, whose every step all-gathers every weight through the host):
# qwen3-8b and mamba2-2.7b (bf16) of 2 x 1,024; moonshot (f32, capacity
# factor E / K: dropless) of 2 x 512; jamba (f32, dropless) of 2 x 512;
# whisper-medium (bf16, 1,500 frames) of 2 x 256; llama-3.2-vision-11b
# (bf16, 1,601 patch rows) of 2 x 1,024. Then the reference's other
# sharding modes: qwen3-8b in tp_sp_opt (a sequence-parallel prefill) and
# fsdp_cp (a context-parallel prefill and weight-stationary decode steps
# over the sequence-split cache) on both meshes, 4 decode steps on 1 x 2 and
# 1 on 2 x 1 (ZeRO-3's steps through the host), and moonshot in fsdp_cp on
# 1 x 2. A case: (label, model, S, steps, mode)
MESH = dict(batch=2, meshes={
    (1, 2): (("qwen_1x2", MAIN["model"], 1024, 4, "tp_sp"),
             ("moe_1x2", "moonshot-v1-16b-a3b", 512, 4, "tp_sp"),
             ("mamba2_1x2", SSM_MODEL, 1024, 4, "tp_sp"),
             ("jamba_1x2", "jamba-v0.1-52b", 512, 4, "tp_sp"),
             ("whisper_1x2", "whisper-medium", 256, 4, "tp_sp"),
             ("vlm_1x2", "llama-3.2-vision-11b", 1024, 4, "tp_sp"),
             ("qwen_opt_1x2", MAIN["model"], 1024, 4, "tp_sp_opt"),
             ("qwen_cp_1x2", MAIN["model"], 1024, 4, "fsdp_cp"),
             ("moe_cp_1x2", "moonshot-v1-16b-a3b", 512, 4, "fsdp_cp")),
    (2, 1): (("qwen_2x1", MAIN["model"], 1024, 1, "tp_sp"),
             ("mamba2_2x1", SSM_MODEL, 1024, 1, "tp_sp"),
             ("qwen_opt_2x1", MAIN["model"], 1024, 1, "tp_sp_opt"),
             ("qwen_cp_2x1", MAIN["model"], 1024, 1, "fsdp_cp"))})
# each model's layers in the mesh phase: 2 of qwen3-8b's 36, moonshot's 48
# and mamba2's 64; one period of jamba (8 of 32: 7 SSM, 1 attention, 4
# MoE) and of vision (5 of 40, the cross layer 3); 2 of whisper's 24
# decoder and 2 of its 24 encoder layers
MESH_LAYERS = {MAIN["model"]: 2, "moonshot-v1-16b-a3b": 2, SSM_MODEL: 2,
               "jamba-v0.1-52b": 8, "llama-3.2-vision-11b": 5,
               "whisper-medium": 2}


def mesh_config(torch, name: str, dtype=None):
    """``name`` at its widths and ``MESH_LAYERS[name]`` layers (an
    encoder's too), in ``dtype`` (a ``torch`` dtype's name) where given;
    a MoE in f32 (routing must not flip on bf16 reduction order) and
    dropless (``spmd.dropless``: capacity factor E / K)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import spmd
    n = MESH_LAYERS[name]
    cfg = dataclasses.replace(get_config(name), n_layers=n)
    if cfg.encoder is not None:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, n_layers=n))
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype))
    if cfg.moe is None:
        return cfg
    return spmd.dropless(dataclasses.replace(cfg, dtype=torch.float32))


def mesh_kernels(cfg, train: bool) -> tuple:
    """The hand kernels a mesh job of ``cfg`` launches on every rank:
    serving, flash (the prefills) and paged attention (the decode steps)
    for attention layers and the SSD scan for SSM layers; training, flash's
    training forward and its backward, the SSD scan and its backward."""
    attn, ssm = cfg.family != "ssm", cfg.ssm is not None
    if train:
        return ((("flash_attention_lse", "flash_attention_bwd") if attn
                 else ()) + (("ssd_chunk", "ssd_chunk_bwd") if ssm else ()))
    return ((("flash_attention", "paged_attention") if attn else ())
            + (("ssd_chunk",) if ssm else ()))


def mesh_kernel_shapes(torch) -> dict:
    """The shapes at which each rank of the mesh phase's 1 x 2 serving
    jobs (``MESH``) launches the hand kernels, each config's heads halved,
    by kernel and label: flash (B, Sq, Sk, H, Hkv, hd, causal, dtype,
    q_offset) for the causal self prefill, the encoder, the cross prefill
    and the cross decode (Sq 1); paged (B, sequence lengths, rows, H, Hkv,
    hd, dtype, with the log-sum-exp) for the decode steps; the SSD scan
    (B, S, H, P, N, chunk, dtype). An ``fsdp_cp`` job's ranks attend with
    every head: flash over their S/2 query rows against all S keys at
    ``q_offset`` 0 and S/2, paged over their half of the cache's rows with
    the log-sum-exp (rank 0's rows all visible; rank 1's up to the last
    step, and a lane of length 0, a rank holding none of its rows)."""
    tp = 2
    out = {"flash_attention": {}, "paged_attention": {}, "ssd_chunk": {}}
    for label, name, S, steps, mode in MESH["meshes"][(1, tp)]:
        cfg = mesh_config(torch, name)
        B, dt = MESH["batch"], cfg.dtype
        if mode == "fsdp_cp":
            heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_)
            s = S // tp
            for r in range(tp):
                out["flash_attention"][f"{label} rank {r} rows {s}"] = (
                    B, s, S, *heads, True, dt, r * s)
            rows = -(-(S + steps) // (16 * tp)) * 16
            out["paged_attention"][f"{label} rank 0 decode {rows}"] = (
                B, [rows] * B, rows, *heads, dt, True)
            out["paged_attention"][f"{label} rank 1 decode {rows}"] = (
                B, [0, S + steps - rows], rows, *heads, dt, True)
            continue
        if mode != "tp_sp":     # tp_sp_opt's kernels run tp_sp's shapes
            continue
        if cfg.family != "ssm":
            heads = (cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim_)
            out["flash_attention"][f"{label} self {S}"] = (
                B, S, S, *heads, True, dt, 0)
            out["paged_attention"][f"{label} decode {S + steps}"] = (
                B, [S + steps] * B, S + steps, *heads, dt, False)
            if cfg.encoder is not None:
                out["flash_attention"][f"{label} encoder {cfg.n_ctx}"] = (
                    B, cfg.n_ctx, cfg.n_ctx, *heads, False, dt, 0)
            if cfg.n_ctx:
                out["flash_attention"][f"{label} cross {S}x{cfg.n_ctx}"] = (
                    B, S, cfg.n_ctx, *heads, False, dt, 0)
                out["flash_attention"][f"{label} cross decode {cfg.n_ctx}"] = (
                    B, 1, cfg.n_ctx, *heads, False, dt, 0)
        if cfg.ssm is not None:
            s = cfg.ssm
            out["ssd_chunk"][f"{label} {S}"] = (
                B, S, s.n_heads(cfg.d_model) // tp, s.head_dim, s.d_state,
                s.chunk, dt)
    return out


def check_mesh_kernels(torch, gen) -> dict:
    """Flash, paged decode and the SSD scan against their plain versions
    (``ref.blockwise_attention``, ``ref.paged_attention_ref``,
    ``ref.ssd_chunk_scan``, f32 on the same values) at each rank shape of
    :func:`mesh_kernel_shapes`, under the full-head checks' limits: bf16
    attention within 2e-2 absolute and of a row's magnitude, f32 within
    1e-5; the SSD scan's y within 1e-2 of its magnitude and of each head's
    in bf16 (1e-4 in f32), its state within 1e-4. Flash at its
    ``q_offset``; paged with the log-sum-exp where the shape asks: within
    1e-4 of the plain version's, a lane of length 0 an output of 0 and a
    log-sum-exp of -inf exactly. The ``fsdp_cp`` shapes (an offset or the
    log-sum-exp) are timed as well: the kernel (with and without the
    device spin, and its host time), its plain version, its bound from its
    cost and, for flash, SDPA with the offset's causal mask. Returns the
    errors, variants and times by kernel and label."""
    import torch.nn.functional as F
    from repro_torch.launch import roofline as rl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as ssd

    shapes = mesh_kernel_shapes(torch)
    out = {k: {} for k in shapes}
    # the card's peak for the products' type: the tensor cores' dense bf16
    # rate, or f32 outside them (the simt variants), H100 SXM data sheet
    peak = lambda dt: (rl.H100.peak_flops if dt == torch.bfloat16
                       else 67e12)

    def held(name, label, err, row_err, dt):
        if dt == torch.float32:
            require(err <= 1e-5, f"{name} at the mesh's {label} (f32): "
                    f"max_abs_err {err}")
        else:
            require(err <= 2e-2 and row_err <= 2e-2,
                    f"{name} at the mesh's {label}: max_abs_err {err}, "
                    f"row-scaled {row_err}")

    for label, (B, Sq, Sk, H, Hkv, hd, causal, dt, off) in \
            shapes["flash_attention"].items():
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for shape in ((B, Sq, H, hd), (B, Sk, Hkv, hd),
                                 (B, Sk, Hkv, hd)))
        err, row_err = chunk_errors(
            fa.flash_attention(q, k, v, causal=causal, q_offset=off),
            ref.blockwise_attention(q.float(), k.float(), v.float(), causal,
                                    off))
        held("flash_attention", label, err, row_err, dt)
        out["flash_attention"][label] = dict(
            max_abs_err=err, row_scaled_err=row_err,
            variant=fa.variant(dt, hd), shape=[B, Sq, Sk, H, Hkv, hd],
            causal=causal, q_offset=off, dtype=str(dt))
        if " rank " in label:                  # an fsdp_cp rank's shape
            n_bytes, n_flops = rl.flash_cost(Sq, Sk, H, Hkv, hd, causal,
                                             q.element_size(), off)
            b_ms, b_by = rl.bound(B * n_bytes, B * n_flops, peak(dt))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            mask = (torch.arange(Sq, device="cuda")[:, None] + off
                    >= torch.arange(Sk, device="cuda")[None])
            out["flash_attention"][label].update(
                **kernel_times(lambda: fa.flash_attention(
                    q, k, v, causal=True, q_offset=off)),
                plain_ms=time_ms(lambda: ref.blockwise_attention(
                    q, k, v, True, off), reps=5),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)))
        del q, k, v
    page = 16
    for label, (B, lens, n, H, Hkv, hd, dt, lse) in \
            shapes["paged_attention"].items():
        W = -(-n // page)
        q, kp, vp, bt, sl = paged_inputs(torch, gen, lens, H, Hkv, hd,
                                         page, W, B * W + 1, dt)
        got = pa.paged_attention(q, kp, vp, bt, sl, return_lse=lse)
        want = ref.paged_attention_ref(q.float(), kp.float(), vp.float(), bt,
                                       sl, return_lse=lse)
        rec = dict(shape=[B, n, H, Hkv, hd], lens=lens, dtype=str(dt))
        if lse:
            (got, got_lse), (want, want_lse) = got, want
            empty = sl == 0
            live = ~empty[:, None]
            rec["lse_max_abs_err"] = float(
                (got_lse - want_lse).abs()[live.expand_as(got_lse)].max())
            require(rec["lse_max_abs_err"] <= 1e-4
                    and bool(torch.isneginf(got_lse[empty]).all())
                    and bool((got[empty] == 0).all()),
                    f"paged_attention's log-sum-exp at the mesh's {label}: "
                    f"{rec}")
            got, want = got[~empty], want[~empty]
        err, row_err = chunk_errors(got, want)
        held("paged_attention", label, err, row_err, dt)
        if lse:
            n_bytes, n_flops = rl.paged_cost(lens, H, Hkv, hd, W,
                                             q.element_size(), lse=True)
            b_ms, b_by = rl.bound(n_bytes, n_flops, peak(dt))
            rec.update(
                **kernel_times(lambda: pa.paged_attention(
                    q, kp, vp, bt, sl, return_lse=True)),
                plain_ms=time_ms(lambda: ref.paged_attention_ref(
                    q, kp, vp, bt, sl, return_lse=True), reps=5),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
        out["paged_attention"][label] = dict(max_abs_err=err,
                                             row_scaled_err=row_err, **rec)
        del q, kp, vp
    for label, (B, S, H, P, N, chunk, dt) in shapes["ssd_chunk"].items():
        args = ssd_inputs(torch, gen, S, H, P, N, dt, B=B)
        y, st = ssd.ssd_chunk(*args, chunk)
        y_ref, st_ref = ref.ssd_chunk_scan(*args, chunk)
        errs = dict(y_scaled_err=scaled_err(y, y_ref),
                    y_head_scaled_err=head_scaled_err(y, y_ref),
                    state_scaled_err=scaled_err(st, st_ref))
        lim = 1e-4 if dt == torch.float32 else 1e-2
        require(errs["state_scaled_err"] <= 1e-4
                and errs["y_scaled_err"] <= lim
                and errs["y_head_scaled_err"] <= lim,
                f"ssd_chunk at the mesh's {label}: {errs}")
        out["ssd_chunk"][label] = dict(
            **errs, variant=ssd.variant(dt, N, P, chunk),
            shape=[B, S, H, P, N], dtype=str(dt))
        del args, y, st, y_ref, st_ref
    out["flash_attention_bwd"] = check_mesh_bwd(torch, gen, peak)
    for name, by in out.items():
        for label, rec in by.items():
            emit("kernel_check_mesh", name=name, case=label, **rec)
    return out


# the flash backward at the query offsets of the sequence-split modes'
# training, qwen3-8b's heads (32/8, hd 128), B 2, in bf16 (wgmma) and f32
# (simt): (Sq, Sk, q_offset) by label. An fsdp_cp 1 x 2 rank's 512 query
# rows over 1,024 keys (rank 0, rank 1), and rank 3 of a model axis of 8
# over 1,000 tokens: 125 rows at offset 375, a diagonal that cuts the
# 64-row tiles of the wgmma variant
MESH_BWD = {"qwen_cp_1x2 rank 0 rows 512": (512, 1024, 0),
            "qwen_cp_1x2 rank 1 rows 512": (512, 1024, 512),
            "tp 8 rank 3 rows 125 of 1000": (125, 1000, 375)}


def check_mesh_bwd(torch, gen, peak) -> dict:
    """The flash training forward and backward with ``q_offset`` at each
    ``MESH_BWD`` shape, in bf16 and f32, against their plain versions
    (``ref.flash_attention_lse`` and ``ref.flash_attention_bwd_ref`` at
    the offset, f32 on the same values, the plain backward from the
    kernel's o and lse) under ``phase_kernels_train``'s limits: lse within
    1e-4, the output and dq, dk, dv by their largest and row-scaled
    errors, two backward runs bitwise equal, the ``wgmma`` variant in bf16
    and ``simt`` in f32. Each is timed: the backward (with and without
    the device spin, and its host time), its plain version, its bound
    (``bwd_cost`` at the offset; ``peak`` the products' rate by dtype),
    SDPA's backward with the offset's boolean mask, and forward +
    backward beside SDPA's forward + backward with that mask. Returns the
    numbers by label."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline as rl
    cfg = get_config(MAIN["model"])
    B, H, Hkv, hd = 2, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    out = {}
    for (label, (Sq, Sk, off)), dt in ((c, dt) for c in MESH_BWD.items()
                                       for dt in (torch.bfloat16,
                                                  torch.float32)):
        q, dout = (torch.randn((B, Sq, H, hd), generator=gen,
                               device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((B, Sk, Hkv, hd), generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        o, lse = fa.flash_attention_fwd(q, k, v, True, off)
        o_ref, lse_ref = ref.flash_attention_lse(q.float(), k.float(),
                                                 v.float(), True, off)
        lse_err = float((lse - lse_ref).abs().max())
        o_err = chunk_errors(o, o_ref)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, dout, True, off)
        again = fa.flash_attention_bwd(q, k, v, o, lse, dout, True, off)
        deterministic = all(bool(torch.equal(a, b))
                            for a, b in zip(grads, again))
        want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                           o.float(), lse, dout.float(),
                                           True, off)
        errs = {n: grad_errors(g, w)
                for n, g, w in zip(("dq", "dk", "dv"), grads, want)}
        del again, want, o_ref, lse_ref
        bf16 = dt == torch.bfloat16
        variant = fa.bwd_variant(dt, hd)
        case = f"{label} {str(dt).split('.')[-1]}"
        require(deterministic, f"flash_attention_bwd at the mesh's {case}: "
                f"two runs differ")
        require(variant == ("wgmma" if bf16 else "simt"),
                f"flash_attention_bwd at the mesh's {case}: the {variant} "
                f"variant")
        lim_abs, lim_row = (5e-2, 3e-2) if bf16 else (1e-4, 1e-4)
        require(lse_err <= 1e-4 and o_err[0] <= lim_abs
                and o_err[1] <= lim_row, f"flash_attention_fwd at the "
                f"mesh's {case}: lse error {lse_err}, output {o_err}")
        for n, (e_abs, e_row) in errs.items():
            require(e_abs <= lim_abs and e_row <= lim_row,
                    f"flash_attention_bwd at the mesh's {case}: {n} error "
                    f"{e_abs}, row-scaled {e_row}")
        n_bytes, n_flops = rl.bwd_cost(B, Sq, Sk, H, Hkv, hd, True,
                                       q.element_size(), off)
        b_ms, b_by = rl.bound(n_bytes, n_flops, peak(dt))
        f_bytes, f_flops = rl.flash_cost(Sq, Sk, H, Hkv, hd, True,
                                         q.element_size(), off)
        fb_ms, fb_by = rl.bound(n_bytes + B * f_bytes,
                                n_flops + B * f_flops, peak(dt))
        mask = (torch.arange(Sq, device="cuda")[:, None] + off
                >= torch.arange(Sk, device="cuda")[None])
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        dt_ = dout.transpose(1, 2)
        with torch.enable_grad():
            o_sdpa = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)

        def sdpa_bwd():
            torch.autograd.grad(o_sdpa, (qt, kt, vt), dt_, retain_graph=True)

        def sdpa_fwd_bwd():
            with torch.enable_grad():
                oo = F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
                torch.autograd.grad(oo, (qt, kt, vt), dt_)

        def fwd_bwd():
            oo, ll = fa.flash_attention_fwd(q, k, v, True, off)
            fa.flash_attention_bwd(q, k, v, oo, ll, dout, True, off)

        row = dict(shape=dict(B=B, Sq=Sq, Sk=Sk, H=H, Hkv=Hkv, hd=hd,
                              causal=True, dtype=str(dt)),
                   q_offset=off, variant=variant,
                   deterministic=deterministic, lse_max_abs_err=lse_err,
                   fwd_max_abs_err=o_err[0], fwd_row_scaled_err=o_err[1],
                   max_abs_err=max(e[0] for e in errs.values()),
                   row_scaled_err=max(e[1] for e in errs.values()),
                   errors={n: dict(max_abs=e[0], row_scaled=e[1])
                           for n, e in errs.items()},
                   **kernel_times(lambda: fa.flash_attention_bwd(
                       q, k, v, o, lse, dout, True, off)),
                   plain_ms=time_ms(lambda: ref.flash_attention_bwd_ref(
                       q, k, v, o, lse, dout, True, off), reps=5),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=time_ms(sdpa_bwd),
                   fwd_bwd_ms=time_ms(fwd_bwd), fwd_bwd_bound_ms=fb_ms,
                   fwd_bwd_bound_by=fb_by,
                   library_fwd_bwd_ms=time_ms(sdpa_fwd_bwd))
        out[case] = row
        del q, k, v, o, lse, dout, grads, o_sdpa, qt, kt, vt, mask
    return out


def mesh_jobs(torch, args) -> dict:
    """By mesh shape, the ``spmd.Job`` of each ``MESH`` case, the
    ``spmd.TrainJob`` of each ``MESH_TRAIN`` case (their tokens and frames
    or patch embeddings drawn from the seed), then the ``spmd.CellJob`` of
    each ``MESH_DRYRUN`` case."""
    from repro_torch.launch import spmd
    from repro_torch.training.optimizer import OptConfig
    gen = torch.Generator().manual_seed(args.seed + 25)
    gen_train = torch.Generator().manual_seed(args.seed + 26)
    gen_extras = torch.Generator().manual_seed(args.seed + 27)
    # the sequence-split modes' train jobs draw from a stream of their own,
    # so that the tp_sp jobs' tokens do not move with them
    gen_modes = torch.Generator().manual_seed(args.seed + 30)
    opt = OptConfig(lr=spmd.TRAIN_LR, warmup_steps=1)
    out = {}
    for shape, cases in MESH["meshes"].items():
        jobs = out[shape] = []
        for _, name, S, steps, mode in cases:
            cfg = mesh_config(torch, name)
            jobs.append(spmd.Job(cfg, torch.randint(
                0, cfg.vocab, (MESH["batch"], S), generator=gen,
                dtype=torch.int32), steps, seed=args.seed,
                extras=spmd.modality_extras(cfg, MESH["batch"], gen_extras),
                mode=mode))
        for _, name, S, dtype, steps, mode in MESH_TRAIN["meshes"][shape]:
            cfg = mesh_config(torch, name, dtype)
            jobs.append(spmd.TrainJob(cfg, torch.randint(
                0, cfg.vocab, (MESH_TRAIN["batch"], S),
                generator=gen_train if mode == "tp_sp" else gen_modes,
                dtype=torch.int32), steps, opt=opt, seed=args.seed,
                extras=spmd.modality_extras(cfg, MESH_TRAIN["batch"],
                                            gen_extras), mode=mode))
        for _, name, dtype, mode, kinds in MESH_DRYRUN["meshes"].get(shape,
                                                                      ()):
            jobs.append(spmd.CellJob(mesh_config(torch, name, dtype),
                                     dryrun_shapes(kinds), seed=args.seed,
                                     mode=mode))
    return out


# the mesh_dryrun lines: build_cell's step of each case at each shape on
# every rank of the mesh phase's spawns (a spmd.CellJob after the mesh's
# train jobs), held to the dry run's count of that rank's step in a fake
# world of the same mesh. A case: (label, model, dtype, sharding mode, the
# shapes it runs); the sequence-split modes' train cells run on 1 x 2,
# where model splits the sequence
MESH_DRYRUN = dict(
    shapes={"prefill": dict(kind="prefill", global_batch=2, seq_len=512),
            "train": dict(kind="train", global_batch=2, seq_len=512),
            "decode": dict(kind="decode", global_batch=2, seq_len=512)},
    meshes={(1, 2): (("qwen_1x2", MAIN["model"], "bfloat16", "tp_sp",
                      ("prefill", "train")),
                     ("moe_1x2", "moonshot-v1-16b-a3b", "float32", "tp_sp",
                      ("prefill", "train")),
                     ("qwen_opt_1x2", MAIN["model"], "bfloat16",
                      "tp_sp_opt", ("prefill", "decode", "train")),
                     ("qwen_cp_1x2", MAIN["model"], "bfloat16", "fsdp_cp",
                      ("prefill", "decode", "train"))),
            (2, 1): (("qwen_2x1", MAIN["model"], "bfloat16", "tp_sp",
                      ("prefill", "train")),
                     ("qwen_cp_2x1", MAIN["model"], "bfloat16", "fsdp_cp",
                      ("prefill", "decode")))})


def dryrun_shapes(kinds) -> dict:
    """The ``MESH_DRYRUN`` shapes of ``kinds``, by kind."""
    return {k: MESH_DRYRUN["shapes"][k] for k in kinds}


def mesh_dryrun_counts(torch) -> dict:
    """By mesh shape and case, each rank's dry-run record of each
    ``MESH_DRYRUN`` shape: its step counted on ``meta`` in a world of the
    ``fake`` backend of that mesh (``dryrun.run_cell`` with the mesh's
    shape and the rank), in this process, which no world holds; and under
    ``"seconds"`` the time the counts took."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    out = {}
    for shape, cases in MESH_DRYRUN["meshes"].items():
        for label, name, dtype, mode, kinds in cases:
            cfg = mesh_config(torch, name, dtype)
            out[(shape, label)] = [
                {k: dryrun.run_cell(name, sh, shape, cfg=cfg, rank=r,
                                    mode=mode)
                 for k, sh in dryrun_shapes(kinds).items()}
                for r in range(math.prod(shape))]
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_dryrun(case, res, predicted, shape, smi) -> None:
    """One ``MESH_DRYRUN`` case (a ``mesh_dryrun`` line per rank and
    shape): the rank's step on the card against the dry run's count of
    that rank: argument bytes and the collectives' calls and bytes by kind
    and axis (``dryrun.collective_record`` of the rank's
    ``collectives.stats()``) equal, the peak within ``LAUNCH``'s window."""
    from repro_torch.launch import dryrun
    label, name, dtype, mode, _ = case
    lo, hi = LAUNCH["peak_window"]
    for r in res["records"]:
        require(not r["foreign"], f"mesh_dryrun {label}: rank {r['rank']} "
                f"loaded {r['foreign']}")
        for k, meas in r["cells"].items():
            rec = predicted[(shape, label)][r["rank"]][k]
            require(rec["status"] == "ok", f"mesh_dryrun {label} {k}: {rec}")
            mem = rec["memory"]
            _, by_axis = dryrun.collective_record(meas["collectives"],
                                                  rec["collective_lines"])
            pick = lambda b: {a: {kind: [d["count"], d["bytes"]]
                                  for kind, d in kinds.items()}
                              for a, kinds in b.items()}
            ratio = mem["peak_bytes_per_device"] / meas["peak_bytes"]
            emit("mesh_dryrun", case=label, model=name, dtype=dtype,
                 mode=mode, layers=MESH_LAYERS[name], mesh=list(shape),
                 rank=r["rank"], cell=k, **MESH_DRYRUN["shapes"][k],
                 predicted_argument_bytes=mem["argument_bytes"],
                 measured_argument_bytes=meas["argument_bytes"],
                 predicted_peak_bytes=mem["peak_bytes_per_device"],
                 measured_peak_bytes=meas["peak_bytes"],
                 predicted_over_measured_peak=ratio,
                 predicted_collectives=pick(rec["collectives_by_axis"]),
                 measured_collectives=pick(by_axis),
                 predicted_collective_s=rec["roofline"]["collective_s"],
                 launches=meas["launches"], count_s=rec["count_s"],
                 counts_s=predicted["seconds"], rank_job_s=r["seconds"],
                 nvidia_smi=smi)
            require(mem["argument_bytes"] == meas["argument_bytes"],
                    f"mesh_dryrun {label} {k} rank {r['rank']}: argument "
                    f"bytes {mem['argument_bytes']} predicted, "
                    f"{meas['argument_bytes']} on the card")
            require(pick(rec["collectives_by_axis"]) == pick(by_axis),
                    f"mesh_dryrun {label} {k} rank {r['rank']}: collectives "
                    f"{pick(rec['collectives_by_axis'])} predicted, "
                    f"{pick(by_axis)} on the card")
            require(lo <= ratio <= hi,
                    f"mesh_dryrun {label} {k} rank {r['rank']}: predicted "
                    f"peak {mem['peak_bytes_per_device']} is {ratio:.3f} x "
                    f"the measured {meas['peak_bytes']}")


def phase_mesh(torch, args) -> dict:
    """The hand kernels at the 1 x 2 ranks' shapes against their plain
    versions (:func:`check_mesh_kernels`), then the model across a (data,
    model) mesh of two ranks sharing the card
    over gloo (``repro_torch.launch.spmd``), one spawn per mesh for the
    serving jobs (``MESH``) and the training jobs (``MESH_TRAIN``) alike.
    Serving: qwen3-8b and mamba2-2.7b with tensor parallelism (1 x 2) and
    with ZeRO-3 (2 x 1), moonshot with expert parallelism (1 x 2), jamba,
    whisper-medium and llama-3.2-vision-11b with tensor and expert
    parallelism (1 x 2), each held against the same model in this process
    fed the ranks' tokens (:func:`mesh_serving`). Training, the
    ``mesh_train`` lines: the same meshes' AdamW steps, and qwen3-8b's and
    moonshot's in the sequence-split modes, held against the same steps
    in one process with no mesh, run and checked in rank 0's process
    (``spmd.train_checked``: the blocks reach it over gloo, so no job's
    weights or gradients go through a file) (:func:`mesh_training`). The
    ``mesh_dryrun`` lines: ``build_cell``'s steps on each rank against the
    dry run's count of that rank, made here before the spawns
    (:func:`mesh_dryrun`). No ``jax`` or ``repro`` module may load in any
    rank. The times are of a gloo run,
    which stages every collective through the host: they show no
    collective speed. The sharding modes' jobs (a ``MESH`` case's mode,
    ``tp_sp_opt`` or ``fsdp_cp``) are held as ``tp_sp``'s are. Returns
    each rank's launches by path, and the kernels' checks at the ranks'
    shapes (:func:`check_mesh_kernels`)."""
    from repro_torch.launch import spmd

    kernel_checks = check_mesh_kernels(
        torch, torch.Generator(device="cuda").manual_seed(args.seed + 28))
    reset_peak(torch)
    smi = nvidia_smi()
    card = torch.cuda.get_device_properties(0).total_memory
    predicted = mesh_dryrun_counts(torch)
    paths = {}
    for shape, jobs in mesh_jobs(torch, args).items():
        cases, train_cases = MESH["meshes"][shape], MESH_TRAIN["meshes"][shape]
        cell_cases = MESH_DRYRUN["meshes"].get(shape, ())
        reset_peak(torch)
        t0 = time.perf_counter()
        backend, results = spmd.run(jobs, shape, device="cuda")
        seconds = time.perf_counter() - t0
        require(backend == "gloo", f"mesh {shape}: backend {backend} for "
                f"two ranks on one card")
        n = len(cases)
        for case, job, res in zip(cases, jobs[:n], results[:n]):
            mesh_serving(case, job, res, shape, backend, seconds, smi, card,
                         paths)
        m = n + len(train_cases)
        for case, job, res in zip(train_cases, jobs[n:m], results[n:m]):
            mesh_training(case, job, res, shape, backend, seconds, smi, card,
                          paths)
        for case, res in zip(cell_cases, results[m:]):
            mesh_dryrun(case, res, predicted, shape, smi)
        del results
        reset_peak(torch)
    return paths, kernel_checks


def mesh_memory(res, card: int) -> dict:
    """Each rank's peak device memory (the ranks run together, the one
    process after them), the one process's, and the card's, in GB."""
    ranks = [r["peak_bytes"] for r in res["records"]]
    return dict(ranks_peak_gb=[b / 1e9 for b in ranks],
                ranks_peak_sum_gb=sum(ranks) / 1e9,
                one_process_peak_gb=res["single"]["peak_bytes"] / 1e9,
                card_total_gb=card / 1e9)


def require_mesh_kernels(where: str, res, kernels) -> None:
    """Every rank launched each of ``kernels`` with the one process's
    variants, and no plain version ran on any rank or in the one
    process."""
    one = res["single"]["counts"]
    require(not any(one["plain_calls"].values()),
            f"{where}: a plain version ran in the one process: "
            f"{one['plain_calls']}")
    for r in res["records"]:
        c, rank = r["counts"], r["rank"]
        for k in kernels:
            require(c["launches"][k] > 0,
                    f"{where}: rank {rank} never launched {k}")
            if k in c["launches_by_variant"]:
                require(c["launches_by_variant"][k]
                        == one["launches_by_variant"][k],
                        f"{where}: rank {rank}'s {k} variants "
                        f"{c['launches_by_variant'][k]} are not the one "
                        f"process's {one['launches_by_variant'][k]}")
        require(not any(c["plain_calls"].values()),
                f"{where}: a plain version ran on rank {rank}: "
                f"{c['plain_calls']}")


def mesh_serving(case, job, res, shape, backend, seconds, smi, card,
                 paths):
    """One serving job of :func:`phase_mesh`: logits within the row-scaled
    2e-2 of the one process's, greedy tokens equal but near ties, the
    ranks of a data index equal, the path's kernels (:func:`mesh_kernels`)
    launched on every rank through the one process's variants, no plain
    call, no pair dropped by the MoE on either side. Prints each rank's
    launches by variant, collectives and peak memory beside the one
    process's and the card's."""
    label, _, S, steps, mode = case
    cfg, chk, single = job.cfg, res["check"], res["single"]
    one = single["counts"]
    require_mesh_kernels(f"mesh {label}", res, mesh_kernels(cfg, False))
    for r in res["records"]:
        paths[f"mesh_{label}_rank{r['rank']}"] = {
            k: n for k, n in r["counts"]["launches"].items() if n}
    require(chk["ok"], f"mesh {label}: {chk}")
    if cfg.moe is not None:
        require(chk["dropped"] == {"mesh": 0, "one_process": 0},
                f"mesh {label}: pairs dropped {chk['dropped']}")
    emit("mesh", case=label, model=cfg.name, mode=mode, layers=cfg.n_layers,
         encoder_layers=cfg.encoder.n_layers if cfg.encoder else None,
         dtype=str(cfg.dtype), mesh=list(shape), backend=backend,
         prompts=[MESH["batch"], S], decode_steps=steps,
         extras={k: list(v.shape) for k, v in (job.extras or {}).items()},
         capacity_factor=(cfg.moe.capacity_factor if cfg.moe else None),
         mesh_and_checks_s=seconds, mesh_s=res["mesh_seconds"],
         check=chk, ranks=res["ranks"], memory=mesh_memory(res, card),
         one_process=dict(launches={k: n for k, n in
                                    one["launches"].items() if n},
                          launches_by_variant={
                              k: v for k, v in
                              one["launches_by_variant"].items()
                              if any(v.values())},
                          plain_calls=one["plain_calls"],
                          moe_pairs=single["moe_pairs"],
                          moe_dropped=single["moe_dropped"],
                          seconds=single["seconds"]),
         nvidia_smi=smi)


# the mesh_train lines: in the mesh phase's spawns, full widths, 2 layers
# (whisper: 2 decoder and 2 encoder layers); the gradient at the starting
# weights, then AdamW steps (lr 1e-4, no warmup, from spmd.warm_state) of
# qwen3-8b and mamba2-2.7b (bf16) on 2 x 1,024 tokens with tensor
# parallelism (1 x 2) and with ZeRO-3 and data parallelism (2 x 1), of
# mamba2-2.7b in f32 as well on 1 x 2 (bf16 rounding moves its gradients
# 1-2% of their norm: f32 holds its sharded backward to tighter limits), of
# moonshot (f32, dropless) on 2 x 512 with expert parallelism (1 x 2), of
# whisper-medium (bf16, 1,500 frames) on 2 x 256 with tensor parallelism
# (1 x 2); then the reference's other sharding modes on 1 x 2, the
# residual split by sequence over model: qwen3-8b (bf16, 2 x 1,024) in
# tp_sp_opt (the normed rows all-gathered, the partial sums
# reduce-scattered) and in fsdp_cp (whole weights, context-parallel
# attention: the flash backward at q_offset 1,024 / 2 on rank 1), and
# moonshot (f32, dropless, 2 x 512) in fsdp_cp; each against the same in
# one process (rank 0's, spmd.train_checked), within spmd.train_limits
# (PERF.md). A case: (label, model, S, dtype, steps, sharding mode)
MESH_TRAIN = dict(batch=2, meshes={
    (1, 2): (("qwen_tp_1x2", MAIN["model"], 1024, "bfloat16", 2, "tp_sp"),
             ("moe_ep_1x2", "moonshot-v1-16b-a3b", 512, "float32", 2,
              "tp_sp"),
             ("mamba2_tp_1x2", SSM_MODEL, 1024, "bfloat16", 2, "tp_sp"),
             ("mamba2_tp_f32_1x2", SSM_MODEL, 1024, "float32", 2, "tp_sp"),
             ("whisper_tp_1x2", "whisper-medium", 256, "bfloat16", 2,
              "tp_sp"),
             ("qwen_opt_1x2", MAIN["model"], 1024, "bfloat16", 2,
              "tp_sp_opt"),
             ("qwen_cp_1x2", MAIN["model"], 1024, "bfloat16", 2, "fsdp_cp"),
             ("moe_cp_1x2", "moonshot-v1-16b-a3b", 512, "float32", 2,
              "fsdp_cp")),
    (2, 1): (("qwen_zero3_2x1", MAIN["model"], 1024, "bfloat16", 2,
              "tp_sp"),
             ("mamba2_zero3_2x1", SSM_MODEL, 1024, "bfloat16", 2, "tp_sp"))})


def mesh_training(case, job, res, shape, backend, seconds, smi, card,
                  paths):
    """One training job of :func:`phase_mesh` (a ``mesh_train`` line).
    Requires, on every rank: each step's loss and grad norm, and the
    gradients at the starting weights and the parameters after the steps
    put back together from the ranks' blocks, within
    ``spmd.train_limits`` of the one process's, every rank's losses and
    norms and every leaf's replicas equal, the path's training kernels
    (:func:`mesh_kernels`: flash's forward with lse and backward, the SSD
    scan and its backward) launched with the one process's variants, no
    plain call (in the one process neither), and for the MoE no pair
    dropped on either side. In ``fsdp_cp`` the ranks past the first of
    ``model`` launch every flash training forward and backward with a
    query offset and the first none; no other job launches one. Prints
    each rank's collectives by kind, the reduce-scatters' bytes among
    them, and its peak memory."""
    label, _, S = case[:3]
    mode = case[5]
    cfg, chk, single = job.cfg, res["check"], res["single"]
    one = single["counts"]
    kernels = mesh_kernels(cfg, True)
    require_mesh_kernels(f"mesh_train {label}", res, kernels)
    for r in res["records"]:
        c = r["counts"]
        cp = mode == "fsdp_cp" and r["coords"][1] > 0
        want = {k: c["launches"][k] if cp else 0
                for k in ("flash_attention_lse", "flash_attention_bwd")}
        got = {k: c["launches_with_offset"][k] for k in want}
        require(got == want, f"mesh_train {label}: rank {r['rank']} "
                f"launched {got} flash calls with a query offset, not "
                f"{want}")
    for r in res["records"]:
        paths[f"mesh_train_{label}_rank{r['rank']}"] = {
            k: n for k, n in r["counts"]["launches"].items() if n}
    require(chk["ok"], f"mesh_train {label}: {chk}")
    if cfg.moe is not None:
        require(chk["dropped"] == {"mesh": 0, "one_process": 0},
                f"mesh_train {label}: pairs dropped {chk['dropped']}")
    emit("mesh_train", case=label, model=cfg.name, mode=mode,
         layers=cfg.n_layers,
         encoder_layers=cfg.encoder.n_layers if cfg.encoder else None,
         dtype=str(cfg.dtype), mesh=list(shape), backend=backend,
         batch=[MESH_TRAIN["batch"], S], steps=job.steps, lr=job.opt.lr,
         extras={k: list(v.shape) for k, v in (job.extras or {}).items()},
         capacity_factor=(cfg.moe.capacity_factor if cfg.moe else None),
         mesh_and_checks_s=seconds, mesh_s=res["mesh_seconds"],
         one_process_s=res["one_process_seconds"],
         check_s=res["check_seconds"], check=chk, ranks=res["ranks"],
         memory=mesh_memory(res, card),
         one_process=dict(
             launches={k: n for k, n in one["launches"].items() if n},
             launches_by_variant={
                 k: one["launches_by_variant"][k] for k in kernels
                 if k in one["launches_by_variant"]},
             plain_calls=one["plain_calls"],
             moe_pairs=single["moe_pairs"],
             moe_dropped=single["moe_dropped"],
             seconds=single["seconds"]),
         nvidia_smi=smi)


def _pre_wb_not_summed(p, x, cfg, ctx=None):
    """A planted fault: ``mamba2._pre`` with ``wB`` not entering the rank's
    heads, so its gradient is this rank's part alone."""
    import torch.nn.functional as F
    from repro_torch.distributed import collectives as C
    from repro_torch.models import mamba2 as M2
    from repro_torch.models.common import rms_norm
    s = cfg.ssm
    H = p["wdt"].shape[1]
    h = C.enter(rms_norm(x, p["ln"], cfg.norm_eps), "tp", ctx)
    Bm = (h @ p["wB"]).reshape(*h.shape[:-1], s.n_groups, s.d_state)
    Cm = (h @ C.enter(p["wC"], "tp", ctx)).reshape(
        *h.shape[:-1], s.n_groups, s.d_state)
    dt = F.softplus((h @ p["wdt"]).float() + p["dt_bias"])
    return (h @ p["wx"], h @ p["wz"], M2._groups(Bm, H, cfg, ctx),
            M2._groups(Cm, H, cfg, ctx), dt)


def _no_data_sum(self) -> None:
    """A planted fault: ``Model.sum_grads_over_data`` summing nothing, so
    the gradients of the leaves no fsdp dim splits are each data rank's
    rows' alone."""


# the faults of --mesh-controls, by mesh: (label, module, attribute, planted)
MESH_FAULTS = {
    (1, 2): ("wB_grad_not_summed", "repro_torch.models.mamba2", "_pre",
             _pre_wb_not_summed),
    (2, 1): ("data_grads_not_summed", "repro_torch.models.transformer",
             "Model.sum_grads_over_data", _no_data_sum)}


def mesh_control_rank(mesh, device, job, fault):
    """One rank of :func:`mesh_controls`: ``spmd.train`` of ``job``, then
    again with ``fault`` (a ``MESH_FAULTS`` entry) planted; both records,
    their gradients and parameters on the CPU."""
    import importlib
    from repro_torch.launch import spmd
    from repro_torch.tree import tree_map
    _, module, attr, planted = fault
    obj = importlib.import_module(module)
    *owner, attr = attr.split(".")
    for name in owner:
        obj = getattr(obj, name)
    out = []
    for faulty in (False, True):
        saved = getattr(obj, attr)
        if faulty:
            setattr(obj, attr, planted)
        try:
            rec = spmd.train(mesh, device, job)
        finally:
            setattr(obj, attr, saved)
        for key in ("grads", "params"):
            rec[key] = tree_map(lambda t: t.detach().cpu(), rec[key])
        out.append(rec)
    return out


def mesh_controls(torch, args) -> None:
    """``--mesh-controls``: the readings that ``spmd.train_limits`` of
    mamba2-2.7b lie between. First :func:`check_mesh_kernels`; then its
    train jobs of the mesh phase
    (``MESH_TRAIN``, the same tokens) on each mesh, sound and then with the
    mesh's planted fault (``MESH_FAULTS``), each held against the same job
    in one process by ``spmd.check_train``; prints every reading
    (``mesh_control`` lines) and requires none."""
    from repro_torch.launch import spmd
    smi = nvidia_smi()
    check_mesh_kernels(torch, torch.Generator(device="cuda").manual_seed(
        args.seed + 28))
    for shape, jobs in mesh_jobs(torch, args).items():
        n = len(MESH["meshes"][shape])
        for case, job in zip(MESH_TRAIN["meshes"][shape], jobs[n:]):
            if job.cfg.name != SSM_MODEL:
                continue
            backend, per_rank = spmd.launch(
                mesh_control_rank, shape, (job, MESH_FAULTS[shape]),
                device="cuda")
            single = spmd.train(None, torch.device("cuda"), job)
            for i, fault in enumerate((None, MESH_FAULTS[shape][0])):
                chk = spmd.check_train([r[i] for r in per_rank], single, job,
                                       shape)
                emit("mesh_control", case=case[0], fault=fault,
                     mesh=list(shape), backend=backend, steps=job.steps,
                     check=chk, nvidia_smi=smi)
            del per_rank, single
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, prompts and kernel inputs")
    ap.add_argument("--lr-witness-layers", type=int, default=None,
                    help="build the kernels, run only train_mamba2's lr "
                    "witness with mamba2-2.7b at this many layers, and "
                    "exit (the smoke itself runs it at 2)")
    ap.add_argument("--lr-witness-lr", type=float, default=None,
                    help="with --lr-witness-layers: train both runs at "
                    "this lr instead of train_main's, and print both "
                    "curves without holding them to each other (how each "
                    "falls at that lr)")
    ap.add_argument("--mesh-controls", action="store_true",
                    help="build the kernels, run only mamba2-2.7b's mesh "
                    "train jobs, sound and with a planted fault, print "
                    "their checks' readings without requiring them, and "
                    "exit")
    args = ap.parse_args(argv)
    # cuBLAS is deterministic only with a fixed workspace, set before torch
    # loads it; train_main's resume check runs under deterministic
    # algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    if args.mesh_controls:
        mesh_controls(torch, args)
        return 0
    if args.lr_witness_layers:
        from repro_torch.configs import get_config
        with torch.enable_grad():
            lr_witness(torch, args, dataclasses.replace(
                get_config(SSM_MODEL), n_layers=args.lr_witness_layers),
                lr=args.lr_witness_lr)
        return 0

    rng = np.random.default_rng(args.seed)
    vocab = 151936
    prompt_lens = [int(n) for n in rng.integers(
        MAIN["prompt_min"], MAIN["prompt_max"] + 1, MAIN["n_requests"])]
    # one prime length: the SSD kernel's ragged last chunk on a main path
    prompt_lens[-1] = next_prime(prompt_lens[-1])
    prompts = [[int(t) for t in rng.integers(0, vocab, n)]
               for n in prompt_lens]
    flow, matched = workflow(np.random.default_rng(args.seed + 2), vocab)
    suffix = int(statistics.median(len(p) - n for p, n in
                                   zip(flow[1:], matched[1:])))

    # wall seconds of each phase since the one before
    seconds, last = {}, [time.perf_counter()]

    def mark(phase):
        now = time.perf_counter()
        seconds[phase], last[0] = now - last[0], now

    checks = phase_kernels(torch, args, prompt_lens,
                           (WORKFLOW["context"], suffix),
                           gateway_shapes(gateway_jobs(args.seed)[0]))
    mark("kernels")
    phase_reference(torch, args)
    phase_prefix_reference(torch, args)
    mark("reference")
    model, launches, variants, tokens_chunked = phase_main(torch, args,
                                                           prompts)
    mark("main")
    # the paged kernels' launches are the chunked main path's; flash's the
    # monolithic path's
    mono, variants["flash_attention"], tokens_mono = phase_dense_monolithic(
        torch, model, prompts, tokens_chunked)
    launches["flash_attention"] = mono["flash_attention"]
    mark("dense_monolithic")
    dense_kv = phase_dense_kv(torch, model, prompts, tokens_mono)
    mark("dense_kv")
    prefix = phase_prefix(torch, model, flow, matched)
    mark("prefix")
    ssm, variants["ssd_chunk"], mamba = phase_ssm_main(torch, args,
                                                       prompt_lens)
    launches.update(ssm)
    mark("ssm_main")
    launch = phase_launch(torch, args, {model.cfg.name: model,
                                        mamba.cfg.name: mamba})
    mark("launch")
    # the node's models: the first layers of the main paths' (their
    # weights, not copies); the rest go, so that an offload frees memory
    qwen_cut = shallow(model, NODE_LAYERS[MAIN["model"]])
    mamba_cut = shallow(mamba, NODE_LAYERS[SSM_MODEL])
    del model, mamba
    node, host = phase_node(torch, qwen_cut, mamba_cut, flow)
    del qwen_cut, mamba_cut
    mark("node")
    pred = train_predictor()
    card = phase_gateway_reference(torch, args, pred)
    mark("gateway_reference")
    gateway, inproc_maestro = phase_gateway(torch, args, host, pred)
    del host                  # two workers' pinned copies need the room
    mark("gateway")
    phase_sim(args, pred)
    mark("sim")
    examples = phase_examples(torch)
    mark("examples")
    workers = phase_worker_reference(torch, args, pred, card)
    mark("worker_reference")
    phase_worker_fault(torch, args, pred)
    mark("worker_fault")
    workers.update(phase_gateway_process(torch, args, pred, inproc_maestro))
    mark("gateway_process")
    zoo_checks, zoo_paths, moe_variants = zoo_phases(
        torch, args, prompt_lens, prompts, mark)
    train_checks, ssd_checks, train_paths, train_variants = train_phases(
        torch, args, mark)
    mesh_paths, mesh_checks = phase_mesh(torch, args)
    mark("mesh")
    emit("timing", seconds_by_phase=seconds,
         total_s=time.perf_counter() - t0)
    by_path = {"dense_kv": dense_kv, "prefix_chunked": prefix["chunked"],
               "prefix_monolithic": prefix["monolithic"], "node": node,
               **{f"gateway_{run}": n for run, n in gateway.items()},
               **workers, **zoo_paths, **train_paths, **launch, **examples,
               **mesh_paths}

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
        zoo = zoo_checks[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name],
            # the largest over the main path's shapes, the gateway's and
            # the zoo's
            max_abs_err=max([c["max_abs_err"], c.get("gateway_shapes", {})
                             .get("max_abs_err", 0.0)]
                            + [z["max_abs_err"] for z in zoo.values()]),
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"],
            # SDPA for flash; None where no single PyTorch call computes
            # the function (the paged kernels would need their pages
            # gathered first, and nothing computes the SSD scan)
            library_ms=c.get("library_ms"),
            # launches on the path by variant; the decode kernel has one
            variants=variants.get(name),
            # launches on the later slices' paths (prefix cache on; the
            # node; the gateway under each policy, and under fcfs at the
            # default reject_limit; the worker fleets, summed over their
            # children and per child)
            # (flash: the serving forward and, on the training paths, the
            # forward that also writes the row log-sum-exp)
            launches_by_path={p: n.get(name, 0) + (
                n.get("flash_attention_lse", 0)
                if name == "flash_attention" else 0)
                for p, n in by_path.items()},
            # each number at the zoo's shapes, by (H, Hkv) (the SSD scan:
            # by its N, P and heads); moonshot's chunk launches by variant
            zoo_shapes={shape: {k: z[k] for k in (
                "max_abs_err", "ms", "ms_no_spin", "host_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")}
                for shape, z in zoo.items()},
            # flash with its query offset and paged attention with its
            # row log-sum-exp at an fsdp_cp rank's shapes (the mesh phase)
            mode_shapes={label: rec for label, rec in
                         mesh_checks.get(name, {}).items() if "ms" in rec},
            **({"moe_main_variants": moe_variants}
               if name == "chunk_prefill_attention" else {})))
    qwen = next(iter(train_checks.values()))   # train_main's shape
    kernels.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces=None,
        replaces_reason=("no Pallas kernel: the reference differentiates "
                         "its jnp blockwise attention "
                         "(src/repro/models/layers.py:91) with JAX autodiff"),
        launches=train_paths["train_main"]["flash_attention_bwd"],
        max_abs_err=max(c["max_abs_err"] for c in train_checks.values()),
        ms=qwen["ms"], plain_ms=qwen["plain_ms"], bound_ms=qwen["bound_ms"],
        bound_by=qwen["bound_by"],
        # SDPA's backward (autograd of one scaled_dot_product_attention)
        library_ms=qwen["library_ms"],
        variants=train_variants["flash_attention_bwd"],
        launches_by_path={p: n.get("flash_attention_bwd", 0)
                          for p, n in by_path.items()
                          if n.get("flash_attention_bwd")},
        # ptxas's registers and spills of the backward's device kernels
        ptxas=bwd_ptxas(),
        # with its query offset at the sequence-split modes' rank shapes
        # (the mesh phase): SDPA's backward and forward + backward there
        # with the offset's boolean mask
        mode_shapes=mesh_checks["flash_attention_bwd"],
        train_shapes={label: {k: c.get(k) for k in (
            "max_abs_err", "row_scaled_err", "lse_max_abs_err", "variant",
            "ms", "ms_no_spin", "host_ms", "plain_ms", "bound_ms",
            "bound_by", "bound_share", "library_ms", "library_ratio",
            "fwd_bwd_ms", "fwd_bwd_bound_ms", "library_fwd_bwd_ms")}
            for label, c in train_checks.items()}))
    mamba = next(iter(ssd_checks.values()))   # train_mamba2's microbatch
    kernels.append(dict(
        name="ssd_chunk_bwd", route="cuda",
        source="src/repro_torch/csrc/ssd_chunk_bwd.cu",
        replaces=None,
        replaces_reason=("no Pallas kernel: the reference differentiates "
                         "its jnp chunked scan "
                         "(src/repro/models/mamba2.py:59) with JAX "
                         "autodiff"),
        launches=train_paths["train_mamba2"]["ssd_chunk_bwd"],
        max_abs_err=max(c["max_abs_err"] for c in ssd_checks.values()),
        ms=mamba["ms"], plain_ms=mamba["plain_ms"],
        bound_ms=mamba["bound_ms"], bound_by=mamba["bound_by"],
        # no single PyTorch call computes the scan's gradient
        library_ms=None,
        variants=train_variants["ssd_chunk_bwd"],
        launches_by_path={p: n.get("ssd_chunk_bwd", 0)
                          for p, n in by_path.items()
                          if n.get("ssd_chunk_bwd")},
        # ptxas's registers and spills of the backward's device kernels
        ptxas=bwd_ptxas("ssd_chunk_bwd"),
        train_shapes={label: {k: c.get(k) for k in (
            "max_abs_err", "row_scaled_err", "variant", "ms", "ms_no_spin",
            "host_ms", "plain_ms", "bound_ms", "bound_by", "bound_share",
            "library_ms", "state_bytes")}
            for label, c in ssd_checks.items()}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
