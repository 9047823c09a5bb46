"""Continuous-batching inference engine — the port of
``repro/serving/engine.py`` for every family of the zoo: dense and MoE
self-attention stacks, pure-SSM stacks, hybrids, the encoder-decoder and
the decoder with cross-attention layers.

Iteration-level scheduling: each ``step()`` admits waiting requests into
free slots (admission is prediction-guided through the Maestro accountant +
rho margin: Eq. 3's R_need gates it), then runs ONE fused iteration of at
most ``max_batch_tokens``: every decoding sequence contributes its next
position, and sequences still prefilling contribute one fixed-width chunk
of ``prefill_chunk_tokens`` prompt tokens each, streamed into the arena
through ``Model.prefill_chunk``. With ``prefill_chunk_tokens=0`` (the
default) admission runs a monolithic prefill instead. Pure-decode
iterations run up to ``decode_horizon`` tokens per lane in one launch with
one host sync. Preemption is boundary-only (``evict`` between steps).

K/V lives in the paged :class:`~repro_torch.serving.kv_arena.KVArena`;
decode and chunk attention read it through per-sequence block tables via
:mod:`repro_torch.kernels.ops`, which launches the CUDA kernels for tensors
on the card and runs their plain versions for tensors on the CPU. A model
with SSM layers keeps their recurrent state in a dense per-slot cache,
registered with the accountant: a pure-SSM model (``paged_kv_layout()`` of
0 layers) holds nothing else and decodes from it alone; so does any model
under ``kv_backend="dense"``, whose self-attention K/V then sits in that
cache too (``Model.cache``) and is read through the paged decode kernel
over the cache viewed as pages (``Model.decode_step``); a hybrid is paged
and holds both, its monolithic prefill writing the prompt's K/V and the
state, its paged decode stepping the state of every lane. Either decodes
all ``max_slots`` lanes one token at a time: the chunk and horizon knobs
degrade to 0 and 1, as the reference's do.

An encdec or vlm model is paged for its self-attention and holds its
cross-attention K/V in the same dense per-slot cache: the monolithic
prefill runs the encoder over the request's frames (or takes its patch
embeddings), writes the prompt's cross K/V at the slot, and every decode
step reads them there. A request without ``extras`` (the gateway sends
none) prefills against an engine-constant stub (``_modal_extras``). The
chunk and horizon knobs degrade to 0 and 1 and the prefix cache stays
off, as the reference's do.

With ``prefix_cache`` on, admission matches each prompt against the
arena's :class:`~repro_torch.serving.prefix_cache.PrefixIndex`: the
matched pages are aliased into the new sequence (a partially matched page
is copied on the device first), and prefill starts after them — the
monolithic path runs the suffix as one paged chunk of the sequence
(:meth:`Model.prefill_suffix`, the chunk kernel), the chunked path starts
its first chunk there. A finished prompt publishes its full pages into the
index. No write ever lands on a shared row: horizon and one-token decode
writes copy a shared page first.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import dtype_bytes
from repro_torch.core.runtime.accounting import MemoryAccountant
from repro_torch.core.runtime.kv_pool import VirtualKVPool
from repro_torch.core.sched.margins import RhoEstimator
from repro_torch.kernels import ops
from repro_torch.models.transformer import Model
from repro_torch.serving.kv_arena import KVArena
from repro_torch.serving.prefix_cache import (PrefixCacheConfig,
                                              PrefixMatch, page_digests,
                                              root_key)


class PromptTooLongError(ValueError):
    """Prompt cannot fit the engine's sequence window (needs <= s_max - 1
    tokens so at least one decode position remains). Raised at ``submit``
    time — silent KV overflow is never possible."""


class EngineStalledError(RuntimeError):
    """``drain()`` exhausted its step budget with work still queued or
    active. Raised instead of silently returning a partial result set."""


@dataclasses.dataclass
class Request:
    req_id: int
    tokens: List[int]
    max_new: int = 64
    pred_len: Optional[float] = None      # L_hat from the dispatch gateway
    # modality inputs: {"frames": [1,F,D]} (encdec) or {"ctx_embeds":
    # [1,N,C]} (vlm) tensors on the engine's device; None takes the stub
    extras: Optional[Dict[str, Any]] = None
    out: List[int] = dataclasses.field(default_factory=list)
    eos: Optional[int] = None
    truncated: bool = False               # finished early (KV exhausted)
    prefill_avoided: int = 0              # prompt tokens served from cache
    submit_s: float = 0.0                 # wall stamp at engine submit
    ttft_s: float = 0.0                   # wall submit -> first kept token


def pad_writes(offs: np.ndarray, last_idx: np.ndarray, slots: List[int],
               page: int) -> None:
    """Spread a chunk's pad columns over the null row so that one of them
    lands where a row reads it. offs [B,C] the chunk's write offsets, set
    in place; ``slots`` the lanes advancing, each with real columns up to
    ``last_idx``. Every pad column writes the null row, of which rows read
    only offset 0 (an idle lane's pad rows, at position 0). A sequential
    scatter (the reference's) leaves there the last pad column in row-major
    order; a scatter on the card lands duplicates in any order, and MoE
    routing gives pad rows capacity, so tokens would depend on the order.
    That last column keeps offset 0; the others write the null row's last
    offset (``page`` >= 2), which nothing reads."""
    pad = np.ones(offs.shape, bool)
    for s in slots:
        pad[s, :last_idx[s] + 1] = False
    cols = np.flatnonzero(pad)
    if cols.size:
        offs[pad] = page - 1
        offs.flat[cols[-1]] = 0


class Engine:
    def __init__(self, model: Model, accountant: MemoryAccountant,
                 max_slots: int = 4, s_max: int = 256,
                 page_tokens: int = 16, arena: Optional[KVArena] = None,
                 prefix_cache=None, prefix_ns: Optional[str] = None,
                 max_batch_tokens: Optional[int] = None,
                 prefill_chunk_tokens: int = 0,
                 decode_horizon: int = 1, device=None,
                 kv_backend: Optional[str] = None):
        """``model`` holds its weights (the reference passes ``params``
        beside it). ``arena``: the physical page store (a private one on
        ``device`` is created by default; pass one with ``init_rows`` sized
        to the peak to avoid plane regrowth). ``prefix_cache``: None/False
        (off, the default), True, or a :class:`PrefixCacheConfig`; it takes
        effect only for a model that supports prefix reuse. ``prefix_ns``:
        the digest namespace of the prefix index (a node passes the serving
        model name; defaults to the config name). ``prefill_chunk_tokens`` > 0
        switches prefill to fixed-width chunks fused into the decode
        iteration. ``max_batch_tokens``: per-iteration token budget across
        decode positions + prefill chunks (None = unbounded; at least one
        chunk always advances). ``decode_horizon`` > 1 fuses up to that many
        decode iterations into one launch per ``step()``; mixed
        prefill+decode iterations fall back to one-token decode. Both knobs
        need every layer's context in paged KV; for a model without it they
        degrade to 0 and 1. ``device``: ``cuda`` unless the caller names
        another; it must be the model's device. ``kv_backend``: None or
        "paged" (the default; the reference's "pallas" and "ref" mean the
        same here, since the dispatch picks the kernel or its plain version
        by device) keeps self-attention K/V in the arena's pages; "dense"
        keeps it in a dense ``[max_slots, s_max, Hkv, hd]`` cache per
        attention layer, as the reference's dense backend does, with its
        degradations: no arena plane, no prefix cache, no chunked prefill,
        no horizon. A model without attention layers is always "dense"."""
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.acc = accountant
        self.s_max = s_max
        self.max_slots = max_slots
        self.arena = (arena if arena is not None
                      else KVArena(page_tokens, device=self.device))
        self.page_tokens = self.arena.page_tokens
        alpha = max(model.cfg.kv_bytes_per_token(
            dtype_bytes=dtype_bytes(model.cfg.dtype)), 1)
        self.alpha = alpha
        self.pool = VirtualKVPool(accountant,
                                  page_bytes=alpha * self.page_tokens,
                                  page_tokens=self.page_tokens)
        self.pool.set_virtual_budget(model.cfg.name,
                                     alpha * s_max * max_slots * 4)
        n_layers, Hkv, hd, kv_dtype = model.paged_kv_layout()
        if kv_backend is None or kv_backend in ("pallas", "ref"):
            kv_backend = "paged"
        if kv_backend not in ("paged", "dense"):
            raise ValueError(f"kv_backend must be None, 'paged', 'pallas', "
                             f"'ref' or 'dense', not {kv_backend!r}")
        if n_layers == 0:
            kv_backend = "dense"         # nothing to page: state-only model
        self.kv_backend = kv_backend
        self.paged = kv_backend == "paged"
        self.binding = self.arena.register(
            model.cfg.name, self.pool, s_max=s_max,
            n_layers=n_layers if self.paged else 0,
            n_kv_heads=Hkv, head_dim=hd, dtype=kv_dtype)
        self._pc = None
        self._pc_ns = prefix_ns or model.cfg.name
        if prefix_cache:
            pc_cfg = (prefix_cache if isinstance(prefix_cache,
                                                 PrefixCacheConfig)
                      else PrefixCacheConfig())
            if pc_cfg.enabled and self.paged and model.supports_prefix_reuse:
                self._pc = self.arena.enable_prefix_cache(accountant, pc_cfg)
        self._hits: Dict[int, PrefixMatch] = {}
        self.rho = RhoEstimator()
        self.waiting: Deque[Request] = collections.deque()
        self.active: Dict[int, Request] = {}
        self.slot_of: Dict[int, int] = {}
        self.free_slots = list(range(max_slots))
        self.positions = np.zeros(max_slots, np.int32)
        self._needs: Dict[int, float] = {}   # admitted R_need, by req_id
        self._state_key = f"{model.cfg.name}::decode-state"
        self._state_bytes = 0
        self.cache: Optional[Dict[str, torch.Tensor]] = None
        self._ensure_cache()
        self._modal_extras = self._make_modal_extras()
        self.horizon = (int(decode_horizon)
                        if (decode_horizon and int(decode_horizon) > 1
                            and self.paged and model.supports_decode_horizon)
                        else 1)
        # persistent device-side decode tables (horizon > 1 only): uploaded
        # when admission, release, eviction or page growth dirties them —
        # never rebuilt per token
        self._dev_bt: Optional[torch.Tensor] = None
        self._dev_pos: Optional[torch.Tensor] = None
        self._tables_dirty = True
        self.max_batch_tokens = max_batch_tokens
        self.chunk_tokens = (int(prefill_chunk_tokens)
                             if (prefill_chunk_tokens and self.paged
                                 and model.supports_chunked_prefill) else 0)
        self._prefill_pos: Dict[int, int] = {}   # rid -> prompt tokens done
        # iteration telemetry: the prefill/decode token split, fused
        # iterations, and horizon launches + decode-side host syncs (one
        # blocking device->host fetch per one-token decode batch OR per
        # horizon launch)
        self.stat_prefill_tokens = 0
        self.stat_decode_tokens = 0
        self.stat_steps = 0
        self.stat_fused_steps = 0
        self.stat_horizon_steps = 0
        self.stat_decode_syncs = 0
        self.finished: List[Request] = []

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -------------------------------------------------------------- state
    def _ensure_cache(self) -> None:
        """(Re)allocate the dense per-slot cache (SSM state / conv, static
        cross K/V; empty for a pure self-attention model on the paged
        path; plus every attention layer's K/V on the dense one) and
        register its bytes with the accountant, so engine state is never
        silently device-resident."""
        if self.cache is not None:
            return
        self.cache = (self.model.state_cache(self.max_slots) if self.paged
                      else self.model.cache(self.max_slots, self.s_max,
                                            self.page_tokens))
        nbytes = sum(t.numel() * t.element_size()
                     for t in self.cache.values())
        self._state_bytes = nbytes
        if nbytes:
            self.acc.register_context(self._state_key, nbytes)

    def release_kv(self) -> None:
        """Drop every byte of device KV this engine holds: boundary-evict
        active requests back to the front of the waiting queue (their arena
        pages return to pool + plane), then free the dense state cache and
        its accountant registration. Called on sleep/offload."""
        evicted = [req for rid in list(self.active)
                   if (req := self.evict(rid)) is not None]
        self.waiting.extendleft(reversed(evicted))
        self.binding.release_all()
        if self._pc is not None:       # slept models give back their pins
            self._pc.flush_model(self._pc_ns)
        if self.cache is not None:
            self.cache = None
            if self._state_bytes:
                self.acc.unregister_context(self._state_key)
            self._state_bytes = 0
        self._dev_bt = self._dev_pos = None     # device tables go with KV
        self._tables_dirty = True

    # ------------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        if len(req.tokens) > self.s_max - 1:
            raise PromptTooLongError(
                f"prompt of {len(req.tokens)} tokens exceeds the engine "
                f"window (s_max={self.s_max}, >=1 decode slot required)")
        if not req.submit_s:
            req.submit_s = time.perf_counter()
        self.waiting.append(req)

    def _r_need(self, req: Request) -> float:
        pred = req.pred_len if req.pred_len is not None else req.max_new
        return self.rho.r_need(self.alpha * (len(req.tokens) + pred))

    def _admit(self) -> List[Request]:
        admitted = []
        while self.waiting and self.free_slots:
            req = self.waiting[0]
            need = self._r_need(req)
            # pages cover prompt + the first decode write, never past the
            # sequence window (block tables hold ceil(s_max/page) pages)
            need_tokens = min(max(int(need / self.alpha),
                                  len(req.tokens) + 1), self.s_max)
            hit = alias = None
            if self._pc is not None:
                hit = self._prefix_lookup(req)
                alias = list(hit.rows)
                if hit.partial_row is not None:
                    alias.append(hit.partial_row)
                alias = alias or None
            if not self.binding.alloc_seq(req.req_id, self.model.cfg.name,
                                          need_tokens, alias_rows=alias):
                break   # memory-infeasible: reject-for-now (backpressure)
            if hit is not None:
                # the divergent tail lands mid-page: privatise that page
                # (copy on the device) before the suffix overwrites it; the
                # index pin keeps the row shared, so this always copies
                if (hit.partial_row is not None
                        and self.binding.make_private(req.req_id,
                                                      len(hit.rows))):
                    self._pc.cow_copies += 1
                self._hits[req.req_id] = hit
            self.waiting.popleft()
            slot = self.free_slots.pop()
            self.slot_of[req.req_id] = slot
            self.active[req.req_id] = req
            self._needs[req.req_id] = need
            self._tables_dirty = True
            admitted.append(req)
        return admitted

    def _prefix_lookup(self, req: Request) -> PrefixMatch:
        """Match the prompt against the prefix index, capped so the final
        prompt token always runs through prefill (its logits seed
        decoding)."""
        digs = page_digests(req.tokens, self.page_tokens, self._pc_ns)
        m = self._pc.match(self._pc_ns, digs, req.tokens, self.page_tokens)
        P = len(req.tokens)
        if m.n_full_tokens >= P:          # whole prompt cached: keep 1 page
            m.rows.pop()
            m.n_full_tokens -= self.page_tokens
            m.partial_row, m.partial_overlap = None, 0
        if m.partial_row is not None:
            m.partial_overlap = min(m.partial_overlap,
                                    P - 1 - m.n_full_tokens)
            if m.partial_overlap <= 0:
                m.partial_row, m.partial_overlap = None, 0
        m.digests = digs
        return m

    def _make_modal_extras(self) -> Optional[Dict[str, torch.Tensor]]:
        """The stub input of the model's modality frontend (None for a
        text-only model): frames [1,F,D] (encdec) or patch embeddings
        [1,N,ctx_dim or D] (vlm), standard normal in the model dtype, drawn
        from a ``torch.Generator`` seeded 0 on the engine's device, so that
        an engine's every prefill, and every run, sees the same stub. It
        has the distribution of the reference's
        ``jax.random.normal(PRNGKey(0))`` stub, not its bits."""
        cfg = self.model.cfg
        if not cfg.ctx_key:
            return None
        gen = torch.Generator(device=self.device).manual_seed(0)
        return {cfg.ctx_key: torch.randn((1, cfg.n_ctx, cfg.ctx_width),
                                         generator=gen, device=self.device)
                .to(cfg.dtype)}

    # -------------------------------------------------------------- prefill
    def _first_token(self, req: Request, tok: int) -> None:
        req.out.append(tok)
        if not req.ttft_s and req.submit_s:
            req.ttft_s = time.perf_counter() - req.submit_s

    def _begin_chunked(self, req: Request) -> None:
        """Register a newly admitted request with the chunked-prefill plan:
        its prompt streams into the arena ``chunk_tokens`` at a time,
        starting after the pages a prefix-cache hit aliased."""
        hit = self._hits.get(req.req_id)
        p0 = hit.tokens_matched if hit is not None else 0
        self._prefill_pos[req.req_id] = p0
        if p0:
            req.prefill_avoided = p0
            self._pc.tokens_avoided += p0

    def _prefill(self, req: Request) -> None:
        """Monolithic prefill: of the suffix after a prefix-cache hit, else
        of the whole prompt; then publish the prompt's full pages."""
        self._ensure_cache()
        slot = self.slot_of[req.req_id]
        hit = self._hits.pop(req.req_id, None)
        if hit is not None and hit.tokens_matched > 0:
            self._prefill_suffix(req, hit, slot)
        else:
            self._prefill_full(req, slot)
        if self._pc is not None:
            self._index_prompt(req, hit.digests if hit is not None else None)

    def _prefill_full(self, req: Request, slot: int) -> None:
        toks = torch.tensor([req.tokens], dtype=torch.int32,
                            device=self.device)
        logits, k_all, v_all, state = self.model.prefill_with_state(
            toks, req.extras or self._modal_extras)
        P = len(req.tokens)
        self.stat_prefill_tokens += P
        if self.paged:
            self.binding.write_prompt(req.req_id, k_all[:, 0], v_all[:, 0])
        elif k_all is not None:          # the dense K/V cache
            self.cache["k"][:, slot, :P] = k_all[:, 0]
            self.cache["v"][:, slot, :P] = v_all[:, 0]
        if state is not None:            # ssm state / conv, cross K/V
            for name, t in state.items():
                self.cache[name][:, slot] = t[:, 0]
        self.positions[slot] = P
        self._tables_dirty = True
        self._first_token(req, int(logits.argmax(dim=-1)[0]))

    def _prefill_suffix(self, req: Request, hit: PrefixMatch,
                        slot: int) -> None:
        """Cache-hit prefill: the tokens after the ``M`` matched ones run
        as one paged chunk of this sequence, reading the aliased prefix
        pages in place and writing the suffix's K/V behind them."""
        M = hit.tokens_matched
        S = len(req.tokens) - M
        self.stat_prefill_tokens += S
        toks = torch.tensor([req.tokens[M:]], dtype=torch.int32,
                            device=self.device)
        plane = self.binding.plane
        logits = self.model.prefill_suffix(
            plane.k, plane.v, toks, M,
            self._dev(self.binding.row_table(req.req_id)[None]),
            attend=ops.chunk_prefill_attention)
        self.positions[slot] = len(req.tokens)
        self._tables_dirty = True
        self._first_token(req, int(logits.argmax(dim=-1)[0]))
        req.prefill_avoided = M
        self._pc.tokens_avoided += M

    def _index_prompt(self, req: Request, digs=None) -> None:
        """Publish every full prompt page into the prefix index (pinning its
        row) so later stages sharing this prefix can alias it."""
        page = self.page_tokens
        if digs is None:
            digs = page_digests(req.tokens, page, self._pc_ns)
        rows = self.binding.seq_rows(req.req_id)
        parent = root_key(self._pc_ns)
        for i, d in enumerate(digs):
            self._pc.insert(self._pc_ns, d, parent, self.binding.plane,
                            rows[i], req.tokens[i * page:(i + 1) * page],
                            n_prefix_tokens=(i + 1) * page)
            parent = d

    def _prefill_chunk_batch(self, rids: List[int]) -> None:
        """One fused chunk forward for the given mid-prefill sequences: each
        contributes the next ``chunk_tokens`` of its prompt at fixed shape
        [max_slots, C]. Slots not advancing this iteration are padding —
        tokens/positions zero, write coordinates at the null row. A sequence
        whose chunk reaches the end of its prompt gets its first token from
        that chunk's last-row logits and joins decode at the NEXT
        iteration."""
        C = self.chunk_tokens
        page = self.page_tokens
        toks = np.zeros((self.max_slots, C), np.int32)
        pos = np.zeros((self.max_slots, C), np.int32)
        rows = np.zeros((self.max_slots, C), np.int32)
        offs = np.zeros((self.max_slots, C), np.int32)
        bt = np.zeros((self.max_slots, self.binding.bt_width), np.int32)
        last_idx = np.zeros(self.max_slots, np.int32)
        for rid in rids:
            req = self.active[rid]
            slot = self.slot_of[rid]
            p0 = self._prefill_pos[rid]
            n = min(C, len(req.tokens) - p0)
            table = self.binding.row_table(rid)
            bt[slot] = table
            abs_t = np.arange(p0, p0 + n)
            toks[slot, :n] = req.tokens[p0:p0 + n]
            pos[slot, :n] = abs_t
            rows[slot, :n] = table[abs_t // page]
            offs[slot, :n] = abs_t % page
            last_idx[slot] = n - 1
            self._prefill_pos[rid] = p0 + n
            self.stat_prefill_tokens += n
        self._tables_dirty = True
        pad_writes(offs, last_idx, [self.slot_of[rid] for rid in rids],
                   page)
        plane = self.binding.plane
        logits = self.model.prefill_chunk(
            plane.k, plane.v, self._dev(toks), self._dev(pos), self._dev(bt),
            self._dev(rows), self._dev(offs), self._dev(last_idx),
            attend=ops.chunk_prefill_attention)
        nxt = logits.argmax(dim=-1).cpu().numpy()
        for rid in rids:
            req = self.active[rid]
            if self._prefill_pos[rid] < len(req.tokens):
                continue                       # more chunks to stream
            del self._prefill_pos[rid]
            slot = self.slot_of[rid]
            self.positions[slot] = len(req.tokens)
            self._first_token(req, int(nxt[slot]))
            if self._pc is not None:
                hit = self._hits.pop(rid, None)
                self._index_prompt(req, hit.digests if hit is not None
                                   else None)

    # --------------------------------------------------------------- decode
    def step(self) -> List[Request]:
        """One fused engine iteration; returns the requests that finished
        DURING THIS CALL only (the history stays on ``self.finished``)."""
        n0 = len(self.finished)
        self.stat_steps += 1
        for req in self._admit():
            if self.chunk_tokens:
                self._begin_chunked(req)
            else:
                self._prefill(req)
        # sequences still streaming their prompt join decode at the NEXT
        # iteration after their final chunk — snapshot the decode set first
        decode_rids = [rid for rid in self.active
                       if rid not in self._prefill_pos]
        use_horizon = self.horizon > 1 and not self._prefill_pos
        caps: Dict[int, int] = {}
        # grow page coverage for this step's writes; a sequence the pool
        # cannot extend finishes truncated (honest backpressure)
        for rid in (list(decode_rids) if self.paged else []):
            pos = int(self.positions[self.slot_of[rid]])
            if use_horizon:
                # pre-grant up to a horizon's worth of pages; a partial
                # grant caps that lane's emission budget, a zero grant
                # truncates exactly like the one-token path
                req = self.active[rid]
                want = min(self.horizon, req.max_new - len(req.out),
                           self.s_max - 1 - pos)
                got = self._pregrant(rid, pos, want)
                if got > 0:
                    caps[rid] = got
                    continue
            elif self.binding.ensure_tokens(rid, pos + 1):
                continue
            self.active[rid].truncated = True
            self._release(rid)
            decode_rids.remove(rid)
        if self._prefill_pos:
            # token-budget split: decode takes one position per sequence,
            # the remainder admits whole prefill chunks; at least one chunk
            # always advances (prefill cannot starve)
            if self.max_batch_tokens is None:
                n_adv = len(self._prefill_pos)
            else:
                room = self.max_batch_tokens - len(decode_rids)
                n_adv = max(room // self.chunk_tokens, 1)
            self._prefill_chunk_batch(list(self._prefill_pos)[:n_adv])
            if decode_rids:
                self.stat_fused_steps += 1
        if decode_rids and use_horizon:
            self._decode_horizon_batch(decode_rids, caps)
        elif decode_rids:
            toks = np.zeros((self.max_slots, 1), np.int32)
            for rid in decode_rids:
                toks[self.slot_of[rid], 0] = self.active[rid].out[-1]
            if self.paged:
                logits = self._decode_paged(toks, decode_rids)
            else:                 # every lane steps its dense cache
                logits = self.model.decode_step(
                    self.cache, self._dev(toks),
                    self._dev(self.positions.copy()),
                    page_tokens=self.page_tokens)
            nxt = logits.argmax(dim=-1).cpu().numpy()
            self.stat_decode_syncs += 1
            self.stat_decode_tokens += len(decode_rids)
            self._tables_dirty = True
            done = []
            for rid in decode_rids:
                req = self.active[rid]
                slot = self.slot_of[rid]
                tok = int(nxt[slot])
                req.out.append(tok)
                self.positions[slot] += 1
                if (len(req.out) >= req.max_new
                        or (req.eos is not None and tok == req.eos)
                        or self.positions[slot] >= self.s_max - 1):
                    done.append(rid)
            for rid in done:
                self._release(rid)
        return self.finished[n0:]

    def _pregrant(self, rid: int, pos: int, want: int) -> int:
        """Pre-grant pages for up to ``want`` horizon writes starting at
        ``pos``. Returns the emission budget actually covered (0 = not even
        one write grantable -> the caller truncates). When the pool refuses
        the full horizon the budget falls back page by page."""
        page = self.page_tokens
        have = self.binding.token_capacity(rid) - pos
        e = want
        while e > max(have, 0):
            if self.binding.ensure_tokens(rid, pos + e):
                self._tables_dirty = True   # new pages -> new block rows
                break
            e = (pos + e - 1) // page * page - pos   # one page fewer
        if e <= 0:
            return 0
        # covered by pages already granted: record the token high-water
        # mark with the pool (never allocates here, cannot fail)
        self.binding.ensure_tokens(rid, pos + e)
        if self._pc is not None:
            # a horizon write must never land on a shared row: privatise
            # every page the launch will touch before it starts, and point
            # the persistent device tables at the copies
            for pidx in range(pos // page, (pos + e - 1) // page + 1):
                if self.binding.make_private(rid, pidx):
                    self._pc.cow_copies += 1
                    self._tables_dirty = True
        return e

    def _decode_horizon_batch(self, decode_rids: List[int],
                              caps: Dict[int, int]) -> None:
        """One horizon launch: up to ``self.horizon`` decode iterations for
        every decoding lane and ONE host sync for the token block. The host
        re-applies the device's stop predicate over the emitted tokens to
        release finished requests."""
        B = self.max_slots
        live = np.zeros(B, bool)
        last = np.zeros(B, np.int32)
        rem = np.ones(B, np.int32)
        cap = np.zeros(B, np.int32)
        eos = np.full(B, -1, np.int32)
        for rid in decode_rids:
            slot = self.slot_of[rid]
            req = self.active[rid]
            live[slot] = True
            last[slot] = req.out[-1]
            rem[slot] = req.max_new - len(req.out)
            cap[slot] = caps[rid]
            if req.eos is not None:
                eos[slot] = req.eos
        if self._tables_dirty or self._dev_bt is None:
            bt = np.zeros((B, self.binding.bt_width), np.int32)
            for rid in decode_rids:
                bt[self.slot_of[rid]] = self.binding.row_table(rid)
            self._dev_bt = self._dev(bt)
            self._dev_pos = self._dev(self.positions.copy())
            self._tables_dirty = False
        plane = self.binding.plane
        tok_blk, self._dev_pos = self.model.decode_horizon(
            plane.k, plane.v, self._dev_bt, self._dev_pos, self._dev(last),
            self._dev(live), self._dev(rem), self._dev(cap), self._dev(eos),
            self.s_max, attend=ops.paged_attention, horizon=self.horizon,
            page_tokens=self.page_tokens)
        blk = tok_blk.cpu().numpy()               # the ONE host sync
        self.stat_decode_syncs += 1
        self.stat_horizon_steps += 1
        done = []
        for rid in decode_rids:
            req = self.active[rid]
            slot = self.slot_of[rid]
            for t in blk[slot]:
                if t < 0:
                    break                       # lane froze on device
                tok = int(t)
                req.out.append(tok)
                self.positions[slot] += 1
                self.stat_decode_tokens += 1
                if (len(req.out) >= req.max_new
                        or (req.eos is not None and tok == req.eos)
                        or self.positions[slot] >= self.s_max - 1):
                    done.append(rid)
                    break
        for rid in done:
            self._release(rid)

    def _decode_paged(self, toks: np.ndarray, decode_rids: List[int]):
        """One paged decode step: block tables / write coordinates for the
        decoding slots; idle and mid-prefill slots point at the null row.
        Returns logits [max_slots, Vp] f32."""
        bt = np.zeros((self.max_slots, self.binding.bt_width), np.int32)
        seq_lens = np.ones(self.max_slots, np.int32)
        rows = np.zeros(self.max_slots, np.int32)
        offs = np.zeros(self.max_slots, np.int32)
        for rid in decode_rids:
            slot = self.slot_of[rid]
            pos = int(self.positions[slot])
            if self._pc is not None and self.binding.make_private(
                    rid, pos // self.page_tokens):
                # a decode write must never land on a shared row
                self._pc.cow_copies += 1
            table = self.binding.row_table(rid)
            bt[slot] = table
            seq_lens[slot] = pos + 1
            rows[slot] = table[pos // self.page_tokens]
            offs[slot] = pos % self.page_tokens
        plane = self.binding.plane
        return self.model.decode_step_paged(
            plane.k, plane.v, self._dev(bt), self._dev(seq_lens),
            self._dev(rows), self._dev(offs), self._dev(toks),
            self._dev(self.positions.copy()), attend=ops.paged_attention,
            state_cache=self.cache)

    def _release(self, rid: int) -> None:
        req = self.active.pop(rid)
        slot = self.slot_of.pop(rid)
        actual = self.alpha * (len(req.tokens) + len(req.out))
        # calibrate against the reservation ADMISSION charged
        self.rho.observe(actual, max(self._needs.pop(rid, 1.0), 1.0))
        self.binding.free_seq(rid)      # pages -> pool -> arena rows
        self.free_slots.append(slot)
        self.positions[slot] = 0
        self._tables_dirty = True
        self.finished.append(req)

    # ------------------------------------------------------------ preemption
    def cancel(self, req_id: int) -> Optional[Request]:
        """Withdraw a request still waiting for admission (no KV held)."""
        for i, r in enumerate(self.waiting):
            if r.req_id == req_id:
                del self.waiting[i]
                return r
        return None

    def evict(self, req_id: int) -> Optional[Request]:
        """Boundary preemption: release an active request between engine
        steps. Its KV pages return to the pool, the arena plane and the
        accountant, the slot frees, and the partial output is discarded —
        the caller requeues it, and it restarts from its prompt."""
        req = self.active.pop(req_id, None)
        if req is None:
            return self.cancel(req_id)
        slot = self.slot_of.pop(req_id)
        self._needs.pop(req_id, None)
        self._hits.pop(req_id, None)
        # mid-chunked-prefill eviction drops the streaming cursor too; a
        # later re-admission restarts the prompt
        self._prefill_pos.pop(req_id, None)
        self.binding.free_seq(req_id)
        self.free_slots.append(slot)
        self.positions[slot] = 0
        self._tables_dirty = True
        req.out.clear()
        req.ttft_s = 0.0            # the discarded first token doesn't count
        return req

    def drain(self, max_steps: int = 10_000) -> List[Request]:
        steps = max_steps
        while (self.waiting or self.active) and steps:
            self.step()
            steps -= 1
        if self.waiting or self.active:
            raise EngineStalledError(
                f"drain({max_steps}) exhausted with {len(self.waiting)} "
                f"waiting / {len(self.active)} active requests still held")
        out, self.finished = self.finished, []
        return out
