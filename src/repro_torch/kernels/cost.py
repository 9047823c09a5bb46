"""What each hand kernel must cost: the bytes it must move (each input read
once, each output written once) and the flops it must do on its inputs, as
functions of its shapes.

``launch.roofline.bound`` turns a cost into the least time the card could
take; ``chip_smoke.py`` bounds each kernel with it, and
:mod:`repro_torch.kernels.ops` charges the dry run's counter each kernel
call on ``meta`` with it. ``launch.roofline`` re-exports these functions.
"""
from __future__ import annotations


def paged_cost(seq_lens, H, Hkv, hd, W, esize, lse: bool = False):
    """Paged decode over lanes of ``seq_lens`` tokens: K and V read once,
    q in, out written (and with ``lse`` each row's f32 log-sum-exp, a lane
    of length 0 then reading nothing), the block table and lengths; 4 * hd
    flops per (lane, key) pair and head."""
    tokens = sum(max(s, 0 if lse else 1) for s in seq_lens)
    B = len(seq_lens)
    n_bytes = (2 * tokens * Hkv * hd * esize        # K and V, read once
               + 2 * B * H * hd * esize             # q in, out
               + B * W * 4 + B * 4                  # block table, seq_lens
               + (B * H * 4 if lse else 0))         # the row log-sum-exp
    return n_bytes, 4 * tokens * H * hd             # QK^T and PV products


def chunk_cost(pos, H, Hkv, hd, W, esize):
    """A prefill chunk at positions ``pos`` [B, C] (a tensor): each lane's
    keys up to its last position read once, q in, out written, positions
    and table; 4 * hd flops per causally visible pair and head."""
    B, C = pos.shape
    k_lens = (pos.amax(dim=1) + 1).tolist()
    visible = int((pos.long() + 1).sum())           # causal keys per row
    n_bytes = (2 * sum(k_lens) * Hkv * hd * esize
               + 2 * B * C * H * hd * esize + B * C * 4 + B * W * 4)
    return n_bytes, 4 * visible * H * hd


def _visible(Sq: int, Sk: int, causal: bool, q_offset: int = 0) -> int:
    """(query, key) pairs attended: all, or causal with query i seeing keys
    j <= i + ``q_offset`` (top-left aligned at 0)."""
    if not causal:
        return Sq * Sk
    n = max(0, min(Sq, Sk - q_offset))      # rows that do not see every key
    return n * (n + 1) // 2 + n * q_offset + (Sq - n) * Sk


def flash_cost(Sq, Sk, H, Hkv, hd, causal, esize, q_offset: int = 0):
    """Bytes (q, k, v in, out written) and flops of one sequence's dense
    attention: 4 * hd per visible (query, key) pair and head."""
    n_bytes = (2 * Sq * H * hd + 2 * Sk * Hkv * hd) * esize
    return n_bytes, 4 * _visible(Sq, Sk, causal, q_offset) * H * hd


def bwd_cost(B, Sq, Sk, H, Hkv, hd, causal, esize, q_offset: int = 0):
    """Bytes (q, o, dout, dq and k, v, dk, dv in the I/O dtype; lse f32)
    and flops (the five products, 10 * hd per visible pair and head, the
    pairs :func:`_visible` admits under ``q_offset``) of the flash
    backward."""
    _, fwd_flops = flash_cost(Sq, Sk, H, Hkv, hd, causal, esize, q_offset)
    n_bytes = B * (4 * Sq * H * hd + 4 * Sk * Hkv * hd) * esize \
        + B * H * Sq * 4
    return n_bytes, B * fwd_flops * 10 // 4


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


def ssd_bwd_cost(B, S, H, P, N, Q, esize, with_state):
    """Bytes (x, B, C, dy and dx, dB, dC in the I/O dtype; dt, ddt, A, dA
    and the final state's gradient in f32) and flops of the SSD scan's
    backward over B sequences with chunks of Q: per chunk of n tokens and
    head, G = C B^T, dM = dy xdt^T, M^T dy, dG B and dG^T C over the
    n(n+1)/2 visible pairs, and five [n] x [N, P] products (the chunk's
    state and its gradient, their terms in dC, dx and dB), 2 flops per
    multiply-add."""
    n_bytes = (B * S * H * (3 * P + 4 * N) * esize + 2 * B * S * H * 4
               + 2 * H * 4 + (B * H * N * P * 4 if with_state else 0))
    macs = 0
    for c0 in range(0, S, Q):
        n = min(Q, S - c0)
        macs += n * (n + 1) // 2 * (3 * N + 2 * P) + 5 * n * N * P
    return n_bytes, 2 * B * H * macs
