"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit: they carry the
``cuda`` marker and skip elsewhere (the ``cuda`` fixture decides, at run
time). On the H100: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.

Tolerances: float32 to 1e-5 (the kernel's tiled online softmax against the
plain version's one-shot softmax, both in f32); bfloat16 to 2e-2, as in
``tests/test_kernels.py``. The splice is held bitwise. The SSD scan is held
by its largest error over the largest magnitude: 1e-4 at f32 (fixed chunks
of at most 64 against the plain version's largest-divisor chunks, sums in
another order), 1e-2 for a bf16 ``y`` (one rounding of the output), also
per head, and 1e-4 for the f32 state in either dtype. Cases of the chunk,
flash and SSD kernels assert the variant (``wgmma`` or ``simt``) they took,
and the bf16 ones of the wgmma attention loop also each row's error over
its magnitude (2e-2). TF32 stays off.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import chunk_prefill as cp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk as ssd

pytestmark = pytest.mark.cuda

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t.to(dtype) if dtype is not None else t


def _paged_inputs(rng, B, H, Hkv, hd, page, slots, dtype, dev):
    n_rows = B * slots + 3
    q = rng.standard_normal((B, H, hd), np.float32)
    kp = rng.standard_normal((n_rows, page, Hkv, hd), np.float32)
    vp = rng.standard_normal((n_rows, page, Hkv, hd), np.float32)
    bt = rng.permutation(n_rows)[:B * slots].reshape(B, slots).astype(np.int32)
    seq_lens = rng.integers(1, page * slots + 1, B).astype(np.int32)
    return (_t(q, dev, dtype), _t(kp, dev, dtype), _t(vp, dev, dtype),
            _t(bt, dev), _t(seq_lens, dev))


def _close(got, exp, dtype):
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), exp.float(), **tol)


@pytest.mark.parametrize("B,H,Hkv,hd,page,slots", [
    (2, 8, 2, 64, 16, 8),
    (3, 4, 4, 32, 8, 4),
    (1, 16, 2, 128, 32, 4),
    (8, 32, 8, 128, 16, 128),     # qwen3-8b decode at s_max 2048: 16 splits
    (132, 8, 8, 64, 16, 8),       # B * Hkv = 1056 blocks: one split
    (2, 12, 1, 128, 16, 64),      # g = 12, 32 splits of 32
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel(dev, B, H, Hkv, hd, page, slots, dtype):
    rng = np.random.default_rng(0)
    q, kp, vp, bt, sl = _paged_inputs(rng, B, H, Hkv, hd, page, slots, dtype,
                                      dev)
    got = pa.paged_attention(q, kp, vp, bt, sl)
    torch.cuda.synchronize()
    _close(got, ref.paged_attention_ref(q, kp, vp, bt, sl), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_at_span_edges(dev, dtype):
    """qwen3-8b decode shapes, split 16 ways in spans of 128: an idle slot
    (seq_len 0), one position, each side of a span boundary and the whole
    window; two identical calls are bitwise equal."""
    B, H, Hkv, hd, page, slots = 8, 32, 8, 128, 16, 128
    n_split, span = pa.split_plan(B, Hkv, slots, page)
    assert (n_split, span) == (16, 128)
    rng = np.random.default_rng(10)
    q, kp, vp, bt, _ = _paged_inputs(rng, B, H, Hkv, hd, page, slots, dtype,
                                     dev)
    sl = torch.tensor([0, 1, span - 1, span, span + 1, 2 * span + 1,
                       page * slots - 1, page * slots], dtype=torch.int32,
                      device=dev)
    got = pa.paged_attention(q, kp, vp, bt, sl)
    again = pa.paged_attention(q, kp, vp, bt, sl)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, ref.paged_attention_ref(q, kp, vp, bt, sl), dtype)


@pytest.mark.parametrize("B,H,Hkv,hd,page,slots", [
    (2, 8, 2, 64, 16, 8),         # 4 splits of 32
    (8, 32, 8, 128, 16, 128),     # 16 splits of 128
    (132, 8, 8, 64, 16, 8),       # one split
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_splice_is_bitwise(dev, B, H, Hkv, hd, page,
                                                  slots, dtype):
    """Splicing k_new/v_new equals scattering them first, bit for bit, with
    one split or several; the page row under the write position holds
    other values, so the splice is what was read."""
    rng = np.random.default_rng(1)
    q, kp, vp, bt, sl = _paged_inputs(rng, B, H, Hkv, hd, page, slots, dtype,
                                      dev)
    k_new = _t(rng.standard_normal((B, Hkv, hd), np.float32), dev, dtype)
    v_new = _t(rng.standard_normal((B, Hkv, hd), np.float32), dev, dtype)
    w = (sl - 1).long()
    rows = bt[torch.arange(B, device=dev), w // page].long()
    kp_sc, vp_sc = kp.clone(), vp.clone()
    kp_sc[rows, w % page] = k_new
    vp_sc[rows, w % page] = v_new
    spliced = pa.paged_attention(q, kp, vp, bt, sl, k_new=k_new, v_new=v_new)
    scattered = pa.paged_attention(q, kp_sc, vp_sc, bt, sl)
    torch.cuda.synchronize()
    assert torch.equal(spliced, scattered)
    _close(spliced, ref.paged_attention_ref(q, kp, vp, bt, sl, k_new=k_new,
                                            v_new=v_new), dtype)


def test_paged_attention_kernel_reads_a_layer_slice_in_place(dev):
    """The kernel takes one layer of a 5-D plane as a view, with no copy."""
    rng = np.random.default_rng(2)
    L, B, H, Hkv, hd, page, slots = 3, 2, 8, 2, 64, 16, 4
    n_rows = B * slots + 1
    plane_k = _t(rng.standard_normal((L, n_rows, page, Hkv, hd), np.float32),
                 dev)
    plane_v = _t(rng.standard_normal((L, n_rows, page, Hkv, hd), np.float32),
                 dev)
    q = _t(rng.standard_normal((B, H, hd), np.float32), dev)
    bt = _t(np.arange(1, n_rows).reshape(B, slots).astype(np.int32), dev)
    sl = _t(np.array([5, 60], np.int32), dev)
    got = pa.paged_attention(q, plane_k[1], plane_v[1], bt, sl)
    exp = ref.paged_attention_ref(q, plane_k[1].clone(), plane_v[1].clone(),
                                  bt, sl)
    torch.cuda.synchronize()
    _close(got, exp, torch.float32)


@pytest.mark.parametrize("B,C,H,Hkv,hd,page,slots", [
    (2, 4, 4, 2, 8, 4, 4),
    (3, 8, 6, 2, 16, 8, 3),
    (1, 16, 2, 2, 32, 16, 2),
    (2, 8, 8, 1, 64, 4, 6),
    (8, 256, 32, 8, 128, 16, 128),  # qwen3-8b chunk of 256 at s_max 2048
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_prefill_kernel(dev, B, C, H, Hkv, hd, page, slots, dtype):
    rng = np.random.default_rng(3)
    n_rows = B * slots + 3
    q = _t(rng.standard_normal((B, C, H, hd), np.float32), dev, dtype)
    kp = _t(rng.standard_normal((n_rows, page, Hkv, hd), np.float32), dev,
            dtype)
    vp = _t(rng.standard_normal((n_rows, page, Hkv, hd), np.float32), dev,
            dtype)
    bt = _t(rng.permutation(n_rows)[:B * slots].reshape(B, slots)
            .astype(np.int32), dev)
    p0 = rng.integers(0, slots * page - C + 1, B)
    pos = _t((p0[:, None] + np.arange(C)[None, :]).astype(np.int32), dev)
    got = cp.chunk_prefill_attention(q, kp, vp, bt, pos)
    # the plain version takes its score dot in the I/O dtype; the kernel
    # upcasts first — hold both at f32 inputs for the tight check
    exp = ref.chunk_prefill_attention_ref(q.float(), kp.float(), vp.float(),
                                          bt, pos)
    torch.cuda.synchronize()
    _close(got, exp, dtype)


def test_chunk_prefill_kernel_pad_rows_are_finite(dev):
    rng = np.random.default_rng(4)
    B, C, H, Hkv, hd, page, slots = 2, 4, 4, 2, 8, 4, 3
    q = _t(rng.standard_normal((B, C, H, hd), np.float32), dev)
    kp = _t(rng.standard_normal((10, page, Hkv, hd), np.float32), dev)
    vp = _t(rng.standard_normal((10, page, Hkv, hd), np.float32), dev)
    bt = torch.ones((B, slots), dtype=torch.int32, device=dev)
    pos = torch.zeros((B, C), dtype=torch.int32, device=dev)
    out = cp.chunk_prefill_attention(q, kp, vp, bt, pos)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())


def _row_err(got, exp) -> float:
    """The largest error of a row (one query and head) over that row's
    largest magnitude: the rounding of P and of the output gives about
    5e-3, a dropped or misplaced 64-key tile tenths."""
    return float(((got.float() - exp).abs().amax(-1)
                  / exp.abs().amax(-1).clamp_min(1e-30)).max())


@pytest.mark.parametrize("page", [8, 16, 32, 64])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("C,p0", [
    (256, 1024),     # a whole chunk on tile boundaries
    (100, 37),       # C not a multiple of 128, first position not of 64
    (200, 61),
])
def test_chunk_prefill_kernel_wgmma(dev, page, hd, C, p0):
    """The wgmma variant at every page it takes: B = 3 sequences starting
    at p0, p0 + 7, p0 + 14, the last one's second half pad columns
    (position 0), which stay finite; GQA 4."""
    rng = np.random.default_rng(11)
    B, H, Hkv = 3, 8, 2
    slots = -(-(p0 + 14 + C) // page) + 1
    n_rows = B * slots + 3
    bf16 = torch.bfloat16
    q = _t(rng.standard_normal((B, C, H, hd), np.float32), dev, bf16)
    kp = _t(rng.standard_normal((n_rows, page, Hkv, hd), np.float32), dev,
            bf16)
    vp = _t(rng.standard_normal((n_rows, page, Hkv, hd), np.float32), dev,
            bf16)
    bt = _t(rng.permutation(n_rows)[:B * slots].reshape(B, slots)
            .astype(np.int32), dev)
    pos = p0 + 7 * np.arange(B)[:, None] + np.arange(C)[None, :]
    pos[-1, C // 2:] = 0
    pos = _t(pos.astype(np.int32), dev)
    assert cp.variant(bf16, hd, page) == "wgmma" == (
        "wgmma" if cp.takes_wgmma(bf16, hd, page) else "simt")
    before = dict(cp.launches_by_variant)
    got = cp.chunk_prefill_attention(q, kp, vp, bt, pos)
    assert cp.launches_by_variant["wgmma"] == before["wgmma"] + 1
    exp = ref.chunk_prefill_attention_ref(q.float(), kp.float(), vp.float(),
                                          bt, pos)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _close(got, exp, bf16)
    assert _row_err(got, exp) <= 2e-2


@pytest.mark.parametrize("dtype,hd,page", [
    (torch.float32, 128, 16), (torch.bfloat16, 32, 16),
    (torch.bfloat16, 128, 4), (torch.bfloat16, 128, 128)])
def test_chunk_prefill_variant_rule_matches_its_mirror(dev, dtype, hd, page):
    want = "wgmma" if cp.takes_wgmma(dtype, hd, page) else "simt"
    assert cp.variant(dtype, hd, page) == want == "simt"


def test_wrappers_raise_on_inputs_they_do_not_take(dev):
    q = torch.zeros((1, 4, 32), device=dev, dtype=torch.float16)
    kp = torch.zeros((2, 4, 2, 32), device=dev, dtype=torch.float16)
    bt = torch.zeros((1, 1), device=dev, dtype=torch.int32)
    sl = torch.ones((1,), device=dev, dtype=torch.int32)
    with pytest.raises(ValueError):
        pa.paged_attention(q, kp, kp, bt, sl)             # float16
    with pytest.raises(ValueError):
        pa.paged_attention(q.float(), kp.float(), kp.float(), bt.long(), sl)
    with pytest.raises(ValueError):
        cp.chunk_prefill_attention(q.float()[:, None], kp.float(),
                                   kp.float(), bt, sl[None].cpu())


@pytest.mark.parametrize("chunk,horizon", [(0, 1), (16, 4)])
def test_engine_on_the_card_matches_the_cpu(dev, chunk, horizon):
    """The reduced qwen3-8b from one set of weights: the engine on the card
    (kernels) and on the CPU (plain versions) emit identical greedy
    tokens, and the card run never takes a plain version."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime.accounting import MemoryAccountant
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, init_params
    from repro_torch.serving.engine import Engine, Request

    cfg = get_config("qwen3-8b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in (3, 17, 40, 9)]

    def run(device):
        model = build_model(cfg, params, device=device)
        eng = Engine(model, MemoryAccountant(m_total=1e9), max_slots=3,
                     s_max=96, page_tokens=8, prefill_chunk_tokens=chunk,
                     decode_horizon=horizon, device=device)
        for i, p in enumerate(prompts):
            eng.submit(Request(req_id=i, tokens=p, max_new=10))
        return {r.req_id: r.out for r in eng.drain()}

    want = run("cpu")
    ops.reset_counts()
    got = run("cuda")
    assert got == want
    assert pa.launches > 0 and not any(ops.plain_calls.values())
    assert (cp.launches > 0) == bool(chunk)
    assert (fa.launches > 0) == (not chunk)    # monolithic prefill


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd,causal", [
    (1, 128, 128, 4, 4, 64, True),      # MHA
    (2, 77, 77, 8, 2, 64, True),        # GQA 4x, S not a multiple of 32
    (2, 77, 77, 8, 2, 64, False),
    (1, 50, 131, 8, 1, 128, False),     # MQA, cross-length
    (1, 50, 131, 8, 1, 128, True),
    (1, 131, 50, 8, 1, 128, True),      # more queries than keys
    (1, 131, 50, 8, 1, 128, False),
    (1, 397, 397, 32, 8, 128, True),    # qwen3-8b heads, prime length
    # the wgmma variant's tile edges (128 query rows, 64 keys), g = 4
    (1, 1, 1, 8, 2, 128, True),
    (1, 63, 63, 8, 2, 128, True),
    (1, 64, 64, 8, 2, 128, True),
    (1, 65, 65, 8, 2, 128, True),
    (1, 127, 127, 8, 2, 128, True),
    (1, 128, 128, 8, 2, 128, True),
    (1, 129, 129, 8, 2, 128, True),
    (1, 1306, 1306, 32, 8, 128, True),  # the longest smoke prompt
    (2, 129, 129, 4, 4, 64, False),     # hd 64, g = 1, B = 2
    (2, 200, 333, 16, 2, 64, True),     # hd 64, g = 8, Sq < Sk
    (2, 333, 200, 16, 2, 64, False),    # Sq > Sk
    (1, 77, 77, 4, 2, 32, True),        # hd 32: the simt variant
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(dev, B, Sq, Sk, H, Hkv, hd, causal, dtype):
    rng = np.random.default_rng(6)
    q = _t(rng.standard_normal((B, Sq, H, hd), np.float32), dev, dtype)
    k = _t(rng.standard_normal((B, Sk, Hkv, hd), np.float32), dev, dtype)
    v = _t(rng.standard_normal((B, Sk, Hkv, hd), np.float32), dev, dtype)
    want = ("wgmma" if dtype == torch.bfloat16 and hd in (64, 128)
            else "simt")
    assert fa.variant(dtype, hd) == want
    before = dict(fa.launches_by_variant)
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.launches_by_variant[want] == before[want] + 1
    # the oracle upcasts first, as the kernel does; the plain version
    # (score dot in the I/O dtype) agrees with it at f32
    exp = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                  causal=causal)
    torch.cuda.synchronize()
    _close(got, exp, dtype)
    if dtype == torch.float32:
        _close(got, ref.blockwise_attention(q, k, v, causal=causal), dtype)
    else:
        # each row's error over that row's magnitude: the rounding of P and
        # of the output gives about 5e-3, a dropped or misplaced K/V tile
        # tenths
        row = ((got.float() - exp).abs().amax(-1)
               / exp.abs().amax(-1).clamp_min(1e-30))
        assert float(row.max()) <= 2e-2


def _ssd_inputs(rng, B, S, H, P, N, dtype, dev):
    x = rng.standard_normal((B, S, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, S, H, N), np.float32)
    Cm = rng.standard_normal((B, S, H, N), np.float32)
    return (_t(x, dev, dtype), _t(dt, dev), _t(A, dev), _t(Bm, dev, dtype),
            _t(Cm, dev, dtype))


def _scaled_err(got, exp):
    return float((got.float() - exp.float()).abs().max()
                 / (exp.float().abs().max() + 1e-9))


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 128, 4, 32, 16, 32),
    (1, 64, 2, 16, 8, 16),
    (2, 96, 8, 64, 32, 32),
    (1, 67, 4, 16, 16, 32),         # prime S: ragged last chunk
    (1, 1, 2, 16, 16, 256),
    (1, 397, 80, 64, 128, 256),     # mamba2-2.7b heads, prime prompt
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_kernel(dev, B, S, H, P, N, chunk, dtype):
    rng = np.random.default_rng(7)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, B, S, H, P, N, dtype, dev)
    y, state = ssd.ssd_chunk(x, dt, A, Bm, Cm, chunk)
    y_ref, state_ref = ref.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert y.dtype == dtype and state.dtype == torch.float32
    assert state.shape == (B, H, N, P)
    assert _scaled_err(y, y_ref) < (1e-4 if dtype == torch.float32 else 1e-2)
    assert _scaled_err(state, state_ref) < 1e-4
    if S <= 128:   # the sequential oracle, at f32
        y_seq = ref.ssd_chunk_ref(x.float(), dt, A, Bm.float(), Cm.float())
        assert _scaled_err(y.float(), y_seq) < (
            1e-4 if dtype == torch.float32 else 1e-2)


def _head_err(got, exp) -> float:
    diff = (got.float() - exp.float()).abs().amax(dim=(0, 1, 3))
    return float((diff / exp.float().abs().amax(dim=(0, 1, 3))
                  .clamp_min(1e-30)).max())


@pytest.mark.parametrize("N", [64, 128])
@pytest.mark.parametrize("S", [13, 64, 65, 1499])
def test_ssd_chunk_kernel_wgmma(dev, S, N):
    """The wgmma variant at B = 2: one partial chunk, one whole, one and a
    row, and 24 chunks with a ragged end; P 64 as in mamba2-2.7b."""
    rng = np.random.default_rng(12)
    B, H, P = 2, 4, 64
    x, dt, A, Bm, Cm = _ssd_inputs(rng, B, S, H, P, N, torch.bfloat16, dev)
    assert ssd.variant(torch.bfloat16, N, P, 256) == "wgmma"
    assert ssd.takes_wgmma(torch.bfloat16, N, P, 256)
    before = dict(ssd.launches_by_variant)
    y, state = ssd.ssd_chunk(x, dt, A, Bm, Cm, 256)
    assert ssd.launches_by_variant["wgmma"] == before["wgmma"] + 1
    y_ref, state_ref = ref.ssd_chunk_scan(x, dt, A, Bm, Cm, 256)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    assert _scaled_err(y, y_ref) < 1e-2
    assert _head_err(y, y_ref) < 1e-2
    assert _scaled_err(state, state_ref) < 1e-4


def test_ssd_chunk_kernel_wgmma_wide_heads(dev):
    """P 128: two state warpgroups, each with its 64 columns."""
    rng = np.random.default_rng(13)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, 2, 200, 3, 128, 128,
                                   torch.bfloat16, dev)
    assert ssd.variant(torch.bfloat16, 128, 128, 64) == "wgmma"
    y, state = ssd.ssd_chunk(x, dt, A, Bm, Cm, 64)
    y_ref, state_ref = ref.ssd_chunk_scan(x, dt, A, Bm, Cm, 64)
    torch.cuda.synchronize()
    assert _head_err(y, y_ref) < 1e-2
    assert _scaled_err(state, state_ref) < 1e-4


@pytest.mark.parametrize("dtype,N,P,chunk", [
    (torch.float32, 128, 64, 256), (torch.bfloat16, 16, 64, 256),
    (torch.bfloat16, 128, 32, 256), (torch.bfloat16, 128, 64, 32)])
def test_ssd_variant_rule_matches_its_mirror(dev, dtype, N, P, chunk):
    want = "wgmma" if ssd.takes_wgmma(dtype, N, P, chunk) else "simt"
    assert ssd.variant(dtype, N, P, chunk) == want == "simt"


def test_new_wrappers_raise_on_inputs_they_do_not_take(dev):
    q = torch.zeros((1, 8, 4, 32), device=dev)
    k = torch.zeros((1, 8, 3, 32), device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k)                      # 4 % 3 heads
    with pytest.raises(ValueError):
        fa.flash_attention(q.half(), k[:, :, :2].half(), k[:, :, :2].half())
    flat = torch.zeros(1 + 8 * 4 * 64, device=dev, dtype=torch.bfloat16)
    qm = flat[1:].view(1, 8, 4, 64)                       # 2 bytes off
    km = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(qm, km, km)
    x, dt, A, Bm, Cm = _ssd_inputs(np.random.default_rng(8), 1, 8, 2, 16, 8,
                                   torch.float32, dev)
    with pytest.raises(ValueError):
        ssd.ssd_chunk(x, dt.double(), A, Bm, Cm)          # dt not f32
    with pytest.raises(ValueError):
        ssd.ssd_chunk(x, dt, A, Bm[..., :4], Cm)          # B/C mismatch
    with pytest.raises(ValueError):
        ssd.ssd_chunk(x.transpose(1, 2), dt, A, Bm, Cm)   # layout


def test_mamba2_engine_on_the_card_matches_the_cpu(dev):
    """The reduced mamba2-2.7b from one set of weights: the engine on the
    card (the SSD kernel in every prefill) and on the CPU (its plain
    version) emit identical greedy tokens; a prime prompt length takes the
    kernel's ragged last chunk."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime.accounting import MemoryAccountant
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, init_params
    from repro_torch.serving.engine import Engine, Request

    cfg = get_config("mamba2-2.7b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in (3, 17, 41, 90)]

    def run(device):
        model = build_model(cfg, params, device=device)
        eng = Engine(model, MemoryAccountant(m_total=1e9), max_slots=3,
                     s_max=128, prefill_chunk_tokens=16, decode_horizon=4,
                     device=device)
        assert eng.chunk_tokens == 0 and eng.horizon == 1
        for i, p in enumerate(prompts):
            eng.submit(Request(req_id=i, tokens=p, max_new=10))
        return {r.req_id: r.out for r in eng.drain()}

    want = run("cpu")
    ops.reset_counts()
    got = run("cuda")
    assert got == want
    assert ssd.launches == cfg.n_layers * len(prompts)
    assert not any(ops.plain_calls.values())
