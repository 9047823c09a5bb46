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
per head, and 1e-4 for the f32 state in either dtype; its backward against
the plain version in float64, also by each row's error (bf16 3e-2, f32
1e-3), and bitwise over two runs. Cases of
the chunk, flash and SSD kernels (and the SSD backward) assert the variant
(``wgmma`` or ``simt``) they took,
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
    (8, 16, 16, 64, 16, 128),     # whisper-medium decode at s_max 2048
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


@pytest.mark.parametrize("name", ["whisper-medium",
                                  "llama-3.2-vision-11b"])
def test_cross_attention_engine_on_the_card_matches_the_cpu(dev, name):
    """Reduced whisper and vision from one set of weights, each request
    with the same frames or patch embeddings on both devices: identical
    greedy tokens, the knobs degrading to 0 and 1, and on the card paged
    decode and flash (prefill, encoder, cross prefill and cross decode)
    launching and no plain version."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime.accounting import MemoryAccountant
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, init_params
    from repro_torch.serving.engine import Engine, Request

    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in (3, 17, 40, 9)]
    key = cfg.ctx_key
    extras = rng.standard_normal((len(prompts), cfg.n_ctx, cfg.ctx_width),
                                 np.float32)

    def run(device):
        model = build_model(cfg, params, device=device)
        eng = Engine(model, MemoryAccountant(m_total=1e9), max_slots=3,
                     s_max=96, page_tokens=8, prefill_chunk_tokens=16,
                     decode_horizon=4, device=device)
        assert (eng.chunk_tokens, eng.horizon) == (0, 1)
        for i, p in enumerate(prompts):
            eng.submit(Request(req_id=i, tokens=p, max_new=10, extras={
                key: _t(extras[i:i + 1], device)}))
        return {r.req_id: r.out for r in eng.drain()}

    want = run("cpu")
    ops.reset_counts()
    got = run("cuda")
    assert got == want
    assert pa.launches > 0 and fa.launches > 0 and cp.launches == 0
    assert not any(ops.plain_calls.values())


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
    # the cross-attention families: whisper's causal decoder prefill at
    # its 384-token longest prompt, its encoder self-attention and cross
    # prefill over its 1,500 frames, vision's cross prefill over 1,601
    # patches, and both cross decodes (one query row per lane)
    (1, 384, 384, 16, 16, 64, True),
    (1, 1500, 1500, 16, 16, 64, False),
    (1, 397, 1500, 16, 16, 64, False),
    (1, 397, 1601, 32, 8, 128, False),
    (8, 1, 1500, 16, 16, 64, False),
    (8, 1, 1601, 32, 8, 128, False),
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


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128),
                                      (torch.float32, 32)])
@pytest.mark.parametrize("M,C", [(37, 9), (37, 100), (1030, 301)])
def test_chunk_kernel_reads_a_copied_page_behind_a_ragged_suffix(dev, dtype,
                                                                 hd, M, C):
    """A prefix-cache hit on the card: pages aliased from a cached prompt,
    the partially matched one copied on the device (on a full plane, so the
    copy grows it), the suffix's K/V scattered from mid-page, then the
    chunk kernel at B=1 and a ragged C over the sequence's table — against
    its plain version. Past the suffix the copied page still holds the
    other prompt's K/V: the causal mask must hide it."""
    from repro_torch.core.runtime.accounting import MemoryAccountant
    from repro_torch.core.runtime.kv_pool import VirtualKVPool
    from repro_torch.serving.kv_arena import KVArena

    page, L, H, Hkv = 16, 2, 8, 2
    acc = MemoryAccountant(m_total=1e10)
    arena = KVArena(page, init_rows=4, device=dev)
    pool = VirtualKVPool(acc, page_bytes=64, page_tokens=page)
    b = arena.register("m", pool, s_max=2048, n_layers=L, n_kv_heads=Hkv,
                       head_dim=hd, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(M + C)
    n_cached = M // page + 1                  # full pages + the partial one
    assert b.alloc_seq(0, "m", n_cached * page)
    plane = b.plane
    cached = b.seq_rows(0)
    for t in (plane.k, plane.v):
        t[:, cached] = torch.randn((L, n_cached, page, Hkv, hd),
                                   generator=gen, device=dev).to(dtype)
    assert b.alloc_seq(1, "m", M + C + 1, alias_rows=cached)
    while plane.free_rows:                    # the copy must grow the plane
        plane.take_row()
    rows_before = plane.n_rows
    assert b.make_private(1, M // page)
    assert plane.n_rows == 2 * rows_before
    copy = b.seq_rows(1)[M // page]
    assert torch.equal(plane.k[:, copy], plane.k[:, cached[-1]])
    stale = plane.k[:, cached[-1]].clone()
    table = torch.from_numpy(b.row_table(1)).to(dev)
    pos = torch.arange(M, M + C, dtype=torch.int32, device=dev)
    rows = table.long()[(pos // page).long()]
    layer = 1
    for t in (plane.k, plane.v):
        t[layer, rows, (pos % page).long()] = torch.randn(
            (C, Hkv, hd), generator=gen, device=dev).to(dtype)
    q = torch.randn((1, C, H, hd), generator=gen, device=dev).to(dtype)
    cp.launches_by_variant.update(simt=0, wgmma=0)
    got = cp.chunk_prefill_attention(q, plane.k[layer], plane.v[layer],
                                     table[None], pos[None])
    torch.cuda.synchronize()
    want = ref.chunk_prefill_attention_ref(
        q.float(), plane.k[layer].float(), plane.v[layer].float(),
        table[None], pos[None])
    _close(got, want, dtype)
    if dtype == torch.bfloat16:
        assert _row_err(got, want) <= 2e-2
    assert cp.launches_by_variant[cp.variant(dtype, hd, page)] == 1
    # the cached prompt's row kept its contents
    assert torch.equal(plane.k[:, cached[-1]], stale)


@pytest.mark.parametrize("chunk,horizon", [(0, 8), (8, 1)])
def test_prefix_engine_on_the_card_matches_the_cpu(dev, chunk, horizon):
    """The reduced qwen3-8b with the prefix cache on: the card and the CPU
    emit identical tokens and identical hit counters on the workflow of
    ``tests/test_torch_prefix.py``, and the card's suffix prefill runs the
    chunk kernel."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime.accounting import MemoryAccountant
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, init_params
    from repro_torch.serving.engine import Engine, Request

    cfg = get_config("qwen3-8b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    base = [int(t) for t in rng.integers(0, cfg.vocab, 40)]
    prompts = [base, base[:32] + [3, 1, 4, 1, 5], base[:16] + [9] * 20,
               base[:20] + [7] * 11, base[:32] + [3, 1, 4, 1, 5]]

    def run(device):
        model = build_model(cfg, params, device=device)
        eng = Engine(model, MemoryAccountant(m_total=1e9), max_slots=2,
                     s_max=64, prefix_cache=True, prefill_chunk_tokens=chunk,
                     decode_horizon=horizon, device=device)
        out = {}
        for i, p in enumerate(prompts):
            eng.submit(Request(req_id=i, tokens=p, max_new=8))
            out.update({r.req_id: (r.out, r.prefill_avoided)
                        for r in eng.drain()})
        assert eng.arena.check_mirror()
        return out, (eng.arena.pages_aliased, eng.arena.cow_copies)

    want = run("cpu")
    ops.reset_counts()
    got = run("cuda")
    assert got == want
    assert [got[0][i][1] for i in range(5)] == [0, 32, 16, 20, 32]
    assert cp.launches > 0 and pa.launches > 0
    assert not any(ops.plain_calls.values())


def test_offload_and_activation_move_the_weights(dev):
    """A node on the card: building it drops the models' device copies,
    activation copies the pinned host tier back (the same bytes), and an
    offload frees every byte of the weights the accountant drops."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    from repro_torch.serving.engine import Request
    from repro_torch.serving.node_runtime import NodeRuntime

    cfg = get_config("qwen3-8b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model = build_model(cfg, params, device=dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    node = NodeRuntime(0, 0, {"q": model}, {"q": model.param_tree()},
                       hbm_budget=1e9, max_slots=2, s_max=64, device=dev)
    weight_bytes = node.profiles["q"].weight_bytes
    assert before - torch.cuda.memory_allocated() >= weight_bytes
    assert all(t.is_pinned() for t in node.host_params["q"].values())
    node.activate("q")
    for n, p in model.named_parameters():
        assert p.is_cuda and torch.equal(p.cpu(), node.host_params["q"][n])
    node.submit("q", Request(req_id=0, tokens=[5, 6, 7], max_new=4))
    while node.has_work():
        node.step()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    node.sleep("q")
    freed = before - torch.cuda.memory_allocated()
    assert freed >= weight_bytes and "q" not in node.acc.weights
    assert node.activate("q") > 0
    assert node.engines["q"].model is model and model.device.type == "cuda"


# ------------------------------------------- the MoE and hybrid configs
# (H, Hkv) of moonshot-v1-16b-a3b (g = 1), llama4-scout-17b-a16e (g = 5)
# and qwen3-32b / qwen1.5-110b (g = 8), all at hd 128
ZOO_HEADS = [(16, 16), (40, 8), (64, 8)]


@pytest.mark.parametrize("H,Hkv", ZOO_HEADS)
def test_attention_kernels_at_the_zoo_group_sizes(dev, H, Hkv):
    """Paged decode (8 lanes, splice on), the chunk kernel's wgmma variant
    (a 256-row chunk with pad rows) and flash's wgmma variant (causal, a
    prime length) in bf16 at each group size, against their plain
    versions held at f32 on the same values."""
    rng = np.random.default_rng(H + Hkv)
    bf16, hd, page, slots = torch.bfloat16, 128, 16, 32
    q, kp, vp, bt, sl = _paged_inputs(rng, 8, H, Hkv, hd, page, slots, bf16,
                                      dev)
    k_new = _t(rng.standard_normal((8, Hkv, hd), np.float32), dev, bf16)
    v_new = _t(rng.standard_normal((8, Hkv, hd), np.float32), dev, bf16)
    got = pa.paged_attention(q, kp, vp, bt, sl, k_new=k_new, v_new=v_new)
    w = (sl.clamp_min(1) - 1).long()
    rows = bt[torch.arange(8, device=dev), w // page].long()
    kp[rows, w % page], vp[rows, w % page] = k_new, v_new
    _close(got, ref.paged_attention_ref(q, kp, vp, bt, sl), bf16)
    C = 256
    qc = _t(rng.standard_normal((3, C, H, hd), np.float32), dev, bf16)
    pos = 100 + 7 * np.arange(3)[:, None] + np.arange(C)[None, :]
    pos[-1, C // 2:] = 0
    pos = _t(pos.astype(np.int32), dev)
    assert cp.variant(bf16, hd, page) == "wgmma"
    got = cp.chunk_prefill_attention(qc, kp, vp, bt[:3], pos)
    exp = ref.chunk_prefill_attention_ref(qc.float(), kp.float(), vp.float(),
                                          bt[:3], pos)
    assert bool(torch.isfinite(got).all())
    _close(got, exp, bf16)
    assert _row_err(got, exp) <= 2e-2
    S = 397
    qf = _t(rng.standard_normal((1, S, H, hd), np.float32), dev, bf16)
    kf = _t(rng.standard_normal((1, S, Hkv, hd), np.float32), dev, bf16)
    vf = _t(rng.standard_normal((1, S, Hkv, hd), np.float32), dev, bf16)
    assert fa.variant(bf16, hd) == "wgmma"
    got = fa.flash_attention(qf, kf, vf, causal=True)
    exp = ref.blockwise_attention(qf.float(), kf.float(), vf.float(), True)
    torch.cuda.synchronize()
    _close(got, exp, bf16)
    assert _row_err(got, exp) <= 2e-2


@pytest.mark.parametrize("S", [1, 13, 64, 65, 397])
def test_ssd_chunk_kernel_at_jamba_widths(dev, S):
    """jamba-v0.1-52b's scan in bf16: N = 16, P = 64, 128 heads, chunk 256
    capped at 64, which only the simt variant takes; y by its scaled and
    per-head error (1e-2), the f32 state 1e-4."""
    rng = np.random.default_rng(S)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, 1, S, 128, 64, 16, torch.bfloat16,
                                   dev)
    assert ssd.variant(torch.bfloat16, 16, 64, 256) == "simt"
    before = dict(ssd.launches_by_variant)
    y, state = ssd.ssd_chunk(x, dt, A, Bm, Cm, 256)
    assert ssd.launches_by_variant["simt"] == before["simt"] + 1
    y_ref, state_ref = ref.ssd_chunk_scan(x, dt, A, Bm, Cm, 256)
    torch.cuda.synchronize()
    assert _scaled_err(y, y_ref) < 1e-2
    assert _head_err(y, y_ref) < 1e-2
    assert _scaled_err(state, state_ref) < 1e-4


@pytest.mark.parametrize("name,chunk,horizon", [
    ("moonshot-v1-16b-a3b", 16, 4), ("moonshot-v1-16b-a3b", 0, 4),
    ("jamba-v0.1-52b", 16, 4)])
def test_moe_and_hybrid_engines_on_the_card_match_the_cpu(dev, name, chunk,
                                                          horizon):
    """Reduced moonshot (chunked and monolithic) and jamba (its knobs
    degrade: monolithic prefill, one-token decode) from one set of
    weights: identical greedy tokens on the card and the CPU, every kernel
    of the path launched and no plain version on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core.runtime.accounting import MemoryAccountant
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, init_params
    from repro_torch.serving.engine import Engine, Request

    cfg = get_config(name).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(14)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in (3, 17, 41, 9)]

    def run(device):
        model = build_model(cfg, params, device=device)
        eng = Engine(model, MemoryAccountant(m_total=1e9), max_slots=3,
                     s_max=128, page_tokens=8, prefill_chunk_tokens=chunk,
                     decode_horizon=horizon, device=device)
        for i, p in enumerate(prompts):
            eng.submit(Request(req_id=i, tokens=p, max_new=10))
        return {r.req_id: r.out for r in eng.drain()}

    want = run("cpu")
    ops.reset_counts()
    got = run("cuda")
    assert got == want
    assert pa.launches > 0 and not any(ops.plain_calls.values())
    if cfg.family == "hybrid":
        assert fa.launches == cfg.n_attn_layers * len(prompts)
        assert ssd.launches == (cfg.n_layers - cfg.n_attn_layers) * len(
            prompts)
    else:
        assert (cp.launches > 0) == bool(chunk)
        assert (fa.launches > 0) == (not chunk)


# ------------------------------------------------------------- training
# (B, Sq, Sk, H, Hkv, hd, causal): the training paths' kinds of shape, at
# a test's size, ragged lengths among them
BWD_SHAPES = [
    (2, 256, 256, 8, 2, 128, True),      # qwen3-like, g = 4
    (2, 200, 200, 16, 16, 64, False),    # whisper's encoder kind
    (2, 97, 97, 4, 4, 64, True),         # ragged causal
    (1, 96, 300, 8, 2, 128, False),      # cross, Sq < Sk
    (1, 150, 70, 4, 1, 64, True),        # causal with Sk < Sq
    (1, 77, 77, 4, 2, 32, True),         # hd 32: simt in either dtype
]


def _grad_row_err(got, want):
    """Each row's error over the larger of its magnitude and 1% of the
    tensor's (a causal first row's dq is zero up to rounding)."""
    diff = (got.float() - want).abs()
    floor = 1e-2 * float(want.abs().max())
    return float((diff.amax(-1) / want.abs().amax(-1).clamp_min(floor))
                 .max())


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd,causal", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel(dev, B, Sq, Sk, H, Hkv, hd, causal, dtype):
    """dq, dk, dv against the plain backward on the same inputs (the
    kernel's o and lse): f32 to 1e-5; bf16 (P and dS rounded for their
    products) to 3e-2 of each row's magnitude. lse against the plain
    forward's to 1e-5; the variant the rule gives."""
    rng = np.random.default_rng(9)
    q, dout = (_t(rng.standard_normal((B, Sq, H, hd), np.float32), dev,
                  dtype) for _ in range(2))
    k, v = (_t(rng.standard_normal((B, Sk, Hkv, hd), np.float32), dev,
               dtype) for _ in range(2))
    want_variant = ("wgmma" if dtype == torch.bfloat16 and hd in (64, 128)
                    else "simt")
    assert fa.bwd_variant(dtype, hd) == want_variant
    before = dict(fa.bwd_launches_by_variant)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, dout, causal)
    assert fa.bwd_launches_by_variant[want_variant] == \
        before[want_variant] + 1
    _, lse_ref = ref.flash_attention_lse(q.float(), k.float(), v.float(),
                                         causal)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       o.float(), lse, dout.float(), causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-5)
    for got, w in zip(grads, want):
        assert got.dtype == dtype and got.shape == w.shape
        if dtype == torch.float32:
            torch.testing.assert_close(got, w, **F32_TOL)
        else:
            assert _grad_row_err(got, w) <= 3e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_backward_runs_are_bitwise_equal(dev, dtype):
    rng = np.random.default_rng(10)
    q, dout = (_t(rng.standard_normal((2, 300, 8, 128), np.float32), dev,
                  dtype) for _ in range(2))
    k, v = (_t(rng.standard_normal((2, 300, 2, 128), np.float32), dev,
               dtype) for _ in range(2))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    a = fa.flash_attention_bwd(q, k, v, o, lse, dout, True)
    b = fa.flash_attention_bwd(q, k, v, o, lse, dout, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# the wgmma backward's tile edges: 128-key blocks of dkdv (64 keys per
# warpgroup), 64-row query tiles, 128-row blocks of dq: (Sq, Sk, causal)
BWD_EDGES = [
    (96, 127, False),    # a block one key short
    (128, 128, True),    # exactly one block, the diagonal
    (131, 129, True),    # one key into a second block
    (40, 128, True),     # Sq < 64: one ragged query tile
    (40, 129, False),
    (300, 127, True),    # causal with Sk < Sq
    (257, 129, False),   # Sq > Sk, one row into a third dq block
]


@pytest.mark.parametrize("Sq,Sk,causal", BWD_EDGES)
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [1, 4])
def test_flash_backward_wgmma_at_its_tile_edges(dev, Sq, Sk, causal, hd, g):
    """The bf16 wgmma variant at B = 2, two kv heads: dq, dk and dv against
    the plain backward on the kernel's o and lse, each row's error over
    its magnitude to 3e-2 and the largest to 5e-2 (chip_smoke.py's
    limits), and two runs bitwise equal."""
    B, Hkv, bf16 = 2, 2, torch.bfloat16
    H = g * Hkv
    rng = np.random.default_rng(Sq * 1000 + Sk + hd + g)
    q, dout = (_t(rng.standard_normal((B, Sq, H, hd), np.float32), dev,
                  bf16) for _ in range(2))
    k, v = (_t(rng.standard_normal((B, Sk, Hkv, hd), np.float32), dev,
               bf16) for _ in range(2))
    assert fa.bwd_variant(bf16, hd) == "wgmma"
    before = fa.bwd_launches_by_variant["wgmma"]
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, dout, causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, dout, causal)
    assert fa.bwd_launches_by_variant["wgmma"] == before + 2
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       o.float(), lse, dout.float(), causal)
    torch.cuda.synchronize()
    for got, w, a in zip(grads, want, again):
        assert got.dtype == bf16 and got.shape == w.shape
        assert torch.equal(got, a)
        assert float((got.float() - w).abs().max()) <= 5e-2
        assert _grad_row_err(got, w) <= 3e-2


# a context-parallel rank's queries at q_offset: (Sq, Sk, q_offset). An
# fsdp_cp 1 x 2 rank's 512 rows over 1,024 keys (ranks 0 and 1); rank 3 of
# 8 over 1,000 tokens, whose diagonal cuts the 64-row tiles; offsets of a
# few rows, and one past every key (every key visible)
BWD_OFFSETS = [(512, 1024, 0), (512, 1024, 512), (125, 1000, 375),
               (70, 200, 3), (131, 131, 61), (40, 90, 100)]


@pytest.mark.parametrize("Sq,Sk,off", BWD_OFFSETS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernel_at_a_query_offset(dev, Sq, Sk, off, dtype):
    """The training forward and the backward with ``q_offset`` (query i
    sees keys j <= i + q_offset) at B = 2, 8/2 heads of 128: lse against
    the plain forward's at the offset to 1e-4; dq, dk, dv against the
    plain backward on the kernel's o and lse, f32 to 1e-5, bf16 (the
    wgmma variant) each row's error to 3e-2 of its magnitude and the
    largest to 5e-2; two runs bitwise equal; each launch counted among
    those with an offset where it is not 0."""
    B, H, Hkv, hd = 2, 8, 2, 128
    rng = np.random.default_rng(Sq + Sk + off)
    q, dout = (_t(rng.standard_normal((B, Sq, H, hd), np.float32), dev,
                  dtype) for _ in range(2))
    k, v = (_t(rng.standard_normal((B, Sk, Hkv, hd), np.float32), dev,
               dtype) for _ in range(2))
    before = dict(fa.offset_launches)
    o, lse = fa.flash_attention_fwd(q, k, v, True, off)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, dout, True, off)
    again = fa.flash_attention_bwd(q, k, v, o, lse, dout, True, off)
    shifted = int(off > 0)
    assert fa.offset_launches["flash_attention_lse"] == \
        before["flash_attention_lse"] + shifted
    assert fa.offset_launches["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 2 * shifted
    _, lse_ref = ref.flash_attention_lse(q.float(), k.float(), v.float(),
                                         True, off)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       o.float(), lse, dout.float(), True,
                                       off)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
    for got, w, a in zip(grads, want, again):
        assert got.dtype == dtype and got.shape == w.shape
        assert torch.equal(got, a)
        if dtype == torch.float32:
            torch.testing.assert_close(got, w, **F32_TOL)
        else:
            assert float((got.float() - w).abs().max()) <= 5e-2
            assert _grad_row_err(got, w) <= 3e-2


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 64),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 128)])
def test_serving_output_is_unchanged_by_the_lse_output(dev, dtype, hd):
    """The training forward writes lse beside the same output bits: the
    serving forward (lse pointer null) and it agree bitwise."""
    rng = np.random.default_rng(11)
    q = _t(rng.standard_normal((2, 333, 16, hd), np.float32), dev, dtype)
    k, v = (_t(rng.standard_normal((2, 333, 4, hd), np.float32), dev, dtype)
            for _ in range(2))
    for causal in (True, False):
        served = fa.flash_attention(q, k, v, causal)
        trained, _ = fa.flash_attention_fwd(q, k, v, causal)
        assert torch.equal(served, trained)


def test_flash_attention_fn_equals_autograd_of_the_plain_version(dev):
    """Under grad on the card, ``ops.flash_attention`` is the training
    forward and the backward kernel (f32: to 1e-5 of autograd through the
    plain version); without grad, the serving forward."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(12)
    ts = [_t(rng.standard_normal(s, np.float32), dev).requires_grad_()
          for s in ((2, 50, 8, 64), (2, 50, 2, 64), (2, 50, 2, 64))]
    dout = _t(rng.standard_normal((2, 50, 8, 64), np.float32), dev)
    ops.reset_counts()
    ops.flash_attention(*ts, causal=True).backward(dout)
    got = [t.grad.clone() for t in ts]
    c = ops.counts()
    assert c["launches"]["flash_attention_lse"] == 1
    assert c["launches"]["flash_attention_bwd"] == 1
    assert c["launches"]["flash_attention"] == 0
    assert not any(ops.plain_calls.values())
    for t in ts:
        t.grad = None
    ref.blockwise_attention(*ts, True).backward(dout)
    for g, t in zip(got, ts):
        torch.testing.assert_close(g, t.grad, **F32_TOL)
    with torch.no_grad():
        ops.flash_attention(*ts, causal=True)
    assert ops.counts()["launches"]["flash_attention"] == 1


def test_ssd_chunk_under_grad_runs_the_kernels_or_raises(dev):
    """Under grad the scan runs its forward kernel and, on backward, the
    hand-written backward, never the plain version; it raises, before any
    launch, at widths the backward does not take (the simt variant at
    N = P = 128 needs more shared memory than a block has) rather than
    falling back. In bf16 at chunks of 64 those widths take the wgmma
    variant, which does."""
    from repro_torch.kernels import ops
    x, dt, A, Bm, Cm = _ssd_inputs(np.random.default_rng(13), 1, 16, 2, 16,
                                   8, torch.float32, dev)
    x.requires_grad_()
    ops.reset_counts()
    y, _ = ops.ssd_chunk(x, dt, A, Bm, Cm, 8)
    y.sum().backward()
    c = ops.counts()
    assert c["launches"]["ssd_chunk"] == 1
    assert c["launches"]["ssd_chunk_bwd"] == 1
    assert x.grad is not None and not any(ops.plain_calls.values())
    wide = [t.requires_grad_() if t.is_floating_point() else t
            for t in _ssd_inputs(np.random.default_rng(13), 1, 16, 2, 128,
                                 128, torch.float32, dev)]
    with pytest.raises(ValueError, match="shared memory"):
        ops.ssd_chunk(*wide, 64)
    assert ops.counts()["launches"]["ssd_chunk"] == 1
    with torch.no_grad():
        ops.ssd_chunk(*wide, 64)
    wide = [t.detach().to(torch.bfloat16).requires_grad_()
            if t.dtype == torch.float32 and t.dim() == 4 else t.detach()
            for t in wide]
    y, _ = ops.ssd_chunk(*wide, 64)
    y.float().sum().backward()
    c = ops.counts()
    assert c["launches_by_variant"]["ssd_chunk_bwd"]["wgmma"] == 1
    assert wide[0].grad is not None and not any(ops.plain_calls.values())


SSD_BWD_SHAPES = [
    (1, 131, 80, 64, 128, 256, True),    # mamba2-2.7b's heads, ragged
    (2, 256, 8, 64, 128, 256, False),
    (1, 200, 16, 64, 16, 256, True),     # jamba's widths
    (2, 67, 4, 16, 16, 32, True),        # the reduced configs' chunk
    (1, 5, 2, 8, 4, 64, False),          # one short chunk
    # the wgmma variant's edges in bf16: one token, a chunk less and more
    # than one, prime lengths; N and P 64 and 128; B 2
    (2, 1, 3, 64, 64, 256, True),
    (2, 63, 2, 64, 128, 256, False),
    (2, 65, 2, 128, 64, 256, True),
    (2, 131, 2, 128, 128, 64, False),
    (2, 257, 3, 64, 128, 256, True),
    (2, 257, 2, 128, 128, 256, True),
]


def _ssd_bwd_case(rng, B, S, H, P, N, dtype, dev, with_state):
    x, dt, A, Bm, Cm = _ssd_inputs(rng, B, S, H, P, N, dtype, dev)
    dy = _t(rng.standard_normal((B, S, H, P), np.float32), dev, dtype)
    ds = (_t(rng.standard_normal((B, H, N, P), np.float32), dev)
          if with_state else None)
    return x, dt, A, Bm, Cm, dy, ds


def _row_err(got, exp) -> float:
    """The largest row error over the larger of the row's magnitude and 1%
    of the tensor's."""
    g, e = got.float(), exp.float()
    floor = max(1e-2 * float(e.abs().max()), 1e-30)
    return float(((g - e).abs().amax(-1)
                  / e.abs().amax(-1).clamp_min(floor)).max())


@pytest.mark.parametrize("B,S,H,P,N,chunk,with_state", SSD_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_kernel(dev, B, S, H, P, N, chunk, with_state, dtype):
    """The backward kernel against its plain version (ref.ssd_chunk_bwd, in
    float64 on the same inputs: at B 2, S 257, N = P = 128 dA is the sum of
    terms far larger than itself, and the plain version in f32 is about as
    far from the float64 result as the kernel is, on the other side):
    each gradient's largest error over its largest magnitude below 1e-4 in
    f32 (sums in another order) and 1e-2 for the bf16 dx, dB, dC (one
    rounding of the output), and each row's below 1e-3 and 3e-2; the
    variant the rule names, two runs bitwise equal.
    Where the simt variant's block would need more shared memory than the
    card has (f32 at N = P = 128), it raises before any launch."""
    x, dt, A, Bm, Cm, dy, ds = _ssd_bwd_case(np.random.default_rng(17), B,
                                             S, H, P, N, dtype, dev,
                                             with_state)
    want_variant = ("wgmma" if ssd.takes_wgmma_bwd(dtype, N, P, chunk)
                    else "simt")
    assert ssd.bwd_variant(dtype, N, P, chunk) == want_variant
    if ssd.bwd_smem(dtype, N, P, chunk) > ssd.MAX_SMEM:
        with pytest.raises(ValueError, match="shared memory"):
            ssd.ssd_chunk_bwd(x, dt, A, Bm, Cm, dy, ds, chunk)
        assert want_variant == "simt"
        return
    before = dict(ssd.bwd_launches_by_variant)
    got = ssd.ssd_chunk_bwd(x, dt, A, Bm, Cm, dy, ds, chunk)
    again = ssd.ssd_chunk_bwd(x, dt, A, Bm, Cm, dy, ds, chunk)
    assert ssd.bwd_launches_by_variant[want_variant] == \
        before[want_variant] + 2
    want = ref.ssd_chunk_bwd(x.double(), dt.double(), A.double(),
                             Bm.double(), Cm.double(), dy.double(),
                             ds.double() if ds is not None else None, chunk)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for name, g, w, t in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                             (x, dt, A, Bm, Cm)):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        lim, lim_row = ((1e-2, 3e-2) if g.dtype == torch.bfloat16
                        else (1e-4, 1e-3))
        assert _scaled_err(g, w) < lim, (name, _scaled_err(g, w))
        assert _row_err(g, w) < lim_row, (name, _row_err(g, w))


@pytest.mark.parametrize("dtype,N,P,chunk", [
    (torch.bfloat16, 128, 64, 256), (torch.bfloat16, 64, 128, 64),
    (torch.bfloat16, 128, 128, 64), (torch.bfloat16, 64, 64, 256),
    (torch.float32, 128, 64, 256), (torch.bfloat16, 16, 64, 256),
    (torch.bfloat16, 128, 32, 256), (torch.bfloat16, 128, 64, 32),
    (torch.bfloat16, 96, 64, 64)])
def test_ssd_bwd_variant_rule_matches_its_mirror(dev, dtype, N, P, chunk):
    """The backward launcher's rule (C) equals takes_wgmma_bwd (Python),
    and takes the variant the forward takes."""
    want = "wgmma" if ssd.takes_wgmma_bwd(dtype, N, P, chunk) else "simt"
    assert ssd.bwd_variant(dtype, N, P, chunk) == want
    assert want == ssd.variant(dtype, N, P, chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_ssd_backward_runs_are_bitwise_equal(dev, dtype):
    args = _ssd_bwd_case(np.random.default_rng(18), 2, 300, 8, 64, 128,
                         dtype, dev, True)
    a = ssd.ssd_chunk_bwd(*args, 256)
    b = ssd.ssd_chunk_bwd(*args, 256)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_ssd_chunk_fn_equals_autograd_of_the_plain_version(dev):
    """f32: ops.ssd_chunk under grad on the card (the forward and backward
    kernels) against autograd of the plain scan on the card, with and
    without a gradient on the final state."""
    from repro_torch.kernels import ops
    ins = _ssd_inputs(np.random.default_rng(19), 2, 97, 4, 32, 16,
                      torch.float32, dev)
    dy = torch.randn((2, 97, 4, 32), device=dev)
    ds = torch.randn((2, 4, 16, 32), device=dev)
    for with_state in (False, True):
        grads = []
        for fn in (ops.ssd_chunk, ref.ssd_chunk_scan):
            ts = [t.clone().requires_grad_() for t in ins]
            y, st = fn(*ts, 32)
            loss = (y * dy).sum() + ((st * ds).sum() if with_state else 0)
            grads.append(torch.autograd.grad(loss, ts))
        for g, w in zip(*grads):
            assert _scaled_err(g, w) < 1e-4


def test_a_train_step_on_the_card_equals_the_cpu(dev):
    """Reduced qwen3-8b in f32: one ``make_train_step`` (two microbatches)
    on the card (the flash kernels) and on the CPU (the plain versions)
    from the same weights and batch: loss, grad norm and parameters to
    1e-5."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, init_params
    from repro_torch.training import OptConfig, adamw_init, make_train_step
    from repro_torch.tree import leaves, tree_map
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(),
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab, (4, 33)).astype(np.int32))
    out = {}
    for d in ("cpu", dev):
        model = build_model(cfg, tree_map(torch.clone, params), device=d,
                            trainable=True)
        p = model.param_tree()
        opt = adamw_init(p)
        batch = {"tokens": toks[:, :-1].to(d), "labels": toks[:, 1:].to(d)}
        ops.reset_counts()
        p, opt, m = make_train_step(model, OptConfig(eps=1e-6), 2)(
            p, opt, batch)
        out[str(d)] = ([t.cpu() for t in leaves(p)],
                       {k: float(v) for k, v in m.items()})
    assert not any(ops.plain_calls.values())
    (pc, mc), (pg, mg) = out["cpu"], out[str(dev)]
    for k in mc:
        assert abs(mc[k] - mg[k]) <= 1e-5 * max(1.0, abs(mc[k])), k
    for a, b in zip(pc, pg):
        torch.testing.assert_close(b, a, **F32_TOL)


def test_train_lm_killed_and_resumed_on_the_card_equals_an_uninterrupted_run(
        dev, tmp_path, monkeypatch):
    """``train_lm.main`` on the card (it turns on deterministic algorithms
    and cuBLAS's fixed workspace itself): a reduced qwen3-8b in bf16 at hd
    64, so every attention trains through flash's wgmma variants, killed in
    its fourth step and resumed from the checkpoint of step 2, ends with
    the uninterrupted run's loss, grad norm and parameters, bit for bit."""
    import dataclasses
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.training import train_lm
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), head_dim=64,
                              dtype=torch.bfloat16, name="qwen3-tiny-bf16")
    args = ["--device", "cuda", "--steps", "6", "--batch", "4", "--seq",
            "129", "--n-micro", "2", "--ckpt-every", "2"]
    was = torch.are_deterministic_algorithms_enabled()
    ops.reset_counts()
    whole = train_lm.main(args + ["--ckpt", str(tmp_path / "a")], cfg)
    assert torch.are_deterministic_algorithms_enabled() == was
    assert whole["start"] == 0 and np.isfinite(whole["loss"])
    c = ops.counts()
    assert c["launches_by_variant"]["flash_attention_bwd"] == {
        "simt": 0, "wgmma": 6 * 2 * cfg.n_layers}
    assert not any(ops.plain_calls.values())

    make = train_lm.make_train_step
    calls = []

    class Killed(Exception):
        pass

    def dying(*a, **k):
        step = make(*a, **k)

        def run(*args):
            calls.append(1)
            if len(calls) == 4:
                raise Killed
            return step(*args)
        return run

    monkeypatch.setattr(train_lm, "make_train_step", dying)
    with pytest.raises(Killed):
        train_lm.main(args + ["--ckpt", str(tmp_path / "b")], cfg)
    assert latest_step(str(tmp_path / "b")) == 2
    monkeypatch.setattr(train_lm, "make_train_step", make)
    resumed = train_lm.main(args + ["--ckpt", str(tmp_path / "b")], cfg)
    assert resumed["start"] == 2
    assert resumed["loss"] == whole["loss"]
    assert resumed["grad_norm"] == whole["grad_norm"]
    model = train_lm.build_model(cfg, device="cpu", trainable=True)
    like = (model.param_tree(), train_lm.adamw_init(model.param_tree()))
    a = restore(str(tmp_path / "a"), like)[0]
    b = restore(str(tmp_path / "b"), like)[0]
    assert all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(leaves(a), leaves(b)))


# ------------------------------------------------------- the launch tooling
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dry_run_argument_bytes_equal_the_cards_tensors(dev, kind):
    """A reduced cell counted on meta: its argument bytes are the bytes of
    the same step's arguments made on the card; the step on meta launched
    no kernel and ran no plain version, and the card's step launched the
    kernels the count charged."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import counter, dryrun
    from repro_torch.models import build_model
    from repro_torch.training import build_cell
    cfg = get_config("qwen3-8b").reduced()
    shape = dict(kind=kind, seq_len=64, global_batch=2)
    ops.reset_counts()
    rec = dryrun.count_cell(cfg, shape, n_micro=2 if kind == "train" else 1)
    c = ops.counts()
    assert not any(c["launches"].values()) and not any(
        c["plain_calls"].values())
    model = build_model(cfg, device=dev, trainable=kind == "train")
    step, args = build_cell(model, shape,
                            n_micro=2 if kind == "train" else 1)
    assert rec["memory"]["argument_bytes"] == counter.tensor_bytes(args)
    with torch.set_grad_enabled(kind == "train"):
        step(*args)
    torch.cuda.synchronize()
    c = ops.counts()
    assert not any(c["plain_calls"].values())
    for name, k in rec["kernels"].items():
        assert c["launches"][name] == k["calls"], name


def test_moved_cost_functions_give_the_smokes_bounds(dev):
    """The bounds chip_smoke.py printed before the cost functions moved to
    repro_torch.kernels.cost (re-exported by repro_torch.launch.roofline):
    the SSD backward at mamba2-2.7b's 2 x 4,096 (0.277 ms, bytes) and the
    flash backward at qwen3-8b's causal 2 x 4,096 (0.695 ms,
    operations)."""
    from repro_torch.launch import roofline as rl
    ms, by = rl.bound(*rl.ssd_bwd_cost(2, 4096, 80, 64, 128, 64, 2, False),
                      rl.H100.peak_flops)
    assert by == "bytes" and round(ms, 3) == 0.277
    ms, by = rl.bound(*rl.bwd_cost(2, 4096, 4096, 32, 8, 128, True, 2),
                      rl.H100.peak_flops)
    assert by == "operations" and round(ms, 3) == 0.695


@pytest.mark.parametrize("S,tp,H,Hkv,hd", [
    (256, 2, 8, 2, 64),
    (400, 4, 8, 2, 128),         # blocks of 100 rows: a ragged query tile
    (2048, 2, 32, 8, 128),       # a 1 x 2 rank of qwen3-8b's 2 x 1,024
    (130, 2, 4, 4, 32),          # hd 32: simt in both dtypes
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_with_a_query_offset(dev, S, tp, H, Hkv, hd,
                                                    dtype):
    """A context-parallel rank's block: query rows r S/tp .. of a causal
    sequence over all S keys, ``q_offset`` r S/tp, for each rank r, against
    ``ref.flash_attention_ref(q_offset=)`` (bf16 also by each row's error
    over its magnitude) and against those rows of the whole sequence's
    attention; the variant is (dtype, hd)'s and a launch is counted."""
    rng = np.random.default_rng(S + tp)
    B = 2
    q = _t(rng.standard_normal((B, S, H, hd), np.float32), dev, dtype)
    k = _t(rng.standard_normal((B, S, Hkv, hd), np.float32), dev, dtype)
    v = _t(rng.standard_normal((B, S, Hkv, hd), np.float32), dev, dtype)
    want_variant = ("wgmma" if dtype == torch.bfloat16 and hd in (64, 128)
                    else "simt")
    assert fa.variant(dtype, hd) == want_variant
    whole = fa.flash_attention(q, k, v, causal=True)
    s = S // tp
    for r in range(tp):
        qr = q[:, r * s:(r + 1) * s].contiguous()
        before = fa.launches_by_variant[want_variant]
        got = fa.flash_attention(qr, k, v, causal=True, q_offset=r * s)
        assert fa.launches_by_variant[want_variant] == before + 1
        exp = ref.flash_attention_ref(qr.float(), k.float(), v.float(),
                                      True, q_offset=r * s)
        torch.cuda.synchronize()
        _close(got, exp, dtype)
        _close(got, whole[:, r * s:(r + 1) * s], dtype)
        if dtype == torch.bfloat16:
            row = ((got.float() - exp).abs().amax(-1)
                   / exp.abs().amax(-1).clamp_min(1e-30))
            assert float(row.max()) <= 2e-2
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(q, k, v, causal=True, q_offset=-1)


@pytest.mark.parametrize("B,H,Hkv,hd,page,slots", [
    (2, 8, 2, 64, 16, 8),
    (8, 32, 8, 128, 16, 128),     # qwen3-8b's decode: 16 splits
    (5, 32, 8, 128, 16, 33),      # a 1 x 2 rank's 528 rows of fsdp_cp
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_log_sum_exp(dev, B, H, Hkv, hd, page,
                                            slots, dtype):
    """With ``return_lse``: lanes of length 0 (output 0, log-sum-exp -inf),
    1, a span's edge and the whole window against the plain version's (the
    log-sum-exp to 1e-4 in both dtypes: f32 scores), the other lanes'
    outputs bitwise those of the launch without it (whose lengths are
    clamped to 1); and a cache split in two blocks of rows, each attended
    alone and merged by the log-sum-exps, against the whole."""
    rng = np.random.default_rng(12)
    q, kp, vp, bt, _ = _paged_inputs(rng, B, H, Hkv, hd, page, slots, dtype,
                                     dev)
    n = page * slots
    lens = [0, 1, n, max(n - 33, 2), 0, n // 2, 17, 3][:B]
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    got, lse = pa.paged_attention(q, kp, vp, bt, sl, return_lse=True)
    plain = pa.paged_attention(q, kp, vp, bt, sl)
    exp, exp_lse = ref.paged_attention_ref(q, kp, vp, bt, sl,
                                           return_lse=True)
    torch.cuda.synchronize()
    _close(got, exp, dtype)
    torch.testing.assert_close(lse, exp_lse, rtol=1e-4, atol=1e-4)
    empty = sl == 0
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))
    assert torch.isneginf(lse[empty]).all()
    assert torch.equal(got[~empty], plain[~empty])
    # two blocks of rows of every lane, merged by their log-sum-exps
    parts = []
    for lo, w in ((0, slots // 2), (slots // 2, slots - slots // 2)):
        local = (sl - lo * page).clamp(0, w * page).int()
        parts.append(pa.paged_attention(q, kp, vp, bt[:, lo:lo + w]
                                        .contiguous(), local,
                                        return_lse=True))
    lses = torch.stack([p[1] for p in parts])
    wts = torch.exp(lses - lses.amax(0))[..., None]
    merged = ((torch.stack([p[0].float() for p in parts]) * wts).sum(0)
              / wts.sum(0).clamp_min(1e-30))
    _close(merged[~empty], exp[~empty].float(), dtype)
