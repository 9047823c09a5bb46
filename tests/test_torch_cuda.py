"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit: they carry the
``cuda`` marker and skip elsewhere (the ``cuda`` fixture decides, at run
time). On the H100: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.

Tolerances: float32 to 1e-5 (the kernel's tiled online softmax against the
plain version's one-shot softmax, both in f32); bfloat16 to 2e-2, as in
``tests/test_kernels.py``. The splice is held bitwise. TF32 stays off.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import chunk_prefill as cp
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

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
    (8, 32, 8, 128, 16, 128),     # qwen3-8b decode at s_max 2048
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel(dev, B, H, Hkv, hd, page, slots, dtype):
    rng = np.random.default_rng(0)
    q, kp, vp, bt, sl = _paged_inputs(rng, B, H, Hkv, hd, page, slots, dtype,
                                      dev)
    got = pa.paged_attention(q, kp, vp, bt, sl)
    torch.cuda.synchronize()
    _close(got, ref.paged_attention_ref(q, kp, vp, bt, sl), dtype)


@pytest.mark.parametrize("B,H,Hkv,hd,page,slots", [
    (2, 8, 2, 64, 16, 8),
    (8, 32, 8, 128, 16, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_splice_is_bitwise(dev, B, H, Hkv, hd, page,
                                                  slots, dtype):
    """Splicing k_new/v_new equals scattering them first, bit for bit; the
    page row under the write position holds other values, so the splice is
    what was read."""
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
