"""The port's plain paged-attention versions against the JAX package.

The same numpy inputs go through ``repro_torch.kernels.ref``, the JAX
oracles in ``repro.kernels.ref`` and the Pallas kernels in interpret mode,
at float32 with atol/rtol 1e-5 (the plain versions and the oracles do the
same operations; the Pallas kernels take a tiled online softmax). Cases are
taken from the sweeps of ``tests/test_kernels.py``. The CUDA kernels
themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.chunk_prefill import chunk_prefill_attention as pl_chunk
from repro.kernels.paged_attention import paged_attention as pl_paged
from repro_torch.kernels import _build, ops
from repro_torch.kernels import chunk_prefill as cp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk as ssd


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)


def _paged_case(seed, B, H, Hkv, hd, page, slots):
    rng = np.random.default_rng(seed)
    n_rows = B * slots + 3
    return dict(
        q=rng.standard_normal((B, H, hd), np.float32),
        kp=rng.standard_normal((n_rows, page, Hkv, hd), np.float32),
        vp=rng.standard_normal((n_rows, page, Hkv, hd), np.float32),
        bt=rng.permutation(n_rows)[:B * slots].reshape(B, slots)
        .astype(np.int32),
        sl=rng.integers(0, page * slots + 1, B).astype(np.int32),  # 0 clamps
        kn=rng.standard_normal((B, Hkv, hd), np.float32),
        vn=rng.standard_normal((B, Hkv, hd), np.float32),
    )


def _torch(c, *names):
    return [torch.from_numpy(c[n]) for n in names]


def _jax(c, *names):
    return [jnp.asarray(c[n]) for n in names]


@pytest.mark.parametrize("B,H,Hkv,hd,page,slots", [
    (2, 8, 2, 64, 16, 8),
    (3, 4, 4, 32, 8, 4),
    (1, 16, 2, 128, 32, 4),
])
@pytest.mark.parametrize("splice", [False, True])
def test_paged_attention_ref_matches_jax_and_pallas(B, H, Hkv, hd, page,
                                                    slots, splice):
    c = _paged_case(0, B, H, Hkv, hd, page, slots)
    kw_t = dict(zip(("k_new", "v_new"), _torch(c, "kn", "vn"))) \
        if splice else {}
    kw_j = dict(zip(("k_new", "v_new"), _jax(c, "kn", "vn"))) \
        if splice else {}
    got = ref.paged_attention_ref(*_torch(c, "q", "kp", "vp", "bt", "sl"),
                                  **kw_t).numpy()
    args = _jax(c, "q", "kp", "vp", "bt", "sl")
    np.testing.assert_allclose(
        got, np.asarray(jref.paged_attention_ref(*args, **kw_j)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(pl_paged(*args, page_size=page, interpret=True,
                                 **kw_j)), **TOL)


def test_paged_attention_ref_splice_is_bitwise_scatter():
    B, H, Hkv, hd, page, slots = 2, 8, 2, 64, 16, 8
    c = _paged_case(1, B, H, Hkv, hd, page, slots)
    q, kp, vp, bt, sl, kn, vn = _torch(c, "q", "kp", "vp", "bt", "sl", "kn",
                                       "vn")
    w = (sl.clamp(min=1) - 1).long()
    rows = bt[torch.arange(B), w // page].long()
    kp_sc, vp_sc = kp.clone(), vp.clone()
    kp_sc[rows, w % page] = kn
    vp_sc[rows, w % page] = vn
    assert torch.equal(
        ref.paged_attention_ref(q, kp, vp, bt, sl, k_new=kn, v_new=vn),
        ref.paged_attention_ref(q, kp_sc, vp_sc, bt, sl))


@pytest.mark.parametrize("B,C,H,Hkv,hd,page,slots", [
    (2, 4, 4, 2, 8, 4, 4),       # GQA 2x, chunk spans pages
    (3, 8, 6, 2, 16, 8, 3),      # GQA 3x
    (2, 8, 8, 1, 64, 4, 6),      # MQA, chunk 2x page
])
def test_chunk_prefill_ref_matches_jax_and_pallas(B, C, H, Hkv, hd, page,
                                                  slots):
    rng = np.random.default_rng(2)
    n_rows = B * slots + 3
    c = dict(
        q=rng.standard_normal((B, C, H, hd), np.float32),
        kp=rng.standard_normal((n_rows, page, Hkv, hd), np.float32),
        vp=rng.standard_normal((n_rows, page, Hkv, hd), np.float32),
        bt=rng.permutation(n_rows)[:B * slots].reshape(B, slots)
        .astype(np.int32))
    p0 = rng.integers(0, slots * page - C + 1, B)
    c["pos"] = (p0[:, None] + np.arange(C)[None, :]).astype(np.int32)
    names = ("q", "kp", "vp", "bt", "pos")
    got = ref.chunk_prefill_attention_ref(*_torch(c, *names)).numpy()
    args = _jax(c, *names)
    np.testing.assert_allclose(
        got, np.asarray(jref.chunk_prefill_attention_ref(*args)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(pl_chunk(*args, page_size=page, interpret=True)),
        **TOL)


def test_chunk_prefill_ref_pad_rows_are_finite():
    rng = np.random.default_rng(3)
    B, C, H, Hkv, hd, page, slots = 2, 4, 4, 2, 8, 4, 3
    q = torch.from_numpy(rng.standard_normal((B, C, H, hd), np.float32))
    kp = torch.from_numpy(rng.standard_normal((10, page, Hkv, hd),
                                              np.float32))
    bt = torch.ones((B, slots), dtype=torch.int32)
    pos = torch.zeros((B, C), dtype=torch.int32)
    assert bool(torch.isfinite(
        ref.chunk_prefill_attention_ref(q, kp, kp, bt, pos)).all())


def test_ops_dispatch_cpu_tensors_to_the_plain_versions_with_splice():
    """On CPU tensors the dispatch runs the plain version — and passes
    k_new/v_new through, unlike the reference ``ops.paged_attention``."""
    c = _paged_case(4, 2, 8, 2, 64, 16, 8)
    args = _torch(c, "q", "kp", "vp", "bt", "sl")
    kn, vn = _torch(c, "kn", "vn")
    ops.reset_counts()
    got = ops.paged_attention(*args, k_new=kn, v_new=vn)
    assert torch.equal(got, ref.paged_attention_ref(*args, k_new=kn,
                                                    v_new=vn))
    assert not torch.equal(got, ref.paged_attention_ref(*args))
    assert ops.plain_calls["paged_attention"] == 1
    assert pa.launches == 0 and cp.launches == 0


def test_kernel_wrappers_never_fall_back_to_the_cpu():
    """Given CPU tensors a kernel wrapper raises; it has no plain branch."""
    c = _paged_case(5, 1, 4, 2, 32, 8, 2)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention(*_torch(c, "q", "kp", "vp", "bt", "sl"))
    q = torch.zeros((1, 2, 4, 32))
    kp = torch.zeros((3, 8, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        cp.chunk_prefill_attention(q, kp, kp,
                                   torch.zeros((1, 2), dtype=torch.int32),
                                   torch.zeros((1, 2), dtype=torch.int32))


def test_build_raises_without_the_cuda_toolkit(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


@pytest.mark.parametrize("B,Hkv,W,page", [
    (8, 8, 128, 16),      # qwen3-8b decode at s_max 2048
    (4, 2, 16, 8),        # the reduced reference engine
    (132, 8, 128, 16),    # 1056 blocks already: one split
    (1, 1, 1, 4),         # a window shorter than a tile
    (3, 4, 7, 16),        # a window that is not a whole number of tiles
    (2, 1, 2048, 16),
])
def test_paged_split_plan_covers_the_window_in_whole_tiles(B, Hkv, W, page):
    n_split, span = pa.split_plan(B, Hkv, W, page)
    assert n_split >= 1 and span > 0 and span % pa.SPLIT_TILE == 0
    assert (n_split - 1) * span < W * page <= n_split * span
    if n_split > 1:       # no more blocks than the target asks for
        assert B * Hkv * (n_split - 1) < pa.TARGET_BLOCKS
    assert pa.split_plan(B, Hkv, W, page) == (n_split, span)


def test_paged_split_plan_at_the_smoke_shapes():
    """16 spans of 128 at the main path's decode shapes; spans of one
    tile for the reduced reference engine, so its card-vs-CPU token check
    takes several splits; one split once B * Hkv fills the card."""
    assert pa.split_plan(8, 8, 128, 16) == (16, 128)
    assert pa.split_plan(4, 2, 16, 8) == (4, 32)
    assert pa.split_plan(132, 8, 8, 16) == (1, 128)


def test_reset_counts_zeroes_the_per_variant_flash_counts():
    fa.launches = 3
    for v in fa.launches_by_variant:
        fa.launches_by_variant[v] = 2
    ops.plain_calls["flash_attention"] = 1
    ops.reset_counts()
    assert fa.launches == 0
    assert fa.launches_by_variant == {"simt": 0, "wgmma": 0}
    assert not any(ops.plain_calls.values())


def test_flash_wrapper_never_falls_back_to_the_cpu():
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    before = dict(fa.launches_by_variant)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, k)
    assert fa.launches_by_variant == before


def test_reset_counts_zeroes_the_chunk_and_ssd_variant_counts():
    for mod in (cp, ssd):
        mod.launches = 3
        for v in mod.launches_by_variant:
            mod.launches_by_variant[v] = 2
    ops.reset_counts()
    for mod in (cp, ssd):
        assert mod.launches == 0
        assert mod.launches_by_variant == {"simt": 0, "wgmma": 0}


def test_variant_rules_at_the_smoke_paths_shapes():
    """The launchers' rules, written out in Python: the full-width main
    paths (bf16 qwen3-8b chunks at page 16, bf16 mamba2-2.7b scans with
    chunk 256) take the wgmma variants; the reduced f32 models of the
    card-vs-CPU checks, f32 at full width, pages the tile does not hold in
    whole swizzle atoms and chunks shorter than 64 take simt."""
    from repro_torch.configs import get_config
    bf16, f32 = torch.bfloat16, torch.float32
    qwen, mamba = get_config("qwen3-8b"), get_config("mamba2-2.7b")
    hd = qwen.head_dim_
    assert cp.takes_wgmma(bf16, hd, 16)
    pages = [cp.takes_wgmma(bf16, hd, p) for p in (4, 8, 16, 32, 64, 128)]
    assert pages == [False, True, True, True, True, False]
    assert cp.takes_wgmma(bf16, 64, 8) and not cp.takes_wgmma(bf16, 32, 16)
    assert not cp.takes_wgmma(f32, hd, 16)
    small = qwen.reduced()
    assert not cp.takes_wgmma(small.dtype, small.head_dim_, 8)
    s = mamba.ssm
    assert ssd.takes_wgmma(bf16, s.d_state, s.head_dim, s.chunk)
    assert ssd.takes_wgmma(bf16, 64, 128, 64)
    assert not ssd.takes_wgmma(bf16, s.d_state, s.head_dim, 32)
    assert not ssd.takes_wgmma(bf16, 16, s.head_dim, s.chunk)
    assert not ssd.takes_wgmma(f32, s.d_state, s.head_dim, s.chunk)
    r = mamba.reduced()
    assert not ssd.takes_wgmma(r.dtype, r.ssm.d_state, r.ssm.head_dim,
                               r.ssm.chunk)
