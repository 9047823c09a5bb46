"""The port's model against the JAX model on the same weights.

The JAX model's parameters (``m.init(PRNGKey(s))`` mapped to numpy) become
the port's through ``repro_torch.convert.params_from_jax``; both run on the
CPU at the reduced (float32) configs, and their float32 logits agree to
atol 1e-4 for ``prefill``, one ``prefill_chunk`` and one
``decode_step_paged`` with the splice on and off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ref as jref
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import build_model, init_params


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODELS = ("qwen3-8b", "starcoder2-15b")
ATOL = dict(rtol=0, atol=1e-4)
PAGE, ROWS, C = 4, 12, 6


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    jcfg = jax_config(request.param).reduced()
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(request.param).reduced()
    model = build_model(cfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"), device="cpu")
    return jm, jparams, model


def _close(got, exp, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(exp),
                               **(tol or ATOL))


@pytest.mark.parametrize("name", MODELS)
def test_config_matches_reference(name):
    jcfg, cfg = jax_config(name), get_config(name)
    for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        for f in dataclasses.fields(c):
            if f.name != "dtype":
                assert getattr(c, f.name) == getattr(j, f.name), f.name
        assert c.param_count() == j.param_count()
        assert c.kv_bytes_per_token() == j.kv_bytes_per_token()
        assert c.head_dim_ == j.head_dim_
    assert cfg.dtype == torch.bfloat16 and cfg.reduced().dtype == torch.float32


@pytest.mark.parametrize("name", MODELS)
def test_init_params_matches_reference_layout_and_scale(name):
    """Same leaves and shapes as the converted JAX tree; ones/zeros where
    the reference has them; normal leaves with std = 1/sqrt(fan_in)."""
    cfg = get_config(name).reduced()
    jm = jax_build(jax_config(name).reduced())
    conv = params_from_jax(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0))), cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    ours = init_params(cfg, gen, device="cpu")
    flat_c = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(conv)[0]}
    flat_o = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert flat_c.keys() == flat_o.keys()
    for k, t in flat_o.items():
        assert t.shape == flat_c[k].shape and t.dtype == torch.float32, k
        ref = flat_c[k]
        if bool((ref == ref.flatten()[0]).all()):      # ones / zeros leaf
            assert torch.equal(t, ref), k
        else:
            fan_in = t.shape[-2] if t.dim() >= 2 else t.shape[-1]
            assert abs(float(t.std()) * fan_in ** 0.5 - 1) < 0.1, k


def test_prefill_logits_and_cache_match(pair):
    jm, jparams, model = pair
    toks = np.random.default_rng(0).integers(0, 512, (2, 11)).astype(np.int32)
    jlogits, jcache = jm.prefill(jparams, jnp.asarray(toks))
    logits, k, v = model.prefill(torch.from_numpy(toks))
    _close(logits, jlogits)
    _close(k, jcache["slot0"]["k"])
    _close(v, jcache["slot0"]["v"])


def test_chunk_then_decode_logits_match(pair):
    """One prefill chunk into zeroed planes, then one decode step with the
    splice off and on: logits and the written planes agree."""
    jm, jparams, model = pair
    cfg = model.cfg
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    B, W = 2, 4
    rng = np.random.default_rng(1)
    bt = np.array([[3, 5, 7, 0], [2, 4, 0, 0]], np.int32)
    n = np.array([C, 4])                      # sequence 1 is half pad
    toks = np.zeros((B, C), np.int32)
    pos = np.zeros((B, C), np.int32)
    rows = np.zeros((B, C), np.int32)
    offs = np.zeros((B, C), np.int32)
    for b in range(B):
        toks[b, :n[b]] = rng.integers(0, cfg.vocab, n[b])
        pos[b, :n[b]] = np.arange(n[b])
        rows[b, :n[b]] = bt[b, pos[b, :n[b]] // PAGE]
        offs[b, :n[b]] = pos[b, :n[b]] % PAGE
    last_idx = (n - 1).astype(np.int32)
    shape = (L, ROWS, PAGE, Hkv, hd)
    jl, jkp, jvp = jm.prefill_chunk(
        jparams, jnp.zeros(shape), jnp.zeros(shape), *map(jnp.asarray, (
            toks, pos, bt, rows, offs, last_idx)),
        attend=jref.chunk_prefill_attention_ref)
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    t = torch.from_numpy
    logits = model.prefill_chunk(kp, vp, t(toks), t(pos), t(bt), t(rows),
                                 t(offs), t(last_idx),
                                 attend=ops.chunk_prefill_attention)
    _close(logits, jl)
    _close(kp, jkp)
    _close(vp, jvp)
    # decode the next token of both sequences
    dpos = n.astype(np.int32)
    dtoks = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    drows = bt[np.arange(B), dpos // PAGE]
    doffs = (dpos % PAGE).astype(np.int32)
    seq_lens = (dpos + 1).astype(np.int32)
    for inline in (False, True):
        jl, _, jkp2, _ = jm.decode_step_paged(
            jparams, {}, jkp, jvp, *map(jnp.asarray, (
                bt, seq_lens, drows, doffs, dtoks, dpos)),
            attend=jref.paged_attention_ref, inline=inline)
        kp2, vp2 = kp.clone(), vp.clone()
        logits = model.decode_step_paged(
            kp2, vp2, t(bt), t(seq_lens), t(drows), t(doffs), t(dtoks),
            t(dpos), attend=ops.paged_attention, inline=inline)
        _close(logits, jl)
        _close(kp2, jkp2)


def test_default_device_is_cuda_and_never_silently_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_config("qwen3-8b").reduced())


def test_non_dense_families_are_refused():
    """Every family of the reference is served; a family it lacks is
    refused by name."""
    for family in ("rwkv", "diffusion"):
        cfg = dataclasses.replace(get_config("qwen3-8b").reduced(),
                                  family=family)
        with pytest.raises(NotImplementedError, match=family):
            build_model(cfg, device="cpu")
