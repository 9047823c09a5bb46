"""The Engine's dense KV backend (``kv_backend="dense"``) against the paged
one and against the JAX package's dense engine.

The reference's ``tests/test_kv_arena.py`` pins paged = dense token for
token; here the port's dense engine must give the port's paged engine's
greedy tokens, and the reference's dense engine's, on the same weights
(the reduced configs through ``params_from_jax``, float32): a dense
self-attention stack, an MoE one and the Jamba hybrid; and for every
config, the families the reference's dense engine serves (all ten), the
paged engine's tokens. The dense engine
holds its K/V in ``Model.cache`` (no arena plane, no pages mapped), and its
chunk, horizon and prefix-cache knobs degrade as the reference's do.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.runtime.accounting import MemoryAccountant as JaxAccountant
from repro.models import build_model as jax_build
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import base as config_base
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.runtime.accounting import MemoryAccountant
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving.engine import Engine, Request


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NAMES = ("qwen3-8b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b")
LENS = (8, 5, 17, 11)


def _pair(name):
    jm = jax_build(jax_config(name).reduced())
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(name).reduced()
    model = build_model(cfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"), device="cpu")
    return jm, jparams, model


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in LENS]


def _port(model, prompts, **kw):
    eng = Engine(model, MemoryAccountant(m_total=256e6), max_slots=2,
                 s_max=64, device="cpu", **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(req_id=i, tokens=list(p), max_new=6))
    return eng, {r.req_id: r.out for r in eng.drain()}


def _reference(jm, jparams, prompts):
    eng = JaxEngine(jm, jparams, JaxAccountant(m_total=256e6), max_slots=2,
                    s_max=64, kv_backend="dense")
    for i, p in enumerate(prompts):
        eng.submit(JaxRequest(req_id=i, tokens=list(p), max_new=6))
    return {r.req_id: r.out for r in eng.drain()}


@pytest.mark.parametrize("name", NAMES)
def test_dense_engine_equals_paged_and_the_reference(name):
    jm, jparams, model = _pair(name)
    prompts = _prompts(model.cfg.vocab)
    ops.reset_counts()
    eng, dense = _port(model, prompts, kv_backend="dense")
    assert eng.kv_backend == "dense" and not eng.paged
    assert eng.binding.plane is None and eng.arena.mapped_pages() == 0
    assert eng.cache["k"].shape[:3] == (model.cfg.n_layers
                                        - model.n_ssm_layers, 2, 64)
    # the dense decode reads its cache through the paged decode's plain
    # version on the CPU, once per attention layer and decode step
    n_attn = model.cfg.n_layers - model.n_ssm_layers
    assert ops.plain_calls["paged_attention"] == n_attn * eng.stat_decode_syncs
    paged_eng, paged = _port(model, prompts, kv_backend="ref")
    assert paged_eng.paged and paged_eng.kv_backend == "paged"
    assert dense == paged
    assert dense == _reference(jm, jparams, prompts)


def test_dense_engine_knobs_degrade_and_the_backend_is_checked():
    _, _, model = _pair("qwen3-8b")
    eng = Engine(model, MemoryAccountant(m_total=256e6), max_slots=2,
                 s_max=30, page_tokens=4, device="cpu", kv_backend="dense",
                 prefill_chunk_tokens=8, decode_horizon=4, prefix_cache=True)
    assert (eng.chunk_tokens, eng.horizon, eng._pc) == (0, 1, None)
    # s_max rounded up to whole pages of the paged decode's view
    assert eng.cache["k"].shape[2] == 32
    assert eng._state_bytes == sum(t.numel() * t.element_size()
                                   for t in eng.cache.values())
    eng.release_kv()
    assert eng.cache is None and eng._state_bytes == 0
    with pytest.raises(ValueError, match="kv_backend"):
        Engine(model, MemoryAccountant(m_total=256e6), device="cpu",
               kv_backend="pages")
    mamba = build_model(get_config("mamba2-2.7b").reduced(), device="cpu")
    eng = Engine(mamba, MemoryAccountant(m_total=256e6), device="cpu",
                 kv_backend="ref")
    assert eng.kv_backend == "dense" and not eng.paged


def _registered():
    for m in config_base._ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    return sorted(config_base._REGISTRY)


@pytest.mark.parametrize("name", _registered())
def test_every_config_serves_dense_as_paged(name):
    """Every config the reference's dense engine serves (all ten) runs
    the port's dense backend, with the paged engine's tokens: the
    attention, MoE, pure-SSM, hybrid, encoder-decoder and cross-attention
    families (a cross-attention model on its stub context)."""
    model = build_model(get_config(name).reduced(), device="cpu")
    prompts = _prompts(model.cfg.vocab)
    eng, dense = _port(model, prompts, kv_backend="dense")
    _, paged = _port(model, prompts)
    assert not eng.paged and dense == paged
    assert all(len(out) == 6 for out in dense.values())
