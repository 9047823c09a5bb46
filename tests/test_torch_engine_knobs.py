"""The port's engine against the JAX engine over its knobs, on the CPU.

``tests/test_torch_engine.py`` compares the engines at the default knobs.
This sweep crosses the rest at smoke size (reduced qwen3-8b, f32, the JAX
engine with ``kv_backend="ref"``): chunk {0, 4}, horizon {1, 8},
``max_batch_tokens`` {None, 6}, ``s_max`` {32, 64}, ``eos`` off or a token
the first greedy stream emits, ``pred_len`` off or 40, and slots {2, 3}.
The sixteen cases are a 2^(7-3) fractional factorial (eos = chunk ^
horizon ^ budget, pred_len = horizon ^ budget ^ s_max, slots = chunk ^
budget ^ s_max), so every pair of knobs meets in all four combinations.
Further cases give the accountant so little memory that admission is
refused and, with a small predicted length, that a decode cannot extend
its pages. Tokens, ``truncated`` flags, the six ``stat_*`` counters and
the number of refused allocations and extensions must be equal.
"""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.runtime.accounting import MemoryAccountant as JaxAccountant
from repro.models import build_model as jax_build
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.runtime.accounting import MemoryAccountant
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


STATS = ("stat_prefill_tokens", "stat_decode_tokens", "stat_steps",
         "stat_fused_steps", "stat_horizon_steps", "stat_decode_syncs")
MAX_NEW = 20          # 14 + 20 > 32: the longest prompt meets s_max = 32
PROMPT_LENS = (3, 7, 12, 5, 9, 14)


def _factorial():
    cases = []
    for chunk, h, mbt, smax in itertools.product((0, 1), repeat=4):
        cases.append(dict(chunk=(0, 4)[chunk], horizon=(1, 8)[h],
                          max_batch_tokens=(None, 6)[mbt],
                          s_max=(32, 64)[smax], eos=bool(chunk ^ h ^ mbt),
                          pred_len=(None, 40.0)[h ^ mbt ^ smax],
                          slots=(2, 3)[chunk ^ mbt ^ smax], m_total=512e6))
    return cases


# accountant budgets that refuse admission (a page holds 16 KB here);
# pred_len 1 also lets decode outgrow its grant
REFUSING = [
    dict(chunk=0, horizon=1, pred_len=1.0, m_total=40e3),
    dict(chunk=4, horizon=8, pred_len=1.0, m_total=40e3),
    dict(chunk=4, horizon=8, pred_len=None, m_total=70e3),
    dict(chunk=0, horizon=1, pred_len=40.0, m_total=100e3),
]
CASES = _factorial() + [dict(dict(max_batch_tokens=None, s_max=64,
                                  eos=True, slots=3), **c) for c in REFUSING]


def _id(c):
    return ("c{chunk}-h{horizon}-b{max_batch_tokens}-s{s_max}-e{eos:d}"
            "-p{pred_len}-n{slots}-m{m_total:g}").format(**c)


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(jax_config("qwen3-8b").reduced())
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_config("qwen3-8b").reduced()
    model = build_model(cfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, p)]
               for p in PROMPT_LENS]
    # eos: the fourth token of the first request's greedy stream
    eng = Engine(model, MemoryAccountant(m_total=512e6), max_slots=3,
                 s_max=64, device="cpu")
    eng.submit(Request(req_id=0, tokens=list(prompts[0]), max_new=8))
    eos = eng.drain()[0].out[3]
    return jm, jparams, model, prompts, eos


def _serve(eng, req_cls, prompts, eos, pred_len):
    refused = {"alloc": 0, "extend": 0}
    b = eng.binding
    alloc, extend = b.alloc_seq, b.ensure_tokens

    def counted_alloc(*a, **k):
        ok = alloc(*a, **k)
        refused["alloc"] += not ok
        return ok

    def counted_extend(*a, **k):
        ok = extend(*a, **k)
        refused["extend"] += not ok
        return ok

    b.alloc_seq, b.ensure_tokens = counted_alloc, counted_extend
    for i, p in enumerate(prompts):
        eng.submit(req_cls(req_id=i, tokens=list(p), max_new=MAX_NEW,
                           eos=eos, pred_len=pred_len))
    done = {r.req_id: (r.out, r.truncated) for r in eng.drain()}
    return done, {k: getattr(eng, k) for k in STATS}, refused


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_engine_knobs_match_the_jax_engine(pair, case):
    jm, jparams, model, prompts, eos_tok = pair
    eos = eos_tok if case["eos"] else None
    kw = dict(max_slots=case["slots"], s_max=case["s_max"],
              max_batch_tokens=case["max_batch_tokens"],
              prefill_chunk_tokens=case["chunk"],
              decode_horizon=case["horizon"])
    want = _serve(JaxEngine(jm, jparams, JaxAccountant(m_total=case["m_total"]),
                            kv_backend="ref", **kw),
                  JaxRequest, prompts, eos, case["pred_len"])
    got = _serve(Engine(model, MemoryAccountant(m_total=case["m_total"]),
                        device="cpu", **kw),
                 Request, prompts, eos, case["pred_len"])
    assert got == want
    done, stats, refused = got
    assert len(done) == len(prompts)
    if case["m_total"] < 1e6:
        assert refused["alloc"] > 0
        if case["pred_len"] == 1.0:
            assert refused["extend"] > 0
            assert any(t for _, t in done.values())
    if case["eos"]:
        assert len(done[0][0]) == 4 and done[0][0][-1] == eos_tok
    if case["s_max"] == 32 and case["m_total"] > 1e6:
        assert len(done[5][0]) == 32 - PROMPT_LENS[5]
