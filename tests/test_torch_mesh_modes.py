"""The reference's two other sharding modes, ``tp_sp_opt`` and ``fsdp_cp``,
on the port's gloo CPU ranks against the reference's sharded run in the
same mode; their collective plans; and the plain versions of the two
kernels they extend (flash attention's query offset, paged attention's row
log-sum-exp).

The reference side runs once, in a subprocess with four forced host
devices (``test_torch_mesh.py``'s harness): reduced qwen3-8b in both modes
on JAX meshes (1, 2), (2, 1) and (2, 2), one row in ``fsdp_cp`` on (2, 2)
(the data axis then does not split the lanes), and reduced
moonshot-v1-16b-a3b in both modes on (1, 2): a prefill of B x 16 tokens,
then two greedy decode steps. The port spawns one gloo rank per device,
one spawn per mesh, once that subprocess has ended, and each rank serves
the same cases (``spmd.serve``) from the same weights. Compared: the
prefill logits, each decode step's logits and the greedy tokens fed
(identical), within ``test_torch_mesh.py``'s limits (1e-4 on f32 logits,
1e-5 on the K/V blocks). Moonshot's capacity is per shard on both sides.

The collective plans (``collectives.stats()`` of one prefill and of one
decode step, on 2 x 2 against ``tp_sp``'s): ``tp_sp_opt``'s prefill
reduce-scatters where ``tp_sp`` all-reduces over ``model``, the same
tensors, and all-gathers each layer's normed rows twice; ``fsdp_cp``'s
prefill all-reduces nothing over ``model``; its decode step all-gathers
no weight (``tp_sp``'s gathers every layer's over ``data``).

The plain versions: ``ref.flash_attention_ref`` and
``ref.blockwise_attention`` with ``q_offset`` against the reference's
``kv_blockwise_attention`` on the rank's rows of a sequence, the flash
cost's visible pairs against a count, and ``ref.paged_attention_ref``'s
log-sum-exp: a cache split into 2 and 4 blocks of rows, lanes empty in
some blocks or in all, each block attended alone and the blocks merged by
their log-sum-exps, against the whole cache.

About 60 s on one worker with one intra-op thread.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_rank import run_mode_cases
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models.layers import kv_blockwise_attention
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.distributed.sharding import MODES, ShardingCtx
from repro_torch.kernels import cost, ops, ref
from repro_torch.launch import spmd
from repro_torch.models import build_model


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


QWEN, MOE = "qwen3-8b", "moonshot-v1-16b-a3b"
NEW = ("tp_sp_opt", "fsdp_cp")
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
# (model, mode, mesh label, batch)
CASES = ([(QWEN, mode, label, 4) for mode in NEW for label in MESHES]
         + [(QWEN, "fsdp_cp", "2x2", 1)]
         + [(MOE, mode, "1x2", 4) for mode in NEW])
S, SMAX, STEPS = 16, 32, 2
TOL = dict(rtol=0, atol=1e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


def case_id(name, mode, label, B):
    return f"{name}/{mode}/{label}/{B}"


REFERENCE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import build_model

S, SMAX, STEPS = %d, %d, %d
CASES = %r
MESHES = %r
inputs = np.load(sys.argv[1])
res = {}
for name in sorted({c[0] for c in CASES}):
    cfg = get_config(name).reduced()
    structure = jax.tree.structure(build_model(cfg).abstract_params())
    params = jax.tree.unflatten(structure, [
        jnp.asarray(inputs[f"{name}/params/{i}"])
        for i in range(structure.num_leaves)])
    for _, mode, label, B in [c for c in CASES if c[0] == name]:
        mesh = jax.make_mesh(MESHES[label], ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        m = build_model(cfg, mesh=mesh, mode=mode)
        p = jax.tree.map(lambda s, a: jax.device_put(a, NamedSharding(mesh, s)),
                         m.param_pspecs(), params,
                         is_leaf=lambda s: isinstance(s, P))
        key = f"{name}/{mode}/{label}/{B}"
        logits, caches = jax.jit(m.prefill)(
            p, jnp.asarray(inputs[f"{name}/tokens"][:B]))
        res[f"{key}/prefill"] = logits
        res[f"{key}/k"] = caches["slot0"]["k"]
        structs, _ = m.cache_specs(B, SMAX)
        cache = {sl: {kk: jnp.zeros(st.shape, st.dtype).at[:, :, :S].set(
                     caches[sl][kk]) for kk, st in sub.items()}
                 for sl, sub in structs.items()}
        decode = jax.jit(m.decode_step)
        fed = []
        for i in range(STEPS):
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)
            fed.append(nxt)
            logits, cache = decode(p, cache, nxt[:, None],
                                   jnp.full((B,), S + i, jnp.int32))
            res[f"{key}/decode{i}"] = logits
        res[f"{key}/fed"] = jnp.stack(fed, 1)
        res[f"{key}/cache_k"] = cache["slot0"]["k"]
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in res.items()})
""" % (S, SMAX, STEPS, CASES, MESHES)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The prompts and the weights (the reference's ``init`` at key 0; in
    the port's layout, saved for the ranks), and the reference's run
    started in a subprocess of its own."""
    d = tmp_path_factory.mktemp("modes")
    rng = np.random.default_rng(3)
    inputs, params = {}, {}
    for name in (QWEN, MOE):
        jcfg = jax_config(name).reduced()
        inputs[f"{name}/tokens"] = rng.integers(
            0, jcfg.vocab, (4, S)).astype(np.int32)
        tree = jax.tree.map(np.asarray,
                            jax_build(jcfg).init(jax.random.PRNGKey(0)))
        for i, a in enumerate(jax.tree.leaves(tree)):
            inputs[f"{name}/params/{i}"] = a
        params[name] = str(d / f"{name}.pt")
        torch.save(params_from_jax(tree, get_config(name).reduced(), "cpu"),
                   params[name])
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "inputs.npz"),
         str(d / "ref.npz")], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    yield dict(inputs=inputs, params=params, proc=proc, out=d / "ref.npz")
    if proc.poll() is None:
        proc.kill()
        proc.wait()


_REF = {}


@pytest.fixture(scope="module")
def reference(setup):
    if not _REF:
        _, err = setup["proc"].communicate(timeout=600)
        assert setup["proc"].returncode == 0, err[-4000:]
        _REF.update(np.load(setup["out"]))
    return _REF


def _job(setup, name, mode, B, steps=STEPS):
    cfg = get_config(name).reduced()
    toks = torch.from_numpy(setup["inputs"][f"{name}/tokens"][:B])
    return spmd.Job(cfg, toks, steps, params=setup["params"][name],
                    mode=mode)


@pytest.fixture(scope="module")
def port(setup, reference):
    """Every case of every mesh and, on 2 x 2, the plans of qwen3-8b in
    the three modes: one spawn of ranks per mesh, after the reference's
    subprocess has ended."""
    runs = {}
    for label, shape in MESHES.items():
        jobs = {case_id(*c): _job(setup, c[0], c[1], c[3])
                for c in CASES if c[2] == label}
        plans = ({mode: _job(setup, QWEN, mode, 4) for mode in MODES}
                 if label == "2x2" else {})
        _, runs[label] = spmd.launch(run_mode_cases, shape, (jobs, plans),
                                     device="cpu", threads=1)
    return runs


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("name,mode,label,B", CASES,
                         ids=[case_id(*c) for c in CASES])
def test_each_mode_matches_the_reference_sharded_run(port, reference, name,
                                                     mode, label, B):
    """The prefill logits, each greedy decode step's logits and tokens, the
    prefill's K/V and the cache after the steps, rank by rank: the rank's
    heads over the sequence in ``tp_sp_opt`` (``tp_sp``'s layout), its
    rows of every head in ``fsdp_cp`` (``kv_sp``); the ranks of one data
    index hold the same logits bitwise."""
    key = case_id(name, mode, label, B)
    tp = MESHES[label][1]
    recs = [r["jobs"][key] for r in port[label]]
    logits = spmd.gather_rows(recs)
    _close(logits[0], reference[f"{key}/prefill"], **LOGIT_TOL)
    for i in range(STEPS):
        _close(logits[1 + i], reference[f"{key}/decode{i}"], **LOGIT_TOL)
    assert np.array_equal(spmd.gather_rows(recs, "fed", dim=0).numpy(),
                          reference[f"{key}/fed"])
    for rec in recs:
        (lo, hi), m = rec["rows"], rec["coords"][1]
        assert rec["foreign"] == []
        twin = next(q for q in recs if q["coords"][0] == rec["coords"][0])
        assert torch.equal(rec["logits"], twin["logits"])
        for mine, whole in ((rec["k"], reference[f"{key}/k"]),
                            (rec["cache_k"], reference[f"{key}/cache_k"])):
            if mode == "fsdp_cp":
                n = mine.shape[2]
                want = whole[:, lo:hi, m * n:(m + 1) * n]
            else:
                h = whole.shape[3] // tp
                want = whole[:, lo:hi, :, m * h:(m + 1) * h]
            _close(mine, want)
    if B == 1:
        assert {r["rows"] for r in recs} == {(0, 1)}


def _calls(stats, kind, axis="model"):
    return stats.get(kind, {}).get(axis, {}).get("calls", 0)


def _bytes(stats, kind, axis="model"):
    return stats.get(kind, {}).get(axis, {}).get("bytes", 0)


def test_the_collective_plans_of_the_modes(port):
    """On 2 x 2, rank by rank: ``tp_sp_opt``'s prefill reduce-scatters
    over ``model`` the tensors ``tp_sp`` all-reduces (the embedding and
    each layer's two outputs), all-gathers each layer's normed rows twice
    and the last row once beside the logits, and all-reduces nothing over
    ``model``; ``fsdp_cp``'s prefill all-reduces nothing over ``model``,
    its decode step all-gathers no weight, where ``tp_sp``'s gathers each
    layer's over ``data``."""
    L = get_config(QWEN).reduced().n_layers
    for rank in port["2x2"]:
        plans = rank["plans"]
        base, _ = plans["tp_sp"]["prefill"]
        opt, _ = plans["tp_sp_opt"]["prefill"]
        assert _calls(base, "all_reduce") == 1 + 2 * L
        assert _calls(opt, "reduce_scatter") == 1 + 2 * L
        assert _bytes(opt, "reduce_scatter") == _bytes(base, "all_reduce")
        assert _calls(opt, "all_reduce") == 0
        assert (_calls(opt, "all_gather")
                == _calls(base, "all_gather") + 2 * L + 1)
        cp, _ = plans["fsdp_cp"]["prefill"]
        assert _calls(cp, "all_reduce") == 0
        assert _calls(cp, "all_gather", "data") > 0     # ZeRO-3 weights
        _, cp_weights = plans["fsdp_cp"]["decode"]
        assert cp_weights == []
        _, base_weights = plans["tp_sp"]["decode"]
        assert len(base_weights) >= L


@pytest.mark.parametrize("mode", NEW)
def test_the_modes_refuse_what_they_do_not_run(mode):
    """A family a mode does not run yet raises, naming the mode; the loss
    of a dense model in the mode runs (with no mesh, the one-card loss);
    an unknown mode name raises ``ValueError``."""
    from repro_torch.launch.mesh import LocalMesh
    with pytest.raises(NotImplementedError, match=mode):
        build_model(get_config("mamba2-2.7b").reduced(), device="cpu",
                    mode=mode)
    cfg = get_config(QWEN).reduced()
    model = build_model(cfg, device="cpu", trainable=True, mode=mode)
    toks = torch.randint(0, cfg.vocab, (1, 8),
                         generator=torch.Generator().manual_seed(0))
    loss = model.loss(toks, toks)
    one = build_model(cfg, model.param_tree(), device="cpu").loss(toks, toks)
    assert torch.isfinite(loss) and torch.equal(loss.detach(), one)
    with pytest.raises(ValueError, match="sharding mode"):
        ShardingCtx(LocalMesh(("data", "model"), (1, 2), 0, (0, 0)),
                    mode="tp_sp_fast")
    with pytest.raises(ValueError, match="sharding mode"):
        build_model(get_config(QWEN).reduced(), device="cpu", mode="cp")


# ---------------------------------------------------------------------------
# The plain versions of the two kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,tp", [(64, 2), (60, 4), (1024, 2)])
def test_a_query_offset_is_the_referenced_rows_of_the_whole_attention(S, tp):
    """Rank r of a context-parallel line holds query rows r S/tp .. and
    every key: ``flash_attention_ref`` and ``blockwise_attention`` (the
    CPU's path) with ``q_offset`` r S/tp, against those rows of the
    reference's ``kv_blockwise_attention`` over the whole sequence; and
    ``ops.flash_attention`` takes the offset, under grad too: its
    gradient of the rows' sum is the reference's."""
    rng = np.random.default_rng(S + tp)
    B, H, Hkv, hd = 2, 4, 2, 32
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    whole = np.asarray(kv_blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    s = S // tp
    for r in range(tp):
        qr = torch.from_numpy(q[:, r * s:(r + 1) * s])
        want = whole[:, r * s:(r + 1) * s]
        _close(ref.flash_attention_ref(qr, kt, vt, True, q_offset=r * s),
               want)
        _close(ref.blockwise_attention(qr, kt, vt, True, q_offset=r * s),
               want)
        _close(ops.flash_attention(qr, kt, vt, True, q_offset=r * s), want)
    qg = torch.from_numpy(q[:, s:2 * s]).requires_grad_(True)
    ops.flash_attention(qg, kt, vt, True, q_offset=s).sum().backward()
    dq = jax.grad(lambda x: kv_blockwise_attention(
        x, jnp.asarray(k), jnp.asarray(v), causal=True)[:, s:2 * s].sum())(
            jnp.asarray(q))
    _close(qg.grad, np.asarray(dq)[:, s:2 * s])


def test_the_flash_backward_cost_counts_the_pairs_an_offset_admits():
    """``cost.bwd_cost`` at an offset: 10 * hd flops per pair that
    ``cost._visible`` admits and head, its bytes those of no offset; the
    ranks of a context-parallel line sum to the whole sequence's flops."""
    B, H, Hkv, hd = 2, 32, 8, 128
    for Sq, Sk, off in ((512, 1024, 0), (512, 1024, 512), (125, 1000, 375),
                        (7, 9, 20)):
        n_bytes, flops = cost.bwd_cost(B, Sq, Sk, H, Hkv, hd, True, 2, off)
        assert flops == B * 10 * cost._visible(Sq, Sk, True, off) * H * hd
        assert n_bytes == cost.bwd_cost(B, Sq, Sk, H, Hkv, hd, True, 2)[0]
    S, tp = 1000, 8
    s = S // tp
    assert sum(cost.bwd_cost(B, s, S, H, Hkv, hd, True, 2, r * s)[1]
               for r in range(tp)) == cost.bwd_cost(B, S, S, H, Hkv, hd,
                                                    True, 2)[1]


def test_the_flash_cost_counts_the_pairs_an_offset_admits():
    """``cost._visible`` against a count of the (query, key) pairs with
    j <= i + q_offset, and the causal work of the ranks of a line: rank r
    does (r + 1/2) / tp of the whole, (r + 1) / tp at most."""
    for Sq in range(0, 9):
        for Sk in range(1, 11):
            for off in range(0, 12):
                want = sum(min(i + off + 1, Sk) for i in range(Sq))
                assert cost._visible(Sq, Sk, True, off) == want
                assert cost._visible(Sq, Sk, False, off) == Sq * Sk
    S, tp = 4096, 16
    s = S // tp
    shares = [cost._visible(s, S, True, r * s) for r in range(tp)]
    assert sum(shares) == cost._visible(S, S, True)
    assert shares[-1] / shares[0] == pytest.approx(2 * tp - 1, rel=1e-2)


def _split_paged(q, k, v, seq_lens, parts, page):
    """Paged attention with the log-sum-exp over each of ``parts`` blocks
    of a dense [B, S, Hkv, hd] cache alone, the blocks merged by their
    log-sum-exps as ``fsdp_cp``'s decode merges its ranks'."""
    B, S = k.shape[:2]
    n = S // parts
    outs, lses = [], []
    for r in range(parts):
        kb = k[:, r * n:(r + 1) * n].reshape(B * n // page, page,
                                             *k.shape[2:])
        vb = v[:, r * n:(r + 1) * n].reshape(B * n // page, page,
                                             *v.shape[2:])
        bt = (torch.arange(B)[:, None] * (n // page)
              + torch.arange(n // page)[None]).int()
        lens = (seq_lens - r * n).clamp(0, n).int()
        o, lse = ops.paged_attention(q, kb, vb, bt, lens, return_lse=True)
        outs.append(o.float())
        lses.append(lse)
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.amax(0))[..., None]
    return (torch.stack(outs) * w).sum(0) / w.sum(0), lse


@pytest.mark.parametrize("parts", [2, 4])
def test_split_paged_attention_merged_by_its_log_sum_exp_is_the_whole(parts):
    """A cache of 64 rows split into ``parts`` blocks: lanes of 1, 16, 17,
    40 and 64 positions (each block past a lane's last holds none of its
    rows: output 0, log-sum-exp -inf), merged, against the whole cache's
    attention; the whole's log-sum-exp is the blocks' logsumexp; a lane of
    length 0 gives 0 and -inf; without ``return_lse`` the output is the
    one the kernel's plain version gave before (length clamped to 1)."""
    rng = np.random.default_rng(parts)
    B, H, Hkv, hd, S, page = 5, 8, 2, 32, 64, 8
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, hd))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, hd))
                         .astype(np.float32))
    seq_lens = torch.tensor([1, 16, 17, 40, 64], dtype=torch.int32)
    bt = (torch.arange(B)[:, None] * (S // page)
          + torch.arange(S // page)[None]).int()
    kp = k.reshape(B * S // page, page, Hkv, hd)
    vp = v.reshape(B * S // page, page, Hkv, hd)
    want, want_lse = ref.paged_attention_ref(q, kp, vp, bt, seq_lens,
                                             return_lse=True)
    got, lses = _split_paged(q, k, v, seq_lens, parts, page)
    _close(got, want)
    _close(torch.logsumexp(lses, 0), want_lse)
    assert torch.isinf(lses[-1][0]).all()           # lane 0: one row
    plain = ref.paged_attention_ref(q, kp, vp, bt, seq_lens)
    _close(want, plain)
    empty = torch.zeros(B, dtype=torch.int32)
    o0, l0 = ref.paged_attention_ref(q, kp, vp, bt, empty, return_lse=True)
    assert torch.equal(o0, torch.zeros_like(o0))
    assert torch.isneginf(l0).all()
    assert torch.equal(ref.paged_attention_ref(q, kp, vp, bt, empty),
                       ref.paged_attention_ref(q, kp, vp, bt, empty + 1))
