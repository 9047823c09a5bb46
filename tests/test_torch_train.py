"""The port's training against the JAX package's, on the CPU.

For every registered config (reduced, float32), the same weights (the
reference's ``Model.init`` through ``params_from_jax``) and the same batch:
``Model.loss`` equals the reference's to 1e-5 and every gradient leaf its
``jax.value_and_grad`` leaf (mapped by ``tree_from_jax``, in its own dtype)
to 5e-5 of that leaf's largest magnitude (float32 sums in other orders
through a few layers). qwen1.5-110b runs with the same random non-zero
q/k/v biases on both sides. jamba's MoE gates amplify float32 rounding
(its gradients differ by up to 1e-3 of a leaf's magnitude in float32), so
it runs as a float64 copy on both sides, every float32 cast widened, to
1e-9.

``make_train_step`` after two steps equals the reference's for ``n_micro``
1 and 2 and each gradient compression (none, bf16, int8 with error
feedback): the parameters, ``m``, ``v``, ``ef``, ``step`` and the metrics,
from the same optimizer state (``opt_state_from_jax``), on a float64 copy
to 1e-10 (see the test for why not float32).

Last, the port's own versions of ``tests/test_models.py``'s training
tests: the loss halves on the tiny task, and two microbatches give one
batch's step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


from repro.configs import get_config as jax_config
from repro.configs.base import list_configs as jax_list_configs
from repro.models import build_model as jax_build
from repro.training import OptConfig as JaxOptConfig
from repro.training import adamw_init as jax_adamw_init
from repro.training import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import opt_state_from_jax, params_from_jax, \
    tree_from_jax
from repro_torch.models import build_model
from repro_torch.training import OptConfig, adamw_init, make_train_step
from repro_torch.tree import leaves, leaves_with_paths, tree_map


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NAMES = sorted(jax_list_configs())
B, S = 2, 24


def _configs(name, dtype=np.float32):
    jc = dataclasses.replace(jax_config(name).reduced(),
                             dtype=jnp.dtype(dtype))
    tc = dataclasses.replace(get_config(name).reduced(),
                             dtype=getattr(torch, np.dtype(dtype).name))
    return jc, tc


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed, b=B, s=S, dtype=np.float32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encoder is not None or cfg.cross_attn is not None:
        batch[cfg.ctx_key] = rng.standard_normal(
            (b, cfg.n_ctx, cfg.ctx_width)).astype(dtype)
    return batch


def _random_biases(tree, seed=7):
    """Random non-zero q/k/v biases (the reference initialises them to
    zero, which would leave their gradients' path untested)."""
    rng = np.random.default_rng(seed)
    for slot in tree["groups"].values():
        attn = slot.get("attn", {})
        for k in ("bq", "bk", "bv"):
            if k in attn:
                attn[k] = (0.5 * rng.standard_normal(attn[k].shape)).astype(
                    attn[k].dtype)
    return tree


def _loss_and_grads(name, dtype):
    jc, tc = _configs(name, dtype)
    jm = jax_build(jc)
    params = _numpy(jm.init(jax.random.PRNGKey(0)))
    if jc.qkv_bias:
        params = _random_biases(params)
    batch = _batch(tc, 1, dtype=dtype)
    extras = {k: v for k, v in batch.items() if k not in ("tokens",
                                                         "labels")}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(batch["tokens"]),
                          jnp.asarray(batch["labels"]),
                          {k: jnp.asarray(v) for k, v in extras.items()})))(
        jax.tree.map(jnp.asarray, params))
    model = build_model(tc, params_from_jax(params, tc, "cpu"),
                        device="cpu", trainable=True)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = model.loss(t["tokens"], t["labels"],
                      {k: v for k, v in t.items()
                       if k not in ("tokens", "labels")})
    loss.backward()
    want = dict(leaves_with_paths(tree_from_jax(_numpy(jgrads), tc, "cpu")))
    got = dict(leaves_with_paths(model.grad_tree()))
    return float(loss.detach()), float(jloss), got, want


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_every_gradient_leaf_equal_the_reference(name, monkeypatch):
    if name == "jamba-v0.1-52b":
        _widen(monkeypatch)
        with jax.enable_x64(True):
            loss, jloss, got, want = _loss_and_grads(name, np.float64)
        tol = 1e-9
    else:
        loss, jloss, got, want = _loss_and_grads(name, np.float32)
        tol = 5e-5
    assert abs(loss - jloss) <= 1e-5
    assert set(got) == set(want) and len(got) > 10
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        scale = float(w.abs().max()) or 1.0
        err = float((g - w).abs().max()) / scale
        assert err <= tol, (path, err)


STEP_CASES = [(n, c) for n in (1, 2) for c in ("none", "bf16", "int8")]


def _widen(monkeypatch):
    """Every float32 cast point of both packages widened to float64."""
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    monkeypatch.setattr(torch, "float32", torch.float64)
    monkeypatch.setattr(jnp, "float32", jnp.float64)


@pytest.mark.parametrize("n_micro,compression", STEP_CASES)
def test_two_train_steps_equal_the_references(n_micro, compression,
                                              monkeypatch):
    """On a float64 copy (every float32 cast point of both packages
    widened): in float32 the int8 quantizer moves an element by a whole
    level wherever rounding puts g / scale on the other side of a half,
    and Adam's first steps move an element whose gradient is near eps by a
    ratio that rounding sets, so two float32 runs part by lr-sized steps
    (a third of the elements after two int8 steps) whatever their
    arithmetic. In float64 they agree to 1e-10.

    int8 runs at one layer: its scale is one leaf's largest magnitude, and
    a leaf of the reference stacks a slot's layers where the port's holds
    one layer (ROADMAP §3), so at two layers the scales differ."""
    _widen(monkeypatch)
    with jax.enable_x64(True):
        jc, tc = _configs("qwen3-8b", np.float64)
        if compression == "int8":
            jc = dataclasses.replace(jc, n_layers=1)
            tc = dataclasses.replace(tc, n_layers=1)
        jm = jax_build(jc)
        jparams = jm.init(jax.random.PRNGKey(3))
        kw = dict(lr=1e-3, warmup_steps=2, compression=compression)
        jopt = jax_adamw_init(jparams, compression)
        model = build_model(tc, params_from_jax(_numpy(jparams), tc, "cpu"),
                            device="cpu", trainable=True)
        params = model.param_tree()
        opt = opt_state_from_jax(_numpy(jopt), tc, "cpu")
        jstep = jax.jit(jax_make_train_step(jm, JaxOptConfig(**kw), n_micro))
        step = make_train_step(model, OptConfig(**kw), n_micro)
        for i in range(2):
            batch = _batch(tc, 10 + i, b=4, s=16, dtype=np.float64)
            jparams, jopt, jmetrics = jstep(
                jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
            params, opt, metrics = step(
                params, opt, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[k]),
                                       float(jmetrics[k]), rtol=1e-10,
                                       err_msg=k)
        assert int(opt["step"]) == int(jopt["step"]) == 2
        assert ("ef" in opt) == (compression != "none")
        trees = [("params", params, jparams)] + [
            (k, opt[k], jopt[k]) for k in ("m", "v", "ef") if k in jopt]
        for what, got, ref_tree in trees:
            want = leaves(tree_from_jax(_numpy(ref_tree), tc, "cpu"))
            assert len(want) == len(leaves(got))
            for g, w in zip(leaves(got), want):
                assert g.dtype == w.dtype
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                           atol=1e-10, err_msg=what)


def test_loss_decreases_on_tiny_task():
    """A few steps of training on a repetitive sequence halve the loss
    (``tests/test_models.py``'s, on the port's own initialisation)."""
    cfg = get_config("qwen3-8b").reduced()
    model = build_model(cfg, device="cpu", seed=0, trainable=True)
    params = model.param_tree()
    opt_cfg = OptConfig(lr=3e-3, warmup_steps=1, weight_decay=0.0)
    step = make_train_step(model, opt_cfg)
    opt = adamw_init(params)
    toks = torch.arange(16, dtype=torch.int32).tile(4, 4)      # [4, 64]
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    losses = []
    for _ in range(25):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.5, losses[:3] + losses[-3:]


def test_microbatch_equivalence():
    """n_micro=2 gradient accumulation ~ single-batch gradients
    (``tests/test_models.py``'s, on the port)."""
    cfg = dataclasses.replace(get_config("starcoder2-15b").reduced(),
                              dtype=torch.float32)
    init = build_model(cfg, device="cpu", seed=1).param_tree()
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    opt_cfg = OptConfig(warmup_steps=1)
    out = []
    for n_micro in (1, 2):
        model = build_model(cfg, tree_map(torch.clone, init), device="cpu",
                            trainable=True)
        params = model.param_tree()
        opt = adamw_init(params)
        params, _, m = make_train_step(model, opt_cfg, n_micro)(
            params, opt, batch)
        out.append(([t.clone() for t in leaves(params)], float(m["loss"])))
    (p1, l1), (p2, l2) = out
    assert abs(l1 - l2) < 1e-3
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-4)


def test_recomputation_changes_neither_the_output_nor_the_gradients():
    """``backbone(remat=True)`` (every layer and encoder layer recomputed in
    the backward pass) equals ``remat=False`` bit for bit, output and
    gradients: the recomputation runs the same operations."""
    cfg = dataclasses.replace(get_config("whisper-medium").reduced(),
                              dtype=torch.float32)
    model = build_model(cfg, device="cpu", seed=2, trainable=True)
    batch = _batch(cfg, 4)
    toks = torch.from_numpy(batch["tokens"])
    extras = {cfg.ctx_key: torch.from_numpy(batch[cfg.ctx_key])}
    out = []
    for remat in (True, False):
        model.zero_grad(set_to_none=True)
        hidden = model.backbone(toks, extras, remat=remat)
        hidden.square().sum().backward()
        out.append((hidden.detach(), [t.clone()
                                      for t in leaves(model.grad_tree())]))
    (h1, g1), (h2, g2) = out
    assert torch.equal(h1, h2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
