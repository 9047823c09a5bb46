"""The port's checkpoints and its training driver, on the CPU.

The five cases of ``tests/test_checkpoint.py`` on the port's trees (nested
dicts and lists of tensors, a bfloat16 leaf among them): round trip,
latest and prune, asynchronous save (which snapshots the tensors when it is
called: the port updates them in place), no partial checkpoint visible,
restore with a dtype cast; the layout on disk is ``np.savez``'s. Then
``train_lm.main`` at a tiny config: a run killed after its first
checkpoint and resumed ends with the same losses and parameters, bit for
bit, as an uninterrupted run.
"""
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step, prune, restore, save
from repro_torch.configs import get_config
from repro_torch.training import train_lm
from repro_torch.tree import leaves


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn((8, 16), generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.float32),
                       "step": torch.zeros((), dtype=torch.int32)},
            "layers": [{"h": torch.randn((3, 4), generator=g)
                        .to(torch.bfloat16)}]}


def _equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(leaves(a), leaves(b)))


def test_roundtrip(tmp_path, tree):
    save(str(tmp_path), tree, step=3, extra={"loss": 0.5})
    out, extra = restore(str(tmp_path), tree)
    assert extra == {"loss": 0.5}
    assert _equal(out, tree)
    d = tmp_path / "step_00000003"
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["n_leaves"] == 4 and manifest["step"] == 3
    assert manifest["tree"][0] == "layers/0/h"
    assert manifest["dtypes"]["leaf_0"] == "bfloat16"
    with np.load(d / "arrays.npz") as z:      # np.savez's format
        assert z["leaf_0"].dtype == np.uint16
        np.testing.assert_array_equal(z["leaf_3"], tree["w"].numpy())


def test_latest_and_prune(tmp_path, tree):
    for s in (1, 2, 3, 4, 5):
        save(str(tmp_path), tree, step=s)
    assert latest_step(str(tmp_path)) == 5
    prune(str(tmp_path), keep=2)
    assert latest_step(str(tmp_path)) == 5
    out, _ = restore(str(tmp_path), tree, step=4)
    assert out is not None
    with pytest.raises(Exception):
        restore(str(tmp_path), tree, step=1)   # pruned


def test_async_save(tmp_path, tree):
    want = tree["w"].clone()
    t = save(str(tmp_path), tree, step=9, async_=True)
    assert isinstance(t, threading.Thread)
    tree["w"].add_(1.0)             # in place, after the save was called
    t.join(timeout=30)
    assert not t.is_alive()
    out, _ = restore(str(tmp_path), tree)
    assert torch.equal(out["w"], want)


def test_no_partial_checkpoint_visible(tmp_path, tree):
    """tmp dirs never count as checkpoints (atomic publish)."""
    save(str(tmp_path), tree, step=1)
    (tmp_path / ".tmp_step_00000002").mkdir()
    assert latest_step(str(tmp_path)) == 1


def test_restore_casts_to_the_like_trees_dtypes(tmp_path, tree):
    """Restore casts to the target tree's dtypes (bf16 parameters from an
    f32 checkpoint after a precision change); a like leaf lends only its
    shape, dtype and device."""
    save(str(tmp_path), tree, step=1)
    like = {**tree, "w": torch.empty((), dtype=torch.bfloat16).expand(8, 16)}
    out, _ = restore(str(tmp_path), like)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], tree["w"].to(torch.bfloat16))
    with pytest.raises(ValueError):
        restore(str(tmp_path), {**tree, "w": tree["w"][:4]})


def _tiny():
    return dataclasses.replace(get_config("qwen3-8b").reduced(),
                               dtype=torch.float32, name="qwen3-tiny")


ARGS = ["--device", "cpu", "--steps", "6", "--batch", "4", "--seq", "17",
        "--n-micro", "2", "--ckpt-every", "2"]


class _Killed(Exception):
    pass


def _final(ckpt):
    cfg = _tiny()
    model = train_lm.build_model(cfg, device="cpu", trainable=True)
    like = (model.param_tree(), train_lm.adamw_init(model.param_tree()))
    return restore(ckpt, like)[0]


def test_train_lm_killed_and_resumed_equals_an_uninterrupted_run(
        tmp_path, monkeypatch):
    whole = train_lm.main(ARGS + ["--ckpt", str(tmp_path / "a")], _tiny())
    assert whole["start"] == 0 and np.isfinite(whole["loss"])

    # kill the run during its fourth step: the checkpoint of step 2 stands
    make = train_lm.make_train_step
    calls = []

    def dying(*a, **k):
        step = make(*a, **k)

        def run(*args):
            calls.append(1)
            if len(calls) == 4:
                raise _Killed
            return step(*args)
        return run

    monkeypatch.setattr(train_lm, "make_train_step", dying)
    with pytest.raises(_Killed):
        train_lm.main(ARGS + ["--ckpt", str(tmp_path / "b")], _tiny())
    assert latest_step(str(tmp_path / "b")) == 2
    monkeypatch.setattr(train_lm, "make_train_step", make)
    resumed = train_lm.main(ARGS + ["--ckpt", str(tmp_path / "b")], _tiny())
    assert resumed["start"] == 2
    assert resumed["loss"] == whole["loss"]
    assert resumed["grad_norm"] == whole["grad_norm"]
    assert _equal(_final(str(tmp_path / "a")), _final(str(tmp_path / "b")))
