"""The port's examples (``repro_torch.examples``) against the reference's
``examples/*.py``, on the CPU.

The reference's examples are loaded by path with ``importlib`` and run as
they are; what they print is captured. Where an example builds what the
port builds differently (weights drawn by ``jax.random``, the simulator's
and the nodes' hardware model), the port's example is given the
reference's: converted weights through ``params_from_jax``, and the
reference's ``HardwareSpec`` values.

* ``cross_cluster_sim``: 60 jobs under fcfs and under maestro, the same
  printed rows and equal ``SimResult`` fields.
* ``serve_multi_agent``: in process under the virtual clock, ``n_jobs=2,
  train_jobs=40``: every ``GatewayMetrics`` key equal but
  ``engine_prefill_compiles`` (the port compiles nothing) and the TTFT
  percentiles (stamped on the wall clock).
* ``quickstart``: on a float64 copy of both packages (in float32 Adam's
  first steps move an element whose gradient is near eps by a ratio that
  rounding sets; see ``tests/test_torch_train.py``), the reference's
  initial weights and batch passed in: the losses and grad norms to
  1e-10, the served tokens equal (both serve the same trained weights, to
  1e-10), the headroom and invariant equal.

No wall-clock assertion.
"""
import dataclasses
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.predictor import cost_model as jax_cm
from repro.serving import cluster as jax_cluster
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.predictor import cost_model as cm
from repro_torch.examples import cross_cluster_sim, quickstart, \
    serve_multi_agent
from repro_torch.models import build_model
from repro_torch.serving import cluster
from repro_torch.sim import cluster as sim_cluster

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
REF_HW = dataclasses.asdict(jax_cm.HardwareSpec())


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: test processes that each spin a pool of
    threads on a shared host slow one another down a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(name: str):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ simulator
@pytest.mark.parametrize("policy", ["fcfs", "maestro"])
def test_cross_cluster_sim_equals_the_reference(policy, monkeypatch, capsys):
    ref = _reference("cross_cluster_sim")
    monkeypatch.setattr(sim_cluster, "HardwareSpec",
                        lambda: cm.HardwareSpec(**REF_HW))
    argv = ["--policy", policy, "--jobs", "60"]
    monkeypatch.setattr("sys.argv", ["cross_cluster_sim.py"] + argv)
    ref_runs = []
    run = ref.Simulator.run
    monkeypatch.setattr(ref.Simulator, "run",
                        lambda self: ref_runs.append(run(self))
                        or ref_runs[-1])
    ref.main()
    want_out = capsys.readouterr().out
    monkeypatch.undo()
    monkeypatch.setattr(sim_cluster, "HardwareSpec",
                        lambda: cm.HardwareSpec(**REF_HW))
    got = cross_cluster_sim.main(argv)
    got_out = capsys.readouterr().out
    assert got_out == want_out
    assert len(got) == len(ref_runs) == 1
    g, w = dataclasses.asdict(got[0]), dataclasses.asdict(ref_runs[0])
    assert g == w
    assert got[0].policy == policy


# ------------------------------------------------------------ live gateway
def test_serve_multi_agent_equals_the_reference(monkeypatch, capsys):
    ref = _reference("serve_multi_agent")
    want = ref.main(n_jobs=2, train_jobs=40)
    capsys.readouterr()
    # the reference's zoo (build_zoo's seed), converted
    names = cluster.ClusterSpec().model_names
    _, jhost = jax_cluster.build_zoo(names)
    host = {n: params_from_jax(jhost[n], get_config(n).reduced(), "cpu")
            for n in names}
    zoo = {n: build_model(get_config(n).reduced(), host[n], device="cpu")
           for n in names}
    hw = cm.HardwareSpec(**REF_HW)

    def fleet(spec, backend, device):
        assert backend == "inproc" and device == "cpu"
        nodes = cluster.build_fleet(spec, zoo=zoo, host=host, device=device)
        for node in nodes:      # route by the reference's modelled seconds
            for n, prof in node.profiles.items():
                node.profiles[n] = dataclasses.replace(prof, hw=hw)
            node.residency.hw = hw
        return nodes

    monkeypatch.setattr(serve_multi_agent, "build_fleet", fleet)
    got = serve_multi_agent.main(n_jobs=2, train_jobs=40, device="cpu")
    out = capsys.readouterr().out
    assert "finished jobs        : 2/2" in out
    skip = {"engine_prefill_compiles", "ttft_p50_s", "ttft_p95_s"}
    g, w = got.row(), want.row()
    assert set(g) == set(w)
    assert {k: v for k, v in g.items() if k not in skip} == \
        {k: v for k, v in w.items() if k not in skip}
    assert got.finished_jobs == 2 and got.dropped_jobs == 0
    assert got.engine_prefill_compiles == 0


# ------------------------------------------------------------ quickstart
class _Recorder:
    """Stands in for ``jax`` in the reference example's namespace: its
    ``jit`` records each step's arguments and metrics; everything else is
    ``jax``'s."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)

        def step(params, opt, batch):
            out = jitted(params, opt, batch)
            self.calls.append((params, batch,
                               {k: float(v) for k, v in out[2].items()}))
            return out

        return step


def _widen(monkeypatch):
    """Every float32 cast point of both packages widened to float64 (the
    configs' ``reduced()`` included)."""
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    monkeypatch.setattr(torch, "float32", torch.float64)
    monkeypatch.setattr(jnp, "float32", jnp.float64)


@pytest.mark.parametrize("name", ["qwen3-8b", "whisper-medium",
                                  "mamba2-2.7b"])
def test_quickstart_equals_the_reference(name, monkeypatch, capsys):
    _widen(monkeypatch)
    with jax.enable_x64(True):
        ref = _reference("quickstart")
        rec = _Recorder()
        monkeypatch.setattr(ref, "jax", rec)
        monkeypatch.setattr("sys.argv", ["quickstart.py", "--arch", name,
                                         "--steps", "3"])
        ref.main()
        out = capsys.readouterr().out
        cfg = get_config(name).reduced()
        assert cfg.dtype == torch.float64
        params0, batch = rec.calls[0][0], rec.calls[0][1]
        tbatch = {k: torch.from_numpy(np.array(v)) for k, v in
                  batch.items()}
        got = quickstart.main(
            ["--arch", name, "--steps", "3", "--device", "cpu"],
            params=params_from_jax(jax.tree.map(np.asarray, params0), cfg,
                                   "cpu"), batch=tbatch)
    mine = capsys.readouterr().out
    want_loss = [m["loss"] for *_, m in rec.calls]
    want_gnorm = [m["grad_norm"] for *_, m in rec.calls]
    np.testing.assert_allclose(got["losses"], want_loss, rtol=1e-10)
    np.testing.assert_allclose(got["grad_norms"], want_gnorm, rtol=1e-10)
    want_tokens = {int(i): eval(toks) for i, toks in re.findall(
        r"request (\d+): generated (\[[^\]]*\])", out)}
    assert len(want_tokens) == 4
    assert got["tokens"] == want_tokens
    m = re.search(r"headroom (\d+)MB, invariant=(\w+)", out)
    assert f"{got['headroom'] / 1e6:.0f}" == m.group(1)
    assert str(got["invariant"]) == m.group(2) == "True"
    assert "[quickstart] OK" in mine
