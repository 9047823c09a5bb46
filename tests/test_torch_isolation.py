"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor any module of the JAX package ``repro``, and neither do
its entry points nor the ranks ``repro_torch.launch.spmd`` spawns."""
import json
import os
import pathlib
import subprocess
import sys

PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_no_module_of_the_port_imports_jax_or_repro():
    src = pathlib.Path(__file__).resolve().parent.parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, text=True,
                         capture_output=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    # the walk reaches the modules this port copies from the reference
    for name in ("repro_torch.serving.gateway", "repro_torch.serving.clock",
                 "repro_torch.serving.telemetry",
                 "repro_torch.serving.registry", "repro_torch.serving.worker",
                 "repro_torch.core.control_loop",
                 "repro_torch.core.sched.policies",
                 "repro_torch.core.sched.substrate",
                 "repro_torch.core.sched.srtf",
                 "repro_torch.core.predictor.length_model",
                 "repro_torch.data.tracegen", "repro_torch.data.apps",
                 "repro_torch.distributed.fault",
                 "repro_torch.serving.transport",
                 "repro_torch.serving.faultplan",
                 "repro_torch.sim.cluster", "repro_torch.sim.simulator",
                 "repro_torch.models.moe", "repro_torch.configs.qwen3_32b",
                 "repro_torch.configs.qwen1_5_110b",
                 "repro_torch.configs.moonshot_v1_16b_a3b",
                 "repro_torch.configs.llama4_scout_17b_a16e",
                 "repro_torch.configs.jamba_v0_1_52b",
                 "repro_torch.configs.whisper_medium",
                 "repro_torch.configs.llama3_2_vision_11b",
                 "repro_torch.tree", "repro_torch.training.optimizer",
                 "repro_torch.training.train_step",
                 "repro_torch.training.train_lm",
                 "repro_torch.checkpoint.checkpoint",
                 "repro_torch.distributed.collectives",
                 "repro_torch.launch.spmd"):
        assert name in got["modules"], name


# the worker's entry point as ``python -m`` runs it, then the modules loaded
HELP_PROBE = """
import contextlib, io, json, runpy, sys
sys.argv = ["worker", "--help"]
out = io.StringIO()
with contextlib.redirect_stdout(out):
    try:
        runpy.run_module("repro_torch.serving.worker", run_name="__main__")
    except SystemExit as e:
        code = e.code
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"code": code, "help": out.getvalue(), "bad": bad}))
"""


def test_the_worker_entry_point_imports_neither_jax_nor_repro():
    """``python -m repro_torch.serving.worker --help``: the standalone
    worker's entry point loads only the port."""
    src = pathlib.Path(__file__).resolve().parent.parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", HELP_PROBE], env=env,
                         text=True, capture_output=True, timeout=300,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["code"] == 0
    assert "--listen" in got["help"] and "--once" in got["help"]
    assert got["bad"] == []


# the mesh entry point as ``python -m`` runs it (two gloo ranks on the CPU),
# then the modules loaded in this process; each rank prints its own
SPMD_PROBE = """
import contextlib, io, json, runpy, sys
sys.argv = ["spmd", "--arch", "qwen3-8b", "--reduced", "--device", "cpu",
            *json.loads(sys.argv[1])]
out = io.StringIO()
with contextlib.redirect_stdout(out):
    try:
        runpy.run_module("repro_torch.launch.spmd", run_name="__main__")
    except SystemExit as e:
        code = e.code
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"code": code, "out": out.getvalue(), "bad": bad}))
"""


def _spmd(args):
    """``python -m repro_torch.launch.spmd`` (reduced qwen3-8b, on the
    CPU) with ``args``: its printed lines, once its exit code is 0 and no
    foreign module loaded in it."""
    src = pathlib.Path(__file__).resolve().parent.parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", SPMD_PROBE, json.dumps(args)],
                         env=env, text=True, capture_output=True,
                         timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["code"] == 0 and got["bad"] == []
    return [json.loads(l) for l in got["out"].splitlines()]


def test_the_mesh_entry_point_and_its_ranks_import_neither_jax_nor_repro():
    """``python -m repro_torch.launch.spmd ... --device cpu``: the entry
    point, and each rank it spawns (which imports the collectives, the
    live mesh and the sharded model), load only the port."""
    lines = _spmd(["--mesh", "1x2"])
    assert lines[0] == {"spmd": "backend", "backend": "gloo",
                        "mesh": [1, 2], "device": "cpu"}
    ranks = [l for l in lines if l["spmd"] == "rank"]
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["foreign"] == []
        assert r["collectives"]["all_reduce"]["model"]["calls"] > 0
    assert lines[-1]["spmd"] == "check" and lines[-1]["ok"]


def test_the_mesh_train_entry_point_checks_ok_on_two_data_ranks():
    """``python -m repro_torch.launch.spmd --shape train --mesh 2x1
    --reduced --device cpu``: the gradients at the starting weights and 2
    AdamW steps with ZeRO-3 over two data ranks, held against one process
    (``check_train``); each rank reduce-scatters in its backward and loads
    only the port."""
    lines = _spmd(["--mesh", "2x1", "--shape", "train"])
    assert lines[0] == {"spmd": "backend", "backend": "gloo",
                        "mesh": [2, 1], "device": "cpu"}
    ranks = [l for l in lines if l["spmd"] == "rank"]
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["foreign"] == []
        rs = r["collectives"]["reduce_scatter"]["data"]
        assert rs["calls"] == rs["backward"] > 0
    check = lines[-1]
    assert check["spmd"] == "check" and check["ok"] and check["steps"] == 2
    assert check["grads_leaf_scaled_err"] <= check["limits"]["grads"]
