"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor any module of the JAX package ``repro``."""
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
                 "repro_torch.distributed.fault"):
        assert name in got["modules"], name
