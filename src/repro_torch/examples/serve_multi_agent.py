"""Serve a multi-agent workload LIVE through the cluster gateway: the port
of ``examples/serve_multi_agent.py``.

Train the agent-aware cost predictor on a recorded trace, build a fleet of
real engines across simulated-RTT clusters, convert a generated workflow
trace into live jobs, and serve them end to end through the Maestro
hierarchy (SRTF queue -> fitness routing -> rho-margin admission -> node
engines -> calibration feedback).

  PYTHONPATH=src python -m repro_torch.examples.serve_multi_agent
                                          [inproc|process|socket] [--device D]

The nodes run on ``cuda`` unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.predictor import MaestroPred, PredictorConfig
from repro_torch.core.predictor.gbdt import GBDTConfig
from repro_torch.data.tracegen import generate_trace, stratified_temporal_split
from repro_torch.serving.cluster import ClusterSpec, build_fleet, jobs_from_trace
from repro_torch.serving.gateway import ClusterGateway, GatewayConfig
from repro_torch.serving.worker import close_fleet


def train_predictor(train_jobs: int = 300, seed: int = 9) -> MaestroPred:
    jobs = generate_trace(train_jobs, seed=seed)
    train, _ = stratified_temporal_split(jobs)
    cfg = PredictorConfig(
        cls=GBDTConfig(objective="logloss", n_trees=30, max_leaves=7),
        reg=GBDTConfig(n_trees=40, max_leaves=15))
    return MaestroPred(cfg).fit(
        [s.obs for s in train],
        np.array([s.true_len for s in train], float),
        np.array([float(s.tool_call) for s in train]))


def main(n_jobs: int = 6, train_jobs: int = 300, policy: str = "maestro",
         seed: int = 7, backend: str = "inproc", device=None):
    """``policy`` is any name of the policy registry
    (``repro_torch.core.sched.policies``). ``backend``: "inproc" steps
    every node in this process (deterministic default), "process" spawns
    one worker process per node, "socket" runs the same workers over the
    framed-TCP transport. ``device``: the nodes' device, ``cuda`` unless
    named. Returns the run's ``GatewayMetrics``."""
    print(f"[serve] training the agent-aware cost predictor "
          f"({train_jobs} recorded jobs) ...")
    pred = train_predictor(train_jobs)

    spec = ClusterSpec()     # 3 real nodes over 2 clusters, 3-model zoo
    print(f"[serve] building {len(spec.nodes)} {backend} nodes over "
          f"{spec.n_clusters} clusters, zoo={list(spec.model_names)} ...")
    fleet = build_fleet(spec, backend=backend, device=device)

    trace = generate_trace(n_jobs, rate=1.5, seed=seed)
    jobs = jobs_from_trace(trace, n_clusters=spec.rtt_s.shape[0], seed=seed)
    n_stages = sum(len(j.stages) for j in jobs)
    print(f"[serve] serving {len(jobs)} jobs / {n_stages} stages "
          f"under the '{policy}' policy ...")

    t0 = time.time()
    try:
        gw = ClusterGateway(fleet, spec.rtt_s, predictor=pred, policy=policy,
                            cfg=GatewayConfig(node_backend=backend))
        m = gw.run(jobs)
        print(f"[serve] done in {time.time() - t0:.1f}s wall "
              f"({gw.tick} ticks = {gw.now:.1f}s virtual)")
        if backend != "inproc":
            wire = (f", {m.rpc_bytes_sent + m.rpc_bytes_recv} B on the wire"
                    if backend == "socket" else "")
            print(f"[serve]   worker IPC           : {m.ipc_calls} round "
                  f"trips ({m.ipc_wall_s:.1f}s), engine step wall "
                  f"{m.worker_step_wall_s:.1f}s{wire}")
        print(f"[serve]   finished jobs        : {m.finished_jobs}/"
              f"{len(jobs)} (dropped {m.dropped_jobs})")
        print(f"[serve]   SLO attainment       : {m.slo_attainment:.2f}")
        print(f"[serve]   mean / p95 latency   : {m.mean_latency_s:.2f}s / "
              f"{m.p95_latency_s:.2f}s")
        print(f"[serve]   interactive q-delay  : "
              f"{m.interactive_queue_delay_s:.2f}s")
        print(f"[serve]   cold starts / preempt: {m.cold_starts} / "
              f"{m.preemptions}")
        print(f"[serve]   generated tokens     : {m.generated_tokens}")
        if gw.ctl is not None:
            print(f"[serve]   calibrated rho       : {gw.ctl.rho.rho:.3f}")
        for nid, node in gw.fleet.items():
            sig = node.signal()
            print(f"[serve] node {nid} (cluster {node.cluster_id}): "
                  f"warm={sorted(sig.warm_models)} "
                  f"headroom={sig.headroom / 1e6:.0f}MB")
    finally:
        # handles, not the gateway: covers constructor failures too
        close_fleet(fleet)
    return m


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("backend", nargs="?", default="inproc",
                    choices=["inproc", "process", "socket"])
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(backend=a.backend, device=a.device)
