"""Cross-cluster scheduling playground: replay a Table-I-style trace through
the discrete-event simulator under any registered policy and print the
Fig. 7-style metrics. The port of ``examples/cross_cluster_sim.py``; it
runs on the host (numpy), no card.

  PYTHONPATH=src python -m repro_torch.examples.cross_cluster_sim \\
      --policy maestro --rate 2.0 --batch-ratio 0.8 --jobs 400
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np

from repro_torch.core.predictor import MaestroPred, PredictorConfig
from repro_torch.core.predictor.gbdt import GBDTConfig
from repro_torch.core.sched.policies import (POLICIES, make_policy,
                                             registered_policies)
from repro_torch.data.tracegen import generate_trace, stratified_temporal_split
from repro_torch.sim.simulator import SimConfig, SimResult, Simulator


def train_predictor(n_jobs: int = 400) -> MaestroPred:
    jobs = generate_trace(n_jobs, seed=5)
    train, _ = stratified_temporal_split(jobs)
    cfg = PredictorConfig(
        cls=GBDTConfig(objective="logloss", n_trees=30, max_leaves=7),
        reg=GBDTConfig(n_trees=40, max_leaves=15))
    return MaestroPred(cfg).fit(
        [s.obs for s in train],
        np.array([s.true_len for s in train], float),
        np.array([float(s.tool_call) for s in train]))


def main(argv=None) -> List[SimResult]:
    """Returns one ``SimResult`` per policy run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="maestro",
                    choices=list(registered_policies()) + ["all"])
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--batch-ratio", type=float, default=0.8)
    ap.add_argument("--jobs", type=int, default=400)
    args = ap.parse_args(argv)

    names = (list(registered_policies()) if args.policy == "all"
             else [args.policy])
    mp = None
    if any(POLICIES[n].needs_predictor for n in names):
        print("[sim] training predictor ...")
        mp = train_predictor()
    print(f"[sim] {args.jobs} jobs @ {args.rate}/s, "
          f"batch ratio {args.batch_ratio}")
    results = []
    for name in names:
        jobs = generate_trace(args.jobs, rate=args.rate,
                              batch_ratio=args.batch_ratio, seed=13)
        r = Simulator(jobs, make_policy(name, predictor=mp),
                      SimConfig()).run()
        print(f"  {r.policy:12s} slo={r.slo_attainment:5.1%} "
              f"mean_lat={r.mean_latency_s:7.1f}s "
              f"interactive_queue={r.interactive_queue_delay_s:6.2f}s "
              f"cold_starts={r.cold_starts}")
        results.append(r)
    return results


if __name__ == "__main__":
    main()
