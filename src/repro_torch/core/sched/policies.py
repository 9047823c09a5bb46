"""The unified scheduling-policy hierarchy (§IV.A baselines + §III Maestro).

Every policy is written ONCE against the :class:`~repro_torch.core.sched.substrate.
Substrate` protocol and runs unchanged on both planes — the trace-driven
simulator and the live real-engine gateway. All policies share the node
runtime (residency, accounting, profiles), arrivals and SLOs; they differ
ONLY in admission, routing and queue ordering, mirroring the paper's
controlled comparison:

  fcfs          — global FIFO, first feasible node (NOTE: before the API
                  unification the sim plane's fcfs routed least-loaded;
                  that behavior now lives under the explicit name
                  "least-loaded", and fcfs is the pure load-blind baseline
                  on both planes)
  least-loaded  — global FIFO, least-loaded feasible node
  edf           — deadline-first for batch, class priority for interactive
  oracle-srtf   — shortest TRUE remaining time (perfect-knowledge bound)
  maestro       — predicted remaining time (Eq. 7-8) + fitness routing
                  (Eq. 5, Alg. 3) + rho-margin admission + boundary
                  preemption, with Alg. 2 degradation plans entering both
                  feasibility (can_admit) and ranking (C_deg)
  maestro-np    — maestro without boundary preemption (Table II)
  baseline-lb / binpack / maestro-aff — Table VIII routing variants

Policy objects are STATELESS w.r.t. the substrate: the substrate is passed
per call, and all per-run state (controller, prediction cache, preemption
cooldowns) is re-created by ``setup()`` — so one policy instance can be
reused across repeated runs (or across planes) without leaking queue state.

Registering a new policy takes ~10 lines::

    from repro_torch.core.sched.policies import SchedPolicy, register

    class Random(SchedPolicy):
        name = "random"
        def priority(self, sub, stage, now):
            return hash(stage.stage_id) % 1000
    register("random", lambda predictor=None: Random(),
             doc="FIFO-order-free chaos baseline")

Then ``Simulator(jobs, "random")``, ``ClusterGateway(fleet, rtt,
policy="random")`` and both benchmark entry points accept it by name.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.control_loop import MaestroController
from repro_torch.core.sched.fitness import StageRequest
from repro_torch.core.sched.srtf import QueuedStage, SRTFQueue, state_key
from repro_torch.core.sched.substrate import SchedStage, Substrate

_INTERACTIVE_BOOST = 1e9   # interactive class strictly ahead of batch


class SchedPolicy:
    """Unified policy surface: priority / reservation / route / on_finish /
    preemption. Base behavior = non-predictive static reservation and
    least-loaded feasible routing."""

    name = "base"
    requeue_at_boundary = True    # boundary-preemption semantics (§III.D)

    # ------------------------------------------------------------ lifecycle
    def setup(self, sub: Substrate) -> None:
        """Per-run initialization; MUST reset all per-run state."""
        self._guard = SRTFQueue(preempt_gain_s=sub.preempt_gain_s,
                                cooldown_s=sub.preempt_cooldown_s)

    # ------------------------------------------------------------- surface
    def priority(self, sub: Substrate, stage: SchedStage, now: float) -> float:
        """Global-queue order (lower = first)."""
        raise NotImplementedError

    def reservation(self, sub: Substrate, stage: SchedStage) -> float:
        """KV bytes reserved at admission (R_need)."""
        return sub.static_reservation(stage)

    def predicted_len(self, sub: Substrate,
                      stage: SchedStage) -> Optional[float]:
        """L_hat for prediction-guided engine admission (None = none)."""
        return None

    def route(self, sub: Substrate, stage: SchedStage,
              r_need: float) -> Optional[int]:
        """Node id to dispatch to, or None (admission rejection)."""
        best, load = None, float("inf")
        for n in sub.node_ids():
            if sub.can_admit(n, r_need, stage.model):
                l = sub.load(n)
                if l < load:
                    best, load = n, l
        return best

    def should_preempt(self, sub: Substrate, running: SchedStage,
                       running_remaining_s: float, candidate: SchedStage,
                       now: float) -> bool:
        """Boundary preemption decision, guarded by hysteresis + cooldown."""
        if not self.requeue_at_boundary:
            return False
        cand = QueuedStage(
            stage_id=candidate.stage_id, job_id=candidate.job_id,
            interactive=candidate.interactive,
            t_exec=sub.t_exec_est(candidate,
                                  self.predicted_len(sub, candidate)),
            t_future=0.0)
        run = QueuedStage(
            stage_id=running.stage_id, job_id=running.job_id,
            interactive=running.interactive,
            t_exec=running_remaining_s, t_future=0.0)
        return self._guard.should_preempt(run, cand, running_remaining_s, now)

    def on_finish(self, sub: Substrate, stage: SchedStage, actual_kv: float,
                  job_remaining_s: float) -> None:
        """Post-execution calibration hook (substrate clock / bytes)."""


class FCFS(SchedPolicy):
    """Global FIFO + first feasible node; static KV reservation."""
    name = "fcfs"
    requeue_at_boundary = False

    def priority(self, sub, stage, now):
        return float(stage.stage_id)

    def route(self, sub, stage, r_need):
        for n in sub.node_ids():
            if sub.can_admit(n, r_need, stage.model):
                return n
        return None


class LeastLoaded(FCFS):
    """Global FIFO + least-loaded feasible node."""
    name = "least-loaded"

    def route(self, sub, stage, r_need):
        return SchedPolicy.route(self, sub, stage, r_need)


class EDF(SchedPolicy):
    """Earliest absolute deadline for batch, class priority for interactive."""
    name = "edf"
    requeue_at_boundary = False

    def priority(self, sub, stage, now):
        if stage.interactive:
            return -_INTERACTIVE_BOOST + stage.arrival_s
        return stage.arrival_s + stage.deadline_s


class OracleSRTF(SchedPolicy):
    """Shortest TRUE remaining job time — the perfect-knowledge upper bound."""
    name = "oracle-srtf"

    def priority(self, sub, stage, now):
        rem = sub.true_remaining_s(stage)
        return rem - (_INTERACTIVE_BOOST if stage.interactive else 0.0)


class Maestro(SchedPolicy):
    """The full hierarchy: workflow-aware SRTF (Eq. 7-8) + fitness routing
    (Eq. 5-6, Alg. 3) + rho-margin admission + boundary preemption, with
    Alg. 2 degradation cost in the routing score. Whether a policy needs a
    predictor is declared ONLY on its PolicySpec (see ``register`` below)."""
    name = "maestro"

    def __init__(self, predictor, gamma: float = 0.25, preempt: bool = True,
                 weights=None):
        self.predictor = predictor
        self.gamma = gamma
        self.weights = weights          # Optional[FitnessWeights]
        self.requeue_at_boundary = preempt
        self.ctl: Optional[MaestroController] = None
        self._cache: Dict[int, Dict[str, float]] = {}

    # ------------------------------------------------------------ lifecycle
    def setup(self, sub):
        self._guard = SRTFQueue(preempt_gain_s=sub.preempt_gain_s,
                                cooldown_s=sub.preempt_cooldown_s)
        self.ctl = MaestroController(self.predictor, sub.profiles, sub.rtt_s,
                                     weights=self.weights, gamma=self.gamma,
                                     queue=self._guard)
        self._cache = {}
        # batch-precompute per-stage predictions when the substrate knows
        # its stages up-front (same inputs the dispatch gateway would see at
        # stage creation; batching is just speed)
        stages = sub.known_stages()
        if stages and hasattr(self.predictor, "predict"):
            out = self.predictor.predict([s.obs for s in stages])
            for s, L, pt in zip(stages, out["length"], out["p_tool"]):
                self._store(sub, s, float(L), float(pt))

    # ----------------------------------------------------------- prediction
    def _store(self, sub, stage: SchedStage, l_hat: float,
               p_tool: float) -> None:
        prof = sub.profiles[stage.model]
        self._cache[stage.stage_id] = {
            "l_hat": l_hat, "p_tool": p_tool,
            "r_kv_hat": prof.r_kv(stage.prompt_len, l_hat)}

    def _pred(self, sub, stage: SchedStage) -> Dict[str, float]:
        p = self._cache.get(stage.stage_id)
        if p is None:
            out = self.predictor.predict_one(stage.obs)
            self._store(sub, stage, float(out["length"]),
                        float(out["p_tool"]))
            p = self._cache[stage.stage_id]
        return p

    def _state_key(self, stage: SchedStage, p: Dict[str, float]) -> Tuple:
        return state_key(stage.obs.app, stage.obs.role,
                         stage.obs.invocation_idx, p["p_tool"])

    # ------------------------------------------------------------- surface
    def priority(self, sub, stage, now):
        p = self._pred(sub, stage)
        t_rem = (sub.t_exec_est(stage, p["l_hat"])
                 + self.ctl.wf_profiles.future_median(self._state_key(stage,
                                                                      p)))
        # aging prevents starvation of long batch jobs
        wait = max(0.0, now - sub.ready_since(stage.stage_id))
        t_rem -= self.ctl.queue.aging * wait
        return t_rem - (_INTERACTIVE_BOOST if stage.interactive else 0.0)

    def reservation(self, sub, stage):
        return self.ctl.rho.r_need(self._pred(sub, stage)["r_kv_hat"])

    def predicted_len(self, sub, stage):
        return self._pred(sub, stage)["l_hat"]

    def _prefix_digests(self, sub, stage) -> Tuple[str, ...]:
        """Prompt prefix chain for routing; the base hierarchy is
        prefix-blind (see :class:`MaestroPrefix`)."""
        return ()

    def route(self, sub, stage, r_need):
        p = self._pred(sub, stage)
        prof = sub.profiles[stage.model]
        req = StageRequest(
            stage_id=stage.stage_id, model=stage.model, r_need=r_need,
            interactive=stage.interactive, src_cluster=stage.obs.src_cluster,
            t_exec=prof.t_exec(stage.prompt_len, p["l_hat"]),
            prefix_digests=self._prefix_digests(sub, stage))
        # feasibility filter FIRST (Alg. 3 line 3) — eviction-aware, so a
        # node admissible only via degradation stays in and is ranked by its
        # C_deg — then rank by S(N, T)
        nodes = [sub.signal(n) for n in sub.node_ids()
                 if sub.can_admit(n, r_need, stage.model)]
        if not nodes:
            return None
        sel = self.ctl.router.select(
            req, nodes,
            t_act_of=lambda sig, m: sub.t_act(sig.node_id, m),
            c_deg_of=lambda sig, rq: sub.degradation_cost(sig.node_id,
                                                          rq.r_need))
        return None if sel is None else sel[0].node_id

    def on_finish(self, sub, stage, actual_kv, job_remaining_s):
        p = self._pred(sub, stage)
        self.ctl.rho.observe(actual_kv, max(p["r_kv_hat"], 1.0))
        self.ctl.wf_profiles.record(self._state_key(stage, p),
                                    job_remaining_s)


class MaestroNoPreempt(Maestro):
    """Table II ablation: the full hierarchy minus boundary preemption."""
    name = "maestro-np"

    def __init__(self, predictor, gamma: float = 0.25):
        super().__init__(predictor, gamma=gamma, preempt=False)


class BaselineLB(Maestro):
    """Table VIII 'Baseline': load balancing, no prediction-guided packing."""
    name = "baseline-lb"

    def route(self, sub, stage, r_need):
        return SchedPolicy.route(self, sub, stage, r_need)

    def reservation(self, sub, stage):
        return SchedPolicy.reservation(self, sub, stage)


class BinPackOnly(Maestro):
    """Table VIII 'BinPack Only': KV-aware packing, network-blind (gamma=0)."""
    name = "binpack"

    def __init__(self, predictor):
        super().__init__(predictor, gamma=0.0)


class MaestroAff(Maestro):
    """Table VIII 'Maestro-Aff': full fitness scoring (gamma=0.25)."""
    name = "maestro-aff"


class MaestroPrefix(Maestro):
    """Maestro + prefix-affinity routing: successor stages are steered to
    the node whose prefix index already holds their shared prompt prefix
    (system prompt / role template / carried conversation), so the engine
    aliases cached KV pages instead of re-prefilling them."""
    name = "maestro-prefix"

    def __init__(self, predictor, gamma: float = 0.25,
                 w_prefix: float = 0.6):
        from repro_torch.core.sched.fitness import FitnessWeights
        super().__init__(predictor, gamma=gamma,
                         weights=FitnessWeights(w_prefix=w_prefix))

    def _prefix_digests(self, sub, stage):
        return tuple(sub.prefix_digests(stage))


# ---------------------------------------------------------------------------
# Registry: ONE string-dispatch table for both planes and all benchmarks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PolicySpec:
    name: str
    factory: Callable[..., SchedPolicy]    # factory(predictor=None) -> policy
    needs_predictor: bool = False
    doc: str = ""


POLICIES: Dict[str, PolicySpec] = {}


def register(name: str, factory: Callable[..., SchedPolicy],
             needs_predictor: bool = False, doc: str = "") -> None:
    POLICIES[name] = PolicySpec(name, factory, needs_predictor, doc)


def registered_policies() -> Tuple[str, ...]:
    return tuple(POLICIES)


def make_policy(name: str, predictor=None) -> SchedPolicy:
    """Instantiate a registered policy by name (the single entry point the
    simulator, the gateway, the examples and the benchmarks all use)."""
    spec = POLICIES.get(name)
    if spec is None:
        raise ValueError(f"unknown policy {name!r}; registered: "
                         f"{', '.join(sorted(POLICIES))}")
    if spec.needs_predictor and predictor is None:
        raise ValueError(f"policy {name!r} needs a trained predictor "
                         "(pass predictor=...)")
    return spec.factory(predictor=predictor)


register("fcfs", lambda predictor=None: FCFS(),
         doc="global FIFO, first feasible node")
register("least-loaded", lambda predictor=None: LeastLoaded(),
         doc="global FIFO, least-loaded feasible node")
register("edf", lambda predictor=None: EDF(),
         doc="deadline-first batch, class-priority interactive")
register("oracle-srtf", lambda predictor=None: OracleSRTF(),
         doc="true shortest-remaining-time (perfect-knowledge bound)")
register("maestro", lambda predictor=None: Maestro(predictor),
         needs_predictor=True, doc="full hierarchy (Eq. 5-8, Alg. 2-3)")
register("maestro-np", lambda predictor=None: MaestroNoPreempt(predictor),
         needs_predictor=True, doc="maestro without boundary preemption")
register("baseline-lb", lambda predictor=None: BaselineLB(predictor),
         needs_predictor=True, doc="Table VIII load-balancing baseline")
register("binpack", lambda predictor=None: BinPackOnly(predictor),
         needs_predictor=True, doc="Table VIII network-blind packing")
register("maestro-aff", lambda predictor=None: MaestroAff(predictor),
         needs_predictor=True, doc="Table VIII full fitness scoring")
register("maestro-prefix", lambda predictor=None: MaestroPrefix(predictor),
         needs_predictor=True,
         doc="maestro + prefix-affinity routing over cached KV prefixes")
