"""Multi-agent workflow trace generation (§IV.A).

Instantiates jobs from the Table-I templates with Poisson arrivals, unrolls
loops / fan-outs into stage DAGs, and samples ground-truth prompt/output
lengths with learnable structure:

  L ~ tool-call?  LogNormal(ln tool_len, 0.35)
      otherwise   LogNormal(ln base_len * (1 + complexity), sigma + 0.35*cot)

``complexity`` is a latent in [0,1] EXPRESSED IN THE PROMPT TEXT via signal
vocabulary — recoverable only through the semantic encoder (drives the
Table-VII ablation). The batch ratio can be re-weighted to sweep Fig. 7's
x-axis.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.predictor.features import StageObservation
from repro_torch.data.apps import APPS, APP_ID, MODELS, ROLE_ID, AppTemplate

_FILLER = ("the a of to and on for with into from about please could review "
           "data result answer item report note info step check list").split()
_COMPLEX_WORDS = ("thorough detailed comprehensive intricate elaborate "
                  "multifaceted exhaustive rigorous").split()
_SIMPLE_WORDS = "brief quick short simple concise minimal".split()
_TOPIC = ("travel menu booking flight code bug patch news market translation "
          "meeting schedule health recipe budget analysis").split()


@dataclasses.dataclass
class StageRecord:
    job_id: int
    stage_id: int
    deps: List[int]
    obs: StageObservation
    interactive: bool
    # ground truth (hidden from the scheduler until completion)
    true_len: int
    tool_call: bool
    # shared-prefix structure (team traces only): ordered (block_key,
    # n_tokens) pairs describing the prompt as a concatenation of named
    # blocks. Stages whose block sequences share a prefix share the SAME
    # leading prompt tokens when materialized (``jobs_from_trace`` derives
    # each block's token ids from its key alone), which is what the
    # cross-stage prefix cache exploits. None for classic traces.
    prompt_blocks: Optional[Tuple[Tuple[str, int], ...]] = None

    @property
    def model(self) -> str:
        return MODELS[self.obs.model_id]


@dataclasses.dataclass
class JobRecord:
    job_id: int
    app: str
    interactive: bool
    arrival_s: float
    stages: List[StageRecord]
    deadline_s: float = 0.0   # filled by the SLO profiler


def _prompt_text(rng, role: str, complexity: float, n_words: int) -> str:
    total = min(160, max(16, n_words // 8))
    # complexity expressed as a DENSITY of signal vocabulary (so the
    # window-mean-pooled embedding amplitude tracks it at any prompt length)
    n_sig = int(round(complexity * 0.35 * total))
    n_simple = int(round((1.0 - complexity) * 0.15 * total))
    words = list(rng.choice(_COMPLEX_WORDS, n_sig))
    words += list(rng.choice(_SIMPLE_WORDS, n_simple))
    words += list(rng.choice(_TOPIC, 3))
    words += list(rng.choice(_FILLER, max(4, total - len(words))))
    rng.shuffle(words)
    return " ".join(words)


def generate_trace(n_jobs: int, rate: float = 1.0,
                   batch_ratio: Optional[float] = None,
                   seed: int = 0) -> List[JobRecord]:
    """Poisson arrivals at `rate` jobs/s. batch_ratio rebalances the app mix
    (None keeps Table-I proportions)."""
    rng = np.random.default_rng(seed)
    weights = np.array([a.weight for a in APPS])
    if batch_ratio is not None:
        is_b = np.array([not a.interactive for a in APPS])
        w = weights.copy()
        w[is_b] *= batch_ratio / max(w[is_b].sum(), 1e-9)
        w[~is_b] *= (1 - batch_ratio) / max(w[~is_b].sum(), 1e-9)
        weights = w
    weights = weights / weights.sum()

    jobs: List[JobRecord] = []
    t = 0.0
    sid = 0
    for j in range(n_jobs):
        t += rng.exponential(1.0 / rate)
        app = APPS[rng.choice(len(APPS), p=weights)]
        stages: List[StageRecord] = []
        # unroll the template (loops + fanout) into a concrete DAG
        tmpl_to_last: Dict[int, List[int]] = {}  # template idx -> stage ids
        invocation = 0
        for ti, st in enumerate(app.stages):
            dep_ids: List[int] = []
            for d in st.deps:
                dep_ids += tmpl_to_last.get(d, [])
            copies = st.fanout if st.fanout > 1 else 1
            ids = []
            for c in range(copies):
                reps = 1
                while st.loop > 0 and rng.random() < st.loop and reps < 4:
                    reps += 1
                prev = list(dep_ids)
                for r in range(reps):
                    complexity = float(rng.random())
                    tool_call = bool(st.tools_available > 0
                                     and rng.random() < st.p_tool)
                    if tool_call:
                        L = rng.lognormal(np.log(st.tool_len), 0.25)
                    else:
                        # complexity (expressed in the prompt text) drives a
                        # ~6x dynamic range; residual lognormal noise is wider
                        # under CoT (heavy tail, Observation-1 / Fig. 1)
                        sig = 0.42 * st.sigma + (0.22 if st.cot else 0.0)
                        L = rng.lognormal(
                            np.log(st.base_len * (0.4 + 2.2 * complexity)), sig)
                    L = int(np.clip(L, 4, 8192))
                    P = int(np.clip(rng.lognormal(
                        np.log(st.prompt_base), 0.4), 16, 16384))
                    obs = StageObservation(
                        app=APP_ID[app.name], role=ROLE_ID[st.role],
                        position=ti / max(len(app.stages) - 1, 1),
                        invocation_idx=invocation,
                        tools_available=st.tools_available,
                        cot=st.cot, prompt_len=P, model_id=st.model_id,
                        text=_prompt_text(rng, st.role, complexity, P),
                        src_cluster=int(rng.integers(0, 3)))
                    rec = StageRecord(job_id=j, stage_id=sid, deps=prev,
                                      obs=obs, interactive=app.interactive,
                                      true_len=L, tool_call=tool_call)
                    stages.append(rec)
                    prev = [sid]
                    sid += 1
                    invocation += 1
                ids += prev
            tmpl_to_last[ti] = ids
        jobs.append(JobRecord(job_id=j, app=app.name,
                              interactive=app.interactive,
                              arrival_s=t, stages=stages))
    return jobs


# ---------------------------------------------------------------------------
# Multi-agent TEAM traces: workflows with explicit shared-prefix structure
# ---------------------------------------------------------------------------

# (shape name, app template name it reports as, ((role, deps), ...))
# Conversation-style topologies: every stage's prompt embeds its parent's
# full transcript (system prompt + every upstream turn) plus its own role
# header and turn — the LLM-MAS pattern that makes cross-stage KV reuse pay.
_TEAM_SHAPES: Tuple[Tuple[str, str, Tuple[Tuple[str, Tuple[int, ...]], ...]],
                    ...] = (
    ("pipeline", "document_writing",
     (("planner", ()), ("solver", (0,)), ("critic", (1,)),
      ("summarizer", (2,)))),
    ("fanout", "news_collection",
     (("supervisor", ()), ("worker", (0,)), ("worker", (0,)),
      ("worker", (0,)), ("summarizer", (1, 2, 3)))),
    ("debate", "qa_assistant",
     (("planner", ()), ("solver", (0,)), ("critic", (0,)),
      ("summarizer", (1, 2)))),
)


def generate_team_trace(n_jobs: int, rate: float = 2.0, seed: int = 0,
                        n_teams: int = 3, sys_tokens: int = 32,
                        role_tokens: int = 8, turn_tokens: int = 12
                        ) -> List[JobRecord]:
    """Agent-team workflows whose prompts carry explicit shared-prefix
    structure (``StageRecord.prompt_blocks``):

    - every job of team ``t`` opens with the same ``team{t}:sys`` system
      block, so cross-JOB reuse exists within a team;
    - each stage's prompt is its parent's block sequence plus a reply
      block (shared by siblings of the same parent — fan-out workers and
      debate branches diverge only at their role header), a role block and
      a unique turn block, so cross-STAGE reuse exists along every DAG edge.

    Block token ids are derived from the block key alone (see
    ``jobs_from_trace``), so equal keys materialize to identical tokens.
    ``model_id`` alternates over the attention models of the live zoo
    (1 + team % 2 -> qwen3-8b / starcoder2-15b under the default 3-model
    fleet); the SSM family keeps serving the classic trace mix."""
    rng = np.random.default_rng(seed)
    jobs: List[JobRecord] = []
    t = 0.0
    sid = 0
    for j in range(n_jobs):
        t += rng.exponential(1.0 / rate)
        team = j % n_teams
        _, app_name, shape = _TEAM_SHAPES[int(rng.integers(
            0, len(_TEAM_SHAPES)))]
        app = APPS[APP_ID[app_name]]
        stages: List[StageRecord] = []
        local_ids: List[int] = []
        for li, (role, deps) in enumerate(shape):
            dep_ids = [local_ids[d] for d in deps]
            if dep_ids:
                parent = stages[deps[0]]       # one stage per shape slot
                blocks = list(parent.prompt_blocks)
                blocks.append((f"reply:{j}:{parent.stage_id}", turn_tokens))
            else:
                blocks = [(f"team{team}:sys", sys_tokens)]
            blocks.append((f"role:{role}", role_tokens))
            blocks.append((f"turn:{j}:{sid}", turn_tokens))
            complexity = float(rng.random())
            L = int(np.clip(rng.lognormal(np.log(60.0), 0.5), 4, 512))
            n_prompt = sum(n for _, n in blocks)
            obs = StageObservation(
                app=APP_ID[app_name], role=ROLE_ID[role],
                position=li / max(len(shape) - 1, 1),
                invocation_idx=li, tools_available=0, cot=False,
                prompt_len=n_prompt * 32, model_id=1 + (team % 2),
                text=_prompt_text(rng, role, complexity, n_prompt * 32),
                src_cluster=team % 3)
            stages.append(StageRecord(
                job_id=j, stage_id=sid, deps=dep_ids, obs=obs,
                interactive=app.interactive, true_len=L, tool_call=False,
                prompt_blocks=tuple(blocks)))
            local_ids.append(sid)
            sid += 1
        jobs.append(JobRecord(job_id=j, app=app_name,
                              interactive=app.interactive,
                              arrival_s=t, stages=stages))
    return jobs


def flatten_stages(jobs: Sequence[JobRecord]) -> List[StageRecord]:
    return [s for j in jobs for s in j.stages]


def stratified_temporal_split(jobs: Sequence[JobRecord], test_frac: float = 0.2
                              ) -> Tuple[List[StageRecord], List[StageRecord]]:
    """§IV.A: within each (agent, tool-use, thinking-mode) group, the latest
    test_frac of records are the test set."""
    groups: Dict[Tuple, List[StageRecord]] = {}
    for s in flatten_stages(jobs):
        groups.setdefault(
            (s.obs.role, s.tool_call, s.obs.cot), []).append(s)
    train, test = [], []
    for g in groups.values():
        g = sorted(g, key=lambda s: s.stage_id)
        k = max(1, int(len(g) * test_frac))
        train += g[:-k]
        test += g[-k:]
    train.sort(key=lambda s: s.stage_id)
    test.sort(key=lambda s: s.stage_id)
    return train, test


# ---------------------------------------------------------------------------
# Production-traffic plane: pluggable arrival processes, heavy-tailed
# stage->model demand across the full zoo, heavy-tailed lengths.
#
# Everything below is ADDITIVE: ``generate_trace`` / ``generate_team_trace``
# above are frozen (their byte-exact outputs for existing seeds are pinned by
# tests/test_tracegen.py), and ``generate_workload`` draws from its own
# seeded streams so new knobs can never perturb legacy traces.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PoissonArrivals:
    """Homogeneous Poisson arrivals at ``rate`` jobs/s."""
    rate: float = 1.0

    def scaled(self, factor: float) -> "PoissonArrivals":
        return dataclasses.replace(self, rate=self.rate * factor)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        return np.cumsum(rng.exponential(1.0 / self.rate, n))


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals:
    """Non-homogeneous Poisson with a sinusoidal day/night rate profile,

        rate(t) = base + (peak - base) * 0.5 * (1 + sin(2*pi*t/period + phase))

    sampled exactly by thinning against ``peak_rate`` (Lewis & Shedler), so
    the draw count per arrival is itself seeded and reproducible."""
    base_rate: float = 0.5
    peak_rate: float = 4.0
    period_s: float = 120.0
    phase: float = -np.pi / 2  # start at the trough: traces open quiet

    def scaled(self, factor: float) -> "DiurnalArrivals":
        return dataclasses.replace(self, base_rate=self.base_rate * factor,
                                   peak_rate=self.peak_rate * factor)

    def rate_at(self, t: float) -> float:
        swing = 0.5 * (1.0 + np.sin(2.0 * np.pi * t / self.period_s
                                    + self.phase))
        return self.base_rate + (self.peak_rate - self.base_rate) * swing

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if not 0 < self.base_rate <= self.peak_rate:
            raise ValueError("need 0 < base_rate <= peak_rate")
        out = np.empty(n)
        t = 0.0
        for i in range(n):
            while True:
                t += rng.exponential(1.0 / self.peak_rate)
                if rng.random() * self.peak_rate <= self.rate_at(t):
                    break
            out[i] = t
        return out


@dataclasses.dataclass(frozen=True)
class MarkovModulatedArrivals:
    """Markov-modulated Poisson process: phases cycle round-robin with
    exponential dwell times; within phase ``k`` arrivals are Poisson at
    ``rates[k]``. The default is the classic 2-phase on/off burst model
    (long quiet spells punctured by short overload bursts). Restarting the
    exponential inter-arrival draw at each phase boundary is exact because
    the Poisson process is memoryless."""
    rates: Tuple[float, ...] = (0.5, 12.0)
    dwell_s: Tuple[float, ...] = (30.0, 8.0)
    start_phase: int = 0

    def scaled(self, factor: float) -> "MarkovModulatedArrivals":
        return dataclasses.replace(
            self, rates=tuple(r * factor for r in self.rates))

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return self.sample_with_phases(rng, n)[0]

    def sample_with_phases(self, rng: np.random.Generator, n: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Arrival times plus the phase index each arrival landed in (the
        phase trace is what the burst-occupancy property tests check)."""
        if len(self.rates) != len(self.dwell_s) or not self.rates:
            raise ValueError("rates and dwell_s must be equal-length, >= 1")
        if min(self.rates) <= 0 or min(self.dwell_s) <= 0:
            raise ValueError("rates and dwell times must be > 0")
        times = np.empty(n)
        phases = np.empty(n, np.int64)
        t = 0.0
        phase = self.start_phase % len(self.rates)
        phase_end = rng.exponential(self.dwell_s[phase])
        i = 0
        while i < n:
            dt = rng.exponential(1.0 / self.rates[phase])
            if t + dt <= phase_end:
                t += dt
                times[i] = t
                phases[i] = phase
                i += 1
            else:
                t = phase_end
                phase = (phase + 1) % len(self.rates)
                phase_end = t + rng.exponential(self.dwell_s[phase])
        return times, phases


ARRIVALS: Dict[str, type] = {
    "poisson": PoissonArrivals,
    "diurnal": DiurnalArrivals,
    "mmpp": MarkovModulatedArrivals,
}


@dataclasses.dataclass(frozen=True)
class ZipfDemand:
    """Heavy-tailed stage->model demand: rank ``k`` of the zoo gets
    probability proportional to ``(k+1)**-alpha``. ``order`` maps rank to
    model id (identity by default), so the hottest model is configurable.
    With ``n_models=10`` every family of the config zoo — vision, MoE, SSM,
    whisper included — receives traffic (``model_name`` resolves ids modulo
    the fleet's profile list)."""
    alpha: float = 1.1
    n_models: int = 10
    order: Optional[Tuple[int, ...]] = None

    def probs(self) -> np.ndarray:
        w = (np.arange(self.n_models) + 1.0) ** -self.alpha
        return w / w.sum()

    def model_id(self, rng: np.random.Generator) -> int:
        k = int(rng.choice(self.n_models, p=self.probs()))
        return int(self.order[k]) if self.order is not None else k


@dataclasses.dataclass(frozen=True)
class UniformDemand:
    """Uniform stage->model demand over the zoo (ablation baseline)."""
    n_models: int = 10

    def model_id(self, rng: np.random.Generator) -> int:
        return int(rng.integers(0, self.n_models))


DEMANDS: Dict[str, type] = {"zipf": ZipfDemand, "uniform": UniformDemand}


@dataclasses.dataclass(frozen=True)
class ParetoLengths:
    """Heavy-tailed prompt and output lengths: Lomax (Pareto type II),
    ``L = scale * (1 + Pareto(alpha))``, clipped to the engine bounds.
    alpha < 2 gives the infinite-variance decode tail that makes p99.9
    diverge from the mean (the regime Maestro's tail claims live in)."""
    out_scale: float = 90.0
    out_alpha: float = 1.5
    prompt_scale: float = 220.0
    prompt_alpha: float = 1.8
    out_cap: int = 8192
    prompt_cap: int = 16384

    def output_len(self, rng: np.random.Generator) -> int:
        L = self.out_scale * (1.0 + rng.pareto(self.out_alpha))
        return int(np.clip(L, 4, self.out_cap))

    def prompt_len(self, rng: np.random.Generator) -> int:
        P = self.prompt_scale * (1.0 + rng.pareto(self.prompt_alpha))
        return int(np.clip(P, 16, self.prompt_cap))


LENGTHS: Dict[str, type] = {"pareto": ParetoLengths}


def _make(registry: Dict[str, type], spec: Any, kind: str) -> Any:
    """Resolve a (name, kwargs) / name / instance spec against a registry."""
    if spec is None or not isinstance(spec, (str, tuple, list)):
        return spec  # already an instance (or None)
    if isinstance(spec, str):
        name, kwargs = spec, {}
    else:
        name, kwargs = spec[0], dict(spec[1]) if len(spec) > 1 else {}
    if name not in registry:
        raise KeyError(f"unknown {kind} {name!r}; have {sorted(registry)}")
    return registry[name](**kwargs)


def make_arrival(spec: Union[str, Tuple, "PoissonArrivals"]) -> Any:
    return _make(ARRIVALS, spec, "arrival process")


def generate_workload(n_jobs: int,
                      arrival: Any = "poisson",
                      demand: Any = None,
                      lengths: Any = None,
                      batch_ratio: Optional[float] = None,
                      seed: int = 0) -> List[JobRecord]:
    """Production-traffic generator: Table-I templates under a pluggable
    arrival process, optional heavy-tailed stage->model ``demand`` remapping
    (spanning the full zoo instead of the templates' fixed bindings), and
    optional heavy-tailed ``lengths`` overriding the lognormal draws.

    Arrival times and stage bodies come from independent
    ``np.random.default_rng([seed, k])`` streams, so the same seed gives a
    byte-identical trace for any fixed knob combination, and changing one
    knob (e.g. the arrival process) never reshuffles the others."""
    arrival = make_arrival(arrival)
    demand = _make(DEMANDS, demand, "demand distribution")
    lengths = _make(LENGTHS, lengths, "length distribution")
    arrivals = arrival.sample(np.random.default_rng([seed, 1]), n_jobs)
    rng = np.random.default_rng([seed, 2])

    weights = np.array([a.weight for a in APPS])
    if batch_ratio is not None:
        is_b = np.array([not a.interactive for a in APPS])
        w = weights.copy()
        w[is_b] *= batch_ratio / max(w[is_b].sum(), 1e-9)
        w[~is_b] *= (1 - batch_ratio) / max(w[~is_b].sum(), 1e-9)
        weights = w
    weights = weights / weights.sum()

    jobs: List[JobRecord] = []
    sid = 0
    for j in range(n_jobs):
        app = APPS[rng.choice(len(APPS), p=weights)]
        stages: List[StageRecord] = []
        tmpl_to_last: Dict[int, List[int]] = {}
        invocation = 0
        for ti, st in enumerate(app.stages):
            dep_ids: List[int] = []
            for d in st.deps:
                dep_ids += tmpl_to_last.get(d, [])
            copies = st.fanout if st.fanout > 1 else 1
            ids = []
            for c in range(copies):
                reps = 1
                while st.loop > 0 and rng.random() < st.loop and reps < 4:
                    reps += 1
                prev = list(dep_ids)
                for r in range(reps):
                    complexity = float(rng.random())
                    tool_call = bool(st.tools_available > 0
                                     and rng.random() < st.p_tool)
                    if tool_call:
                        L = int(np.clip(
                            rng.lognormal(np.log(st.tool_len), 0.25), 4, 8192))
                    elif lengths is not None:
                        L = lengths.output_len(rng)
                    else:
                        sig = 0.42 * st.sigma + (0.22 if st.cot else 0.0)
                        L = int(np.clip(rng.lognormal(
                            np.log(st.base_len * (0.4 + 2.2 * complexity)),
                            sig), 4, 8192))
                    if lengths is not None:
                        P = lengths.prompt_len(rng)
                    else:
                        P = int(np.clip(rng.lognormal(
                            np.log(st.prompt_base), 0.4), 16, 16384))
                    model_id = (demand.model_id(rng) if demand is not None
                                else st.model_id)
                    obs = StageObservation(
                        app=APP_ID[app.name], role=ROLE_ID[st.role],
                        position=ti / max(len(app.stages) - 1, 1),
                        invocation_idx=invocation,
                        tools_available=st.tools_available,
                        cot=st.cot, prompt_len=P, model_id=model_id,
                        text=_prompt_text(rng, st.role, complexity, P),
                        src_cluster=int(rng.integers(0, 3)))
                    rec = StageRecord(job_id=j, stage_id=sid, deps=prev,
                                      obs=obs, interactive=app.interactive,
                                      true_len=L, tool_call=tool_call)
                    stages.append(rec)
                    prev = [sid]
                    sid += 1
                    invocation += 1
                ids += prev
            tmpl_to_last[ti] = ids
        jobs.append(JobRecord(job_id=j, app=app.name,
                              interactive=app.interactive,
                              arrival_s=float(arrivals[j]), stages=stages))
    return jobs


# Named scenario presets for the tail-metric benchmark suite. Rates are
# tuned for the reduced-config live fleet; ``rate_scale`` sweeps them.
TAIL_SCENARIOS: Dict[str, Dict[str, Any]] = {
    # day/night sinusoid; moderately skewed demand over the full zoo
    "diurnal": dict(
        arrival=("diurnal", dict(base_rate=0.6, peak_rate=6.0,
                                 period_s=90.0)),
        demand=("zipf", dict(alpha=1.4, n_models=10))),
    # on/off bursts whose peak rate exceeds fleet capacity: the overload
    # regime where admission control and shedding differentiate policies
    "bursty-overload": dict(
        arrival=("mmpp", dict(rates=(0.8, 16.0), dwell_s=(24.0, 8.0))),
        demand=("zipf", dict(alpha=0.9, n_models=10)),
        lengths=("pareto", dict(out_alpha=1.4))),
    # steady arrivals, but heavy-tailed demand AND lengths across all ten
    # model families (vision, MoE, SSM, whisper included)
    "heavy-tail-zoo": dict(
        arrival=("poisson", dict(rate=2.5)),
        demand=("zipf", dict(alpha=1.2, n_models=10)),
        lengths=("pareto", dict())),
}


def scenario_workload(name: str, n_jobs: int, seed: int = 0,
                      rate_scale: float = 1.0) -> List[JobRecord]:
    """Instantiate a named ``TAIL_SCENARIOS`` preset at ``n_jobs`` jobs.
    ``rate_scale`` multiplies every arrival rate (smoke runs scale down)."""
    if name not in TAIL_SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(TAIL_SCENARIOS)}")
    spec = TAIL_SCENARIOS[name]
    arrival = make_arrival(spec["arrival"])
    if rate_scale != 1.0:
        arrival = arrival.scaled(rate_scale)
    return generate_workload(
        n_jobs, arrival=arrival, demand=spec.get("demand"),
        lengths=spec.get("lengths"), seed=seed)


def workload_fingerprint(jobs: Sequence[JobRecord]) -> str:
    """Hash every field of every job/stage (floats at full repr precision)
    into a short hex digest — the byte-reproducibility contract for the
    deterministic-workload tests."""
    h = hashlib.blake2b(digest_size=16)
    for j in jobs:
        h.update(repr((j.job_id, j.app, j.interactive, j.arrival_s,
                       j.deadline_s)).encode())
        for s in j.stages:
            h.update(repr((s.job_id, s.stage_id, tuple(s.deps),
                           s.interactive, s.true_len, s.tool_call,
                           s.prompt_blocks,
                           dataclasses.astuple(s.obs))).encode())
    return h.hexdigest()
