"""The 9 LLM-MAS application templates of Table I.

Each template encodes a common agent topology (serial tool-use loops,
supervisor-worker fan-out/fan-in, multi-step reasoning with refinement) as a
DAG of role-typed stage templates. Jobs instantiated from a template share
application logic but differ in inputs — matching §IV.A's trace construction.

Output-length ground truth is generated from role/tool/CoT-conditioned
distributions (Observation-1: tool stages emit short structured outputs;
CoT shifts outputs heavy-tailed), modulated by a latent prompt "complexity"
that is expressed in the prompt TEXT — so the semantic encoder has real
signal to recover (Table VII's ablation direction).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# role ids
ROLES = ["planner", "solver", "critic", "tool_agent", "writer", "translator",
         "supervisor", "worker", "summarizer", "coder", "reviewer", "chat"]
ROLE_ID = {r: i for i, r in enumerate(ROLES)}

# the node-level model zoo (Table V's Qwen3 family, by id)
MODELS = ["qwen3-0.6b", "qwen3-1.7b", "qwen3-4b", "qwen3-8b", "qwen3-14b"]
MODEL_PARAMS_B = [0.6, 1.7, 4.0, 8.0, 14.0]


@dataclasses.dataclass(frozen=True)
class StageTemplate:
    role: str
    model_id: int
    tools_available: int = 0
    p_tool: float = 0.0          # prob. this stage actually makes a tool call
    cot: bool = False
    base_len: float = 180.0      # lognormal median of output tokens (non-tool)
    sigma: float = 0.6           # lognormal sigma (CoT adds +0.35)
    tool_len: float = 45.0       # median when the stage emits a tool call
    prompt_base: int = 300
    deps: Tuple[int, ...] = ()   # indices of prerequisite stages
    loop: float = 0.0            # prob. of repeating this stage (geometric)
    fanout: int = 1              # >1 => supervisor-worker parallel copies


@dataclasses.dataclass(frozen=True)
class AppTemplate:
    name: str
    interactive: bool
    weight: float                # job mix proportion (Table I #Jobs)
    stages: Tuple[StageTemplate, ...]
    slo_factor: float = 2.0      # deadline = slo_factor x isolated p50


def _st(role, model_id, **kw) -> StageTemplate:
    return StageTemplate(role=role, model_id=model_id, **kw)


APPS: List[AppTemplate] = [
    AppTemplate("meeting_booking", True, 8626 / 46769, (
        _st("planner", 1, base_len=120, prompt_base=200),
        _st("tool_agent", 0, tools_available=3, p_tool=0.85, base_len=150,
            tool_len=40, deps=(0,), loop=0.35),
        _st("chat", 1, base_len=90, prompt_base=350, deps=(1,)),
    )),
    AppTemplate("document_writing", False, 8319 / 46769, (
        _st("planner", 2, base_len=250, cot=True, prompt_base=400),
        _st("writer", 3, base_len=700, sigma=0.7, prompt_base=600, deps=(0,)),
        _st("critic", 2, base_len=220, cot=True, deps=(1,), loop=0.4),
        _st("writer", 3, base_len=500, prompt_base=900, deps=(2,)),
    )),
    AppTemplate("news_collection", False, 6616 / 46769, (
        _st("supervisor", 2, base_len=200, prompt_base=250),
        _st("worker", 0, tools_available=2, p_tool=0.7, base_len=180,
            tool_len=50, deps=(0,), fanout=4),
        _st("summarizer", 3, base_len=420, prompt_base=1500, deps=(1,)),
    )),
    AppTemplate("performance", False, 6548 / 46769, (
        _st("tool_agent", 1, tools_available=2, p_tool=0.8, base_len=160,
            tool_len=35, prompt_base=800),
        _st("solver", 3, base_len=450, cot=True, prompt_base=1000, deps=(0,)),
        _st("writer", 2, base_len=380, deps=(1,)),
    )),
    AppTemplate("qa_assistant", True, 5849 / 46769, (
        _st("solver", 4, base_len=380, cot=True, sigma=0.8, prompt_base=500,
            tools_available=2, p_tool=0.3, tool_len=60, loop=0.3),
        _st("critic", 1, base_len=150, deps=(0,)),
        _st("chat", 3, base_len=260, prompt_base=700, deps=(1,)),
    )),
    AppTemplate("text_translation", False, 5124 / 46769, (
        _st("planner", 0, base_len=80, prompt_base=150),
        _st("translator", 1, base_len=550, sigma=0.5, prompt_base=700,
            deps=(0,), fanout=3),
        _st("critic", 1, base_len=120, deps=(1,)),
    )),
    AppTemplate("food_assistant", True, 3334 / 46769, (
        _st("chat", 0, base_len=110, prompt_base=200),
        _st("tool_agent", 0, tools_available=4, p_tool=0.9, base_len=130,
            tool_len=35, deps=(0,), loop=0.45),
        _st("chat", 1, base_len=140, deps=(1,)),
    )),
    AppTemplate("travel_assistant", True, 1543 / 46769, (
        # the real multi-model workflow of Table IV: six invocations, 3 models
        _st("planner", 2, base_len=220, cot=True, prompt_base=300),
        _st("tool_agent", 0, tools_available=5, p_tool=0.9, base_len=140,
            tool_len=45, deps=(0,)),
        _st("solver", 2, base_len=300, deps=(1,)),
        _st("tool_agent", 0, tools_available=5, p_tool=0.85, base_len=140,
            tool_len=45, deps=(2,)),
        _st("writer", 4, base_len=420, prompt_base=900, deps=(3,)),
        _st("chat", 2, base_len=160, deps=(4,)),
    )),
    AppTemplate("code_refactoring", False, 810 / 46769, (
        _st("planner", 3, base_len=300, cot=True, prompt_base=2500),
        _st("coder", 4, base_len=900, sigma=0.8, cot=True, prompt_base=3000,
            deps=(0,), loop=0.5),
        _st("reviewer", 3, base_len=350, cot=True, prompt_base=3500,
            deps=(1,)),
    )),
]

APP_ID = {a.name: i for i, a in enumerate(APPS)}


def interactive_ratio() -> float:
    return sum(a.weight for a in APPS if a.interactive)
