"""Discrete-event pipeline scheduler (the port's copy of `repro.core.schedule`).

Models pipeline-parallel LLM serving exactly as the paper draws it (Figs. 3,
8, 26): work items (P = prompt step, T = one token step) flow through stages
with three dependency kinds —

  activation:  (mb, step, stage s) needs (mb, step, s−1)
  cache order: (mb, T_i, stage s) needs (mb, T_{i−1}, s)
  admission:   at most `max_inflight` microbatches in flight; the next
               queued microbatch enters when a finishing one clears stage 0

Stage occupancy is greedy-FIFO.  The same engine drives the Appendix-B
simulator (durations only) and, via `exec_cb`, the real in-process cluster
(items executed in dependency order with actual arrays).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

Key = Tuple[str, int, str, int, int]  # (pipeline, mb, kind, step, stage)


@dataclass(frozen=True)
class Item:
    pipeline: str
    mb: int
    kind: str          # "P" | "T"
    step: int          # 0 for P, token index for T
    stage: int
    duration: float

    @property
    def key(self) -> Key:
        return (self.pipeline, self.mb, self.kind, self.step, self.stage)


@dataclass
class Trace:
    start: Dict[Key, float] = field(default_factory=dict)
    finish: Dict[Key, float] = field(default_factory=dict)

    @property
    def makespan(self) -> float:
        return max(self.finish.values(), default=0.0)


class EventEngine:
    """Generic dependency-driven greedy scheduler."""

    def __init__(self, exec_cb: Optional[Callable[[Item], None]] = None):
        self.exec_cb = exec_cb
        self.items: Dict[Key, Item] = {}
        self.deps: Dict[Key, List[Key]] = {}
        self.extra_delay: Dict[Key, float] = {}
        self.release: Dict[Key, float] = {}
        self._uid = itertools.count()

    def add(self, item: Item, deps: List[Key] = (), release: float = 0.0,
            extra_delay: float = 0.0) -> None:
        self.items[item.key] = item
        self.deps[item.key] = list(deps)
        self.release[item.key] = release
        self.extra_delay[item.key] = extra_delay

    def run(self, stage_free: Optional[Dict[Tuple[str, int], float]] = None
            ) -> Trace:
        trace = Trace()
        stage_free = dict(stage_free or {})
        pending = {k: set(d for d in ds if d in self.items)
                   for k, ds in self.deps.items()}
        dependents: Dict[Key, List[Key]] = {}
        for k, ds in pending.items():
            for d in ds:
                dependents.setdefault(d, []).append(k)
        heap: List[Tuple[float, int, Key]] = []
        for k, ds in pending.items():
            if not ds:
                heapq.heappush(heap, (self.release[k], next(self._uid), k))
        done = set()
        while heap:
            ready, _, key = heapq.heappop(heap)
            if key in done:
                continue
            item = self.items[key]
            sk = (item.pipeline, item.stage)
            start = max(ready, stage_free.get(sk, 0.0))
            fin = start + item.duration + self.extra_delay[key]
            stage_free[sk] = fin
            trace.start[key] = start
            trace.finish[key] = fin
            done.add(key)
            if self.exec_cb is not None:
                self.exec_cb(item)
            for dep in dependents.get(key, ()):  # release newly-ready items
                pending[dep].discard(key)
                if not pending[dep]:
                    rel = max([self.release[dep]] +
                              [trace.finish[d] for d in self.deps[dep]
                               if d in trace.finish])
                    heapq.heappush(heap, (rel, next(self._uid), dep))
        return trace


@dataclass
class Job:
    mb: int
    arrival: float
    n_tokens: int


# ---------------------------------------------------------------------------
# Strict round-robin pipeline schedule (FasterTransformer semantics, Fig. 3)
# ---------------------------------------------------------------------------

def rr_schedule(jobs: List[Job], *, pipeline: str, depth: int, p_dur: float,
                t_dur: float, max_inflight: Optional[int] = None,
                do_prompt: bool = True, do_tokens: bool = True,
                token_gate: Optional[Dict[int, float]] = None,
                exec_cb: Optional[Callable[[Item], None]] = None
                ) -> Tuple[Trace, List[Item]]:
    """Generate + time the strict round-robin schedule the paper's systems use
    (FasterTransformer, modified for microbatch-level replacement — §5).

    Each stage processes in-flight microbatch slots in a FIXED cyclic order
    (P on entry, then T steps); a slot is backfilled from the queue when its
    microbatch early-stops.  Bubbles arise exactly as in Fig. 3: a slow P (or
    a not-yet-ready prompt handoff, `token_gate`) head-of-line-blocks every
    stage behind it.

    Modeled dependencies:
      stage occupancy — fixed per-stage order = emission order;
      activation      — (mb, step, s) starts after (mb, step, s−1);
      sampled token   — T_i at stage 0 starts after T_{i−1} cleared the LAST
                        stage (the next input token is sampled there);
      admission       — a queued job takes a slot only when the slot frees.

    Returns (trace, items in execution order) — `exec_cb` lets the real
    cluster run actual compute in this exact order.
    """
    max_inflight = max_inflight or depth
    trace = Trace()
    items: List[Item] = []
    queue = sorted(jobs, key=lambda j: (j.arrival, j.mb))
    slots: List[Optional[dict]] = [None] * max_inflight
    qi = 0
    stage_free = [0.0] * depth

    def emit(kind: str, mb: int, step: int, release: float, dur: float) -> float:
        prev_fin = release
        for s in range(depth):
            it = Item(pipeline, mb, kind, step, s, dur)
            start = max(prev_fin, stage_free[s])
            fin = start + it.duration
            stage_free[s] = fin
            trace.start[it.key] = start
            trace.finish[it.key] = fin
            items.append(it)
            if exec_cb is not None:
                exec_cb(it)
            prev_fin = fin
        return prev_fin

    active = 0
    while True:
        for q in range(max_inflight):
            if slots[q] is None and qi < len(queue):
                j = queue[qi]; qi += 1
                slots[q] = {"job": j, "step": -1, "release": j.arrival}
                active += 1
        if active == 0:
            break
        for q in range(max_inflight):
            st = slots[q]
            if st is None:
                continue
            j = st["job"]
            if st["step"] < 0:  # prompt (or external handoff gate)
                if do_prompt:
                    st["release"] = emit("P", j.mb, 0, st["release"], p_dur)
                else:
                    gate = (token_gate or {}).get(j.mb, j.arrival)
                    st["release"] = max(st["release"], gate)
                st["step"] = 0
                if not do_tokens:
                    slots[q] = None
                    active -= 1
                continue
            i = st["step"]
            st["release"] = emit("T", j.mb, i, st["release"], t_dur)
            st["step"] += 1
            if st["step"] >= j.n_tokens:
                slots[q] = None
                active -= 1
    return trace, items


def build_pipeline_items(engine: EventEngine, jobs: List[Job], *,
                         pipeline: str, depth: int, p_dur: float, t_dur: float,
                         max_inflight: Optional[int] = None,
                         do_prompt: bool = True, do_tokens: bool = True,
                         token_release: Optional[Dict[int, float]] = None,
                         token_extra_dep: Optional[Dict[int, Key]] = None,
                         t_extra_delay: float = 0.0) -> None:
    """Emit P/T items + deps for one pipeline.

    token_release/token_extra_dep: per-mb gate for T_0 (e.g. prompt handoff
    from a disaggregated prompt pipeline, incl. stream delay).
    max_inflight: admission control — mb i is gated on mb (i − max_inflight)
    clearing stage 0 of its final step.
    """
    max_inflight = max_inflight or depth
    for idx, job in enumerate(jobs):
        adm_deps: List[Key] = []
        release = job.arrival
        if idx >= max_inflight:
            prev = jobs[idx - max_inflight]
            last_kind = "T" if do_tokens else "P"
            last_step = prev.n_tokens - 1 if do_tokens else 0
            adm_deps.append((pipeline, prev.mb, last_kind, last_step, 0))
        if do_prompt:
            for s in range(depth):
                deps = list(adm_deps) if s == 0 else []
                if s > 0:
                    deps.append((pipeline, job.mb, "P", 0, s - 1))
                engine.add(Item(pipeline, job.mb, "P", 0, s, p_dur),
                           deps=deps, release=release)
        if do_tokens:
            for i in range(job.n_tokens):
                for s in range(depth):
                    deps: List[Key] = []
                    rel = release
                    if s > 0:
                        deps.append((pipeline, job.mb, "T", i, s - 1))
                    if i > 0:
                        deps.append((pipeline, job.mb, "T", i - 1, s))
                    else:
                        if do_prompt:
                            deps.append((pipeline, job.mb, "P", 0, depth - 1 if s == 0 else s))
                        if s == 0:
                            if token_extra_dep and job.mb in token_extra_dep:
                                deps.append(token_extra_dep[job.mb])
                            if token_release and job.mb in token_release:
                                rel = max(rel, token_release[job.mb])
                            deps.extend(adm_deps if not do_prompt else [])
                    engine.add(Item(pipeline, job.mb, "T", i, s, t_dur),
                               deps=deps, release=rel,
                               extra_delay=t_extra_delay if s == 0 and i == 0 else 0.0)
