"""RoundScheduler / StepPlan: the continuous-batching policy (the port's
copy of `repro.serving.scheduler`, without the telemetry and tracing calls).

The scheduler owns the request lifecycle (queue -> active -> preempted /
retired) and emits one `StepPlan` per round; the engine executes it.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, Iterable, List, Optional

from repro_torch.serving.request import Request


@dataclass
class StepPlan:
    """One continuous-batching round, as planned by `RoundScheduler`.

    `work` is the round's active set in admission order: every request in it
    gets one unit of progress this round — a prefill chunk pass while its
    `next_step` is 0, else one decode step.  The engine re-checks
    eligibility (membership, token budget, eos) at execution time, because
    mid-round preemption can change it after planning.  Under fused rounds the engine
    executes all decodes in ONE batched pipeline pass and all chunk-mode
    prefills in one chunk-set pass; the oracle path runs one pass each.
    """
    round_idx: int
    n_active: int
    work: List[Request] = field(default_factory=list)


class RoundScheduler:
    """Admission / resume / preemption / retirement policy for
    `run_continuous` (engine-agnostic: it never runs a pipeline pass
    itself).

    Lifecycle per round: `plan_round` resumes preempted requests, admits
    queued ones while the pools fit them (a fresh admission runs its first
    step through the injected callback so the NEXT admission decision sees
    the pool state that step leaves behind), and snapshots the active set
    into a `StepPlan`; the engine executes it, calling `preempt` when a pool
    fills mid-round; `retire` then returns finished requests' blocks.
    """

    def __init__(self, cluster, requests: List[Request], *, max_active: int):
        self.cl = cluster
        self.max_active = max_active
        self.queue: Deque[Request] = deque(
            sorted(requests, key=lambda r: (r.arrival, r.rid)))
        self.active: List[Request] = []
        self._active_ids: set = set()
        self.preempted: Deque[Request] = deque()
        self.next_step: Dict[int, int] = {r.rid: 0 for r in requests}
        self.rounds = 0

    # ------------------------------------------------------------------
    # state queries
    # ------------------------------------------------------------------
    def pending(self) -> bool:
        return bool(self.queue or self.active or self.preempted)

    def is_active(self, rid: int) -> bool:
        return rid in self._active_ids

    # ------------------------------------------------------------------
    # policy
    # ------------------------------------------------------------------
    def plan_round(self, first_step: Callable[[Request], None]) -> StepPlan:
        """Resume / admit into freed pool space, then snapshot the round."""
        cl = self.cl
        while self.preempted and len(self.active) < self.max_active and \
                cl.can_resume(self.preempted[0].rid, len(self.active)):
            r = self.preempted.popleft()
            cl.resume_seq(r.rid)
            self._activate(r)
        while self.queue and len(self.active) < self.max_active and \
                cl.can_admit(self.queue[0].prompt_len, len(self.active)):
            r = self.queue.popleft()
            first_step(r)
            self._activate(r)
        if not self.active:
            # pending() held, so work exists that no pool can take
            raise MemoryError("pool cannot admit any request — "
                              "kv_pool_blocks too small for this trace")
        self.rounds += 1
        return StepPlan(round_idx=self.rounds, n_active=len(self.active),
                        work=list(self.active))

    def pick_victim(self, exclude: Iterable[int] = ()) -> Optional[Request]:
        """Preemption victim for a full pool: the YOUNGEST active sequence
        that has device-resident blocks to free.  A mid-prefill sequence
        (next_step 0) is never a victim — its chunk cursor assumes the
        partial table stays put."""
        ex = set(exclude)
        return next(
            (v for v in reversed(self.active) if v.rid not in ex
             and self.next_step[v.rid] > 0
             and self.cl.resident_blocks(v.rid) > 0), None)

    def preempt(self, victim: Request) -> None:
        """Move a (already swapped-out) victim from active to the preempted
        FIFO; `plan_round` resumes it once blocks free up."""
        self.active = [a for a in self.active if a.rid != victim.rid]
        self._active_ids.discard(victim.rid)
        self.preempted.append(victim)

    def retire(self) -> List[Request]:
        """End of round: finished sequences return their blocks immediately
        (this is what lets the next round admit queued work)."""
        done = [r for r in self.active
                if self.next_step[r.rid] >= r.max_new or r.done]
        if done:
            gone = set()
            for r in done:
                r.done = True
                self.cl.free_seq(r.rid)
                gone.add(r.rid)
            self.active = [a for a in self.active if a.rid not in gone]
            self._active_ids -= gone
        return done

    # ------------------------------------------------------------------
    def _activate(self, r: Request) -> None:
        self.active.append(r)
        self._active_ids.add(r.rid)
