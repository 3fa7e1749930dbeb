"""DéjàVu controller: heartbeats, the replication status map and the
recovery audit log (the port's copy of `repro.core.controller`).

The paper's §4.2.3 protocol:

- workers send heartbeats (`StageWorker.heartbeat`); a dead worker is
  reported as failed;
- replication acks (x, j, t) keep the replication status map: the last
  step of microbatch (or sequence) j whose KV worker x has replicated;
- 4-step recovery: (1) the ring successor returns the failed worker's
  replica, (2) the ring predecessor re-replicates its own KV to the new
  worker, (3) the controller finds the step to re-execute from, (4) every
  stage resumes from that point.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class RequestRecord:
    rid: int
    prompt_len: int
    max_new: int
    tokens: List[int] = field(default_factory=list)   # emitted tokens
    done: bool = False
    submit_time: float = 0.0
    finish_time: float = 0.0


class Controller:
    def __init__(self):
        self.workers: List = []
        self.requests: Dict[int, RequestRecord] = {}
        # replication status: (worker, microbatch or sequence) -> replicated step
        self.rep_status: Dict[Tuple[int, int], int] = {}
        self.events: List[dict] = []      # audit log (failures, recoveries)

    def register(self, worker) -> None:
        self.workers.append(worker)

    def ack_replication(self, wid: int, mb: int, step: int) -> None:
        """Called by the streamer once a replica copy has landed."""
        if step > self.rep_status.get((wid, mb), -1):
            self.rep_status[(wid, mb)] = step

    def replicated_step(self, wid: int, mb: int) -> int:
        return self.rep_status.get((wid, mb), -1)

    def check_failures(self) -> List[int]:
        """The wids of the dead workers."""
        return [w.wid for w in self.workers if not w.alive]

    def resume_point(self, failed_wid: int, active_mbs: List[int]) -> Dict[int, int]:
        """Step 3 of recovery: the earliest non-replicated step per
        microbatch (or sequence)."""
        return {mb: self.replicated_step(failed_wid, mb) + 1 for mb in active_mbs}

    def log_event(self, kind: str, **kw) -> None:
        self.events.append({"kind": kind, "t": time.monotonic(), **kw})
