"""Deterministic fault injection (the port's copy of
`repro.core.dejavulib.faults`).

Named **injection points** are fired from the streaming hot paths; each
point keeps a deterministic per-run occurrence count, and a `FaultPlan`
targets "the Nth occurrence of point P" with a chosen fault kind.

==========================  =====================================================
point                       fired from
==========================  =====================================================
``engine.step``             ServingEngine, once per scheduled sequence-step
``cluster.fail``            DejaVuCluster.inject_failure (observability only)
``stream.submit``           StreamEngine.submit (caller thread)
``stream.task``             StreamEngine worker thread, before running a task
``stream.wait``             StreamEngine.wait (caller thread)
``stream.drain``            StreamEngine.drain, before the barrier
``transport.transfer.<k>``  Transport.transfer, ``<k>`` the link kind
``tier.demote``             KVTierManager, before each demotion or spill
``tier.promote``            KVTierManager, before each up-tier read
``ssd.put``                 SSDStore.put, between the fsync and the rename
==========================  =====================================================

Fault kinds and how each site realises them:

- ``worker_death``: calls the installed ``worker_killer(wid)`` (the engine
  binds it to ``DejaVuCluster.inject_failure``); the op itself proceeds.
- ``error``: raises `FaultInjected` at the point (a hard crash of that op).
- ``task_error``: raises at ``stream.task``; the stream worker treats it as
  transient and retries the task once.
- ``ssd_write``: raised inside an SSD write; stream tasks retry it.
- ``drop``: returned to the site: the transport retransmits.
- ``corrupt``: returned to the site: the transport flips a byte of the
  received copy, detects the mismatch and retransmits.
- ``delay``: returned to the site: a straggler, with no effect on data.

Determinism: the points fired from the StreamEngine's worker thread are
serialised by its FIFO queue, and the cluster drains the streamer at fixed
barriers (after each replication round), so per-point occurrence counts
are the same in every run of one workload.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.core import telemetry, tracing

FAULT_KINDS = ("error", "task_error", "worker_death", "drop", "corrupt",
               "ssd_write", "delay")

#: kinds the StreamEngine worker treats as transient (one deterministic retry)
RETRYABLE_KINDS = frozenset({"task_error", "ssd_write"})

#: kinds that raise FaultInjected out of fire()
_RAISE_KINDS = frozenset({"error", "task_error", "ssd_write"})


class WorkerDead(RuntimeError):
    """A stage op, or a read of a worker's host tier, reached a dead
    worker: the one error the serving engine recovers from.  Any other
    error, a failed kernel launch included, propagates."""


class FaultInjected(Exception):
    """Raised by `FaultInjector.fire` for raising fault kinds.  Not a
    RuntimeError: no recovery path may absorb an injected op crash unless a
    site chooses to retry it."""

    def __init__(self, spec: "FaultSpec", point: str, n: int):
        super().__init__(f"injected fault {spec.kind!r} at {point!r} occurrence {n}")
        self.spec = spec
        self.point = point
        self.n = n


class StreamTaskError(Exception):
    """One or more fire-and-forget stream tasks failed in the background.
    Raised by ``StreamEngine.drain()`` / ``close()`` with the first failure
    as ``__cause__``."""


@dataclass(frozen=True)
class FaultSpec:
    """Fault one (or a window of) occurrence(s) of a named injection point.
    ``nth`` is 1-based; the spec matches occurrences ``nth .. nth+times-1``."""
    point: str
    nth: int
    kind: str = "error"
    wid: Optional[int] = None      # worker_death target
    delay_s: float = 0.0           # delay kind: straggler seconds (not modelled yet)
    times: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.nth < 1 or self.times < 1:
            raise ValueError("nth and times are 1-based counts")
        if self.kind == "worker_death" and self.wid is None:
            raise ValueError("worker_death spec needs a target wid")

    def matches(self, point: str, n: int) -> bool:
        return point == self.point and self.nth <= n < self.nth + self.times


class FaultPlan:
    """An ordered collection of `FaultSpec`s, indexed by point."""

    def __init__(self, specs: Iterable[FaultSpec] = ()):
        self._by_point: Dict[str, List[FaultSpec]] = {}
        self.specs: List[FaultSpec] = []
        for s in specs:
            self.add(s)

    def add(self, spec: FaultSpec) -> "FaultPlan":
        self.specs.append(spec)
        self._by_point.setdefault(spec.point, []).append(spec)
        return self

    def match(self, point: str, n: int) -> Optional[FaultSpec]:
        for s in self._by_point.get(point, ()):
            if s.matches(point, n):
                return s
        return None

    @classmethod
    def from_fail_at(cls, fail_at: Dict[int, int],
                     point: str = "engine.step") -> "FaultPlan":
        """The ``fail_at={gstep: wid}`` kwarg as a plan: ``engine.step``
        fires once per global step, so occurrence number == gstep."""
        return cls(FaultSpec(point, nth=g, kind="worker_death", wid=w)
                   for g, w in sorted(fail_at.items()))

    def __len__(self) -> int:
        return len(self.specs)

    def __repr__(self) -> str:
        return f"FaultPlan({self.specs!r})"


@dataclass
class FiredFault:
    """One realised fault (what EngineReport.fault_trace carries)."""
    point: str
    n: int
    kind: str
    tag: str = ""
    wid: Optional[int] = None


class FaultInjector:
    """Counts injection-point occurrences and realises a `FaultPlan`.

    One injector is one run.  ``counts`` maps point -> occurrences seen;
    with ``record=True`` every firing is appended to ``trace`` as
    ``(point, n, tag)``.  ``fired`` lists the faults actually realised."""

    def __init__(self, plan: Optional[FaultPlan] = None, record: bool = False):
        self.plan = plan if plan is not None else FaultPlan()
        self.record = record
        self.counts: Dict[str, int] = {}
        self.trace: List[Tuple[str, int, str]] = []
        self.fired: List[FiredFault] = []
        self.worker_killer: Optional[Callable[[Optional[int]], None]] = None
        self._lock = threading.Lock()

    def fire(self, point: str, tag: str = "") -> Optional[FaultSpec]:
        """Count one occurrence of `point`; realise a planned fault if any.

        Returns None (no fault, or a worker_death already delivered through
        ``worker_killer``), returns the spec for site-realised kinds
        (drop/corrupt/delay), or raises `FaultInjected`."""
        with self._lock:
            n = self.counts.get(point, 0) + 1
            self.counts[point] = n
            if self.record:
                self.trace.append((point, n, tag))
            spec = self.plan.match(point, n)
            if spec is not None:
                self.fired.append(FiredFault(point, n, spec.kind, tag, spec.wid))
        if spec is None:
            return None
        telemetry.count("faults.fired", 1, kind=spec.kind, point=point)
        if tracing.active():
            # every realised fault becomes a trace instant on the firing
            # thread's track, beside the passes it disrupted
            tracing.event(f"fault.{spec.kind}", point=point, n=n, tag=tag,
                          **({} if spec.wid is None else {"wid": spec.wid}))
        # actions run outside the lock: worker_killer may re-enter fire()
        # (inject_failure fires "cluster.fail")
        if spec.kind == "worker_death":
            if self.worker_killer is None:
                raise FaultInjected(spec, point, n)
            self.worker_killer(spec.wid)
            return None
        if spec.kind in _RAISE_KINDS:
            raise FaultInjected(spec, point, n)
        return spec


# ---------------------------------------------------------------------------
# Process-wide installation.  Sites call `faults.fire(point, tag)`; with no
# injector installed that is an early return.

_ACTIVE: Optional[FaultInjector] = None


def install(inj: FaultInjector) -> FaultInjector:
    global _ACTIVE
    _ACTIVE = inj
    return inj


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def current() -> Optional[FaultInjector]:
    return _ACTIVE


@contextmanager
def active(inj: FaultInjector):
    """Install `inj` for the duration of a with-block (restores the prior)."""
    prev = _ACTIVE
    install(inj)
    try:
        yield inj
    finally:
        if prev is None:
            uninstall()
        else:
            install(prev)


def fire(point: str, tag: str = "") -> Optional[FaultSpec]:
    inj = _ACTIVE
    if inj is None:
        return None
    return inj.fire(point, tag)


# ---------------------------------------------------------------------------
# Crash-consistency sweep helpers

def survivable_kinds(point: str) -> List[str]:
    """Fault kinds a correct implementation must fully recover from at
    `point`: token-identical output, no leaked blocks."""
    if point in ("engine.step", "stream.drain"):
        return ["worker_death"]
    if point == "stream.task":
        return ["task_error", "delay"]
    if point.startswith("transport.transfer."):
        return ["corrupt", "drop", "delay"] if point.endswith(".net") else ["drop", "delay"]
    if point == "ssd.put":
        return ["ssd_write"]
    if point in ("tier.demote", "tier.promote", "stream.submit", "stream.wait"):
        return ["delay"]
    if point == "cluster.fail":
        return []          # this is the failure mechanism, not a victim
    return ["delay"]


def spec_for_point(point: str, count: int, kind: Optional[str] = None, *,
                   wid: Optional[int] = None, nth: Optional[int] = None,
                   delay_s: float = 1e-3) -> FaultSpec:
    """The sweep's spec for `point` seen `count` times on the reference
    trace: middle occurrence, first survivable kind by default."""
    if kind is None:
        kinds = survivable_kinds(point)
        if not kinds:
            raise ValueError(f"point {point!r} has no survivable fault kinds")
        kind = kinds[0]
    if nth is None:
        nth = (count + 1) // 2 or 1
    return FaultSpec(point, nth=nth, kind=kind, wid=wid, delay_s=delay_s)


def coverage_summary(reference: FaultInjector, exercised: Dict[str, dict]) -> dict:
    """JSON-able points-seen vs points-exercised summary."""
    seen = dict(sorted(reference.counts.items()))
    return {"points_seen": seen, "points_exercised": exercised,
            "unexercised": sorted(p for p in seen
                                  if p not in exercised and survivable_kinds(p))}


def assert_no_leaks(cluster) -> None:
    """Post-run invariant: every retired sequence released everything.
    Per live worker: the block pool is fully free and holds no page tables;
    no ``pagedswap/`` residue in the host store; no ``/seq`` replica keys;
    no ``swap``-kind entry in the KV tiers (prefix entries are a cache, not
    ownership)."""
    workers = list(dict.fromkeys(list(getattr(cluster, "prompt_group", []))
                                 + list(getattr(cluster, "token_group", []))))
    for w in workers:
        pool = getattr(w, "pool", None)
        if pool is not None:
            used = pool.num_used()
            if used:
                raise AssertionError(f"worker {w.wid}: {used} pool block(s) leaked")
            if pool.tables:
                raise AssertionError(f"worker {w.wid}: page tables leaked: "
                                     f"{sorted(pool.tables)}")
        cache = getattr(w, "cache", None)
        if cache is not None:
            stale = [k for k in cache.host.keys() if k.startswith("pagedswap/")]
            if stale:
                raise AssertionError(f"worker {w.wid}: host swap residue: {stale[:4]}...")
            stale = [k for k in cache.replica.keys() if "/seq" in k]
            if stale:
                raise AssertionError(f"worker {w.wid}: replica residue: {stale[:4]}...")
        tier = getattr(w, "tier", None)
        if tier is not None:
            swaps = [e.key for e in tier._entries.values() if e.kind == "swap"]
            if swaps:
                raise AssertionError(f"worker {w.wid}: tier swap entries leaked: {swaps[:4]}")


__all__ = ["FAULT_KINDS", "RETRYABLE_KINDS", "FaultInjected", "StreamTaskError", "WorkerDead",
           "FaultSpec", "FaultPlan", "FiredFault", "FaultInjector", "install",
           "uninstall", "current", "active", "fire", "survivable_kinds",
           "spec_for_point", "coverage_summary", "assert_no_leaks"]
