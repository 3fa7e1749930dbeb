"""Per-request causal tracing: a bounded, deterministic flight recorder (the
port's copy of `repro.core.tracing`, schema letter for letter).

The telemetry registry (`repro_torch.core.telemetry`) deliberately collapses
spans to path-keyed aggregates and never keeps individual events, so it
can answer "what is TTFT p99?" but not "why did request 17's TTFT hit
p99?".  This module is the complementary layer: it records *individual*
events and spans with causal parent links and request/sequence IDs, so a
single run can be replayed into a per-request critical-path breakdown
(`tools/trace_report.py`) or exported to Perfetto / OTLP wire formats
(`repro_torch.core.exporters`).

Design constraints, matching the telemetry registry's rules:

1. **Determinism.**  Two identical runs produce byte-identical dumps.
   Timestamps are *integer nanoseconds on the modeled clock* (the
   telemetry registry's `clock_s`, read only from the serving thread).
   Events fired from other threads (the DejaVuLib streamer) never read
   the clock: they land on their own *track*, where each event's
   timestamp is the track's running cursor (the accumulated modeled
   duration of the events before it) — the streamer FIFO serializes its
   tasks, so per-track order and cursors are reproducible.  The dump
   keeps each track's own order and never merges across tracks.
2. **Near-free when disabled.**  Call sites use the module helpers
   (`event`, `span`, `active`), a single ``is None`` check when no
   tracer is installed — the same pattern as `telemetry` and
   `dejavulib.faults`.
3. **Bounded memory, no silent truncation.**  Each track is a
   fixed-capacity ring buffer that overwrites its oldest events
   (flight-recorder semantics); the snapshot reports explicit
   ``dropped`` and ``emitted`` counters per track so a truncated dump
   is always visibly truncated.

Cross-thread rules: span open/close happens on the owner (serving)
thread only — `Tracer.span` raises off-thread, mirroring the telemetry
thread-affinity guard.  `event()` is safe from any thread; non-owner
threads are routed to the ``streamer`` track automatically.

The snapshot is a versioned, JSON-stable schema (``repro.trace/v1``):

```json
{"schema": "repro.trace/v1",
 "capacity": 65536,
 "tracks": {"serve": {"events": [{"eid": 3, "name": "pass", "ph": "X",
                                  "ts": 120000, "dur": 80000,
                                  "parent": 2, "rid": 17, "seq": 4,
                                  "args": {"kind": "fused_decode"}}],
                      "dropped": 0, "emitted": 4}}}
```

``ph`` follows the Chrome trace-event phases the Perfetto exporter
emits: ``"X"`` complete span (``ts`` + ``dur``), ``"I"`` instant.
"""
from __future__ import annotations

import json
import threading
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

from repro_torch.core import telemetry

SCHEMA = "repro.trace/v1"

#: default per-track ring capacity (events); generous enough that the CI
#: workloads never drop, small enough to bound a runaway run's memory
DEFAULT_CAPACITY = 1 << 16

_NS = 1_000_000_000

#: the track serving-thread events land on by default
SERVE_TRACK = "serve"
#: the track non-owner-thread events are routed to automatically
STREAM_TRACK = "streamer"


class _Track:
    """One ring buffer: fixed capacity, oldest-overwritten, counted drops."""

    __slots__ = ("name", "capacity", "events", "head", "next_eid",
                 "dropped", "emitted", "cursor_ns")

    def __init__(self, name: str, capacity: int):
        self.name = name
        self.capacity = capacity
        self.events: List[dict] = []
        self.head = 0              # index of the OLDEST event once full
        self.next_eid = 0
        self.dropped = 0
        self.emitted = 0
        self.cursor_ns = 0         # running end-time for clock-less threads

    def append(self, ev: dict) -> None:
        self.emitted += 1
        if len(self.events) < self.capacity:
            self.events.append(ev)
            return
        self.events[self.head] = ev    # overwrite the oldest (flight recorder)
        self.head = (self.head + 1) % self.capacity
        self.dropped += 1

    def chronological(self) -> List[dict]:
        return self.events[self.head:] + self.events[:self.head]


class Tracer:
    """The flight recorder: per-track rings + causal span stack.

    One tracer == one run (or one aggregation window).  All mutation is
    lock-protected; the owner thread is bound at construction and
    re-bound by :func:`install`, exactly like the telemetry registry.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._tracks: Dict[str, _Track] = {}
        self._tls = threading.local()
        self._owner = threading.get_ident()

    # -- internals -----------------------------------------------------
    def _track(self, name: str) -> _Track:
        tr = self._tracks.get(name)
        if tr is None:
            tr = self._tracks[name] = _Track(name, self.capacity)
        return tr

    def _stack(self) -> List[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _now_ns(self) -> int:
        t = telemetry.current()
        return 0 if t is None else int(round(t.clock_s * _NS))

    @staticmethod
    def _mkev(eid: int, name: str, ph: str, ts: int, dur: int,
              parent: Optional[int], rid: Optional[int],
              seq: Optional[int], args: dict) -> dict:
        ev = {"eid": eid, "name": name, "ph": ph, "ts": ts}
        if dur:
            ev["dur"] = dur
        if parent is not None:
            ev["parent"] = parent
        if rid is not None:
            ev["rid"] = int(rid)
        if seq is not None:
            ev["seq"] = int(seq)
        if args:
            ev["args"] = {k: args[k] for k in sorted(args)}
        return ev

    # -- recording -----------------------------------------------------
    def event(self, name: str, *, track: Optional[str] = None,
              ts_ns: Optional[int] = None, dur_ns: int = 0,
              rid: Optional[int] = None, seq: Optional[int] = None,
              **args: object) -> None:
        """Record one instant (or pre-timed) event.

        Thread routing: on the owner (serving) thread the timestamp is
        the modeled clock and the event lands on `track` (default
        ``serve``) with the current span as causal parent.  On any other
        thread the clock is never read: the event lands on the
        ``streamer`` track (unless `track` is given) at the track's
        running cursor, which then advances by `dur_ns` — callers on
        such threads carry their own modeled durations.
        """
        on_owner = threading.get_ident() == self._owner
        if track is None:
            track = SERVE_TRACK if on_owner else STREAM_TRACK
        parent = None
        if on_owner:
            st = self._stack()
            if st:
                parent = st[-1]
        with self._lock:
            tr = self._track(track)
            if ts_ns is None:
                if on_owner:
                    ts_ns = self._now_ns()
                else:
                    ts_ns = tr.cursor_ns
                    tr.cursor_ns += int(dur_ns)
            eid = tr.next_eid
            tr.next_eid += 1
            ph = "X" if dur_ns else "I"
            tr.append(self._mkev(eid, name, ph, int(ts_ns), int(dur_ns),
                                 parent, rid, seq, args))

    @contextmanager
    def span(self, name: str, *, rid: Optional[int] = None,
             seq: Optional[int] = None, **args: object) -> Iterator[None]:
        """A complete ("X") event timed on the modeled clock, recorded at
        close.  Owner thread only (the clock lives there); the eid is
        reserved at open so children recorded inside link to it."""
        if threading.get_ident() != self._owner:
            raise RuntimeError(
                "Tracer.span: spans open/close on the owner (serving) "
                "thread only; other threads use event(ts/dur) instead")
        st = self._stack()
        parent = st[-1] if st else None
        with self._lock:
            tr = self._track(SERVE_TRACK)
            eid = tr.next_eid
            tr.next_eid += 1
        st.append(eid)
        t0 = self._now_ns()
        try:
            yield
        finally:
            st.pop()
            dur = self._now_ns() - t0
            with self._lock:
                tr.append(self._mkev(eid, name, "X", t0, dur, parent,
                                     rid, seq, args))

    # -- snapshot ------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Stable, JSON-serialisable dump (schema ``repro.trace/v1``).
        Per-track event order is each track's own (deterministic) order;
        tracks are never merged, so cross-thread interleaving can't make
        two identical runs dump differently."""
        with self._lock:
            tracks = {}
            for name in sorted(self._tracks):
                tr = self._tracks[name]
                tracks[name] = {
                    "dropped": tr.dropped,
                    "emitted": tr.emitted,
                    "events": tr.chronological(),
                }
        return {"schema": SCHEMA, "capacity": self.capacity,
                "tracks": tracks}

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True,
                          separators=(",", ":"))


# -- module-global tracer (mirrors telemetry / dejavulib.faults) --------
_ACTIVE: Optional[Tracer] = None


def install(t: Tracer) -> Optional[Tracer]:
    """Install *t* as the process-wide tracer; returns the previous one.
    Re-binds the owner thread to the installing thread."""
    global _ACTIVE
    prev = _ACTIVE
    t._owner = threading.get_ident()
    _ACTIVE = t
    return prev


def uninstall(prev: Optional[Tracer] = None) -> None:
    global _ACTIVE
    _ACTIVE = prev


def current() -> Optional[Tracer]:
    return _ACTIVE


def active() -> bool:
    """One-attribute-read gate hot call sites check before building args."""
    return _ACTIVE is not None


# -- cheap helpers: one `is None` check when tracing is off -------------
def event(name: str, **kw: object) -> None:
    t = _ACTIVE
    if t is not None:
        t.event(name, **kw)


@contextmanager
def span(name: str, **kw: object) -> Iterator[None]:
    t = _ACTIVE
    if t is None:
        yield
    else:
        with t.span(name, **kw):
            yield
