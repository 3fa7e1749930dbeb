"""StreamEngine: a background streaming thread with its own CUDA stream (the
port's counterpart of `repro.core.dejavulib.streamer`).

The paper overlaps KV-cache streaming with compute through a dedicated CPU
thread and CUDA streams (§4.1).  Here one worker thread drains a FIFO of
transfer closures.  On a CUDA device the thread runs every task under a
side stream that the engine owns, so a task's copies queue behind no
compute kernel; a caller that hands a task device tensors records an event
after producing them, which the task waits on, and marks each tensor as in
use by the side stream (`record_stream`), so the caching allocator cannot
hand its memory out before the copy has finished.  The torch current
stream is per thread, which is why the worker thread enters the side
stream itself.

Errors: `wait()` on a task raises its error.  Errors of fire-and-forget
tasks nobody waits on are raised at the next `drain()` or `close()` as
`StreamTaskError`, the first failure as its ``__cause__``.

Fault injection: `submit`, the worker loop, `wait` and `drain` fire the
``stream.submit``, ``stream.task``, ``stream.wait`` and ``stream.drain``
points (`faults`).  A task that fails with a transient fault
(`faults.RETRYABLE_KINDS`) is retried once; a ``delay`` adds its seconds to
the task's modeled time.

Modeled time: each task carries a `model_seconds` estimate (its transfers'
`HardwareModel` time); `overlap_report()` holds the streamed total against
the compute registered through `compute_span()`, and the exposed remainder
is what DéjàVu's streaming optimisations minimise.  From the worker thread
the engine records only integer-ns counters (``stream.*``) and the
``stream.task`` trace event on the streamer track, never the modeled clock
or a span, so snapshots stay byte-identical from run to run.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from repro_torch.core import telemetry, tracing
from repro_torch.core.dejavulib import faults
from repro_torch.core.dejavulib.faults import StreamTaskError

__all__ = ["StreamEngine", "StreamTaskError"]


@dataclass
class _Task:
    fn: Callable[[], object]
    model_seconds: float
    tag: str
    done: threading.Event = field(default_factory=threading.Event)
    result: object = None
    error: Optional[BaseException] = None


class StreamEngine:
    def __init__(self, name: str = "streamer", device="cpu"):
        self.name = name
        self.device = torch.device(device)
        # the side stream: every task's copies run on it (CUDA only)
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)
        self._q: "queue.Queue[Optional[_Task]]" = queue.Queue()
        self._lock = threading.Lock()
        self._errors: List[_Task] = []   # failed tasks nobody waited on yet
        self._closed = False
        self._submit_lock = threading.Lock()
        self.busy_s = 0.0                # wall seconds the worker thread ran tasks
        self._stream_model_time = 0.0
        self._compute_model_time = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"dejavu-{name}")
        self._thread.start()

    def reset(self) -> None:
        """Zero the modeled stream and compute seconds (`overlap_report`)."""
        with self._lock:
            self._stream_model_time = 0.0
            self._compute_model_time = 0.0

    def _run(self):
        if self.stream is not None:
            with torch.cuda.stream(self.stream):
                self._loop()
        else:
            self._loop()

    def _loop(self):
        while True:
            task = self._q.get()
            if task is None:
                return
            t0 = time.perf_counter()
            extra_model = 0.0
            try:
                spec = faults.fire("stream.task", tag=task.tag)
                if spec is not None and spec.kind == "delay":
                    extra_model = spec.delay_s   # an injected straggler
                task.result = task.fn()
            except faults.FaultInjected as e:
                if e.spec.kind in faults.RETRYABLE_KINDS:
                    telemetry.count("stream.retries")
                    try:                 # transient fault: one retry
                        task.result = task.fn()
                    except BaseException as e2:   # noqa: BLE001 -- surfaced on wait/drain
                        task.error = e2
                else:
                    task.error = e
            except BaseException as e:   # noqa: BLE001 -- surfaced on wait/drain/close
                task.error = e
            if task.error is not None:
                telemetry.count("stream.task_errors")
            model = task.model_seconds + extra_model
            with self._lock:
                self.busy_s += time.perf_counter() - t0
                self._stream_model_time += model
                if task.error is not None:
                    self._errors.append(task)
            # integer-ns counters only from this thread: no span, no clock
            telemetry.count("stream.tasks_done")
            telemetry.count_time("stream.model_ns", model)
            if tracing.active():
                # a non-owner thread: the event lands on the streamer track
                # at that track's own cursor
                tracing.event("stream.task", tag=task.tag, dur_ns=int(round(model * 1e9)),
                              failed=task.error is not None)
            task.done.set()

    def submit(self, fn: Callable[[], object], *, model_seconds: float = 0.0,
               tag: str = "") -> _Task:
        spec = faults.fire("stream.submit", tag=tag)
        if spec is not None and spec.kind == "delay":
            model_seconds += spec.delay_s
        t = _Task(fn, model_seconds, tag)
        telemetry.count("stream.tasks_submitted")
        with self._submit_lock:
            if self._closed:
                raise RuntimeError(f"stream engine {self.name!r} is closed; "
                                   f"cannot submit {tag!r}")
            self._q.put(t)
        return t

    def wait(self, task: _Task, timeout: Optional[float] = None):
        faults.fire("stream.wait", tag=task.tag)
        if not task.done.wait(timeout):
            raise TimeoutError(f"stream task {task.tag!r} timed out")
        if task.error is not None:
            with self._lock:
                if task in self._errors:     # waited on: the caller handles it
                    self._errors.remove(task)
            raise task.error
        return task.result

    def drain(self, timeout: float = 600.0) -> None:
        """Block until the queue is empty (the barrier); raise the errors of
        fire-and-forget tasks that failed since the last barrier."""
        faults.fire("stream.drain", tag=self.name)
        self.wait(self.submit(lambda: None, tag="drain"), timeout)
        self._raise_background_errors()

    def _raise_background_errors(self) -> None:
        with self._lock:
            failed, self._errors = self._errors, []
        if failed:
            first = failed[0]
            raise StreamTaskError(
                f"{len(failed)} background stream task(s) failed on {self.name!r}; "
                f"first: {first.tag!r} ({type(first.error).__name__}: {first.error})"
            ) from first.error

    def hand_off(self, tensors: List[torch.Tensor]) -> Optional[torch.cuda.Event]:
        """Make device tensors made on the caller's stream safe for a task:
        an event recorded after them, which the task waits on (`Event.wait`
        on the side stream), and each tensor marked as used by the side
        stream, so its memory is not reused before the task's copy has run.
        None on the CPU."""
        if self.stream is None or not tensors or not tensors[0].is_cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        for t in tensors:
            t.record_stream(self.stream)
        return ev

    def on_worker_thread(self) -> bool:
        """Whether the caller is the streamer's own thread (a task)."""
        return threading.current_thread() is self._thread

    def sync_copies(self) -> None:
        """Wait until every copy queued on the side stream has landed, so
        the host may read host memory that a non-blocking copy wrote."""
        if self.stream is not None:
            self.stream.synchronize()

    def compute_span(self, model_seconds: float) -> None:
        """Register modeled compute time that streaming can hide behind."""
        with self._lock:
            self._compute_model_time += model_seconds

    def overlap_report(self) -> dict:
        """Modeled seconds streamed, computed, hidden and exposed."""
        with self._lock:
            hidden = min(self._stream_model_time, self._compute_model_time)
            return {"stream_s": self._stream_model_time,
                    "compute_s": self._compute_model_time,
                    "hidden_s": hidden, "exposed_s": self._stream_model_time - hidden}

    def close(self) -> None:
        """Stop the worker thread.  Idempotent.  Raises if the thread does
        not exit or if background tasks failed and were never raised."""
        with self._submit_lock:
            first_close = not self._closed
            self._closed = True
            if first_close:
                self._q.put(None)        # the sentinel: drain the queue, then exit
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            raise RuntimeError(f"stream engine {self.name!r}: worker thread did not exit")
        self._raise_background_errors()
