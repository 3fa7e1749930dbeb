"""The port's fault-injection layer and the machinery under recovery.

- `faults`: the port's `FaultPlan` / `FaultInjector` against the JAX
  package's on scripted `fire` sequences (same counts, same `fired`
  records, the same raise or return per kind), and the sweep helpers;
- `StreamEngine`: background errors at `drain()`, one retry of a
  transient fault, no `submit` after `close`, and its modeled time
  (`overlap_report`, the ``stream.*`` counters) against the JAX streamer's;
- transports: `drop`, `corrupt` and `delay` give exact bytes and count
  their retransmits, and charge the JAX transports' modeled time;
- `Controller`: acks and `resume_point` against the JAX controller;
- `TopKSampler`: (seed, step) decides the draw, so a recovered run samples
  the failure-free run's tokens;
- a reduced crash-consistency sweep (`tests/test_crash_consistency.py`) of
  `run_continuous` with fused rounds and on the per-sequence path: every
  injection point of a fault-free run, faulted at its middle occurrence with
  its first survivable kind, gives the same tokens and leaks nothing.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread is faster, and steady on a shared host
torch.set_num_threads(1)

from repro.core import controller as jax_controller  # noqa: E402
from repro.core import telemetry as jax_telemetry  # noqa: E402
from repro.core.dejavulib import faults as jax_faults  # noqa: E402
from repro.core.dejavulib import streamer as jax_streamer  # noqa: E402
from repro.core.dejavulib import transport as jax_transport  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import controller, telemetry  # noqa: E402
from repro_torch.core.dejavulib import (HardwareModel, HostLinkTransport,  # noqa: E402
                                        NetworkTransport, StreamEngine, faults)
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving import Request, ServingEngine, TopKSampler  # noqa: E402

# ---------------------------------------------------------------------------
# the injector against the JAX module
# ---------------------------------------------------------------------------

SCRIPT = ["engine.step", "stream.submit", "engine.step", "transport.transfer.net",
          "stream.task", "engine.step", "transport.transfer.net", "stream.drain",
          "engine.step", "transport.transfer.hostlink", "stream.task", "engine.step"]


def _play(mod, kind: str):
    """Fire SCRIPT through `mod`'s injector with a plan that faults the
    2nd and 3rd engine.step and the 2nd occurrence of the other points with
    `kind`; returns what each fire did, the counts, the trace, the fired
    records and the kills."""
    specs = [mod.FaultSpec("engine.step", nth=2, kind=kind, wid=1, times=2)]
    specs += [mod.FaultSpec(p, nth=2, kind=kind, wid=0, delay_s=0.5)
              for p in ("stream.task", "transport.transfer.net", "stream.submit")]
    inj = mod.FaultInjector(mod.FaultPlan(specs), record=True)
    kills = []
    inj.worker_killer = kills.append
    out = []
    for point in SCRIPT:
        try:
            spec = inj.fire(point, tag=f"t-{len(out)}")
            out.append(None if spec is None else (spec.kind, spec.delay_s))
        except mod.FaultInjected as e:
            out.append(("raised", e.spec.kind, e.point, e.n))
    return out, inj.counts, inj.trace, [dataclasses.asdict(f) for f in inj.fired], kills


@pytest.mark.parametrize("kind", list(jax_faults.FAULT_KINDS))
def test_injector_matches_jax_on_a_script(kind):
    assert _play(faults, kind) == _play(jax_faults, kind)


def test_module_install_and_plan_helpers_match_jax():
    plan, jplan = (faults.FaultPlan.from_fail_at({9: 2, 3: 1}),
                   jax_faults.FaultPlan.from_fail_at({9: 2, 3: 1}))
    assert [dataclasses.astuple(s) for s in plan.specs] == \
        [dataclasses.astuple(s) for s in jplan.specs]
    assert faults.current() is None and faults.fire("engine.step") is None
    inj = faults.FaultInjector(plan)
    with faults.active(inj):
        assert faults.current() is inj
        with pytest.raises(faults.FaultInjected):      # no worker_killer bound
            for _ in range(3):
                faults.fire("engine.step")
    assert faults.current() is None
    for bad in (dict(kind="nope"), dict(nth=0), dict(kind="worker_death")):
        with pytest.raises(ValueError):
            faults.FaultSpec("engine.step", **{"nth": 1, **bad})
    points = ["engine.step", "stream.drain", "stream.task", "transport.transfer.net",
              "transport.transfer.hostlink", "ssd.put", "tier.demote", "cluster.fail",
              "stream.wait", "other"]
    for p in points:
        assert faults.survivable_kinds(p) == jax_faults.survivable_kinds(p)
        if p != "cluster.fail":
            assert dataclasses.astuple(faults.spec_for_point(p, 7, wid=1)) == \
                dataclasses.astuple(jax_faults.spec_for_point(p, 7, wid=1))
    ref, jref = faults.FaultInjector(), jax_faults.FaultInjector()
    ref.counts = jref.counts = {p: 3 for p in points}
    ex = {"engine.step": {"nth": 2, "kind": "worker_death", "ok": True}}
    assert faults.coverage_summary(ref, ex) == jax_faults.coverage_summary(jref, ex)


# ---------------------------------------------------------------------------
# StreamEngine
# ---------------------------------------------------------------------------

def test_stream_background_errors_raise_at_drain():
    eng = StreamEngine("t")
    done = []
    eng.submit(lambda: 1 / 0, tag="boom")
    eng.submit(lambda: done.append(1), tag="ok")
    with pytest.raises(faults.StreamTaskError, match="boom") as err:
        eng.drain(timeout=30)
    assert isinstance(err.value.__cause__, ZeroDivisionError)
    assert done == [1]                  # the queue went on past the failure
    eng.drain(timeout=30)               # raised once, then clear
    failed = eng.submit(lambda: 1 / 0, tag="waited")
    with pytest.raises(ZeroDivisionError):
        eng.wait(failed, timeout=30)
    eng.drain(timeout=30)               # a waited-on error is the caller's
    eng.close()
    assert not eng._thread.is_alive()


@pytest.mark.parametrize("kind,retried", [("task_error", True), ("error", False)])
def test_stream_retries_a_transient_fault_once(kind, retried):
    runs = []
    inj = faults.FaultInjector(faults.FaultPlan([faults.FaultSpec("stream.task", nth=2,
                                                                  kind=kind)]))
    eng = StreamEngine("t")
    with faults.active(inj):
        eng.submit(lambda: runs.append("a"), tag="a")
        b = eng.submit(lambda: runs.append("b") or "B", tag="b")
        if retried:
            assert eng.wait(b, timeout=30) == "B"
            eng.drain(timeout=30)
        else:
            with pytest.raises(faults.FaultInjected):
                eng.wait(b, timeout=30)
    assert runs == (["a", "b"] if retried else ["a"])
    assert [f.kind for f in inj.fired] == [kind]
    eng.close()


def test_stream_submit_after_close_raises():
    eng = StreamEngine("t")
    eng.close()
    eng.close()                         # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(lambda: None, tag="late")


def test_stream_tasks_run_in_order_on_one_thread():
    eng = StreamEngine("t")
    seen = []
    for i in range(50):
        eng.submit(lambda i=i: seen.append((i, threading.current_thread().name)), tag=str(i))
    eng.drain(timeout=30)
    assert [i for i, _ in seen] == list(range(50))
    assert {name for _, name in seen} == {"dejavu-t"}
    eng.close()


def _stream_modeled_time(engine_cls, fmod, tmod):
    """Five tasks with modeled seconds, each beside 1.5 ms of registered
    compute; the 2nd submit and the 4th task are delayed.  Returns the
    overlap report and the registry's JSON."""
    reg = tmod.Telemetry()
    tmod.install(reg)
    inj = fmod.FaultInjector(fmod.FaultPlan([
        fmod.FaultSpec("stream.submit", nth=2, kind="delay", delay_s=2.5e-4),
        fmod.FaultSpec("stream.task", nth=4, kind="delay", delay_s=5e-4)]))
    eng = engine_cls("t")
    try:
        with fmod.active(inj):
            for i, sec in enumerate((1e-3, 2.5e-3, 0.0, 7e-4, 3e-3)):
                eng.submit(lambda: None, model_seconds=sec, tag=f"x{i}")
                eng.compute_span(1.5e-3)
            eng.drain(timeout=30)
        report = eng.overlap_report()
    finally:
        eng.close()
        tmod.uninstall()
    return report, reg.to_json()


def test_stream_overlap_report_matches_jax():
    port = _stream_modeled_time(StreamEngine, faults, telemetry)
    ref = _stream_modeled_time(jax_streamer.StreamEngine, jax_faults, jax_telemetry)
    assert port == ref
    assert port[0]["exposed_s"] > 0 and port[0]["hidden_s"] == port[0]["compute_s"]


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,retransmits", [("drop", 1), ("corrupt", 1), ("delay", 0)])
@pytest.mark.parametrize("cls", [NetworkTransport, HostLinkTransport])
def test_transport_faults_keep_bytes_exact(cls, kind, retransmits):
    t = cls()
    src = torch.randn(3, 5, 7, dtype=torch.float32)
    inj = faults.FaultInjector(faults.FaultPlan(
        [faults.FaultSpec(f"transport.transfer.{t.kind}", nth=2, kind=kind)]))
    with faults.active(inj):
        outs = [t.transfer(src, tag=f"x{i}") for i in range(3)]
    for out in outs:
        assert torch.equal(out, src) and out.data_ptr() != src.data_ptr()
    assert (t.transfers, t.attempts, t.retransmits) == (3, 3 + retransmits, retransmits)
    assert t.bytes_total() == 3 * src.numel() * 4       # bytes count once per transfer
    assert [(f.point, f.n, f.kind, f.tag) for f in inj.fired] == \
        [(f"transport.transfer.{t.kind}", 2, kind, "x1")]


@pytest.mark.parametrize("kind", ["drop", "corrupt", "delay"])
@pytest.mark.parametrize("cls,jax_cls", [(NetworkTransport, jax_transport.NetworkTransport),
                                         (HostLinkTransport, jax_transport.HostLinkTransport)])
def test_transport_modeled_time_matches_jax(cls, jax_cls, kind):
    """Three transfers, the 2nd faulted, with the reference's
    `HardwareModel`: the same modeled total, bytes and ``transport.*``
    counters as the JAX transport (the total to a relative 1e-12: the
    reference sums its log with `sum`, compensated on Python 3.12, and the
    port keeps a running sum)."""
    jax_hw = jax_transport.DEFAULT_HW
    src = np.random.default_rng(0).standard_normal((3, 5, 7)).astype(np.float32)
    out = []
    for t, fmod, tmod, arr in ((cls(HardwareModel(**dataclasses.asdict(jax_hw))), faults,
                                telemetry, torch.from_numpy(src)),
                               (jax_cls(jax_hw), jax_faults, jax_telemetry, src)):
        reg = tmod.Telemetry()
        tmod.install(reg)
        inj = fmod.FaultInjector(fmod.FaultPlan(
            [fmod.FaultSpec(f"transport.transfer.{t.kind}", nth=2, kind=kind, delay_s=1e-3)]))
        try:
            with fmod.active(inj):
                for i in range(3):
                    t.transfer(arr, tag=f"x{i}")
        finally:
            tmod.uninstall()
        out.append((t.modeled_total(), t.bytes_total(), reg.to_json()))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-12, abs=0)
    assert out[0][1:] == out[1][1:]


def test_transport_without_injector_is_one_copy():
    t = NetworkTransport()
    src = torch.arange(12, dtype=torch.int8)
    assert torch.equal(t.transfer(src), src)
    assert (t.transfers, t.attempts, t.retransmits, t.bytes_total()) == (1, 1, 0, 12)


# ---------------------------------------------------------------------------
# Controller
# ---------------------------------------------------------------------------

class _W:
    def __init__(self, wid, alive):
        self.wid, self.alive, self.last_heartbeat = wid, alive, 0.0


def test_controller_matches_jax():
    acks = [(0, 0, 0), (1, 0, 0), (0, 0, 2), (0, 0, 1), (1, 1, 3), (2, 5, 0), (1, 1, 2)]
    out = []
    for mod in (controller, jax_controller):
        c = mod.Controller()
        for w in (_W(0, True), _W(1, False), _W(2, True), _W(3, False)):
            c.register(w)
        for a in acks:
            c.ack_replication(*a)
        c.log_event("failure", wid=1)
        out.append((dict(c.rep_status), c.replicated_step(0, 0), c.replicated_step(4, 4),
                    c.resume_point(1, [0, 1, 2]), c.resume_point(0, [0, 7]),
                    sorted(c.check_failures()),
                    [{k: v for k, v in e.items() if k != "t"} for e in c.events]))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# TopKSampler, and a reduced crash-consistency sweep of run_continuous
# ---------------------------------------------------------------------------

CFG = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), dtype="float32", num_layers=4)
_MODEL: dict = {}


def model():
    if not _MODEL:
        m = DecoderLM(CFG, device="cpu")
        _MODEL["m"] = (m, m.init(torch.Generator().manual_seed(0)))
    return _MODEL["m"]


def test_topk_sampler_depends_only_on_seed_and_step():
    logits = torch.randn(3, 256, generator=torch.Generator().manual_seed(1))
    s = TopKSampler(k=8, temperature=0.8, seed=5)
    a = s(logits, 4)
    assert a.dtype == np.int32 and a.shape == (3,)
    np.testing.assert_array_equal(a, TopKSampler(k=8, temperature=0.8, seed=5)(logits, 4))
    top = torch.topk(logits, 8).indices.numpy()
    draws = np.stack([s(logits, i) for i in range(40)])
    assert all(d in top[b] for row in draws for b, d in enumerate(row))
    assert len({tuple(r) for r in draws}) > 1       # the step moves the draw
    assert not np.array_equal(draws, np.stack([TopKSampler(8, 0.8, 6)(logits, i)
                                               for i in range(40)]))


@pytest.mark.parametrize("fused", [True, False])
def test_recovered_run_resamples_the_failure_free_tokens(fused):
    m, p = model()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32) for n in [8, 12, 8, 12]]

    def run(fail_at):
        eng = ServingEngine(CFG, m, p, 2, paged=True, kv_pool_blocks=64, replication=True,
                            fused_rounds=fused, sampler=TopKSampler(k=16, seed=11),
                            device="cpu")
        reqs = [Request(rid=i, prompt=q.copy(), max_new=6) for i, q in enumerate(prompts)]
        return eng, eng.run_continuous(reqs, max_active=3, fail_at=fail_at)

    _, clean = run(None)
    eng, rep = run({9: 1})
    assert rep.failures == 1 and rep.recoveries == 1
    assert rep.tokens == clean.tokens
    faults.assert_no_leaks(eng.cluster)


_R = np.random.default_rng(7)
_P0 = _R.integers(0, 256, 16).astype(np.int32)
_P1 = _R.integers(0, 256, 24).astype(np.int32)
_P3 = _R.integers(0, 256, 9).astype(np.int32)
SWEEP_PROMPTS = [_P0, _P1, _P0.copy(), _P3]


def _sweep_run(mode: str, inj):
    m, p = model()
    eng = ServingEngine(CFG, m, p, 2, paged=True, replication=True, kv_block_size=8,
                        fused_rounds=(mode == "fused"), device="cpu")
    reqs = [Request(rid=i, prompt=q.copy(), max_new=4) for i, q in enumerate(SWEEP_PROMPTS)]
    return eng, eng.run_continuous(reqs, max_active=3, fault_injector=inj)


@pytest.mark.parametrize("mode", ["perseq", "fused"])
def test_crash_consistency_sweep(mode):
    """Every injection point of the fault-free run, faulted at its middle
    occurrence with its first survivable kind (worker 1 for a death),
    recovers to the same tokens and leaks no block or replica."""
    ref = faults.FaultInjector(record=True)
    eng, rep = _sweep_run(mode, ref)
    faults.assert_no_leaks(eng.cluster)
    assert rep.failures == 0 and rep.fault_trace == []
    counts = dict(ref.counts)
    assert counts["engine.step"] > 0 and counts["stream.drain"] > 0
    assert counts["transport.transfer.net"] > 0
    exercised = {}
    for point in sorted(counts):
        kinds = faults.survivable_kinds(point)
        if not kinds:
            continue                                # cluster.fail itself
        spec = faults.spec_for_point(point, counts[point], kinds[0], wid=1)
        inj = faults.FaultInjector(faults.FaultPlan([spec]))
        eng, got = _sweep_run(mode, inj)
        assert inj.fired, f"{point}: the planned fault never fired"
        assert got.tokens == rep.tokens, f"{mode}/{point}/{spec.kind}@{spec.nth}"
        if spec.kind == "worker_death":
            assert got.failures == 1 and got.recoveries >= 1
            assert got.fault_trace[0]["point"] == point
        else:
            assert got.failures == 0
        faults.assert_no_leaks(eng.cluster)
        exercised[point] = {"nth": spec.nth, "kind": spec.kind, "ok": True}
    summary = faults.coverage_summary(ref, exercised)
    assert summary["unexercised"] == []
    assert set(exercised) >= {"engine.step", "stream.submit", "stream.task", "stream.wait",
                              "stream.drain", "transport.transfer.net"}
