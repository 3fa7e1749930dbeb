"""The port's flight recorder (`repro_torch.core.tracing`) against the JAX
package's.

Unit level: the cases of `tests/test_tracing.py` on the port's copy: ring
buffer, causal span nesting on the modeled clock, non-owner threads routed
to the streamer track at its cursor, and `Tracer.span` refused off the
owner thread.

Engine level: one traced run of `run_continuous` through every trace
source the port has (reduced gpt2-1.5b, fp32, 2 layers, 2 workers, bridged
weights, the reference's `HardwareModel`): the per-sequence path with
replication, a worker death at step 5 and an injected streamer delay.  Its
dump must equal the JAX engine's byte for byte, and a second port run's;
`tools/trace_report.py` must attribute each request's window, and the
exporters must turn it into Perfetto and OTLP documents whose causal links
resolve.  (The reference's traced run is tiered; the port's tiers are
ROADMAP A.10.)
"""
import dataclasses
import importlib.util
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.registry import PAPER_ARCHS  # noqa: E402
from repro.core import telemetry as jax_telemetry  # noqa: E402
from repro.core import tracing as jax_tracing  # noqa: E402
from repro.core.dejavulib import faults as jax_faults  # noqa: E402
from repro.core.dejavulib.transport import HardwareModel as JaxHardwareModel  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import exporters, telemetry, tracing  # noqa: E402
from repro_torch.core.dejavulib import faults  # noqa: E402
from repro_torch.core.dejavulib.transport import HardwareModel  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

_TOOL = os.path.join(os.path.dirname(__file__), "..", "tools", "trace_report.py")
_spec = importlib.util.spec_from_file_location("trace_report", _TOOL)
trace_report = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(trace_report)

# ---------------------------------------------------------------------------
# unit level: ring buffer, spans, thread routing
# ---------------------------------------------------------------------------


def test_ring_overwrites_oldest_and_counts_drops():
    t = tracing.Tracer(capacity=4)
    for i in range(10):
        t.event("e", n=i)
    tr = t.snapshot()["tracks"][tracing.SERVE_TRACK]
    assert tr["emitted"] == 10
    assert tr["dropped"] == 6                  # visible, never silent
    assert [e["eid"] for e in tr["events"]] == [6, 7, 8, 9]
    assert [e["args"]["n"] for e in tr["events"]] == [6, 7, 8, 9]


def test_span_nesting_parents_and_modeled_clock():
    prev = telemetry.install(telemetry.Telemetry())
    tele = telemetry.current()
    t = tracing.Tracer()
    try:
        with t.span("round"):
            tele.advance(1e-6)
            with t.span("pass", rid=7, kind="fused_decode"):
                tele.advance(2e-6)
                t.event("emit.first_token", rid=7)
    finally:
        telemetry.uninstall(prev)
    evs = t.snapshot()["tracks"][tracing.SERVE_TRACK]["events"]
    # spans record at close (innermost first); eids are reserved at open
    assert [e["name"] for e in evs] == ["emit.first_token", "pass", "round"]
    emit, pas, rnd = evs
    assert rnd["eid"] == 0 and "parent" not in rnd
    assert pas["parent"] == rnd["eid"]
    assert emit["parent"] == pas["eid"]
    assert (rnd["ts"], rnd["dur"]) == (0, 3000)
    assert (pas["ts"], pas["dur"]) == (1000, 2000)
    assert emit["ts"] == 3000 and emit["ph"] == "I"
    assert pas["rid"] == 7 and pas["args"] == {"kind": "fused_decode"}


def test_nonowner_thread_routes_to_streamer_cursor():
    t = tracing.Tracer()

    def worker():
        t.event("xfer", dur_ns=100, bytes=5)
        t.event("stream.task", dur_ns=50)

    th = threading.Thread(target=worker)
    th.start()
    th.join()
    evs = t.snapshot()["tracks"][tracing.STREAM_TRACK]["events"]
    assert [e["ts"] for e in evs] == [0, 100]    # the track's cursor, not the clock
    assert evs[0]["dur"] == 100 and evs[0]["ph"] == "X"
    assert all("parent" not in e for e in evs)


def test_span_raises_off_owner_thread():
    t = tracing.Tracer()
    errs = []

    def worker():
        try:
            with t.span("x"):
                pass
        except RuntimeError as e:
            errs.append(e)

    th = threading.Thread(target=worker)
    th.start()
    th.join()
    assert len(errs) == 1 and "owner" in str(errs[0])


def test_module_helpers_noop_when_uninstalled():
    assert tracing.current() is None
    assert not tracing.active()
    tracing.event("x", rid=1)
    with tracing.span("y"):
        pass
    assert tracing.current() is None


def test_install_uninstall_restores_previous():
    a = tracing.Tracer()
    assert tracing.install(a) is None
    b = tracing.Tracer()
    assert tracing.install(b) is a
    tracing.uninstall(a)
    assert tracing.current() is a
    tracing.uninstall()
    assert tracing.current() is None


def test_streamer_thread_events_match_the_reference():
    """The same events from the owner thread and a streamer thread dump the
    same bytes in both packages."""
    dumps = []
    for tele_mod, trace_mod in ((telemetry, tracing), (jax_telemetry, jax_tracing)):
        reg, t = tele_mod.Telemetry(), trace_mod.Tracer(capacity=8)
        prev_t, prev_r = tele_mod.install(reg), trace_mod.install(t)
        try:
            with trace_mod.span("round"):
                reg.advance(2.5e-6)
                trace_mod.event("sched.plan", round=1, rids=[0, 2])
                th = threading.Thread(target=lambda: [
                    trace_mod.event("xfer", kind="net", dur_ns=40, tag="k"),
                    trace_mod.event("stream.task", tag="rep", dur_ns=60, failed=False)])
                th.start()
                th.join()
                trace_mod.event("stage.decode_batch", track="w1", n=2)
        finally:
            trace_mod.uninstall(prev_r)
            tele_mod.uninstall(prev_t)
        dumps.append(t.to_json())
    assert dumps[0] == dumps[1]


# ---------------------------------------------------------------------------
# engine level: a traced faulted run through the port's serving stack
# ---------------------------------------------------------------------------

HW = HardwareModel(**dataclasses.asdict(JaxHardwareModel()))
_KW = dict(dtype="float32", num_layers=2)
JCFG = dataclasses.replace(PAPER_ARCHS["gpt2-1.5b"].reduced(), **_KW)
TCFG = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), **_KW)
PROMPTS = np.random.default_rng(0).integers(0, 256, (3, 8)).astype(np.int32)
ENGINE_KW = dict(paged=True, kv_pool_blocks=128, replication=True, fused_rounds=False)


@pytest.fixture(scope="module")
def weights():
    jm = build_model(JCFG)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, params_from_jax(TCFG, jax.tree.map(np.asarray, jp), device="cpu")


def _traced_run(weights, port: bool):
    """The per-sequence path with replication, worker 1 killed at step 5 and
    the streamer's second task delayed: every trace source the port has."""
    jm, jp, tp = weights
    if port:
        tele_mod, trace_mod, fault_mod, req = telemetry, tracing, faults, Request
        eng = ServingEngine(TCFG, DecoderLM(TCFG, device="cpu"), tp, 2, hw=HW, device="cpu",
                            **ENGINE_KW)
    else:
        tele_mod, trace_mod, fault_mod, req = jax_telemetry, jax_tracing, jax_faults, JaxRequest
        eng = JaxEngine(JCFG, jm, jp, 2, **ENGINE_KW)
    reg, tracer = tele_mod.Telemetry(), trace_mod.Tracer()
    prev_t, prev_r = tele_mod.install(reg), trace_mod.install(tracer)
    try:
        plan = fault_mod.FaultPlan([fault_mod.FaultSpec("stream.task", nth=2, kind="delay",
                                                        delay_s=1e-3)])
        rep = eng.run_continuous([req(rid=i, prompt=p.copy(), max_new=4, arrival=2e-5 * i)
                                  for i, p in enumerate(PROMPTS)],
                                 max_active=2, fail_at={5: 1}, fault_plan=plan)
    finally:
        trace_mod.uninstall(prev_r)
        tele_mod.uninstall(prev_t)
    assert rep.recoveries == 1 and len(rep.fault_trace) == 2
    return tracer.to_json(), reg.snapshot()


@pytest.fixture(scope="module")
def traced(weights):
    dump, snap = _traced_run(weights, port=True)
    return json.loads(dump), dump, snap


def test_traced_run_matches_the_reference_byte_for_byte(weights, traced):
    _, dump, _ = traced
    jdump, _ = _traced_run(weights, port=False)
    assert dump == jdump


def test_determinism_byte_identical_dumps(weights, traced):
    _, dump, _ = traced
    assert _traced_run(weights, port=True)[0] == dump


def test_traced_run_covers_all_sources(traced):
    trace, _, _ = traced
    assert trace["schema"] == tracing.SCHEMA == "repro.trace/v1"
    serve_names = {e["name"] for e in trace["tracks"]["serve"]["events"]}
    assert {"round", "pass", "sched.admit", "sched.plan", "sched.retire",
            "emit.first_token", "cluster.kill", "worker.kill", "recovery",
            "recovery.first_token", "fault.worker_death"} <= serve_names
    stream_names = {e["name"] for e in trace["tracks"]["streamer"]["events"]}
    assert {"xfer", "stream.task", "fault.delay"} <= stream_names
    assert {"w0", "w1"} <= set(trace["tracks"])       # the per-worker stage tracks
    assert all(t["dropped"] == 0 for t in trace["tracks"].values())


def test_trace_report_attributes_wall_time(traced, tmp_path):
    trace, dump, _ = traced
    report = trace_report.analyze(trace)
    assert len(report["requests"]) == len(PROMPTS)
    for r in report["requests"].values():
        assert r["coverage"] >= 0.95
    assert report["bubbles"]["wall_total_ns"] > 0
    assert not report["dropped"]
    p = tmp_path / "trace.json"
    p.write_text(dump)
    assert trace_report.main([str(p), "--assert"]) == 0


def test_perfetto_export_tracks_and_instants(traced):
    trace, _, _ = traced
    evs = exporters.trace_to_perfetto(trace)["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    assert len(meta) == len(trace["tracks"])
    names = {m["tid"]: m["args"]["name"] for m in meta}
    assert names[1] == "serve" and names[max(names)] == "streamer"
    assert any(e["ph"] == "X" and e.get("dur", 0) > 0 for e in evs)
    insts = [e for e in evs if e["ph"] == "i"]
    assert any(e["name"].startswith("fault.") for e in insts)
    assert all(e["s"] == "t" for e in insts)


def test_prometheus_export_text_format(traced):
    _, _, snap = traced
    lines = exporters.telemetry_to_prometheus(snap).splitlines()
    assert any(line.startswith("# TYPE engine_ttft_s histogram") for line in lines)
    assert any('engine_ttft_s_bucket{le="+Inf"}' in line for line in lines)
    assert any(line.startswith("faults_fired_total{") for line in lines)
    assert any(line.startswith("modeled_clock_seconds ") for line in lines)
    buckets = [int(line.rsplit(" ", 1)[1]) for line in lines
               if line.startswith("engine_ttft_s_bucket{")]
    assert buckets == sorted(buckets)


def test_otlp_export_parents_resolve(traced):
    trace, _, _ = traced
    spans = exporters.trace_to_otlp(trace)["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert len(spans) == sum(len(t["events"]) for t in trace["tracks"].values())
    serve_ids = {s["spanId"] for s in spans
                 if any(a["key"] == "track" and a["value"]["stringValue"] == "serve"
                        for a in s["attributes"])}
    parents = {s["parentSpanId"] for s in spans if "parentSpanId" in s}
    assert parents and parents <= serve_ids
    assert all(len(s["traceId"]) == 32 and len(s["spanId"]) == 16 for s in spans)


def test_golden_schema_key_sets(traced):
    trace, _, snap = traced
    assert sorted(snap) == ["clock_s", "counters", "gauges", "histograms", "schema", "spans"]
    for h in snap["histograms"].values():
        assert sorted(h) == ["buckets_s", "count", "counts", "max_s", "min_s", "p50_s",
                             "p90_s", "p99_s", "sum_s"]
    for s in snap["spans"].values():
        assert sorted(s) == ["count", "max_s", "total_s"]
    assert sorted(trace) == ["capacity", "schema", "tracks"]
    required = {"eid", "name", "ph", "ts"}
    allowed = required | {"dur", "parent", "rid", "seq", "args"}
    for tr in trace["tracks"].values():
        assert sorted(tr) == ["dropped", "emitted", "events"]
        for ev in tr["events"]:
            assert required <= set(ev) <= allowed, ev
            assert ev["ph"] in ("X", "I")
