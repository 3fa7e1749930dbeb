"""The port's telemetry registry (`repro_torch.core.telemetry`) and the
instruments wired through both serving paths, against the JAX package's.

Unit level: the cases of `tests/test_telemetry.py` on the port's copy.

Engine level: reduced gpt2-1.5b (fp32, 2 layers) on 2 stage workers, with
weights bridged from the JAX params and the reference's `HardwareModel`
(built from its fields), serves the same requests through both engines
with a `Telemetry` and a `Tracer` installed around each run.  Every
fault-free case must give the JAX run's `to_json()` of both, byte for byte,
and the same `prefill_stall_trace`: `run_continuous` fused and per
sequence with replication (int8 replicas on the latter), on a windowed
model whose second stage gathers its pages, with ``max_active=1`` (queue
waits) and with a pool small enough to preempt; `run` colocated with
replication, swapping and disaggregated (1, 1).  Under ``fail_at`` the port
deviates from the reference on the fused path (see `CHANGES.md`): the key
sets must be equal, and so must the failure, kill and fault counters and
the count of recovery times.  The tiered cases of `tests/test_telemetry.py`
wait for the port's KV tiers (ROADMAP A.10).
"""
import dataclasses
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread is faster, and steady on a shared host
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.registry import PAPER_ARCHS  # noqa: E402
from repro.core import telemetry as jax_telemetry  # noqa: E402
from repro.core import tracing as jax_tracing  # noqa: E402
from repro.core.dejavulib.transport import HardwareModel as JaxHardwareModel  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import telemetry, tracing  # noqa: E402
from repro_torch.core.dejavulib.transport import HardwareModel  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

# ---------------------------------------------------------------------------
# unit level: the instruments
# ---------------------------------------------------------------------------


def test_counter_gauge_labels():
    t = telemetry.Telemetry()
    t.count("c", 2, kind="net")
    t.count("c", 3, kind="net")
    t.count("c", 1, kind="ici")
    t.gauge("g", 0.5)
    t.gauge("g", 0.25)                       # last write wins
    snap = t.snapshot()
    assert snap["schema"] == telemetry.SCHEMA == "repro.telemetry/v1"
    assert snap["counters"] == {"c{kind=ici}": 1, "c{kind=net}": 5}
    assert snap["gauges"] == {"g": 0.25}


def test_label_key_is_sorted():
    assert telemetry._label_key("n", {"b": 1, "a": 2}) == "n{a=2,b=1}"


def test_count_time_integer_ns():
    t = telemetry.Telemetry()
    for _ in range(1000):
        t.count_time("t_ns", 0.1e-6)
    assert t.snapshot()["counters"]["t_ns"] == 1000 * 100


def test_histogram_quantiles_and_bounds():
    h = telemetry.Histogram()
    assert h.quantile(0.5) == 0.0            # empty
    vals = [1e-5, 2e-5, 3e-5, 4e-5, 1e-3]
    for v in vals:
        h.observe(v)
    assert h.count == len(vals)
    assert h.min == 1e-5 and h.max == 1e-3
    q = [h.quantile(x) for x in (0.5, 0.9, 0.99)]
    assert all(h.min <= v <= h.max for v in q)
    assert q[0] <= q[1] <= q[2]
    h2 = telemetry.Histogram()
    h2.observe(1e9)                          # above the last edge: overflow
    assert h2.counts[-1] == 1
    assert h2.quantile(0.99) == 1e9          # clamped to max
    # the same buckets and quantiles as the reference's histogram
    jh = jax_telemetry.Histogram()
    for v in vals:
        jh.observe(v)
    assert telemetry.DEFAULT_BUCKETS_S == jax_telemetry.DEFAULT_BUCKETS_S
    assert [h.quantile(x) for x in (0.5, 0.9, 0.99)] == \
        [jh.quantile(x) for x in (0.5, 0.9, 0.99)]


def test_span_nesting_paths_and_tags():
    t = telemetry.Telemetry()
    with t.span("round"):
        t.advance(1.0)
        with t.span("pass", kind="fused_decode"):
            t.advance(0.25)
    snap = t.snapshot()["spans"]
    assert snap["round"]["count"] == 1
    assert snap["round"]["total_s"] == pytest.approx(1.25)
    inner = snap["round/pass[kind=fused_decode]"]
    assert inner["count"] == 1
    assert inner["total_s"] == pytest.approx(0.25)


def test_module_helpers_noop_when_uninstalled():
    assert telemetry.current() is None
    telemetry.count("x")
    telemetry.observe("x", 1.0)
    telemetry.gauge("x", 1.0)
    telemetry.advance(1.0)
    assert telemetry.clock() == 0.0
    with telemetry.span("x"):
        pass


def test_advance_and_span_raise_off_owner_thread():
    """The modeled clock has one writer: the thread that owns the registry."""
    t = telemetry.Telemetry()
    errs = []

    def worker():
        for fn in (lambda: t.advance(1.0), lambda: t.span("x").__enter__()):
            try:
                fn()
            except RuntimeError as e:
                errs.append(e)

    th = threading.Thread(target=worker)
    th.start()
    th.join()
    assert len(errs) == 2
    assert all("non-owner thread" in str(e) for e in errs)
    t.count("from_main")
    assert t.snapshot()["counters"]["from_main"] == 1


def test_install_uninstall_restores_previous():
    a = telemetry.Telemetry()
    assert telemetry.install(a) is None
    b = telemetry.Telemetry()
    assert telemetry.install(b) is a
    telemetry.uninstall(a)
    assert telemetry.current() is a
    telemetry.uninstall()
    assert telemetry.current() is None


def test_snapshot_json_round_trip_stable_ordering():
    t = telemetry.Telemetry()
    t.count("z", 1)
    t.count("a", 1)
    t.observe("h", 1e-4)
    with t.span("s", b=1, a=2):
        t.advance(0.5)
    s = t.to_json()
    doc = json.loads(s)
    assert json.dumps(doc, sort_keys=True, separators=(",", ":")) == s
    assert list(doc["counters"]) == ["a", "z"]


def test_registry_json_matches_the_reference_instrument_for_instrument():
    """The same calls on both registries give the same bytes."""
    docs = []
    for mod in (telemetry, jax_telemetry):
        t = mod.Telemetry()
        t.count("transport.bytes", 4096, kind="net")
        t.count_time("stream.model_ns", 1.5e-6)
        t.gauge("engine.bubble_frac", 0.125)
        for v in (1e-6, 3e-4, 2.5e-2, 7.0, 1e4):
            t.observe("engine.ttft_s", v)
        with t.span("round"):
            with t.span("pass", kind="chunkset"):
                t.advance(3.3e-5)
            t.advance(1e-3)
        docs.append(t.to_json())
    assert docs[0] == docs[1]


# ---------------------------------------------------------------------------
# engine level: the port's instruments against the reference's
# ---------------------------------------------------------------------------

HW = HardwareModel(**dataclasses.asdict(JaxHardwareModel()))
GATHER = dict(sliding_window=6, num_meta_tokens=2, full_attn_layers=(0,))
_MODELS: dict = {}


def models(variant: str = "gpt2"):
    """(jax cfg, model, params, port cfg, model, params), once per variant."""
    if variant not in _MODELS:
        kw = dict(dtype="float32", num_layers=2, **(GATHER if variant == "window" else {}))
        jcfg = dataclasses.replace(PAPER_ARCHS["gpt2-1.5b"].reduced(), **kw)
        tcfg = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), **kw)
        jm = build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS[variant] = (jcfg, jm, jp, tcfg, DecoderLM(tcfg, device="cpu"),
                            params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODELS[variant]


_RNG = np.random.default_rng(0)
PROMPTS = _RNG.integers(0, 256, (3, 8)).astype(np.int32)
TINY = _RNG.integers(0, 256, (2, 8)).astype(np.int32)
# with 4-token chunks: r0 decodes in the round in which r1 and r2 prefill
MIXED = [_RNG.integers(0, 256, (n,)).astype(np.int32) for n in (4, 12, 8)]


def requests(cls, prompts=PROMPTS, max_new=4):
    """Staggered arrivals, so the times to first token and the queue waits
    differ from request to request."""
    return [cls(rid=i, prompt=p.copy(), max_new=max_new, arrival=2e-5 * i)
            for i, p in enumerate(prompts)]


PAGED = dict(paged=True, kv_pool_blocks=128)
# name -> (variant, engine kwargs, serving loop, its kwargs, prompts, max_new)
CASES = {
    "continuous_fused_replication": ("gpt2", dict(PAGED, replication=True),
                                     "run_continuous", dict(max_active=3), PROMPTS, 4),
    "continuous_perseq_int8_replicas": ("gpt2", dict(PAGED, replication=True,
                                                     compress_replicas=True,
                                                     fused_rounds=False),
                                        "run_continuous", dict(max_active=3), PROMPTS, 4),
    "continuous_gather_route": ("window", dict(PAGED, replication=True),
                                "run_continuous", dict(max_active=3), PROMPTS, 4),
    "continuous_queue_wait": ("gpt2", PAGED, "run_continuous", dict(max_active=1), PROMPTS, 4),
    "continuous_preempts": ("gpt2", dict(paged=True, kv_pool_blocks=4), "run_continuous",
                            dict(max_active=2), TINY, 10),
    "continuous_chunked_replication": ("gpt2", dict(PAGED, replication=True,
                                                    prefill_chunk_tokens=4),
                                       "run_continuous", dict(max_active=3), MIXED, 4),
    "run_colocated_replication": ("gpt2", dict(microbatch=2, replication=True), "run", {},
                                  PROMPTS, 4),
    "run_swapping": ("gpt2", dict(microbatch=2, swapping=True), "run", {}, PROMPTS, 4),
    "run_disaggregated": ("gpt2", dict(microbatch=2, mode="disaggregated", dp_split=(1, 1)),
                          "run", {}, PROMPTS, 4),
}


def observed(case: str, port: bool, **run_kw):
    """One run of `case` with a fresh registry and tracer installed around
    it.  Returns (report, the registry's JSON, the tracer's JSON)."""
    variant, ekw, loop, lkw, prompts, max_new = CASES[case]
    jcfg, jm, jp, tcfg, tm, tp = models(variant)
    if port:
        tele_mod, trace_mod = telemetry, tracing
        eng = ServingEngine(tcfg, tm, tp, 2, hw=HW, device="cpu", **ekw)
        reqs = requests(Request, prompts, max_new)
    else:
        tele_mod, trace_mod = jax_telemetry, jax_tracing
        eng = JaxEngine(jcfg, jm, jp, 2, **ekw)
        reqs = requests(JaxRequest, prompts, max_new)
    reg, tracer = tele_mod.Telemetry(), trace_mod.Tracer()
    prev_t, prev_r = tele_mod.install(reg), trace_mod.install(tracer)
    try:
        rep = getattr(eng, loop)(reqs, **lkw, **run_kw)
    finally:
        trace_mod.uninstall(prev_r)
        tele_mod.uninstall(prev_t)
    return rep, reg.to_json(), tracer.to_json()


@pytest.mark.parametrize("case", list(CASES))
def test_port_records_what_the_reference_records(case):
    jrep, jtele, jtrace = observed(case, port=False)
    trep, ttele, ttrace = observed(case, port=True)
    assert trep.tokens == jrep.tokens
    assert ttele == jtele
    assert ttrace == jtrace
    assert trep.prefill_stall_trace == jrep.prefill_stall_trace
    assert trep.telemetry == json.loads(ttele)       # the ambient registry's snapshot
    snap = trep.telemetry
    assert snap["schema"] == "repro.telemetry/v1"
    assert snap["histograms"]["engine.ttft_s"]["count"] == len(trep.tokens)
    assert snap["histograms"]["engine.inter_token_s"]["count"] > 0
    assert "engine.bubble_frac" in snap["gauges"]
    assert any("pass[kind=" in k for k in snap["spans"])
    assert any(k.startswith("transport.bytes{") for k in snap["counters"]) == \
        (case not in ("continuous_queue_wait",))
    if case == "continuous_queue_wait":
        qw = snap["histograms"]["engine.queue_wait_s"]
        assert snap["counters"]["engine.admitted"] == qw["count"] == len(PROMPTS)
        assert qw["max_s"] > 0.0
    if case == "continuous_preempts":
        assert snap["counters"]["engine.preemptions"] == trep.preemptions > 0
        assert snap["counters"]["engine.resumed"] > 0


# name -> (case, fail_at).  Steps 1-3 admit the requests; in the chunked
# case step 4 is r1's chunk in the round's chunk-set pass, beside r0's decode.
FAIL_CASES = {
    "continuous_fused_fail_in_decode_5_w1": ("continuous_fused_replication", {5: 1}),
    "continuous_fused_fail_in_prefill_4_w1": ("continuous_chunked_replication", {4: 1}),
    "continuous_perseq_fail_6_w0": ("continuous_perseq_int8_replicas", {6: 0}),
    "run_colocated_fail_3_w1": ("run_colocated_replication", {3: 1}),
}


@pytest.mark.parametrize("name", list(FAIL_CASES))
def test_port_records_the_failure_as_the_reference_does(name):
    case, fail_at = FAIL_CASES[name]
    jrep, jtele, jtrace = observed(case, port=False, fail_at=fail_at)
    trep, ttele, ttrace = observed(case, port=True, fail_at=fail_at)
    assert trep.tokens == jrep.tokens
    assert trep.failures == jrep.failures == 1 and trep.recoveries == 1
    ja, ta = json.loads(jtele), json.loads(ttele)
    for section in ("counters", "gauges", "histograms", "spans"):
        assert sorted(ta[section]) == sorted(ja[section]), section
    for key in ("cluster.failures", "worker.kills{wid=0}", "worker.kills{wid=1}"):
        assert ta["counters"].get(key) == ja["counters"].get(key), key
    fired = [k for k in ja["counters"] if k.startswith("faults.fired")]
    assert fired and all(ta["counters"][k] == ja["counters"][k] for k in fired)
    assert ta["histograms"]["cluster.recovery_s"]["count"] == \
        ja["histograms"]["cluster.recovery_s"]["count"] == 1
    jd, td = json.loads(jtrace), json.loads(ttrace)
    assert sorted(td["tracks"]) == sorted(jd["tracks"])
    for track in jd["tracks"]:
        assert {e["name"] for e in td["tracks"][track]["events"]} == \
            {e["name"] for e in jd["tracks"][track]["events"]}, track
    if not name.startswith("continuous_fused"):
        # the per-sequence and microbatch paths recover as the reference
        # does: the same bytes
        assert ttele == jtele and ttrace == jtrace


def test_ambient_registry_aggregates_and_is_reused():
    """With an ambient registry installed (a benchmark's pattern), runs
    aggregate into it, the engine leaves it installed, and after two runs it
    holds what the reference's holds after the same two."""
    docs = []
    for port in (True, False):
        jcfg, jm, jp, tcfg, tm, tp = models()
        mod = telemetry if port else jax_telemetry
        amb = mod.Telemetry()
        mod.install(amb)
        try:
            if port:
                eng = ServingEngine(tcfg, tm, tp, 2, hw=HW, device="cpu", **PAGED)
                mk = Request
            else:
                eng = JaxEngine(jcfg, jm, jp, 2, **PAGED)
                mk = JaxRequest
            r1 = eng.run_continuous(requests(mk), max_active=3)
            assert mod.current() is amb
            r2 = eng.run_continuous(requests(mk), max_active=3)
            c1 = r1.telemetry["histograms"]["engine.ttft_s"]["count"]
            assert r2.telemetry["histograms"]["engine.ttft_s"]["count"] == 2 * c1
        finally:
            mod.uninstall()
        docs.append(amb.to_json())
    assert docs[0] == docs[1]


def test_engine_installs_a_registry_per_run_unless_told_not_to():
    """Without an ambient registry each run records into a fresh one and
    uninstalls it, so a second run starts from zero; an ambient registry
    tells the engine not to install its own."""
    _, _, _, tcfg, tm, tp = models()
    eng = ServingEngine(tcfg, tm, tp, 2, hw=HW, device="cpu", **PAGED)
    rep = eng.run_continuous(requests(Request), max_active=3)
    assert telemetry.current() is None
    assert rep.telemetry["histograms"]["engine.ttft_s"]["count"] == len(PROMPTS)
    rep2 = eng.run_continuous(requests(Request), max_active=3)
    assert telemetry.current() is None
    assert rep2.telemetry == rep.telemetry and rep2.tokens == rep.tokens
    assert rep2.prefill_stall_trace == rep.prefill_stall_trace
    amb = telemetry.Telemetry()
    telemetry.install(amb)
    try:
        rep3 = eng.run_continuous(requests(Request), max_active=3)
        assert telemetry.current() is amb
    finally:
        telemetry.uninstall()
    assert rep3.telemetry == json.loads(amb.to_json()) == rep.telemetry
