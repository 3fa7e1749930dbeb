"""The port's ring replication and 4-step recovery against the JAX engine,
on the microbatch path (`run()`).

One set of weights, made by the JAX package from a seed and bridged to the
port, serves the same requests through both engines with the same config and
the same failure schedule (reduced gpt2-1.5b at fp32, 4 layers, as
`tests/test_crash_consistency.py`; 4 workers, microbatch 2,
`tests/test_serving_fault.py`'s trace): failures at three steps, straggler
migration, elastic repartition, swapping with replication, a prompt-worker
failure when disaggregated, and int8-compressed replicas.  A paged
cluster's repartition, which streams live blocks, is held the same way.  Each case must
give the JAX run's tokens, failures, recoveries, steps redone, controller
event kinds and resume dicts, and `net` bytes; `faults.assert_no_leaks` must
hold, and the replica stores must hold what JAX's hold.  Only `WorkerDead`
starts a recovery: a plain RuntimeError propagates, on both paths.
`tests/test_torch_recovery_paged.py` holds the paged path
(`run_continuous`) the same way.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread is faster, and steady on a shared host
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.registry import PAPER_ARCHS  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.dejavulib import assert_no_leaks  # noqa: E402
from repro_torch.core.worker import StageWorker, WorkerDead  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

# the paged path's failure trace (tests/test_fused_rounds.py:106-118)
_RNG = np.random.default_rng(0)
PG_PROMPTS = [_RNG.integers(0, 256, (n,)).astype(np.int32) for n in [8, 12, 8, 12, 8, 12]]
PG_NEW = [6, 3, 7, 4, 3, 6]
_MODELS: dict = {}


def models():
    """(jax cfg, jax model, jax params, port cfg, port model, port params),
    made once."""
    if not _MODELS:
        kw = dict(dtype="float32", num_layers=4)
        jcfg = dataclasses.replace(PAPER_ARCHS["gpt2-1.5b"].reduced(), **kw)
        tcfg = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), **kw)
        jm = build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS["gpt2"] = (jcfg, jm, jp, tcfg, DecoderLM(tcfg, device="cpu"),
                           params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODELS["gpt2"]


def _reqs(cls, prompts, max_new):
    return [cls(rid=i, prompt=p.copy(), max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]


def _events(engine):
    """The controller's audit log without its clock."""
    return [{k: v for k, v in e.items() if k != "t"} for e in engine.cluster.controller.events]


def _same(jax_engine, jax_rep, port_engine, port_rep):
    assert port_rep.tokens == jax_rep.tokens
    assert (port_rep.failures, port_rep.recoveries, port_rep.steps_redone) == \
        (jax_rep.failures, jax_rep.recoveries, jax_rep.steps_redone)
    assert _events(port_engine) == _events(jax_engine)
    assert port_rep.fault_trace == jax_rep.fault_trace
    assert port_engine.transfer_summary()["net"] == jax_engine.transfer_summary()["net"]
    assert_no_leaks(port_engine.cluster)


# ---------------------------------------------------------------------------
# run(): microbatch round-robin over dense caches
# ---------------------------------------------------------------------------

MB_PROMPTS = np.random.default_rng(0).integers(0, 256, (4, 8)).astype(np.int32)
MB_NEW = [6] * 4
# name -> (engine kwargs, run kwargs); 2 microbatches x 6 steps = 12 steps
MB_CASES = {
    "fail_9_w2": (dict(replication=True), dict(fail_at={9: 2})),
    "fail_5_w0": (dict(replication=True), dict(fail_at={5: 0})),
    "fail_12_w3": (dict(replication=True), dict(fail_at={12: 3})),
    "migrate_7_w1": (dict(replication=True), dict(migrate_at={7: 1})),
    "repartition_10_to_3": ({}, dict(repartition_at={10: 3})),
    "swapping_fail_11_w1": (dict(swapping=True, replication=True), dict(fail_at={11: 1})),
    "disaggregated_fail_8_w0": (dict(mode="disaggregated", dp_split=(2, 2),
                                     replication=True), dict(fail_at={8: 0})),
    "compressed_fail_9_w2": (dict(replication=True, compress_replicas=True),
                             dict(fail_at={9: 2})),
}


def _mb_run(case, port: bool):
    jcfg, jm, jp, tcfg, tm, tp = models()
    kw, run_kw = MB_CASES[case] if case else (dict(replication=True), {})
    if port:
        eng = ServingEngine(tcfg, tm, tp, 4, microbatch=2, device="cpu", **kw)
        return eng, eng.run(_reqs(Request, MB_PROMPTS, MB_NEW), **run_kw)
    eng = JaxEngine(jcfg, jm, jp, 4, microbatch=2, **kw)
    return eng, eng.run(_reqs(JaxRequest, MB_PROMPTS, MB_NEW), **run_kw)


_JAX_MB: dict = {}


def jax_mb(case):
    if case not in _JAX_MB:
        _JAX_MB[case] = _mb_run(case, port=False)
    return _JAX_MB[case]


@pytest.mark.parametrize("case", list(MB_CASES))
def test_run_recovers_as_jax_does(case):
    je, jrep = jax_mb(case)
    n0 = dict(LAUNCHES)
    te, trep = _mb_run(case, port=True)
    assert LAUNCHES == n0, "the CPU run must not reach a kernel"
    _same(je, jrep, te, trep)
    base = jax_mb(None)[1]
    kw, run_kw = MB_CASES[case]
    if "compress_replicas" not in kw:   # int8 replicas are not exact after a restore
        assert trep.tokens == base.tokens
    assert all(len(t) == 6 for t in trep.tokens.values())
    if "fail_at" in run_kw:
        assert trep.failures == 1
        assert [f["point"] for f in trep.fault_trace] == ["engine.step"]
    if case == "repartition_10_to_3":
        assert len(te.cluster.token_group) == 3
    if case == "migrate_7_w1":
        assert [e["kind"] for e in _events(te)] == ["migrate", "failure", "recovery"]
    if trep.recoveries:
        rec = trep.recovery_log[-1]
        assert rec["first_token_ms"] >= rec["rebuild_ms"] + rec["replica_ms"]


def test_compressed_replicas_cut_net_bytes_and_match_jax():
    """int8 replicas: the wire bytes of a failure-free run fall below 0.6x
    the uncompressed run's (fp32 -> int8 is 4x here), equal JAX's, and the
    tokens do not change without a failure."""
    jcfg, jm, jp, tcfg, tm, tp = models()
    full = ServingEngine(tcfg, tm, tp, 4, microbatch=2, replication=True, device="cpu")
    rep_full = full.run(_reqs(Request, MB_PROMPTS, MB_NEW))
    comp = ServingEngine(tcfg, tm, tp, 4, microbatch=2, replication=True,
                         compress_replicas=True, device="cpu")
    rep_comp = comp.run(_reqs(Request, MB_PROMPTS, MB_NEW))
    jcomp = JaxEngine(jcfg, jm, jp, 4, microbatch=2, replication=True, compress_replicas=True)
    jcomp.run(_reqs(JaxRequest, MB_PROMPTS, MB_NEW))
    assert comp.transfer_summary()["net"] < 0.6 * full.transfer_summary()["net"]
    assert comp.transfer_summary()["net"] == jcomp.transfer_summary()["net"]
    assert full.transfer_summary()["net"] == jax_mb(None)[0].transfer_summary()["net"]
    assert rep_comp.tokens == rep_full.tokens


def test_replica_stores_hold_what_jax_holds():
    """After a failure-free run() with replication, every worker's replica
    store holds the JAX worker's keys, with contents within 1e-5."""
    je, _ = jax_mb(None)
    te, _ = _mb_run(None, port=True)
    for jw, tw in zip(je.cluster.token_group, te.cluster.token_group):
        assert sorted(tw.cache.replica.keys()) == sorted(jw.cache.replica.keys())
        assert tw.cache.replica.keys()
        for key in jw.cache.replica.keys():
            np.testing.assert_allclose(tw.cache.replica.get(key).numpy(),
                                       np.asarray(jw.cache.replica.get(key)), atol=1e-5)
    # the acks agree too: the replication status map
    assert te.cluster.controller.rep_status == je.cluster.controller.rep_status


@pytest.mark.parametrize("depth", [1, 3])
def test_paged_repartition_moves_what_jax_moves(depth):
    """`repartition` of a paged cluster (2 stages -> `depth`) streams every
    live block through stream_out_blocks / stream_in_blocks: the new stages
    hold the JAX cluster's pages, and the network moved the same bytes."""
    jcfg, jm, jp, tcfg, tm, tp = models()
    je = JaxEngine(jcfg, jm, jp, 2, paged=True, kv_pool_blocks=64)
    te = ServingEngine(tcfg, tm, tp, 2, paged=True, kv_pool_blocks=64, device="cpu")
    jcl, tcl = je.cluster, te.cluster
    for rid, prompt in enumerate(PG_PROMPTS[:3]):
        jcl.prefill_seq(rid, prompt, 4)
        tcl.prefill_seq_begin(rid, prompt, 4)
        while tcl.prefill_seq_step(rid) is None:
            pass
    jcl.repartition(depth, [0, 1, 2])
    tcl.repartition(depth, [0, 1, 2])
    assert [(w.wid, w.lo, w.hi) for w in tcl.token_group] == \
        [(w.wid, w.lo, w.hi) for w in jcl.token_group]
    assert tcl.prompt_group is tcl.token_group
    for jw, tw in zip(jcl.token_group, tcl.token_group):
        for rid in range(3):
            jb, tb = jw.live_blocks(rid), tw.live_blocks(rid)
            assert sorted(tb) == sorted(jb)
            for j in jb:
                for leaf in ("k", "v"):
                    np.testing.assert_allclose(tb[j][leaf].numpy(), np.asarray(jb[j][leaf]),
                                               atol=1e-5)
        assert not tw.cache.host.keys()          # the landing zone was cleaned up
    assert te.transfer_summary()["net"] == je.transfer_summary()["net"] > 0
    assert [e["kind"] for e in _events(te)] == ["repartition"]


# ---------------------------------------------------------------------------
# only a dead worker is recovered from
# ---------------------------------------------------------------------------

def _raise_on(monkeypatch, method: str, exc: Exception, n_ok: int = 3):
    """Make `StageWorker.<method>` raise `exc` after `n_ok` calls."""
    calls = {"n": 0}
    orig = getattr(StageWorker, method)

    def patched(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] > n_ok:
            raise exc
        return orig(self, *a, **kw)

    monkeypatch.setattr(StageWorker, method, patched)


@pytest.mark.parametrize("path", ["run", "run_continuous"])
def test_a_plain_runtime_error_propagates(path, monkeypatch):
    """A stage that raises a plain RuntimeError (as a failed CUDA launch
    does) is not a dead worker: the error propagates and no recovery runs."""
    _, _, _, tcfg, tm, tp = models()
    recovered = []
    monkeypatch.setattr("repro_torch.core.cluster.DejaVuCluster.detect_and_recover",
                        lambda self, active: recovered.append(active) or {})
    if path == "run":
        _raise_on(monkeypatch, "decode", RuntimeError("CUDA error: launch failure"))
        eng = ServingEngine(tcfg, tm, tp, 4, microbatch=2, replication=True, device="cpu")
        with pytest.raises(RuntimeError, match="launch failure") as err:
            eng.run(_reqs(Request, MB_PROMPTS, MB_NEW))
    else:
        _raise_on(monkeypatch, "decode_paged_batch", RuntimeError("CUDA error: launch failure"))
        eng = ServingEngine(tcfg, tm, tp, 2, paged=True, kv_pool_blocks=64, replication=True,
                            device="cpu")
        with pytest.raises(RuntimeError, match="launch failure") as err:
            eng.run_continuous(_reqs(Request, PG_PROMPTS, PG_NEW), max_active=4)
    assert not isinstance(err.value, WorkerDead)
    assert recovered == []
    assert eng.cluster.controller.events == []
