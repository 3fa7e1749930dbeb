"""The port's paged prompt-token disaggregation and swapping on
`run_continuous` against the JAX engine.

Reduced gpt2-1.5b (fp32, 2 layers, 4:2 GQA, blocks of 8) with weights
bridged from the JAX params serves the same requests through both engines,
with a `Telemetry` and a `Tracer` installed: swapping colocated (every
sequence lives in host memory between its steps), disaggregated (1, 1) and
(2, 2) (the prompt pipeline streams each prompt's blocks to the token
pipeline), fused and per sequence, on plain stages and on a windowed model
whose second stage gathers its pages; the cases of
`tests/test_continuous_batching.py:111-127` and
`tests/test_fused_rounds.py:132` (swapping) and `:286` (the disaggregated
admission discount), and the disaggregated prefix reuse of
`tests/test_tiered_kv.py:375`.  Greedy tokens, `transfer_summary`,
`pool_stats` and the schedule must be equal, and the registry's and the
tracer's JSON byte for byte.  Under a worker's death (swapping, and
disaggregated on either side) the tokens, the recovery counts and the
controller's events must be the JAX run's.
"""
import dataclasses
import tempfile

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
from repro_torch.core.dejavulib import assert_no_leaks  # noqa: E402
from repro_torch.core.dejavulib.transport import HardwareModel  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

# the reference's hardware model, so the modeled clocks are comparable
HW = HardwareModel(**dataclasses.asdict(JaxHardwareModel()))
VARIANTS = {"gpt2": {},
            "window_meta": dict(sliding_window=6, num_meta_tokens=2, full_attn_layers=(0,))}
_MODELS: dict = {}


@pytest.fixture(autouse=True)
def _ssd_roots_in_tmp(tmp_path, monkeypatch):
    """The tiered cases' private SSD roots lie under the test's directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def models(variant: str):
    """(jax cfg, model, params, port cfg, model, params), once per variant."""
    if variant not in _MODELS:
        kw = dict(dtype="float32", num_layers=2, **VARIANTS[variant])
        jcfg = dataclasses.replace(PAPER_ARCHS["gpt2-1.5b"].reduced(), **kw)
        tcfg = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), **kw)
        jm = build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS[variant] = (jcfg, jm, jp, tcfg, DecoderLM(tcfg, device="cpu"),
                            params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODELS[variant]


def _prompts(n, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (lens[i % len(lens)],)).astype(np.int32) for i in range(n)]


# as tests/test_continuous_batching.py:22-25: a mixed trace, its own budgets
MIXED = (_prompts(4, [8, 12, 8, 12]), [6, 3, 5, 4])
FUSED = (_prompts(4, [8, 12]), 4)                     # tests/test_fused_rounds.py:134
_SHARED = _prompts(1, [24], seed=21)[0]               # tests/test_fused_rounds.py:295
_SYS = np.random.default_rng(0).integers(0, 256, (24,)).astype(np.int32)
SYS_PROMPTS = ([np.concatenate([_SYS, t]) for t in _prompts(4, [8], seed=3)], 5)
DISAGG11 = dict(mode="disaggregated", dp_split=(1, 1))
DISAGG22 = dict(mode="disaggregated", dp_split=(2, 2), n_workers=4)
TIERS = dict(tiered=True, host_cache_blocks=16, ssd_cache_blocks=64)

# name -> (variant, engine kwargs, (prompts, max_new), max_active)
CASES = {
    "swapping_fused": ("gpt2", dict(swapping=True, kv_pool_blocks=64), MIXED, 4),
    "swapping_perseq": ("gpt2", dict(swapping=True, kv_pool_blocks=64, fused_rounds=False),
                        MIXED, 4),
    "swapping_gather_route": ("window_meta", dict(swapping=True, kv_pool_blocks=64), MIXED, 4),
    "disaggregated_1_1_fused": ("gpt2", dict(DISAGG11, kv_pool_blocks=64), MIXED, 4),
    "disaggregated_1_1_perseq": ("gpt2", dict(DISAGG11, kv_pool_blocks=64, fused_rounds=False),
                                 MIXED, 4),
    "disaggregated_2_2_fused": ("gpt2", dict(DISAGG22, kv_pool_blocks=64), MIXED, 4),
    "disaggregated_2_2_gather_route": ("window_meta", dict(DISAGG22, kv_pool_blocks=64),
                                       MIXED, 4),
    "disaggregated_swapping": ("gpt2", dict(DISAGG11, swapping=True, kv_pool_blocks=64),
                               FUSED, 3),
    "disaggregated_admission_discount": ("gpt2", dict(DISAGG11, **TIERS, kv_pool_blocks=7),
                                         ([_SHARED, _SHARED], 3), 2),
    "disaggregated_2_2_prefix_reuse": ("gpt2", dict(DISAGG22, **dict(TIERS, ssd_cache_blocks=None),
                                                    kv_pool_blocks=128), SYS_PROMPTS, 1),
}


def _run(port: bool, variant: str, ekw, trace, max_active, fail_at=None):
    """One run with a fresh registry and tracer installed around it:
    (engine, report, registry JSON, tracer JSON)."""
    jcfg, jm, jp, tcfg, tm, tp = models(variant)
    ekw = dict(ekw)
    n = ekw.pop("n_workers", 2)
    prompts, max_new = trace
    max_new = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    tele, trc = (telemetry, tracing) if port else (jax_telemetry, jax_tracing)
    if port:
        eng = ServingEngine(tcfg, tm, tp, n, paged=True, hw=HW, device="cpu", **ekw)
        cls = Request
    else:
        eng = JaxEngine(jcfg, jm, jp, n, paged=True, **ekw)
        cls = JaxRequest
    reqs = [cls(rid=i, prompt=p.copy(), max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    reg, tracer = tele.Telemetry(), trc.Tracer()
    prev_t, prev_r = tele.install(reg), trc.install(tracer)
    try:
        rep = eng.run_continuous(reqs, max_active=max_active, fail_at=fail_at)
        eng.cluster.streamer.drain()      # the last write-behinds land
    finally:
        trc.uninstall(prev_r)
        tele.uninstall(prev_t)
    return eng, rep, reg.to_json(), tracer.to_json()


def _events(engine):
    """The controller's audit log without its clock."""
    return [{k: v for k, v in e.items() if k != "t"} for e in engine.cluster.controller.events]


def _held_to_jax(variant, ekw, trace, max_active, fail_at=None):
    je, jrep, jtele, jtrace = _run(False, variant, ekw, trace, max_active, fail_at)
    n0 = dict(LAUNCHES)
    te, trep, ttele, ttrace = _run(True, variant, ekw, trace, max_active, fail_at)
    assert LAUNCHES == n0, "the CPU run must not reach a kernel"
    assert trep.tokens == jrep.tokens
    assert (trep.preemptions, trep.failures, trep.recoveries, trep.steps_redone) == \
        (jrep.preemptions, jrep.failures, jrep.recoveries, jrep.steps_redone)
    assert te.transfer_summary() == je.transfer_summary()
    tp, jp = te.cluster.pool_stats(), je.cluster.pool_stats()
    if fail_at:
        # the port's recovery holds a swapped sequence in host memory without
        # taking a pool block; the reference installs it, then swaps it out
        assert tp["peak_blocks"] <= jp["peak_blocks"]
        tp["peak_blocks"] = jp["peak_blocks"]
    assert tp == jp
    assert trep.tier_stats == jrep.tier_stats
    assert (trep.prefill_tokens_saved, trep.prefill_tokens_total) == \
        (jrep.prefill_tokens_saved, jrep.prefill_tokens_total)
    assert _events(te) == _events(je)
    if not fail_at:
        # a death cut a fused pass short: the port runs it again at once, the
        # reference in the next round (CHANGES.md, PR 18)
        assert trep.batch_trace == jrep.batch_trace and trep.pass_trace == jrep.pass_trace
        assert ttele == jtele
        assert ttrace == jtrace
    assert_no_leaks(te.cluster)
    return te, trep


@pytest.mark.parametrize("case", list(CASES))
def test_run_continuous_paged_modes_as_jax_does(case):
    variant, ekw, trace, max_active = CASES[case]
    te, rep = _held_to_jax(variant, ekw, trace, max_active)
    xfer = te.transfer_summary()
    prompts, max_new = trace
    assert [len(rep.tokens[i]) for i in range(len(prompts))] == \
        (max_new if isinstance(max_new, list) else [max_new] * len(prompts))
    cl = te.cluster
    if ekw.get("swapping"):
        assert xfer["hostlink"] > 0
        # between steps every sequence lives in host memory
        assert all(not w.pool.tables for w in cl.token_group)
    if ekw.get("mode") == "disaggregated":
        assert xfer["net"] > 0 and cl.prompt_group != cl.token_group
        assert all(w.pool.peak_used_blocks > 0 for w in cl.workers())
    if variant == "window_meta":
        assert not all(w.reads_pages() for w in cl.workers())
    if case == "disaggregated_admission_discount":
        assert max(rep.batch_trace) == 2                  # both ran at once
        assert cl.token_group[0].pool.peak_used_blocks <= 7
    if case == "disaggregated_2_2_prefix_reuse":
        assert rep.prefill_tokens_saved > 0


def test_swapped_and_disaggregated_runs_give_the_colocated_tokens():
    """Where the KV lives does not change what the model computes:
    swapping and both splits give the tokens of the plain colocated run
    (tests/test_fused_rounds.py:132, tests/test_continuous_batching.py)."""
    _, base, _, _ = _run(True, "gpt2", dict(kv_pool_blocks=64, fused_rounds=False), MIXED, 4)
    for ekw in (dict(swapping=True), DISAGG11, DISAGG22):
        _, rep, _, _ = _run(True, "gpt2", dict(ekw, kv_pool_blocks=64), MIXED, 4)
        assert rep.tokens == base.tokens, ekw


# name -> (engine kwargs, fail_at): swapping loses a token worker; the
# disaggregated split loses its last token worker, or a prompt worker
FAIL_CASES = {
    "swapping_fused_fail_9_w1": (dict(swapping=True), {9: 1}),
    "swapping_perseq_fail_5_w0": (dict(swapping=True, fused_rounds=False), {5: 0}),
    "disaggregated_2_2_fail_9_w3": (DISAGG22, {9: 3}),
    "disaggregated_2_2_fail_3_prompt_w0": (DISAGG22, {3: 0}),
}


@pytest.mark.parametrize("case", list(FAIL_CASES))
def test_paged_modes_recover_as_jax_does(case):
    ekw, fail_at = FAIL_CASES[case]
    te, rep = _held_to_jax("gpt2", dict(ekw, kv_pool_blocks=64, replication=True), MIXED, 4,
                           fail_at)
    assert rep.failures == 1 and rep.recoveries == 1
    _, clean, _, _ = _run(True, "gpt2", dict(ekw, kv_pool_blocks=64, replication=True), MIXED, 4)
    assert rep.tokens == clean.tokens
