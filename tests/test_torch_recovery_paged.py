"""The port's ring replication and 4-step recovery against the JAX engine,
on the paged path (`run_continuous`).

The failure trace of `tests/test_fused_rounds.py:106-118` (6 prompts of 8
and 12 tokens, 2 workers, reduced gpt2-1.5b at fp32, 4 layers) through both
engines with the same bridged weights and the same `fail_at`: fused rounds
and the per-sequence path on plain stages (which read the pages in place),
and fused rounds on stages that gather the pages dense (a sliding window
with meta sinks, ALiBi).  Each case must give the JAX run's tokens,
failures, recoveries, steps redone, controller event kinds and resume
dicts, and `net` bytes, and the failure-free run's tokens;
`faults.assert_no_leaks` must hold.
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
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

VARIANTS = {
    "gpt2": {},
    "window_meta": dict(sliding_window=6, num_meta_tokens=2, full_attn_layers=(0,)),
    "alibi": dict(pos_emb="alibi"),
}
_RNG = np.random.default_rng(0)
PG_PROMPTS = [_RNG.integers(0, 256, (n,)).astype(np.int32) for n in [8, 12, 8, 12, 8, 12]]
PG_NEW = [6, 3, 7, 4, 3, 6]
_MODELS: dict = {}


def models(variant: str):
    """(jax cfg, jax model, jax params, port cfg, port model, port params),
    made once per variant."""
    if variant not in _MODELS:
        kw = dict(dtype="float32", num_layers=4, **VARIANTS[variant])
        jcfg = dataclasses.replace(PAPER_ARCHS["gpt2-1.5b"].reduced(), **kw)
        tcfg = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), **kw)
        jm = build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS[variant] = (jcfg, jm, jp, tcfg, DecoderLM(tcfg, device="cpu"),
                            params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODELS[variant]


def _reqs(cls, prompts, max_new):
    return [cls(rid=i, prompt=p.copy(), max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]


def _events(engine):
    """The controller's audit log without its clock."""
    return [{k: v for k, v in e.items() if k != "t"} for e in engine.cluster.controller.events]


# name -> (variant, fused_rounds, fail_at), as tests/test_fused_rounds.py:106-118
PG_CASES = {
    "fused_fail_9_w1": ("gpt2", True, {9: 1}),
    "fused_fail_5_w0": ("gpt2", True, {5: 0}),
    "perseq_fail_9_w1": ("gpt2", False, {9: 1}),
    "perseq_fail_5_w0": ("gpt2", False, {5: 0}),
    "window_meta_fused_fail_9_w1": ("window_meta", True, {9: 1}),
    "alibi_fused_fail_5_w0": ("alibi", True, {5: 0}),
}


def _pg_run(variant, fused, fail_at, port: bool):
    jcfg, jm, jp, tcfg, tm, tp = models(variant)
    kw = dict(paged=True, kv_pool_blocks=64, replication=True, fused_rounds=fused)
    if port:
        eng = ServingEngine(tcfg, tm, tp, 2, device="cpu", **kw)
        return eng, eng.run_continuous(_reqs(Request, PG_PROMPTS, PG_NEW), max_active=4,
                                       fail_at=fail_at)
    eng = JaxEngine(jcfg, jm, jp, 2, **kw)
    return eng, eng.run_continuous(_reqs(JaxRequest, PG_PROMPTS, PG_NEW), max_active=4,
                                   fail_at=fail_at)


@pytest.mark.parametrize("case", list(PG_CASES))
def test_run_continuous_recovers_as_jax_does(case):
    variant, fused, fail_at = PG_CASES[case]
    je, jrep = _pg_run(variant, fused, fail_at, port=False)
    n0 = dict(LAUNCHES)
    te, trep = _pg_run(variant, fused, fail_at, port=True)
    assert LAUNCHES == n0, "the CPU run must not reach a kernel"
    assert trep.tokens == jrep.tokens
    assert (trep.failures, trep.recoveries, trep.steps_redone) == \
        (jrep.failures, jrep.recoveries, jrep.steps_redone)
    assert _events(te) == _events(je)
    assert trep.fault_trace == jrep.fault_trace
    assert te.transfer_summary()["net"] == je.transfer_summary()["net"]
    assert_no_leaks(te.cluster)
    assert trep.failures == 1 and trep.recoveries == 1
    assert [e["kind"] for e in _events(te)] == ["failure", "recovery"]
    # the gather route really ran on the windowed and ALiBi stages
    assert all(w.reads_pages() for w in te.cluster.workers()) == (variant == "gpt2")
    # recovery regenerates the failure-free tokens
    _, clean = _pg_run(variant, fused, None, port=True)
    assert trep.tokens == clean.tokens
    assert all(len(t) == m for t, m in zip(trep.tokens.values(), PG_NEW))
