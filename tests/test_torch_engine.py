"""The port's continuous-batching engine against the JAX engine.

`repro_torch.serving.ServingEngine.run_continuous` on the CPU, with weights
bridged from the JAX package's, serves the traces of
`tests/test_fused_rounds.py` (reduced gpt2-1.5b, fp32, 2 layers, 2 stage
workers): the mixed trace, the 8-active round, chunk packing and the tiny
pool that preempts.  Greedy tokens, the per-round batch and pass traces,
preemptions and steps must be identical to the JAX engine's, and within the
port the fused rounds must give the per-sequence path's tokens.
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
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

CFG = dataclasses.replace(PAPER_ARCHS["gpt2-1.5b"].reduced(), dtype="float32",
                          num_layers=2)
TCFG = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), dtype="float32",
                           num_layers=2)


def _prompts(n, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(n)]


# name -> (prompts, max_new per request, engine kwargs, max_active), as in
# tests/test_fused_rounds.py
TRACES = {
    "mixed": (_prompts(6, [8, 12]), [6, 3, 7, 4, 3, 6], dict(kv_pool_blocks=64), 4),
    "eight_active": (_prompts(8, [8]), [6] * 8, dict(kv_pool_blocks=256), 8),
    "chunk_packing": (_prompts(2, [8]) + _prompts(2, [40], seed=3), [6] * 4,
                      dict(kv_pool_blocks=128, prefill_chunk_tokens=8), 4),
    "tiny_pool": (_prompts(2, [8], seed=5), [10] * 2, dict(kv_pool_blocks=4), 2),
}


@pytest.fixture(scope="module")
def jax_model():
    model = build_model(CFG)
    return model, model.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_model(jax_model):
    _, params = jax_model
    return (DecoderLM(TCFG, device="cpu"),
            params_from_jax(TCFG, jax.tree.map(np.asarray, params), device="cpu"))


@pytest.fixture(scope="module")
def jax_reports(jax_model):
    """The JAX engine's fused run of each trace, made once per module."""
    model, params = jax_model
    cache = {}

    def get(name):
        if name not in cache:
            prompts, mx, kw, ma = TRACES[name]
            reqs = [JaxRequest(rid=i, prompt=p.copy(), max_new=m)
                    for i, (p, m) in enumerate(zip(prompts, mx))]
            cache[name] = JaxEngine(CFG, model, params, 2, paged=True,
                                    **kw).run_continuous(reqs, max_active=ma)
        return cache[name]
    return get


def run_port(port_model, name, **extra):
    model, params = port_model
    prompts, mx, kw, ma = TRACES[name]
    reqs = [Request(rid=i, prompt=p.copy(), max_new=m)
            for i, (p, m) in enumerate(zip(prompts, mx))]
    eng = ServingEngine(TCFG, model, params, 2, paged=True, device="cpu", **kw, **extra)
    return eng.run_continuous(reqs, max_active=ma)


@pytest.mark.parametrize("name", list(TRACES))
def test_port_engine_matches_jax_engine(name, port_model, jax_reports):
    ref = jax_reports(name)
    n0 = dict(LAUNCHES)
    rep = run_port(port_model, name)
    assert LAUNCHES == n0, "the CPU run must not reach a kernel"
    assert rep.tokens == ref.tokens
    assert rep.batch_trace == ref.batch_trace
    assert rep.pass_trace == ref.pass_trace
    assert rep.preemptions == ref.preemptions
    assert rep.steps_executed == ref.steps_executed
    if name == "tiny_pool":
        assert rep.preemptions >= 1


@pytest.mark.parametrize("name", list(TRACES))
def test_port_fused_equals_per_sequence(name, port_model):
    fused = run_port(port_model, name)
    perseq = run_port(port_model, name, fused_rounds=False)
    assert fused.tokens == perseq.tokens
    assert all(len(t) == m for t, m in zip(fused.tokens.values(), TRACES[name][1]))
    assert sum(fused.pass_trace) <= sum(perseq.pass_trace)
    # the engine's own pass counts: every fused decode pass is one-token
    pc = fused.pass_counts
    assert sum(pc.get(k, 0) for k in ("prefill_chunk", "chunkset", "fused_decode")) \
        == sum(fused.pass_trace)
    assert pc["one_token"] >= pc["fused_decode"] > 0
    assert "perseq_decode" not in pc and perseq.pass_counts["perseq_decode"] > 0


def test_port_eight_active_round_is_one_pass(port_model):
    """An 8-active decode round is one batched pipeline pass; the
    per-sequence path runs 8."""
    fus = run_port(port_model, "eight_active")
    base = run_port(port_model, "eight_active", fused_rounds=False)
    steady = [p for p, b in zip(fus.pass_trace[1:], fus.batch_trace[1:]) if b == 8]
    assert steady and all(p == 1 for p in steady), fus.pass_trace
    assert all(p == 8 for p, b in zip(base.pass_trace[1:], base.batch_trace[1:])
               if b == 8), base.pass_trace


def test_port_chunk_packing_bounds_passes_per_round(port_model):
    """Once admitted, a fused round is at most one chunk-set pass and one
    decode pass; the per-sequence path runs a pass per chunk."""
    fus = run_port(port_model, "chunk_packing")
    base = run_port(port_model, "chunk_packing", fused_rounds=False)
    assert all(p <= 2 for p in fus.pass_trace[1:]), fus.pass_trace
    assert max(base.pass_trace[1:]) > 2, base.pass_trace
