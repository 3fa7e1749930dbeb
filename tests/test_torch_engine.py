"""The port's continuous-batching engine against the JAX engine.

`repro_torch.serving.ServingEngine.run_continuous` on the CPU, with weights
bridged from the JAX package's, serves the traces of
`tests/test_fused_rounds.py` (reduced gpt2-1.5b, fp32, 2 layers, 2 stage
workers): the mixed trace, the 8-active round, chunk packing and the tiny
pool that preempts.  Greedy tokens, the per-round batch and pass traces,
preemptions and steps must be identical to the JAX engine's, and within the
port the fused rounds must give the per-sequence path's tokens.  Those
traces run plain gpt2, whose fused passes read the pages in place; one
windowed and one ALiBi trace hold the route that gathers them dense.
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
from repro_torch.kvcache.paged import PagedKVCache  # noqa: E402
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


# the gather route: a stage with a windowed or ALiBi layer gathers its pages
GATHER_VARIANTS = {
    "window_meta": dict(sliding_window=6, num_meta_tokens=2, full_attn_layers=(0,)),
    "alibi": dict(pos_emb="alibi"),
}


@pytest.mark.parametrize("variant", list(GATHER_VARIANTS))
def test_port_engine_matches_jax_engine_on_the_gather_route(variant):
    """The chunk-packing trace (chunk-set and decode passes) on a windowed
    model, whose layer-0 stage reads the pages and layer-1 stage gathers
    them, and on an ALiBi model, whose stages both gather: tokens and traces
    identical to the JAX engine's."""
    kw = GATHER_VARIANTS[variant]
    jcfg, tcfg = dataclasses.replace(CFG, **kw), dataclasses.replace(TCFG, **kw)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    prompts, mx, ekw, ma = TRACES["chunk_packing"]
    ref = JaxEngine(jcfg, jm, jp, 2, paged=True, **ekw).run_continuous(
        [JaxRequest(rid=i, prompt=p.copy(), max_new=m)
         for i, (p, m) in enumerate(zip(prompts, mx))], max_active=ma)
    eng = ServingEngine(tcfg, DecoderLM(tcfg, device="cpu"),
                        params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu"),
                        2, paged=True, device="cpu", **ekw)
    assert [w.reads_pages() for w in eng.cluster.workers()] == \
        ([True, False] if variant == "window_meta" else [False, False])
    rep = eng.run_continuous([Request(rid=i, prompt=p.copy(), max_new=m)
                              for i, (p, m) in enumerate(zip(prompts, mx))], max_active=ma)
    assert rep.tokens == ref.tokens
    assert rep.batch_trace == ref.batch_trace and rep.pass_trace == ref.pass_trace
    assert rep.pass_counts["chunkset"] > 0 and rep.pass_counts["fused_decode"] > 0


def test_plain_route_never_gathers_and_a_windowed_stage_does(port_model, monkeypatch):
    """With every stage plain causal the fused passes never call
    `gather_dense` (patched to raise when given a batch of sequences, the
    fused passes' call); each admitted request's first chunk runs on the
    per-sequence path, which still gathers its one sequence.  With a
    windowed layer its stage's fused passes gather, and only that stage's."""
    per_seq = []

    def fused_refused(self, seqs, pad_to):
        if not isinstance(seqs, int):
            raise AssertionError("gather_dense in a fused pass of the plain route")
        per_seq.append(seqs)
        return real(self, seqs, pad_to)

    real = PagedKVCache.gather_dense
    with monkeypatch.context() as m:
        m.setattr(PagedKVCache, "gather_dense", fused_refused)
        rep = run_port(port_model, "chunk_packing")
    pc = rep.pass_counts
    assert pc["chunkset"] > 0 and pc["fused_decode"] > 0
    assert len(per_seq) == 2 * pc["prefill_chunk"] > 0       # one per stage per pass

    tcfg = dataclasses.replace(TCFG, **GATHER_VARIANTS["window_meta"])
    model = DecoderLM(tcfg, device="cpu")
    eng = ServingEngine(tcfg, model, model.init(torch.Generator().manual_seed(0)), 2,
                        paged=True, device="cpu", **TRACES["chunk_packing"][2])
    fused = {}
    for w in eng.cluster.workers():
        def counted(seqs, pad_to, _wid=w.wid, _real=w.pages.gather_dense):
            if not isinstance(seqs, int):
                fused[_wid] = fused.get(_wid, 0) + 1
            return _real(seqs, pad_to)
        w.pages.gather_dense = counted
    prompts, mx, _, ma = TRACES["chunk_packing"]
    eng.run_continuous([Request(rid=i, prompt=p.copy(), max_new=n)
                        for i, (p, n) in enumerate(zip(prompts, mx))], max_active=ma)
    stage1 = eng.cluster.workers()[1].wid
    assert set(fused) == {stage1} and fused[stage1] > 0
