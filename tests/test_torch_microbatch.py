"""The port's microbatch round-robin path (`ServingEngine.run`) and
whole-prompt prefill against the JAX package's.

One set of weights, made by the JAX package from a seed and bridged to the
port, serves `tests/test_serving_fault.py`'s trace (4 prompts of 8 tokens,
6 new tokens each, microbatch 2, reduced gpt2-1.5b at fp32) through both
engines: colocated, with microbatch swapping, and disaggregated with an even
and an uneven prompt/token split.  Greedy tokens, steps, peak KV bytes and
the bytes each transport moved must equal the JAX engine's; within the port
`run()` must give `run_continuous`'s tokens.  Below the engine, the stage
functions of the path (`stage_prefill`, the microbatch `stage_decode`) are
held against JAX's at fp32 within atol 1e-4, for gpt2 and for variants with
a sliding window and meta sinks (which pins `attention_auto`'s routing),
ALiBi, and RoPE with rmsnorm and SiLU.
"""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread is faster, and steady on a shared host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import PAPER_ARCHS  # noqa: E402
from repro.core.dejavulib import NetworkTransport as JaxNet  # noqa: E402
from repro.core.dejavulib import PipelineTopo as JaxTopo  # noqa: E402
from repro.core.dejavulib import scatter as jax_scatter  # noqa: E402
from repro.core.dejavulib import stream_in as jax_stream_in  # noqa: E402
from repro.core.dejavulib import stream_out as jax_stream_out  # noqa: E402
from repro.core.dejavulib.buffers import HostMemoryStore as JaxStore  # noqa: E402
from repro.kvcache.cache import decode_state_shapes as jax_shapes  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.request import form_microbatches as jax_form  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.dejavulib import (HostLinkTransport, HostMemoryStore,  # noqa: E402
                                        NetworkTransport, PipelineTopo, scatter,
                                        stream_in, stream_out)
from repro_torch.kernels import LAUNCHES, ops  # noqa: E402
from repro_torch.kvcache.cache import decode_state_shapes, init_decode_state, state_bytes  # noqa: E402,E501
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving import Request, ServingEngine, form_microbatches  # noqa: E402

ATOL = 1e-4

# ---------------------------------------------------------------------------
# stages: stage_prefill and the microbatch stage_decode
# ---------------------------------------------------------------------------

VARIANTS = {
    "gpt2": {},
    "window_meta": dict(sliding_window=6, num_meta_tokens=2, full_attn_layers=(0,)),
    "alibi": dict(pos_emb="alibi"),
    "rope_rmsnorm_silu": dict(pos_emb="rope", norm="rmsnorm", activation="silu"),
}
STAGES = {"first": (0, 1, True, False), "last": (1, 2, False, True)}


def configs(variant: str, **kw):
    kw = dict(dtype="float32", num_layers=2, **VARIANTS[variant], **kw)
    return (dataclasses.replace(PAPER_ARCHS["gpt2-1.5b"].reduced(), **kw),
            dataclasses.replace(get_arch("gpt2-1.5b").reduced(), **kw))


_PAIRS: dict = {}


def pair(variant: str):
    """(jax model, jax params, port model, port params), made once."""
    if variant not in _PAIRS:
        jcfg, tcfg = configs(variant)
        jm = build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _PAIRS[variant] = (jm, jp, DecoderLM(tcfg, device="cpu"),
                           params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return _PAIRS[variant]


def _close(name, t, j):
    assert tuple(t.shape) == tuple(j.shape), name
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_stage_prefill_matches_reference(variant, stage):
    """A microbatch of 2 prompts of 20 tokens: longer than the window, so a
    flash route that ignored the window would show."""
    jm, jp, tm, tp = pair(variant)
    lo, hi, first, last = STAGES[stage]
    rng = np.random.default_rng(zlib.crc32(f"{variant}/{stage}".encode()))
    b, s = 2, 20
    x = rng.standard_normal((b, s, tm.cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, tm.cfg.vocab_size, (b, s)).astype(np.int32)
    jsp = jm.slice_params(jp, lo, hi, first=first, last=last)
    tsp = tm.slice_params(tp, lo, hi, first=first, last=last)
    if first:
        jout = jm.stage_prefill(jsp, None, first=True, last=last, tokens=jnp.asarray(toks))
        tout = tm.stage_prefill(tsp, None, first=True, last=last,
                                tokens=torch.from_numpy(toks))
    else:
        jout = jm.stage_prefill(jsp, jnp.asarray(x), first=False, last=last)
        tout = tm.stage_prefill(tsp, torch.from_numpy(x), first=False, last=last)
    for name, t, j in zip(("out", "k", "v"), tout, jout):
        _close(f"{variant} {stage} {name}", t, j)


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_microbatch_stage_decode_matches_reference(variant, stage):
    """Two sequences sharing one position over a cache of 24 slots: the
    run() decode, through `decode_attention` with one validity row (ALiBi
    through `batched_decode_attention`)."""
    jm, jp, tm, tp = pair(variant)
    lo, hi, first, last = STAGES[stage]
    rng = np.random.default_rng(zlib.crc32(f"decode/{variant}/{stage}".encode()))
    b, s, pos = 2, 24, 17
    hkv, dh = tm.cfg.num_kv_heads, tm.cfg.resolved_head_dim
    kc = rng.standard_normal((1, b, s, hkv, dh)).astype(np.float32)
    vc = rng.standard_normal((1, b, s, hkv, dh)).astype(np.float32)
    x = rng.standard_normal((b, 1, tm.cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, tm.cfg.vocab_size, (b,)).astype(np.int32)
    jsp = jm.slice_params(jp, lo, hi, first=first, last=last)
    tsp = tm.slice_params(tp, lo, hi, first=first, last=last)
    kw = dict(first=first, last=last)
    jout = jm.stage_decode(jsp, None if first else jnp.asarray(x), jnp.asarray(kc),
                           jnp.asarray(vc), jnp.int32(pos), **kw,
                           **({"token": jnp.asarray(tok)} if first else {}))
    tout = tm.stage_decode(tsp, None if first else torch.from_numpy(x),
                           torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), pos,
                           **kw, **({"token": torch.from_numpy(tok)} if first else {}))
    for name, t, j in zip(("out", "k", "v"), tout, jout):
        _close(f"{variant} {stage} {name}", t, j)


@pytest.mark.parametrize("variant", ["gpt2", "window_meta"])
def test_whole_model_prefill_and_decode_step_match_reference(variant):
    """The oracle of the engine tests: whole-model prefill then decode
    steps, logits within atol 1e-4 and the same greedy tokens."""
    jm, jp, tm, tp = pair(variant)
    prompts = np.random.default_rng(7).integers(0, tm.cfg.vocab_size, (2, 10)).astype(np.int32)
    jl, jst, jpos = jm.prefill(jp, {"tokens": jnp.asarray(prompts)}, max_len=16)
    tl, tst, tpos = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)}, max_len=16)
    assert tpos == int(jpos)
    _close("prefill logits", tl, jl)
    _close("prefill k", tst["kv"]["k"], jst["kv"]["k"])
    for step in range(4):
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        assert np.array_equal(tok, torch.argmax(tl, -1).numpy())
        jl, jst = jm.decode_step(jp, jst, jnp.asarray(tok), jnp.int32(tpos + step))
        tl, tst = tm.decode_step(tp, tst, torch.from_numpy(tok), tpos + step)
        _close(f"decode logits {step}", tl, jl)


# ---------------------------------------------------------------------------
# the engine: run() against the JAX engine's run()
# ---------------------------------------------------------------------------

CFG = dataclasses.replace(PAPER_ARCHS["gpt2-1.5b"].reduced(), dtype="float32", num_layers=4)
TCFG = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), dtype="float32", num_layers=4)
PROMPTS = np.random.default_rng(0).integers(0, CFG.vocab_size, (4, 8)).astype(np.int32)
N_NEW = 6

# mode -> (workers, engine kwargs)
MODES = {
    "colocated": (2, dict()),
    "swapping": (2, dict(swapping=True)),
    "disaggregated_even": (4, dict(mode="disaggregated", dp_split=(2, 2))),
    "disaggregated_uneven": (4, dict(mode="disaggregated", dp_split=(1, 3))),
}


@pytest.fixture(scope="module")
def models():
    jm = build_model(CFG)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, DecoderLM(TCFG, device="cpu"), params_from_jax(
        TCFG, jax.tree.map(np.asarray, jp), device="cpu")


def _reqs(cls):
    return [cls(rid=i, prompt=PROMPTS[i].copy(), max_new=N_NEW) for i in range(4)]


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX engine's report and transfer summary per mode, made once."""
    jm, jp, _, _ = models
    cache = {}

    def get(mode):
        if mode not in cache:
            n, kw = MODES[mode]
            eng = JaxEngine(CFG, jm, jp, n, microbatch=2, **kw)
            cache[mode] = (eng.run(_reqs(JaxRequest)), eng.transfer_summary())
        return cache[mode]
    return get


def _port_run(models, mode):
    _, _, tm, tp = models
    n, kw = MODES[mode]
    eng = ServingEngine(TCFG, tm, tp, n, microbatch=2, device="cpu", **kw)
    return eng.run(_reqs(Request)), eng


@pytest.mark.parametrize("mode", list(MODES))
def test_run_matches_jax_run(mode, models, jax_runs):
    ref, ref_xfer = jax_runs(mode)
    n0 = dict(LAUNCHES)
    rep, eng = _port_run(models, mode)
    assert LAUNCHES == n0, "the CPU run must not reach a kernel"
    assert rep.tokens == ref.tokens
    assert all(len(t) == N_NEW for t in rep.tokens.values())
    assert rep.steps_executed == ref.steps_executed
    assert rep.peak_kv_bytes == ref.peak_kv_bytes
    assert eng.transfer_summary() == ref_xfer
    xfer = eng.transfer_summary()
    if mode == "swapping":
        assert xfer["hostlink"] > 0 and rep.peak_kv_bytes < jax_runs("colocated")[0].peak_kv_bytes
        # between its steps every microbatch lives in host memory
        assert all(w.resident() == 0 for w in eng.cluster.token_group)
    if mode.startswith("disaggregated"):
        assert xfer["net"] > 0


def test_run_matches_whole_model_generation(models):
    """`test_serving_fault.py`'s oracle on the port: whole-model prefill and
    decode steps of the first microbatch give run()'s tokens."""
    _, _, tm, tp = models
    logits, state, pos = tm.prefill(tp, {"tokens": torch.from_numpy(PROMPTS[:2])},
                                    max_len=PROMPTS.shape[1] + N_NEW)
    toks = [torch.argmax(logits, -1).to(torch.int32)]
    for _ in range(1, N_NEW):
        logits, state = tm.decode_step(tp, state, toks[-1], pos)
        pos += 1
        toks.append(torch.argmax(logits, -1).to(torch.int32))
    rep, _ = _port_run(models, "colocated")
    assert torch.stack(toks, 1).tolist() == [rep.tokens[0], rep.tokens[1]]


def test_run_goes_through_the_kernels_entry_points(models, monkeypatch):
    """What `chip_smoke.py` checks on the card, counted here at the entry
    points: flash attention once per layer per microbatch prefill, the
    shared-row decode attention once per layer per decode pass."""
    calls = {"flash": 0, "decode": 0}
    real_flash, real_dec = ops._flash, ops.decode_attention_auto

    def flash(*a, **kw):
        calls["flash"] += 1
        return real_flash(*a, **kw)

    def dec(*a, **kw):
        calls["decode"] += 1
        return real_dec(*a, **kw)

    monkeypatch.setattr(ops, "_flash", flash)
    monkeypatch.setattr(ops, "decode_attention_auto", dec)
    rep, _ = _port_run(models, "colocated")
    pc = rep.pass_counts
    assert pc["mb_prefill"] == 2 and pc["mb_decode"] == 2 * (N_NEW - 1)
    assert calls == {"flash": TCFG.num_layers * pc["mb_prefill"],
                     "decode": TCFG.num_layers * pc["mb_decode"]}


def test_run_equals_run_continuous(models):
    rep, _ = _port_run(models, "colocated")
    _, _, tm, tp = models
    cont = ServingEngine(TCFG, tm, tp, 2, paged=True, device="cpu").run_continuous(
        _reqs(Request))
    assert rep.tokens == cont.tokens


def test_microbatches_bucket_by_prompt_length_like_the_reference():
    rng = np.random.default_rng(3)
    lens = [8, 12, 8, 8, 12, 5, 8]
    prompts = [rng.integers(0, 9, n).astype(np.int32) for n in lens]
    mine = form_microbatches([Request(i, p, 3) for i, p in enumerate(prompts)], 2)
    ref = jax_form([JaxRequest(i, p, 3) for i, p in enumerate(prompts)], 2)
    assert [[r.rid for r in m.requests] for m in mine] == \
        [[r.rid for r in m.requests] for m in ref]
    assert [m.mb for m in mine] == [m.mb for m in ref]


@pytest.mark.parametrize("src,dst", [((2, 2), (1, 2)), ((1, 2), (3, 2))])
def test_stream_lands_what_the_reference_lands(src, dst):
    """Prompt KV of 13 tokens in a 24-slot cache, streamed between
    pipelines of other depths: the port lands each chunk on the device with
    kv_unpack (padded to the token block), the reference in host memory;
    the caches are equal and so are the bytes on the wire."""
    layers, b, s, h, d, plen = 6, 2, 24, 2, 8, 13
    rng = np.random.default_rng(9)
    full = {leaf: rng.standard_normal((layers, b, s, h, d)).astype(np.float32)
            for leaf in ("k", "v")}
    for kv in full.values():
        kv[:, :, plen:] = 0
    res = {}
    for pkg, Topo, Store, Net, out_fn, in_fn, conv in (
            ("jax", JaxTopo, JaxStore, JaxNet, jax_stream_out, jax_stream_in, np.asarray),
            ("port", PipelineTopo, HostMemoryStore, NetworkTransport, stream_out, stream_in,
             torch.from_numpy)):
        tp, tt = Topo(src[0], layers, src[1]), Topo(dst[0], layers, dst[1])
        stores = {i: Store(f"d{i}") for i in range(dst[0])}
        net = Net()
        for si in range(src[0]):
            lo, hi = tp.layer_range(si)
            state = {"kv": {k: conv(v[lo:hi].copy()) for k, v in full.items()}}
            out_fn(state, si, tp, tt, stores, net, mb="7", token_range=(0, plen))
        lands = []
        for di in range(dst[0]):
            lo, hi = tt.layer_range(di)
            dt = "float32" if pkg == "jax" else torch.float32
            shapes = {"kv": {k: ((hi - lo, b, s, h, d), dt) for k in ("k", "v")}}
            kw = {} if pkg == "jax" else {"device": "cpu"}
            got = in_fn(stores[di], di, tt, tp, shapes, net, mb="7", token_range=(0, plen),
                        **kw)
            lands.append({k: np.asarray(v) for k, v in got["kv"].items()})
        res[pkg] = (lands, net.bytes_total())
    (jl, jb), (tl, tb) = res["jax"], res["port"]
    assert tb == jb > 0
    for j, t in zip(jl, tl):
        for leaf in ("k", "v"):
            np.testing.assert_array_equal(t[leaf], j[leaf])


def test_scatter_sends_what_the_reference_sends():
    """One token window of a stacked leaf, packed by kv_pack, as one chunk:
    the same key, bytes and values as the reference's buffered scatter."""
    leaf = np.random.default_rng(10).standard_normal((3, 2, 32, 2, 8)).astype(np.float32)
    jstore, tstore = JaxStore("j"), HostMemoryStore("t")
    jout = jax_scatter(jnp.asarray(leaf), "kv/k", (5, 19), jstore, JaxNet(), mb=3)
    tout = scatter(torch.from_numpy(leaf), "kv/k", (5, 19), tstore, HostLinkTransport(), mb=3)
    assert tout == jout
    (key,) = tout
    np.testing.assert_array_equal(tstore.get(key).numpy(), jstore.get(key))


def test_decode_state_matches_the_reference_layout():
    for layers in (None, 3):
        mine = decode_state_shapes(TCFG, 2, 40, layers=layers)
        ref = jax_shapes(dataclasses.replace(CFG, num_layers=layers or CFG.num_layers), 2, 40)
        assert {k: v[0] for k, v in mine["kv"].items()} == \
            {k: v[0] for k, v in ref["kv"].items()}
        assert all(str(v[1]) == f"torch.{r[1]}" for v, r in zip(mine["kv"].values(),
                                                                ref["kv"].values()))
    state = init_decode_state(TCFG, 2, 40, device="cpu")
    assert not state["kv"]["k"].any()
    assert state_bytes(state) == 2 * TCFG.num_layers * 2 * 40 * TCFG.kv_dim * 4


# ---------------------------------------------------------------------------
# whole-prompt prefill on the paged path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(prefill_chunk_tokens=0), dict(fused_rounds=False)])
def test_whole_prompt_paged_prefill_matches_jax(kw, models):
    """`prefill_chunk_tokens=0`, and short prompts with fused rounds off,
    prefill each prompt in one pass through `stage_prefill`, as the
    reference's "batch" mode does."""
    jm, jp, tm, tp = models
    ref = JaxEngine(CFG, jm, jp, 2, paged=True, **kw).run_continuous(_reqs(JaxRequest))
    eng = ServingEngine(TCFG, tm, tp, 2, paged=True, device="cpu", **kw)
    rep = eng.run_continuous(_reqs(Request))
    assert rep.tokens == ref.tokens
    assert rep.pass_trace == ref.pass_trace and rep.batch_trace == ref.batch_trace
    assert rep.steps_executed == ref.steps_executed
    assert rep.pass_counts["prefill_batch"] == 4 and "prefill_chunk" not in rep.pass_counts
    assert eng.cluster.prefill_mode(0) is None
