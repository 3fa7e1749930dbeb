"""The port's moe family (`repro_torch.models.moe`, the moe branches of
`DecoderLM`) against the JAX package's.

`moe_apply` of both packages on the same numpy inputs, with the lossless
dispatch (capacity T, what serving runs) and with capacity dropping.  Then
reduced qwen3-moe-30b-a3b and moonshot-v1-16b-a3b (fp32, 2 layers, 4
experts top-2, d_ff 32), with weights made by the JAX package from a seed
and bridged: each stage function at both pipeline stages within atol 1e-4,
the reference's drop-free decode check through the port's Model API, and
reduced qwen3-moe served by both engines: `run_continuous` fused, per
sequence, over the tiers with a shared prefix, and with replication and a
worker death (greedy tokens, `pool_stats`, `tier_stats` and
`transfer_summary` equal; the failure case skips the schedule, as the
recorded deviation of the fused recovery allows), and `run()` with
microbatches of 2.  `fused_supported` and the cost model's
`fused_round_supported` give the reference's verdict for every config in
the port's registry, and the six configs this slice added equal the
reference's field for field.
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

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.core import costmodel as jax_costmodel  # noqa: E402
from repro.core.cluster import fused_supported as jax_fused_supported  # noqa: E402
from repro.core.dejavulib.transport import HardwareModel as JaxHardwareModel  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ARCHS, PAPER_ARCHS, get_arch  # noqa: E402
from repro_torch.core import costmodel  # noqa: E402
from repro_torch.core.cluster import fused_supported  # noqa: E402
from repro_torch.core.dejavulib import assert_no_leaks  # noqa: E402
from repro_torch.core.dejavulib.transport import HardwareModel  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

ATOL = 1e-4
MOE = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")
QWEN = MOE[0]
STAGES = {"first": (0, 1, True, False), "last": (1, 2, False, True)}
S = 24                                   # cache slots per sequence
# the reference's hardware model, so the tiers' modeled seconds compare
HW = HardwareModel(**dataclasses.asdict(JaxHardwareModel()))


def configs(name: str, **kw):
    """The same reduced config in both packages, at fp32 unless `kw` says
    otherwise."""
    kw = {"dtype": "float32", "num_layers": 2, **kw}
    return (dataclasses.replace(jax_get_arch(name).reduced(), **kw),
            dataclasses.replace(get_arch(name).reduced(), **kw))


_MODELS: dict = {}


def models(name: str):
    """(jax cfg, model, params, port cfg, model, params), made once: the
    JAX weights from PRNGKey(0), bridged to the port."""
    if name not in _MODELS:
        jcfg, tcfg = configs(name)
        jm = jax_build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS[name] = (jcfg, jm, jp, tcfg, DecoderLM(tcfg, device="cpu"),
                         params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODELS[name]


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("t", [1, 7, 40])
def test_moe_apply_matches_reference(t, name, drop):
    """Expert 0 favoured by every token (feature 0 and its router weight),
    so that a drop=True pass of 40 tokens fills it past its capacity and
    drops entries."""
    jcfg, tcfg = configs(name)
    rng = np.random.default_rng(t)
    d, e, ff = tcfg.d_model, tcfg.num_experts, tcfg.d_ff
    x = rng.standard_normal((t, d)).astype(np.float32)
    p = {"router": (0.5 * rng.standard_normal((d, e))).astype(np.float32),
         "w_gate": (rng.standard_normal((e, d, ff)) / 8).astype(np.float32),
         "w_up": (rng.standard_normal((e, d, ff)) / 8).astype(np.float32),
         "w_down": (rng.standard_normal((e, ff, d)) / 8).astype(np.float32)}
    x[:, 0], p["router"][0, 0] = 3.0, 1.0
    want = np.asarray(jax_moe.moe_apply(jnp.asarray(x), {k: jnp.asarray(v)
                                                         for k, v in p.items()},
                                        jcfg, drop=drop))
    got = moe.moe_apply(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                        tcfg, drop=drop)
    assert got.shape == (t, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    assert moe.capacity(t, tcfg) == jax_moe.capacity(t, jcfg)
    if drop and t == 40:
        top = torch.topk(torch.from_numpy(x) @ torch.from_numpy(p["router"]),
                         tcfg.experts_per_token).indices
        assert torch.bincount(top.reshape(-1)).max() > moe.capacity(t, tcfg)


def test_moe_init_has_the_reference_layout():
    """Same keys, shapes and types; the router stays f32 in a bf16 model."""
    jcfg, tcfg = configs(QWEN, dtype="bfloat16")
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name),
                        jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    got = DecoderLM(tcfg, device="cpu").init(torch.Generator().manual_seed(0))

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], f"{prefix}/{k}")
            else:
                yield f"{prefix}/{k}", tree[k]
    w, g = dict(leaves(want)), dict(leaves(got))
    assert w.keys() == g.keys() and "/layers/moe/router" in g and "/layers/mlp/w_up" not in g
    for k, (shape, dtype) in w.items():
        assert (tuple(g[k].shape), str(g[k].dtype)) == (shape, f"torch.{dtype}"), k


# ---------------------------------------------------------------------------
# stage functions: port against reference, both pipeline stages
# ---------------------------------------------------------------------------

# fn -> (batch, rows, pos, q_lens, token keyword)
STAGE_FNS = {
    "stage_prefill": (2, 7, None, None, "tokens"),
    "stage_prefill_chunk": (1, 5, 8, None, "tokens"),
    "stage_decode": (1, 1, 13, None, "token"),
    "stage_decode_batch": (3, 1, [3, 10, S - 1], None, "token"),
    "stage_prefill_chunk_batch": (3, 6, [0, 8, S - 4], [6, 3, 4], "tokens"),
}


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("fn", list(STAGE_FNS))
@pytest.mark.parametrize("name", MOE)
def test_stage_matches_reference(name, fn, stage):
    _, jm, jp, tcfg, tm, tp = models(name)
    b, c, pos, q_lens, tok_kw = STAGE_FNS[fn]
    lo, hi, first, last = STAGES[stage]
    jsp = jm.slice_params(jp, lo, hi, first=first, last=last)
    tsp = tm.slice_params(tp, lo, hi, first=first, last=last)
    rng = np.random.default_rng(zlib.crc32(f"{name}/{fn}/{stage}".encode()))
    hkv, dh = tcfg.num_kv_heads, tcfg.resolved_head_dim
    kc, vc = (rng.standard_normal((1, b, S, hkv, dh)).astype(np.float32) for _ in "kv")
    x = rng.standard_normal((b, c, tcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, tcfg.vocab_size, (b, c)).astype(np.int32)
    if tok_kw == "token":
        toks = toks[:, 0]
    jargs = [jsp, None if first else jnp.asarray(x)]
    targs = [tsp, None if first else torch.from_numpy(x)]
    if pos is not None:
        jargs += [jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos, jnp.int32)]
        targs += [torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()),
                  pos if isinstance(pos, int) else torch.tensor(pos, dtype=torch.int32)]
    if q_lens is not None:
        jargs.append(jnp.asarray(q_lens, jnp.int32))
        targs.append(torch.tensor(q_lens, dtype=torch.int32))
    kw = dict(first=first, last=last)
    jout = getattr(jm, fn)(*jargs, **kw, **({tok_kw: jnp.asarray(toks)} if first else {}))
    tout = getattr(tm, fn)(*targs, **kw, **({tok_kw: torch.from_numpy(toks)} if first else {}))
    for what, j, t in zip(("out", "k", "v"), jout, tout):
        assert tuple(t.shape) == tuple(j.shape), what
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL,
                                   err_msg=f"{name} {stage} {fn} {what}")


def test_moe_decode_matches_with_dropfree_capacity():
    """tests/test_arch_smoke.py:102 through the port's Model API: a prefill
    of 20 tokens and 4 decode steps give the logits of a prefill of all 24,
    and those equal the JAX model's on the bridged weights."""
    jcfg, tcfg = configs(QWEN, moe_capacity_factor=2.0)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = build_model(tcfg, device="cpu")
    params = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 24))
                           .astype(np.int32))
    ref, _, _ = model.prefill(params, {"tokens": tok}, max_len=24)
    logits, state, pos = model.prefill(params, {"tokens": tok[:, :20]}, max_len=24)
    for i in range(4):
        logits, state = model.decode_step(params, state, tok[:, 20 + i], pos)
        pos = pos + 1
    assert float((logits - ref).abs().max()) < 1e-4
    want, _, _ = jm.prefill(jp, {"tokens": jnp.asarray(tok.numpy())}, max_len=24)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# the engines: run_continuous and run() against the JAX engine's
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(0)
MIXED = [_RNG.integers(0, 256, (n,)).astype(np.int32) for n in (8, 20, 5, 17)]
_SYS = _RNG.integers(0, 256, (24,)).astype(np.int32)
SHARED = [np.concatenate([_SYS, _RNG.integers(0, 256, (8,)).astype(np.int32)])
          for _ in range(3)]

# name -> (engine kwargs, prompts, max_new, max_active, fail_at)
CASES = {
    "fused": (dict(kv_pool_blocks=64, prefill_chunk_tokens=8), MIXED, 5, 3, None),
    "per_sequence": (dict(kv_pool_blocks=64, prefill_chunk_tokens=8, fused_rounds=False),
                     MIXED, 5, 3, None),
    "tiered_shared_prefix": (dict(tiered=True, kv_pool_blocks=128, host_cache_blocks=16,
                                  ssd_cache_blocks=64), SHARED, 4, 1, None),
    "replicated_failure": (dict(kv_pool_blocks=64, replication=True), MIXED, 5, 3, {9: 1}),
}


def _serve(port: bool, case: str):
    ekw, prompts, max_new, max_active, fail_at = CASES[case]
    jcfg, jm, jp, tcfg, tm, tp = models(QWEN)
    if port:
        eng = ServingEngine(tcfg, tm, tp, 2, paged=True, hw=HW, device="cpu", **ekw)
        reqs = [Request(rid=i, prompt=p.copy(), max_new=max_new) for i, p in enumerate(prompts)]
    else:
        eng = JaxEngine(jcfg, jm, jp, 2, paged=True, **ekw)
        reqs = [JaxRequest(rid=i, prompt=p.copy(), max_new=max_new)
                for i, p in enumerate(prompts)]
    rep = eng.run_continuous(reqs, max_active=max_active, fail_at=fail_at)
    eng.cluster.streamer.drain()         # the last write-behinds land
    return eng, rep


@pytest.mark.parametrize("case", list(CASES))
def test_run_continuous_matches_jax_engine(case):
    je, jrep = _serve(False, case)
    n0 = dict(LAUNCHES)
    te, trep = _serve(True, case)
    assert LAUNCHES == n0, "the CPU run must not reach a kernel"
    assert trep.tokens == jrep.tokens
    assert all(len(t) == CASES[case][2] for t in trep.tokens.values())
    assert te.cluster.pool_stats() == je.cluster.pool_stats()
    assert trep.tier_stats == jrep.tier_stats
    assert te.transfer_summary() == je.transfer_summary()
    assert (trep.failures, trep.recoveries, trep.preemptions) == \
        (jrep.failures, jrep.recoveries, jrep.preemptions)
    if CASES[case][4]:
        assert trep.failures == trep.recoveries == 1
        assert trep.fault_trace == jrep.fault_trace
    else:
        assert (trep.batch_trace, trep.pass_trace) == (jrep.batch_trace, jrep.pass_trace)
    if case == "tiered_shared_prefix":
        assert trep.prefill_tokens_saved == jrep.prefill_tokens_saved > 0
    assert_no_leaks(te.cluster)


def test_run_with_microbatches_matches_jax_run():
    jcfg, jm, jp, tcfg, tm, tp = models(QWEN)
    prompts = np.random.default_rng(1).integers(0, 256, (4, 8)).astype(np.int32)
    je = JaxEngine(jcfg, jm, jp, 2, microbatch=2)
    jrep = je.run([JaxRequest(rid=i, prompt=p.copy(), max_new=5) for i, p in enumerate(prompts)])
    te = ServingEngine(tcfg, tm, tp, 2, microbatch=2, device="cpu")
    trep = te.run([Request(rid=i, prompt=p.copy(), max_new=5) for i, p in enumerate(prompts)])
    assert trep.tokens == jrep.tokens
    assert te.transfer_summary() == je.transfer_summary()


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "internlm2-1.8b",
                                  "smollm-360m", "yi-34b", "nemotron-4-340b"])
def test_new_configs_equal_the_reference(name):
    """Field for field, the source string included, at full size and
    reduced."""
    for t, j in ((get_arch(name), jax_get_arch(name)),
                 (get_arch(name).reduced(), jax_get_arch(name).reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert name in ARCHS


@pytest.mark.parametrize("name", sorted({**ARCHS, **PAPER_ARCHS}))
def test_fused_rounds_verdict_matches_reference(name):
    for t, j in ((get_arch(name), jax_get_arch(name)),
                 (get_arch(name).reduced(), jax_get_arch(name).reduced())):
        assert fused_supported(t) == jax_fused_supported(j)
        assert costmodel.fused_round_supported(t) == jax_costmodel.fused_round_supported(j)
    assert fused_supported(get_arch(name)) == (get_arch(name).family in ("dense", "moe"))
