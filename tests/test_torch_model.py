"""The port's model (`repro_torch.models`) and weight bridge against the JAX
package's.

One set of weights, made by the JAX package from a seed and handed over by
`repro_torch.bridge.params_from_jax`, runs through each stage function of
both packages on the same inputs (numpy, seeded).  Stage outputs and K/V
caches must agree at fp32 within atol 1e-4, at both pipeline stages, for
reduced gpt2 and for variants of it that exercise the sliding window with
meta sinks, ALiBi, and RoPE with rmsnorm and SiLU.
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
from repro.models import build_model  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402

ATOL = 1e-4
VARIANTS = {
    "gpt2": {},
    "window_meta": dict(sliding_window=6, num_meta_tokens=2, full_attn_layers=(0,)),
    "alibi": dict(pos_emb="alibi"),
    "rope_rmsnorm_silu": dict(pos_emb="rope", norm="rmsnorm", activation="silu"),
}
STAGES = {"first": (0, 1, True, False), "last": (1, 2, False, True)}
S = 24                                   # cache slots per sequence


def configs(variant: str, dtype: str = "float32"):
    """The same reduced gpt2 config in both packages."""
    kw = dict(dtype=dtype, num_layers=2, **VARIANTS[variant])
    jcfg = dataclasses.replace(PAPER_ARCHS["gpt2-1.5b"].reduced(), **kw)
    tcfg = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), **kw)
    return jcfg, tcfg


_CACHE: dict = {}


def pair(variant: str):
    """(jax model, jax params, port model, port params) for a variant, made
    once per module: the JAX weights from PRNGKey(0), bridged to the port."""
    if variant not in _CACHE:
        jcfg, tcfg = configs(variant)
        jm = build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = DecoderLM(tcfg, device="cpu")
        tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
        _CACHE[variant] = (jm, jp, tm, tp)
    return _CACHE[variant]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# config and weight bridge
# ---------------------------------------------------------------------------

def test_port_config_copies_reference_fields():
    """Every field the port's ArchConfig keeps has the reference's value, at
    full size and reduced."""
    for j, t in ((PAPER_ARCHS["gpt2-1.5b"], get_arch("gpt2-1.5b")),
                 (PAPER_ARCHS["gpt2-1.5b"].reduced(), get_arch("gpt2-1.5b").reduced())):
        jd = dataclasses.asdict(j)
        for k, v in dataclasses.asdict(t).items():
            assert jd[k] == v, k
        assert (t.q_dim, t.kv_dim, t.resolved_head_dim) == (j.q_dim, j.kv_dim,
                                                            j.resolved_head_dim)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_bit_exactly(dtype):
    jcfg, tcfg = configs("gpt2", dtype)
    jp = jax.tree.map(np.asarray, build_model(jcfg).init(jax.random.PRNGKey(1)))
    tp = params_from_jax(tcfg, jp, device="cpu")
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for name, a in jl.items():
        t = tl[name]
        assert tuple(t.shape) == a.shape, name
        assert str(t.dtype) == f"torch.{a.dtype.name}", name
        if dtype == "bfloat16":       # compare the 16-bit patterns
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)


def test_bridge_refuses_another_config():
    jcfg, _ = configs("gpt2")
    jp = jax.tree.map(np.asarray, build_model(jcfg).init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(get_arch("gpt2-1.5b"), jp, device="cpu")


def test_port_init_has_reference_layout():
    """The port's own seeded init gives the reference's tree: same keys,
    shapes and types, zero norm scales (the norms multiply by 1 + scale)."""
    jm, jp, tm, _ = pair("gpt2")
    mine = tm.init(torch.Generator().manual_seed(0))
    jl, tl = dict(_leaves(jax.tree.map(np.asarray, jp))), dict(_leaves(mine))
    assert jl.keys() == tl.keys()
    for name, a in jl.items():
        assert tuple(tl[name].shape) == a.shape and tl[name].dtype == torch.float32, name
        if "ln" in name or "final_norm" in name:
            assert not tl[name].any(), name
    w = tl["/layers/attn/wq"]
    assert abs(float(w.std()) - 1 / np.sqrt(w.shape[1]) * 0.88) < 0.02  # truncated at 2 sd
    assert float(w.abs().max()) <= 2 / np.sqrt(w.shape[1]) + 1e-6


@pytest.mark.parametrize("name,kw", [
    ("layernorm", {}), ("rmsnorm", {}), ("gelu", {}), ("silu", {}), ("relu2", {})])
def test_common_blocks_match_reference(name, kw):
    from repro.models import common as jc
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    scale = 0.1 * rng.standard_normal(16).astype(np.float32)
    bias = 0.1 * rng.standard_normal(16).astype(np.float32)
    tx, ts, tb = (torch.from_numpy(a) for a in (x, scale, bias))
    if name == "layernorm":
        j, t = jc.layernorm(x, scale, bias), common.layernorm(tx, ts, tb)
    elif name == "rmsnorm":
        j, t = jc.rmsnorm(x, scale), common.rmsnorm(tx, ts)
    else:
        j, t = jc.activation_fn(name)(x), common.activation_fn(name)(tx)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


def test_rope_and_alibi_slopes_match_reference():
    from repro.models import common as jc
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(4, 13, dtype=np.int32)[None]
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jc.apply_rope(x, pos, 10000.0)), rtol=1e-5, atol=1e-5)
    for n in (4, 25, 112):
        np.testing.assert_array_equal(common.alibi_slopes(n), jc.alibi_slopes(n))


# ---------------------------------------------------------------------------
# stage functions: port against reference, both pipeline stages
# ---------------------------------------------------------------------------

def _inputs(tcfg, b: int, c: int, seed: int):
    rng = np.random.default_rng(seed)
    hkv, dh = tcfg.num_kv_heads, tcfg.resolved_head_dim
    kc = rng.standard_normal((1, b, S, hkv, dh)).astype(np.float32)
    vc = rng.standard_normal((1, b, S, hkv, dh)).astype(np.float32)
    x = rng.standard_normal((b, c, tcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, tcfg.vocab_size, (b, c)).astype(np.int32)
    return kc, vc, x, toks


def _run_both(variant, stage, fn, b, c, pos, q_lens=None, tok_kw="tokens"):
    """Run stage function `fn` of both packages on one stage's slice."""
    jm, jp, tm, tp = pair(variant)
    lo, hi, first, last = STAGES[stage]
    jsp = jm.slice_params(jp, lo, hi, first=first, last=last)
    tsp = tm.slice_params(tp, lo, hi, first=first, last=last)
    kc, vc, x, toks = _inputs(tm.cfg, b, c, seed=zlib.crc32(f"{variant}/{stage}/{fn}".encode()))
    if tok_kw == "token":
        toks = toks[:, 0]
    jargs = [jsp, None if first else jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
             jnp.asarray(pos, jnp.int32)]
    targs = [tsp, None if first else torch.from_numpy(x), torch.from_numpy(kc.copy()),
             torch.from_numpy(vc.copy()),
             pos if isinstance(pos, int) else torch.tensor(pos, dtype=torch.int32)]
    if q_lens is not None:
        jargs.append(jnp.asarray(q_lens, jnp.int32))
        targs.append(torch.tensor(q_lens, dtype=torch.int32))
    kw = dict(first=first, last=last)
    jout = getattr(jm, fn)(*jargs, **kw, **({tok_kw: jnp.asarray(toks)} if first else {}))
    tout = getattr(tm, fn)(*targs, **kw,
                           **({tok_kw: torch.from_numpy(toks)} if first else {}))
    for name, j, t in zip(("out", "k", "v"), jout, tout):
        assert tuple(t.shape) == tuple(j.shape), name
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL,
                                   err_msg=f"{variant} {stage} {fn} {name}")


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_stage_prefill_chunk_matches_reference(variant, stage):
    """One sequence's chunk of 5 tokens at position 8 over a prefix."""
    _run_both(variant, stage, "stage_prefill_chunk", b=1, c=5, pos=8)


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_stage_decode_matches_reference(variant, stage):
    """The per-sequence decode step, the port's own oracle path."""
    _run_both(variant, stage, "stage_decode", b=1, c=1, pos=13, tok_kw="token")


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_stage_decode_batch_matches_reference(variant, stage):
    """The fused decode pass: three sequences at ragged positions, one of
    them writing the last slot of the cache."""
    _run_both(variant, stage, "stage_decode_batch", b=3, c=1, pos=[3, 10, S - 1],
              tok_kw="token")


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_stage_prefill_chunk_batch_matches_reference(variant, stage):
    """The chunk-set pass: ragged chunks padded to 6 rows, one at position
    0, one mid-cache, and a short final chunk whose padded window would run
    past the cache end (the scatter backs it up and keeps the padding out)."""
    _run_both(variant, stage, "stage_prefill_chunk_batch", b=3, c=6, pos=[0, 8, S - 4],
              q_lens=[6, 3, 4])
