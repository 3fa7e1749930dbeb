"""The port's encdec family (seamless-m4t-large-v2 through `EncDecLM`) against
the JAX package's, on the CPU.

Reduced seamless (2 + 2 layers, 32 source slots) at fp32, the JAX weights
from PRNGKey(0) bridged to the port; the same numpy-seeded tokens and source
frame embeddings go through both.  Tolerance: atol 1e-4 on outputs, logits
and states, what differing f32 summation orders leave; greedy tokens
identical.  The JAX side runs under ``backend="xla"`` and, where named,
``"pallas"`` (interpret mode, as tests/test_kernels.py runs it).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread is faster, and steady on a shared host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.kvcache.cache import decode_state_shapes as jax_shapes  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.core.cluster import DejaVuCluster  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kvcache.cache import decode_state_shapes, init_decode_state  # noqa: E402
from repro_torch.models import EncDecLM, build_model  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

ATOL = 1e-4
NAME = "seamless-m4t-large-v2"
SRC = 12                     # source frames of the model tests


def configs(dtype="float32", **kw):
    """The same reduced seamless in both packages."""
    return (dataclasses.replace(jax_arch(NAME).reduced(), dtype=dtype, **kw),
            dataclasses.replace(get_arch(NAME).reduced(), dtype=dtype, **kw))


_PAIRS: dict = {}


def pair(backend="xla"):
    """(jax model, jax params, port model, port params), the JAX weights
    from PRNGKey(0) bridged to the port, made once per backend."""
    if backend not in _PAIRS:
        jcfg, tcfg = configs()
        jm = jax_build(jcfg, backend=backend)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
        _PAIRS[backend] = (jm, jp, build_model(tcfg, device="cpu"), tp)
    return _PAIRS[backend]


def inputs(cfg, b=2, s=10, src=SRC, seed=0):
    """numpy tokens [b,s] int32 and source frame embeddings [b,src,d] f32."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "src_embeds": rng.standard_normal((b, src, cfg.d_model)).astype(np.float32)}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_port(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def close(t, j, what, atol=ATOL):
    assert tuple(t.shape) == tuple(np.shape(j)), what
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=0,
                               atol=atol, err_msg=what)


def _flat(tree):
    return {"/".join(k.key for k in p): a for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


STATE = ("kv/k", "kv/v", "cross/k", "cross/v")


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_config_is_the_references():
    """Field for field, the source string included, at full size and
    reduced."""
    for t, j in ((get_arch(NAME), jax_arch(NAME)),
                 (get_arch(NAME).reduced(), jax_arch(NAME).reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert NAME in ARCHS and get_arch(NAME).source == "arXiv:2308.11596; hf"


def test_init_has_the_reference_layout():
    """Encoder and decoder stacked apart; each decoder layer with lnx and
    cross; src_pos [max_source_len, d], pos_table [max_seq_len, d]."""
    jcfg, tcfg = configs("bfloat16")
    jp = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(0)))
    mine = _flat(EncDecLM(tcfg, device="cpu").init(torch.Generator().manual_seed(0)))
    jl = _flat(jp)
    assert jl.keys() == mine.keys()
    assert {"dec_layers/lnx/scale", "dec_layers/cross/wq", "enc_final/bias"} <= mine.keys()
    for k, a in jl.items():
        assert tuple(mine[k].shape) == a.shape and str(mine[k].dtype) == f"torch.{a.dtype.name}", k
    assert tuple(mine["src_pos"].shape) == (tcfg.max_source_len, tcfg.d_model)
    assert tuple(mine["pos_table"].shape) == (tcfg.max_seq_len, tcfg.d_model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_bit_exactly_and_checks_both_stacks(dtype):
    jcfg, tcfg = configs(dtype)
    jp = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(1)))
    tp = _flat(params_from_jax(tcfg, jp, device="cpu"))
    for k, a in _flat(jp).items():
        t = tp[k]
        assert str(t.dtype) == f"torch.{a.dtype.name}", k
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    with pytest.raises(ValueError, match="enc_layers.attn.wq"):
        params_from_jax(dataclasses.replace(tcfg, num_encoder_layers=3), jp, device="cpu")
    with pytest.raises(ValueError, match="dec_layers.attn.wq"):
        params_from_jax(dataclasses.replace(tcfg, num_layers=1), jp, device="cpu")
    with pytest.raises(ValueError, match="no enc_layers"):
        params_from_jax(tcfg, {k: v for k, v in jp.items() if k != "enc_layers"},
                        device="cpu")


@pytest.mark.parametrize("seq_len", [16, 48])
def test_decode_state_shapes_match_reference(seq_len):
    """The cross part holds min(max_source_len, seq_len) source slots."""
    jcfg, tcfg = configs("bfloat16")
    want = jax_shapes(jcfg, 3, seq_len)
    mine = decode_state_shapes(tcfg, 3, seq_len)
    assert mine.keys() == want.keys() == {"kv", "cross"}
    for path in STATE:
        assert _leaf(mine, path)[0] == _leaf(want, path)[0], path
        assert str(_leaf(mine, path)[1]) == f"torch.{_leaf(want, path)[1]}", path
    state = init_decode_state(tcfg, 3, seq_len, device="cpu")
    assert tuple(state["cross"]["k"].shape) == want["cross"]["k"][0]
    with pytest.raises(ValueError, match="whole model"):
        decode_state_shapes(tcfg, 3, seq_len, layers=1)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("sq", [1, 5, 20])
def test_cross_attention_matches_jax(sq, backend):
    """`cross_kv` and `cross_attention` of decoder layer 0 over 12 source
    rows: one query (decode), fewer queries than keys, and more."""
    _, jp, _, tp = pair()
    cfg = get_arch(NAME).reduced()
    rng = np.random.default_rng(sq)
    enc = rng.standard_normal((2, SRC, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, sq, cfg.d_model)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["dec_layers"]["cross"])
    tl = {k: v[0] for k, v in tp["dec_layers"]["cross"].items()}
    jk, jv = jattn.cross_kv(jnp.asarray(enc), jl, cfg)
    tk, tv = attn.cross_kv(torch.from_numpy(enc), tl, cfg)
    close(tk, jk, "cross k")
    close(tv, jv, "cross v")
    want = jattn.cross_attention(jnp.asarray(x), jl, cfg, jk, jv, backend=backend)
    got = attn.cross_attention(torch.from_numpy(x), tl, cfg, tk, tv)
    close(got, want, f"cross attention, Sq {sq}, {backend}")


def test_encode_matches_jax():
    jm, jp, tm, tp = pair()
    batch = inputs(tm.cfg)
    close(tm.encode(tp, to_port(batch)["src_embeds"]),
          jm.encode(jp, jnp.asarray(batch["src_embeds"])), "encoder output")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_prefill_matches_jax(backend):
    """Logits, the self-attention cache and the cross K/V."""
    jm, jp, tm, tp = pair(backend)
    batch = inputs(tm.cfg)
    jl, js, jpos = jm.prefill(jp, to_jax(batch), max_len=16)
    tl, ts, tpos = tm.prefill(tp, to_port(batch), max_len=16)
    assert tpos == int(jpos) == 10
    close(tl, jl, "prefill logits")
    for path in STATE:
        close(_leaf(ts, path), _leaf(js, path), f"prefill {path}")


def test_greedy_decode_matches_jax_and_keeps_the_cross_kv():
    """Five greedy steps: tokens identical, logits and the self-attention
    cache within the band; the cross K/V are read, never recomputed or
    written."""
    jm, jp, tm, tp = pair()
    batch = inputs(tm.cfg, seed=1)
    jl, js, jpos = jax.jit(jm.prefill, static_argnames="max_len")(jp, to_jax(batch),
                                                                   max_len=16)
    tl, ts, tpos = tm.prefill(tp, to_port(batch), max_len=16)
    cross = {k: v.clone() for k, v in ts["cross"].items()}
    step = jax.jit(jm.decode_step)
    n0 = dict(LAUNCHES)
    for i in range(5):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = tl.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=f"step {i}")
        jl, js = step(jp, js, jt, jpos + i)
        tl, ts = tm.decode_step(tp, ts, tt, tpos + i)
        close(tl, jl, f"decode {i} logits")
        for path in STATE:
            close(_leaf(ts, path), _leaf(js, path), f"decode {i} {path}")
    assert all(torch.equal(ts["cross"][k], cross[k]) for k in cross)
    assert LAUNCHES == n0, "a CPU run must not reach a kernel"


def test_decode_matches_full_forward():
    """Incremental decoding with the cache gives the logits of a prefill
    over the whole sequence (rel < 2e-4, as tests/test_arch_smoke.py asks
    of the reference)."""
    _, _, tm, tp = pair()
    s, extra = 20, 5
    batch = to_port(inputs(tm.cfg, s=s + extra, src=16, seed=2))
    want, _, _ = tm.prefill(tp, batch, max_len=s + extra)
    logits, state, pos = tm.prefill(tp, {"tokens": batch["tokens"][:, :s],
                                         "src_embeds": batch["src_embeds"]},
                                    max_len=s + extra)
    for i in range(extra):
        logits, state = tm.decode_step(tp, state, batch["tokens"][:, s + i], pos + i)
    rel = (logits - want).abs().max().item() / want.abs().max().item()
    assert rel < 2e-4


@pytest.mark.parametrize("kw", [{"paged": True}, {"microbatch": 2}, {}])
def test_cluster_refuses_the_family_as_the_reference_cannot_serve_it(kw):
    """EncDecLM has no stage API, nor has the reference's: the engine and
    the cluster raise a ValueError naming the family."""
    _, _, tm, tp = pair()
    with pytest.raises(ValueError, match="family=encdec"):
        ServingEngine(tm.cfg, tm, tp, 2, device="cpu", **kw)
    with pytest.raises(ValueError, match="family=encdec"):
        DejaVuCluster(tm.cfg, tm, tp, 2, device="cpu")
