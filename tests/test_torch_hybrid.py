"""The port's Hymba family (`repro_torch.models.hybrid.HybridLM`) against the
JAX package's.

Reduced hymba-1.5b (window 16, 4 meta tokens, layer 0 global) at fp32 with
the JAX weights bridged, against the reference under ``backend="xla"``: the
reference's ``backend="pallas"`` routes a windowed prefill layer to
`flash_attention` by the mask's shape and loses the window, which the port
does not copy.  Prompts of 24 tokens put 28 positions through a 20-slot ring,
so the ring wraps during prefill; decode wraps it again.  Prefill logits and
every leaf of the decode state agree within atol 1e-4, and six greedy decode
steps give the same tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread is faster, and steady on a shared host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as jax_arch  # noqa: E402
from repro.kvcache.cache import decode_state_shapes as jax_shapes  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.hybrid import _segments as jax_segments  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kvcache.cache import decode_state_shapes, init_decode_state, state_bytes  # noqa: E402,E501
from repro_torch.models import HybridLM  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.common import layer_params  # noqa: E402
from repro_torch.models.hybrid import _segments  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

ATOL = 1e-4
NAME = "hymba-1.5b"
STATE_LEAVES = ("kv_full/k", "kv_full/v", "kv_swa/k", "kv_swa/v", "swa_pos", "conv", "ssd")


def configs(dtype="float32", **kw):
    """The same reduced hymba-1.5b in both packages (window 16, 4 meta)."""
    return (dataclasses.replace(jax_arch(NAME).reduced(), dtype=dtype, **kw),
            dataclasses.replace(get_arch(NAME).reduced(), dtype=dtype, **kw))


_PAIR: dict = {}


def pair():
    if not _PAIR:
        jcfg, tcfg = configs()
        jm = jax_build(jcfg, backend="xla")
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
        _PAIR["v"] = (jm, jp, HybridLM(tcfg, device="cpu"), tp)
    return _PAIR["v"]


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def close(t, j, what, atol=ATOL):
    assert tuple(t.shape) == tuple(np.shape(j)), what
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=0,
                               atol=atol, err_msg=what)


def test_hybrid_lm_matches_reference():
    jm, jp, tm, tp = pair()
    m, w = tm.cfg.num_meta_tokens, tm.cfg.sliding_window
    s, max_len = 24, 4 + 24 + 8
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab_size, (2, s)).astype(np.int32)
    jl, js, jpos = jax.jit(jm.prefill, static_argnames="max_len")(
        jp, {"tokens": jnp.asarray(toks)}, max_len=max_len)
    tl, ts, tpos = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_len=max_len)
    assert tpos == int(jpos) == m + s and m + s > m + w    # the ring wrapped
    close(tl, jl, "prefill logits")
    for path in STATE_LEAVES:
        close(_leaf(ts, path), _leaf(js, path), f"prefill {path}")
    step = jax.jit(jm.decode_step)
    for i in range(6):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = tl.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=f"step {i}")
        jl, js = step(jp, js, jt, jpos + i)
        tl, ts = tm.decode_step(tp, ts, tt, tpos + i)
        close(tl, jl, f"decode {i} logits")
        for path in STATE_LEAVES:
            close(_leaf(ts, path), _leaf(js, path), f"decode {i} {path}")


def test_hybrid_decode_matches_full_prefill():
    """The port's own prefill + decode gives the logits of a prefill over the
    whole sequence (rel < 2e-4, as tests/test_arch_smoke.py asks of JAX)."""
    _, _, tm, tp = pair()
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, (2, 25)).astype(np.int32))
    total = 25 + tm.cfg.context_overhead
    want, _, _ = tm.prefill(tp, {"tokens": tok}, max_len=total)
    logits, state, pos = tm.prefill(tp, {"tokens": tok[:, :20]}, max_len=total)
    for i in range(5):
        logits, state = tm.decode_step(tp, state, tok[:, 20 + i], pos + i)
    rel = float((logits - want).abs().max()) / (float(want.abs().max()) + 1e-9)
    assert rel < 2e-4


def test_hybrid_decode_never_asks_for_a_row_without_a_valid_key(monkeypatch):
    """The card's decode_attention returns zeros for a row with no valid key
    where the reference averages; Hymba's decode never makes one: the meta
    slots and the new token's own slot are valid in every layer's mask."""
    _, _, tm, tp = pair()
    m = tm.cfg.num_meta_tokens
    assert m > 0
    masks = []
    real = ops.decode_attention_auto

    def spy(q, k, v, mask):
        masks.append(mask.clone())
        return real(q, k, v, mask)
    monkeypatch.setattr(ops, "decode_attention_auto", spy)
    tok = torch.zeros(2, 30, dtype=torch.int32)
    logits, state, pos = tm.prefill(tp, {"tokens": tok}, max_len=m + 40)
    for i in range(4):
        logits, state = tm.decode_step(tp, state, logits.argmax(-1).to(torch.int32), pos + i)
    assert len(masks) == 4 * tm.cfg.num_layers
    for mask in masks:
        assert mask.shape[0] == 1 and mask[0, :m].all() and int(mask.sum()) > m


def test_attention_decode_write_index_matches_reference():
    """A ring-buffer cache writes the new K/V at its slot, not at pos."""
    jm, jp, tm, tp = pair()
    cfg = tm.cfg
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((2, 20, cfg.num_kv_heads, cfg.resolved_head_dim)).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    kv_pos = np.array(list(range(4)) + list(range(20, 36)), np.int32)
    kv_pos[4 + (37 - 4) % 16] = 37
    jl = jax.tree.map(lambda a: a[1], jp["layers"]["attn"])
    tl = layer_params(tp["layers"], 1)["attn"]
    slot = 4 + (37 - 4) % 16
    jo = jattn.attention_decode(jnp.asarray(x), jl, jm.cfg, jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(kv_pos), jnp.int32(37), window=16, num_meta=4,
                                write_index=jnp.int32(slot))
    to = attn.attention_decode(torch.from_numpy(x), tl, cfg, torch.from_numpy(kc.copy()),
                               torch.from_numpy(vc.copy()), torch.from_numpy(kv_pos), 37,
                               window=16, num_meta=4, write_index=slot)
    for name, a, b in zip(("out", "k", "v"), to, jo):
        close(a, b, name)
    assert not np.allclose(to[1][:, slot].numpy(), kc[:, slot])


@pytest.mark.parametrize("layers,full", [(32, (0, 15, 31)), (3, (0,)), (5, (1, 2)), (4, ())])
def test_segments_match_reference(layers, full):
    jcfg, tcfg = configs(num_layers=layers, full_attn_layers=full)
    assert _segments(tcfg) == jax_segments(jcfg)


@pytest.mark.parametrize("seq_len", [40, 8])
def test_hybrid_decode_state_shapes_match_reference(seq_len):
    jcfg, tcfg = configs("bfloat16")
    jshape = jax_shapes(jcfg, 3, seq_len)
    mine = decode_state_shapes(tcfg, 3, seq_len)
    flat = lambda d, p="": ([(f"{p}{k}", v) for k, v in d.items() if not isinstance(v, dict)]  # noqa: E731,E501
                            + [x for k, v in d.items() if isinstance(v, dict)
                               for x in flat(v, f"{p}{k}/")])
    jf, mf = dict(flat(jshape)), dict(flat(mine))
    assert jf.keys() == mf.keys()
    for k in jf:
        assert mf[k][0] == jf[k][0] and str(mf[k][1]) == f"torch.{jf[k][1]}", k
    state = init_decode_state(tcfg, 3, seq_len, device="cpu")
    assert (state["swa_pos"] == -1).all() and not state["ssd"].any()
    assert state_bytes(state) == sum(int(np.prod(s)) * (4 if "ssd" in k or "pos" in k else 2)
                                     for k, (s, _) in mf.items())
    with pytest.raises(ValueError, match="whole model"):
        decode_state_shapes(tcfg, 3, seq_len, layers=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_bit_exactly(dtype):
    jcfg, tcfg = configs(dtype)
    jp = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(1)))
    tp = params_from_jax(tcfg, jp, device="cpu")
    names = []
    for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [k.key for k in path]
        t = tp
        for k in keys:
            t = t[k]
        assert str(t.dtype) == f"torch.{a.dtype.name}", keys     # f32 leaves stay f32
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
        names.append("/".join(keys))
    assert "meta" in names and "layers/ssm/A_log" in names and "layers/attn/wq" in names
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(dataclasses.replace(tcfg, num_layers=3), jp, device="cpu")


def test_hybrid_init_has_reference_layout():
    jcfg, tcfg = configs("bfloat16")
    jp = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(0)))
    mine = HybridLM(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    jl = {"/".join(k.key for k in p): a for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    ml = {"/".join(k.key for k in p): a
          for p, a in jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert jl.keys() == ml.keys()
    for k, a in jl.items():
        assert tuple(ml[k].shape) == a.shape and str(ml[k].dtype) == f"torch.{a.dtype.name}", k


@pytest.mark.parametrize("name", ["mamba2-780m", "hymba-1.5b"])
def test_cluster_refuses_the_families_without_a_stage_api(name):
    """ServingEngine and DejaVuCluster serve through the stage API, which
    MambaLM and HybridLM do not have (nor do the reference's)."""
    cfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32")
    model = HybridLM(cfg, device="cpu") if cfg.family == "hybrid" else None
    for kw in ({"paged": True}, {"microbatch": 2}):
        with pytest.raises(NotImplementedError, match=f"family={cfg.family}"):
            ServingEngine(cfg, model, {}, 2, device="cpu", **kw)
