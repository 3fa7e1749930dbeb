"""The port's Mamba-2 family (`repro_torch.models.ssm`, `mamba_lm`) and its
SSD scan against the JAX package's.

The same seeded numpy inputs go through both packages: the plain
`ssd_scan_ref` against the Pallas `ssd_scan` in interpret mode and both
against the token-by-token oracle of each package (rtol = atol = 2e-4, the
band of tests/test_kernels.py); the SSD block and the whole `MambaLM` at fp32
with the JAX weights bridged (atol 1e-4 on outputs and states, greedy tokens
identical), under both of the reference's backends.
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
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.kvcache.cache import decode_state_shapes as jax_shapes  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import LAUNCHES, ops, ref  # noqa: E402
from repro_torch.kvcache.cache import decode_state_shapes, init_decode_state, state_bytes  # noqa: E402,E501
from repro_torch.models import DecoderLM, EncDecLM, HybridLM, MambaLM, build_model  # noqa: E402,E501
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.common import layer_params  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)         # tests/test_kernels.py SSD band
ATOL = 1e-4                              # stage outputs at fp32
NAME = "mamba2-780m"


def configs(dtype="float32", **kw):
    """The same reduced mamba2-780m in both packages."""
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
        _PAIRS[backend] = (jm, jp, MambaLM(tcfg, device="cpu"), tp)
    return _PAIRS[backend]


def close(t, j, atol=ATOL, what=""):
    assert tuple(t.shape) == tuple(np.shape(j)), what
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=0,
                               atol=atol, err_msg=what)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# the SSD scan: plain version, Pallas kernel and the sequential oracles
# ---------------------------------------------------------------------------

def _ssd_inputs(b, s, nh, hd, g, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)   # noqa: E731
    x = f(b, s, nh, hd)
    dt = np.log1p(np.exp(f(b, s, nh)))                           # softplus
    a_neg = -np.exp(0.3 * f(nh))
    return x, dt, a_neg, 0.5 * f(b, s, g, n), 0.5 * f(b, s, g, n), 0.1 * f(b, nh, hd, n)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,nh,hd,g,n,ch", [
    (2, 96, 4, 16, 1, 8, 32),
    (1, 64, 8, 8, 2, 16, 16),                    # G = 2
    (2, 50, 4, 16, 1, 8, 32),                    # non-multiple of the chunk
    (1, 33, 2, 8, 1, 4, 16),
])
def test_ssd_plain_matches_pallas_and_both_oracles(b, s, nh, hd, g, n, ch, with_h0):
    x, dt, a_neg, bm, cm, h0 = _ssd_inputs(b, s, nh, hd, g, n, seed=s * 7 + nh)
    h0 = h0 if with_h0 else None
    t = [torch.from_numpy(a) for a in (x, dt, a_neg, bm, cm)]
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, hf = ref.ssd_scan_ref(*t, h0=th0, chunk=ch)
    yk, hk = jax_ssd_scan(*map(jnp.asarray, (x, dt, a_neg, bm, cm)),
                          h0=None if h0 is None else jnp.asarray(h0), chunk=ch)
    ys, hs = ref.ssd_sequential_ref(*t, h0=th0)
    yj, hj = jref.ssd_sequential_ref(x, dt, a_neg, bm, cm, h0=h0)
    for name, mine, other in (("y pallas", y, yk), ("h pallas", hf, hk),
                              ("y jax oracle", y, yj), ("h jax oracle", hf, hj),
                              ("y port oracle", y, ys.numpy()), ("h port oracle", hf, hs.numpy()),
                              ("port oracle vs jax oracle", ys, yj)):
        np.testing.assert_allclose(mine.numpy() if hasattr(mine, "numpy") else mine,
                                   np.asarray(other), **TOL, err_msg=name)
    # the CPU dispatch runs the plain version in chunks of min(chunk, S)
    yo, ho = ops.ssd_auto(*t, chunk=ch, h0=th0)
    assert torch.equal(yo, y) and torch.equal(ho, hf)


def test_ssd_dispatch_on_the_cpu_launches_nothing():
    x, dt, a_neg, bm, cm, _ = _ssd_inputs(1, 20, 2, 8, 1, 4, seed=3)
    n0 = LAUNCHES["ssd_scan"]
    ops.ssd_auto(*(torch.from_numpy(a) for a in (x, dt, a_neg, bm, cm)))
    assert LAUNCHES["ssd_scan"] == n0


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(4)
    b, nh, hd, g, n = 2, 4, 8, 2, 8
    x = rng.standard_normal((b, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, nh)))).astype(np.float32)
    a_neg = -np.exp(0.3 * rng.standard_normal(nh)).astype(np.float32)
    bm = 0.5 * rng.standard_normal((b, g, n)).astype(np.float32)
    cm = 0.5 * rng.standard_normal((b, g, n)).astype(np.float32)
    h = 0.1 * rng.standard_normal((b, nh, hd, n)).astype(np.float32)
    yj, hj = jssm.ssd_decode_step(x, dt, a_neg, bm, cm, h)
    yt, ht = ssm.ssd_decode_step(*(torch.from_numpy(a) for a in (x, dt, a_neg, bm, cm, h)))
    close(yt, yj, 1e-5, "y")
    close(ht, hj, 1e-5, "h")


# ---------------------------------------------------------------------------
# the SSD block, from scratch and resuming from a streamed-in state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resume", [False, True])
def test_ssm_prefill_and_decode_match_reference(resume):
    jm, jp, tm, tp = pair()
    cfg = tm.cfg
    jl = jax.tree.map(lambda a: a[1], jp["layers"]["ssm"])
    tl = layer_params(tp["layers"], 1)["ssm"]
    rng = np.random.default_rng(5 + resume)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    h0 = conv0 = None
    if resume:
        h0 = 0.1 * rng.standard_normal((2, cfg.ssm_nheads, cfg.ssm_head_dim,
                                        cfg.ssm_state)).astype(np.float32)
        conv0 = rng.standard_normal((2, cfg.ssm_conv - 1,
                                     cfg.d_inner + 2 * cfg.ssm_state)).astype(np.float32)
    t = lambda a: None if a is None else torch.from_numpy(a)   # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)        # noqa: E731
    jout = jssm.ssm_prefill(j(x), jl, jm.cfg, h0=j(h0), conv0=j(conv0))
    tout = ssm.ssm_prefill(t(x), tl, cfg, h0=t(h0), conv0=t(conv0))
    for name, a, b in zip(("out", "ssd", "conv"), tout, jout):
        close(a, b, what=f"prefill {name}")
    jh, jc, th, tc = jout[1], jout[2], tout[1], tout[2]
    for step in range(3):
        xs = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jo, jh, jc = jssm.ssm_decode(jnp.asarray(xs), jl, jm.cfg, jh, jc)
        to, th, tc = ssm.ssm_decode(torch.from_numpy(xs), tl, cfg, th, tc)
        for name, a, b in zip(("out", "ssd", "conv"), (to, th, tc), (jo, jh, jc)):
            close(a, b, what=f"decode {step} {name}")


# ---------------------------------------------------------------------------
# MambaLM through the Model API
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_mamba_lm_matches_reference(backend):
    """prefill logits and state within 1e-4, then six greedy decode steps
    with identical tokens, logits and states."""
    jm, jp, tm, tp = pair(backend)
    toks = np.random.default_rng(7).integers(0, tm.cfg.vocab_size, (2, 24)).astype(np.int32)
    jl, js, jpos = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, ts, tpos = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tpos == int(jpos) == 24
    close(tl, jl, what="prefill logits")
    for k in ("conv", "ssd"):
        close(ts[k], js[k], what=f"prefill {k}")
    step = jax.jit(jm.decode_step)
    for i in range(6):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = tl.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=f"step {i}")
        jl, js = step(jp, js, jt, jpos + i)
        tl, ts = tm.decode_step(tp, ts, tt, tpos + i)
        close(tl, jl, what=f"decode {i} logits")
        for k in ("conv", "ssd"):
            close(ts[k], js[k], what=f"decode {i} {k}")


def test_mamba_lm_decode_matches_full_prefill():
    """The port's own prefill + decode gives the logits of a prefill over the
    whole sequence (rel < 2e-4, as tests/test_arch_smoke.py asks of JAX)."""
    _, _, tm, tp = pair()
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, (2, 25)).astype(np.int32))
    want, _, _ = tm.prefill(tp, {"tokens": tok})
    logits, state, pos = tm.prefill(tp, {"tokens": tok[:, :20]})
    for i in range(5):
        logits, state = tm.decode_step(tp, state, tok[:, 20 + i], pos + i)
    rel = float((logits - want).abs().max()) / (float(want.abs().max()) + 1e-9)
    assert rel < 2e-4


def test_mamba_lm_init_has_reference_layout():
    """The port's seeded init gives the reference's tree: keys, shapes,
    types (A_log, dt_bias and D float32 in a bf16 model), zero norm scales."""
    jcfg, tcfg = configs("bfloat16")
    jp = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(0)))
    mine = MambaLM(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    jl, tl = dict(_leaves(jp)), dict(_leaves(mine))
    assert jl.keys() == tl.keys()
    for name, a in jl.items():
        assert tuple(tl[name].shape) == a.shape, name
        assert str(tl[name].dtype) == f"torch.{a.dtype.name}", name
    np.testing.assert_allclose(tl["/layers/ssm/A_log"].numpy(), jl["/layers/ssm/A_log"],
                               rtol=1e-6)
    assert not tl["/layers/ssm/norm_scale"].float().any() and not tl["/layers/ln/scale"].any()


# ---------------------------------------------------------------------------
# config, decode state, bridge and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mamba2-780m", "hymba-1.5b"])
def test_port_config_copies_reference(name):
    for j, t in ((jax_arch(name), get_arch(name)),
                 (jax_arch(name).reduced(), get_arch(name).reduced())):
        jd = dataclasses.asdict(j)
        assert all(jd[k] == v for k, v in dataclasses.asdict(t).items())
        for prop in ("context_overhead", "is_attention_free", "d_inner", "ssm_nheads",
                     "resolved_head_dim", "q_dim", "kv_dim"):
            assert getattr(t, prop) == getattr(j, prop), prop


def test_ssm_decode_state_shapes_match_reference():
    jcfg, tcfg = configs("bfloat16")
    jshape = jax_shapes(jcfg, 3, 40)
    mine = decode_state_shapes(tcfg, 3, 40)
    assert mine.keys() == jshape.keys()
    for k in mine:
        assert mine[k][0] == jshape[k][0] and str(mine[k][1]) == f"torch.{jshape[k][1]}", k
    state = init_decode_state(tcfg, 3, 40, device="cpu")
    # full size: 75.5 MB of f32 SSD state per mamba2-780m sequence
    full = decode_state_shapes(get_arch(NAME), 1, 0)
    assert np.prod(full["ssd"][0]) * 4 == 75_497_472
    assert state_bytes(state) == sum(int(np.prod(s)) * (4 if "ssd" in k else 2)
                                     for k, (s, _) in mine.items())


def test_mamba_lm_prefill_state_has_the_declared_layout():
    _, _, tm, tp = pair()
    toks = torch.zeros(3, 11, dtype=torch.int32)
    _, state, _ = tm.prefill(tp, {"tokens": toks})
    shapes = decode_state_shapes(tm.cfg, 3, 11)
    for k, (shape, dt) in shapes.items():
        assert tuple(state[k].shape) == shape and state[k].dtype == dt, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_bit_exactly(dtype):
    jcfg, tcfg = configs(dtype)
    jp = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(1)))
    tp = params_from_jax(tcfg, jp, device="cpu")
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for name, a in jl.items():
        t = tl[name]
        assert str(t.dtype) == f"torch.{a.dtype.name}", name       # f32 leaves stay f32
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)


def test_bridge_refuses_a_wrong_layer_count_or_family():
    jcfg, tcfg = configs()
    jp = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(dataclasses.replace(tcfg, num_layers=3), jp, device="cpu")
    with pytest.raises(ValueError, match="layers.attn"):
        params_from_jax(dataclasses.replace(tcfg, family="hybrid"), jp, device="cpu")


def test_build_model_dispatches_by_family():
    base = get_arch("gpt2-1.5b").reduced()
    assert isinstance(build_model(base, device="cpu"), DecoderLM)
    assert isinstance(build_model(get_arch(NAME).reduced(), device="cpu"), MambaLM)
    assert isinstance(build_model(get_arch("hymba-1.5b").reduced(), device="cpu"), HybridLM)
    assert isinstance(build_model(get_arch("qwen3-moe-30b-a3b").reduced(), device="cpu"),
                      DecoderLM)
    assert isinstance(build_model(get_arch("phi-3-vision-4.2b").reduced(), device="cpu"),
                      DecoderLM)
    assert isinstance(build_model(get_arch("seamless-m4t-large-v2").reduced(), device="cpu"),
                      EncDecLM)
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(base, family="rnn"), device="cpu")


def test_models_refuse_another_family_and_want_a_card_by_default():
    with pytest.raises(ValueError, match="not dense"):
        MambaLM(get_arch("gpt2-1.5b"), device="cpu")
    with pytest.raises(ValueError, match="not ssm"):
        HybridLM(get_arch(NAME), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MambaLM(get_arch(NAME))
