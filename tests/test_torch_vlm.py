"""The port's vlm family (phi-3-vision-4.2b through `DecoderLM`) against the
JAX package's, on the CPU.

Reduced phi-3-vision (8 patch slots) at fp32, the JAX weights from
PRNGKey(0) bridged to the port; the same numpy-seeded tokens and patch
embeddings go through both.  Tolerance: atol 1e-4 on logits and states,
what differing f32 summation orders leave; greedy tokens identical.  The
JAX side runs under ``backend="xla"`` and, where named, ``"pallas"``
(interpret mode, as tests/test_kernels.py runs it).
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
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kvcache.cache import decode_state_shapes  # noqa: E402
from repro_torch.models import DecoderLM, build_model  # noqa: E402
from repro_torch.models.common import unembed  # noqa: E402
from repro_torch.models.losses import causal_lm_loss  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

ATOL = 1e-4
NAME = "phi-3-vision-4.2b"


def configs(dtype="float32", **kw):
    """The same reduced phi-3-vision in both packages."""
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


def inputs(cfg, b=2, s=12, seed=0):
    """numpy tokens [b,s] int32 and patch embeddings [b,P,d] f32."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "patch_embeds": rng.standard_normal((b, cfg.num_patches, cfg.d_model))
            .astype(np.float32)}


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


def test_config_is_the_references():
    """Field for field, the source string included, at full size and
    reduced."""
    for t, j in ((get_arch(NAME), jax_arch(NAME)),
                 (get_arch(NAME).reduced(), jax_arch(NAME).reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert NAME in ARCHS and get_arch(NAME).source == "hf:microsoft/Phi-3-vision-128k-instruct; hf"


def test_init_has_the_reference_layout():
    jcfg, tcfg = configs("bfloat16")
    jp = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(0)))
    mine = _flat(DecoderLM(tcfg, device="cpu").init(torch.Generator().manual_seed(0)))
    jl = _flat(jp)
    assert jl.keys() == mine.keys() and "patch_proj" in mine
    for k, a in jl.items():
        assert tuple(mine[k].shape) == a.shape and str(mine[k].dtype) == f"torch.{a.dtype.name}", k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_bit_exactly_and_checks_the_layout(dtype):
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
    with pytest.raises(ValueError, match="layers.attn.wq"):
        params_from_jax(dataclasses.replace(tcfg, num_layers=3), jp, device="cpu")
    with pytest.raises(ValueError, match="patch_proj"):
        params_from_jax(tcfg, {k: v for k, v in jp.items() if k != "patch_proj"},
                        device="cpu")


@pytest.mark.parametrize("seq_len", [8, 40])
def test_decode_state_shapes_match_reference(seq_len):
    jcfg, tcfg = configs("bfloat16")
    want = jax_shapes(jcfg, 3, seq_len)
    mine = decode_state_shapes(tcfg, 3, seq_len)
    assert mine.keys() == want.keys() == {"kv"}
    for k in ("k", "v"):
        assert mine["kv"][k][0] == want["kv"][k][0]
        assert str(mine["kv"][k][1]) == f"torch.{want['kv'][k][1]}"


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_prefill_matches_jax(backend):
    """Logits and the cache over the patch slots and the prompt; the next
    position counts the patches."""
    jm, jp, tm, tp = pair(backend)
    cfg = tm.cfg
    batch = inputs(cfg)
    max_len = cfg.num_patches + 12 + 6
    jl, js, jpos = jm.prefill(jp, to_jax(batch), max_len=max_len)
    tl, ts, tpos = tm.prefill(tp, to_port(batch), max_len=max_len)
    assert tpos == int(jpos) == cfg.num_patches + 12
    close(tl, jl, "prefill logits")
    for k in ("k", "v"):
        close(ts["kv"][k], js["kv"][k], f"prefill kv {k}")


def test_greedy_decode_matches_jax():
    jm, jp, tm, tp = pair()
    cfg = tm.cfg
    batch = inputs(cfg, seed=1)
    max_len = cfg.num_patches + 12 + 6
    jl, js, jpos = jax.jit(jm.prefill, static_argnames="max_len")(jp, to_jax(batch),
                                                                   max_len=max_len)
    tl, ts, tpos = tm.prefill(tp, to_port(batch), max_len=max_len)
    step = jax.jit(jm.decode_step)
    n0 = dict(LAUNCHES)
    for i in range(5):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = tl.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=f"step {i}")
        jl, js = step(jp, js, jt, jpos + i)
        tl, ts = tm.decode_step(tp, ts, tt, tpos + i)
        close(tl, jl, f"decode {i} logits")
        for k in ("k", "v"):
            close(ts["kv"][k], js["kv"][k], f"decode {i} kv {k}")
    assert LAUNCHES == n0, "a CPU run must not reach a kernel"


def test_decode_matches_full_forward():
    """Incremental decoding with the cache gives the logits of a prefill
    over the whole sequence (rel < 2e-4, as tests/test_arch_smoke.py asks
    of the reference)."""
    _, _, tm, tp = pair()
    cfg = tm.cfg
    s, extra = 20, 5
    batch = to_port(inputs(cfg, s=s + extra, seed=2))
    total = cfg.num_patches + s + extra
    want, _, _ = tm.prefill(tp, batch, max_len=total)
    logits, state, pos = tm.prefill(tp, {"tokens": batch["tokens"][:, :s],
                                         "patch_embeds": batch["patch_embeds"]},
                                    max_len=total)
    for i in range(extra):
        logits, state = tm.decode_step(tp, state, batch["tokens"][:, s + i], pos + i)
    rel = (logits - want).abs().max().item() / want.abs().max().item()
    assert rel < 2e-4


def test_loss_ignores_the_patch_positions():
    """The loss reads the head at the text positions only: it equals the
    JAX loss, and the causal-LM loss of the last stage's logits at those
    positions; its gradient reaches patch_proj through attention."""
    jm, jp, tm, tp = pair()
    cfg = tm.cfg
    batch = inputs(cfg, s=10, seed=3)
    rng = np.random.default_rng(4)
    batch["targets"] = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    batch["loss_mask"] = (rng.random((2, 10)) < 0.8).astype(np.float32)
    want = float(jm.loss(jp, to_jax(batch)))
    tb = to_port(batch)
    live = {k: v.detach().requires_grad_() if k == "patch_proj" else v for k, v in tp.items()}
    got = tm.loss(live, tb)
    assert got.item() == pytest.approx(want, rel=1e-5)
    sp = tm.slice_params(tp, 0, cfg.num_layers, first=True, last=True)
    x, _, _ = tm.stage_prefill(sp, None, first=True, last=False, tokens=tb["tokens"],
                               patch_embeds=tb["patch_embeds"])
    assert x.shape[1] == cfg.num_patches + 10
    text = causal_lm_loss(unembed(cfg, tp, x[:, cfg.num_patches:]), tb["targets"],
                          tb["loss_mask"])
    assert got.item() == pytest.approx(text.item(), rel=1e-6)
    (g,) = torch.autograd.grad(got, [live["patch_proj"]])
    assert g.abs().max().item() > 0


def test_stages_with_patches_match_jax_stages():
    """Two pipeline stages: stage 0 embeds and prepends the patches; the
    last stage's logits and each stage's K/V equal the JAX stages'."""
    jm, jp, tm, tp = pair()
    cfg = tm.cfg
    batch = inputs(cfg, seed=5)
    tb, jb = to_port(batch), to_jax(batch)
    jsp0 = jm.slice_params(jp, 0, 1, first=True, last=False)
    jsp1 = jm.slice_params(jp, 1, 2, first=False, last=True)
    sp0 = tm.slice_params(tp, 0, 1, first=True, last=False)
    sp1 = tm.slice_params(tp, 1, 2, first=False, last=True)
    assert "patch_proj" in sp0 and "patch_proj" not in sp1
    jx, jk0, jv0 = jm.stage_prefill(jsp0, None, first=True, last=False, tokens=jb["tokens"],
                                    patch_embeds=jb["patch_embeds"])
    jl, jk1, jv1 = jm.stage_prefill(jsp1, jx, first=False, last=True)
    x, k0, v0 = tm.stage_prefill(sp0, None, first=True, last=False, tokens=tb["tokens"],
                                 patch_embeds=tb["patch_embeds"])
    tl, k1, v1 = tm.stage_prefill(sp1, x, first=False, last=True)
    for name, t, j in (("x", x, jx), ("logits", tl, jl), ("k0", k0, jk0), ("v0", v0, jv0),
                       ("k1", k1, jk1), ("v1", v1, jv1)):
        close(t, j, name)


def test_cluster_builds_off_fused_rounds_and_prefill_wants_patches():
    """As the reference's (tests/test_fused_registry.py): a vlm engine
    builds, its gate keeps it off the fused rounds, and a whole-prompt stage
    prefill without patch embeddings raises, naming the family."""
    _, _, tm, tp = pair()
    eng = ServingEngine(tm.cfg, tm, tp, 2, paged=True, kv_pool_blocks=64, device="cpu")
    assert eng.cluster.fused_ok is False
    sp = tm.slice_params(tp, 0, 1, first=True, last=False)
    with pytest.raises(ValueError, match="family=vlm"):
        tm.stage_prefill(sp, None, first=True, last=False,
                         tokens=torch.zeros((1, 4), dtype=torch.int32))
