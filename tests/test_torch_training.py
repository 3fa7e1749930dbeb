"""The port's training path (`repro_torch.training`, `models.losses`, the
models' `loss`, `launch.train` and `launch.serve`) against the JAX
package's, on the CPU.

Reduced configs at fp32 with weights made by the JAX package from a seed and
bridged (`params_from_jax`, which also carries the JAX gradients and AdamW
moments across: they are parameter-shaped trees).  Tolerances: the loss
within 1e-5 relative and each gradient leaf within 1e-4 * max(1, max|g|),
what differing summation orders leave of f32; five train steps' losses
within 1e-4 relative.  AdamW's first steps move a parameter by about lr *
sign(g), so a gradient entry near 0 whose sign differs between the two
packages moves it by up to 2 lr: the parameters after the steps are held
to 2 lr, and the update function alone, on identical gradients, to f32
rounding.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread is faster, and steady on a shared host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.launch.serve as jax_serve  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.losses import causal_lm_loss as jax_causal_lm_loss  # noqa: E402
from repro.training import SyntheticDataPipeline as JaxPipeline  # noqa: E402
from repro.training import adamw_init as jax_adamw_init  # noqa: E402
from repro.training import adamw_update as jax_adamw_update  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa: E402
from repro.training.optimizer import quantize_int8 as jax_quantize_int8  # noqa: E402
from repro.training.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import LAUNCHES, refuse_grad  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.losses import causal_lm_loss  # noqa: E402
from repro_torch.models.encdec import EncDecLM  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.training import (SyntheticDataPipeline, TrainConfig, adamw_init,  # noqa: E402
                                  adamw_update, global_norm, latest_step, make_train_step,
                                  restore_checkpoint, save_checkpoint)
from repro_torch.training.checkpoint import _gc  # noqa: E402
from repro_torch.training.optimizer import (AdamWState, quantize_int8, tree_leaves,  # noqa: E402
                                            tree_map)
from repro_torch.training.train import batch_to  # noqa: E402

LR = 1e-3
FAMILIES = {"gpt2-1.5b": "dense", "smollm-360m": "dense", "qwen3-moe-30b-a3b": "moe",
            "mamba2-780m": "ssm", "hymba-1.5b": "hybrid", "phi-3-vision-4.2b": "vlm",
            "seamless-m4t-large-v2": "encdec"}


def configs(name: str):
    """The same reduced fp32 config in both packages."""
    return (dataclasses.replace(jax_get_arch(name).reduced(), dtype="float32"),
            dataclasses.replace(get_arch(name).reduced(), dtype="float32"))


_MODELS: dict = {}


def models(name: str):
    """(jax cfg, model, params, port cfg, model, params), made once: the JAX
    weights from PRNGKey(0), bridged to the port."""
    if name not in _MODELS:
        jcfg, tcfg = configs(name)
        jm = jax_build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS[name] = (jcfg, jm, jp, tcfg, build_model(tcfg, device="cpu"),
                         params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODELS[name]


def _paths(tree, prefix=""):
    """Leaf paths in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def pipeline(cfg, batch=4, seq=16, seed=1):
    """The synthetic batches of `cfg`, with a vlm's patch embeddings and an
    encdec's source frames, as launch/train makes them."""
    return SyntheticDataPipeline(cfg.vocab_size, seq, batch, seed=seed, family=cfg.family,
                                 d_model=cfg.d_model, num_patches=cfg.num_patches,
                                 src_len=min(cfg.max_source_len, seq))


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def port_tree(tcfg, jtree):
    """A parameter-shaped JAX tree (params, gradients, moments) in the
    port's layout."""
    return params_from_jax(tcfg, jax.tree.map(np.asarray, jtree), device="cpu")


def port_value_and_grad(model, params, batch):
    """(loss, the gradients in `tree_leaves` order)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = model.loss(live, batch)
    return loss, torch.autograd.grad(loss, tree_leaves(live))


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_lm_loss_matches_jax(dtype):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.7).astype(np.float32)
    for m in (mask, np.zeros_like(mask)):       # an empty mask divides by 1
        want = float(jax_causal_lm_loss(jnp.asarray(logits, dtype), jnp.asarray(targets),
                                        jnp.asarray(m)))
        got = causal_lm_loss(torch.from_numpy(logits).to(getattr(torch, dtype)),
                             torch.from_numpy(targets), torch.from_numpy(m))
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.item() == pytest.approx(want, rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_loss_and_gradients_match_jax(name):
    jcfg, jm, jp, tcfg, tm, tp = models(name)
    b = pipeline(jcfg).batch_at(0)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, jax_batch(b))
    tl, tg = port_value_and_grad(tm, tp, batch_to(b, "cpu"))
    assert tl.item() == pytest.approx(float(jl), rel=1e-5)
    want = tree_leaves(port_tree(tcfg, jg))
    assert len(want) == len(tg)
    for a, b in zip(want, tg):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, a.abs().max().item())
    # every layer leaf gets a gradient, the attention projections included
    # (an encdec model stacks its encoder's and decoder's layers apart)
    stacks = [k for k in tp if k.endswith("layers")]
    n_layer_leaves = sum(len(tree_leaves(tp[k])) for k in stacks)
    layer_grads = [g for (path, g) in zip(_paths(tp), tg)
                   if path.split("/")[0] in stacks]
    assert stacks and len(layer_grads) == n_layer_leaves
    assert all(g.abs().max().item() > 0 for g in layer_grads)


def test_moe_loss_adds_the_load_balancing_loss():
    """The moe loss is the LM loss plus 0.01 times the mean over layers of
    E * sum_e f_e p_e, each layer dispatching with capacity dropping."""
    from repro.models import moe as jax_moe
    from repro_torch.models import moe
    jcfg, jm, jp, tcfg, tm, tp = models("qwen3-moe-30b-a3b")
    x = np.random.default_rng(3).standard_normal((40, tcfg.d_model)).astype(np.float32)
    lp0 = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    jout, jaux = jax_moe.moe_apply(jnp.asarray(x), lp0, jcfg, return_aux=True)
    tout, taux = moe.moe_apply(torch.from_numpy(x),
                               {k: v[0] for k, v in tp["layers"]["moe"].items()}, tcfg,
                               return_aux=True)
    assert moe.capacity(40, tcfg) < 40          # this case drops entries
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    assert taux.item() == pytest.approx(float(jaux), rel=1e-6)


# ---------------------------------------------------------------------------
# AdamW, train steps, accumulation, remat
# ---------------------------------------------------------------------------

def test_adamw_update_matches_jax_on_the_same_gradients():
    jcfg, jm, jp, tcfg, tm, tp = models("smollm-360m")
    rng = np.random.default_rng(5)
    jopt, topt = jax_adamw_init(jp), adamw_init(tp)
    jparams, tparams = jp, tp
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.3,
                         jp)
        jparams, jopt, jm_ = jax_adamw_update(jax.tree.map(jnp.asarray, g), jopt, jparams,
                                              lr=LR)
        tparams, topt, tm_ = adamw_update(port_tree(tcfg, g), topt, tparams, lr=LR)
        assert tm_["grad_norm"].item() == pytest.approx(float(jm_["grad_norm"]), rel=1e-6)
    assert int(topt.step) == int(jopt.step) == 3
    for jt, tt in ((jparams, tparams), (jopt.m, topt.m), (jopt.v, topt.v)):
        for a, b in zip(tree_leaves(port_tree(tcfg, jt)), tree_leaves(tt)):
            torch.testing.assert_close(b, a, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("name,grad_accum", [
    ("smollm-360m", 1), ("smollm-360m", 2), ("qwen3-moe-30b-a3b", 1), ("mamba2-780m", 1),
    ("hymba-1.5b", 1), ("phi-3-vision-4.2b", 1), ("seamless-m4t-large-v2", 2)])
def test_five_train_steps_match_jax(name, grad_accum):
    jcfg, jm, jp, tcfg, tm, tp = models(name)
    data = pipeline(jcfg)
    jstep = jax.jit(jax_make_train_step(jm, JaxTrainConfig(lr=LR, grad_accum=grad_accum)))
    tstep = make_train_step(tm, TrainConfig(lr=LR, grad_accum=grad_accum))
    jo, to = jax_adamw_init(jp), adamw_init(tp)
    for i in range(5):
        b = data.batch_at(i)
        jp, jo, jmet = jstep(jp, jo, jax_batch(b))
        tp, to, tmet = tstep(tp, to, batch_to(b, "cpu"))
        assert tmet["loss"].item() == pytest.approx(float(jmet["loss"]), rel=1e-4)
        assert tmet["grad_norm"].item() == pytest.approx(float(jmet["grad_norm"]), rel=1e-4)
    for a, b in zip(tree_leaves(port_tree(tcfg, jp)), tree_leaves(tp)):
        assert (a - b).abs().max().item() <= 2 * LR


def test_grad_accum_matches_full_batch():
    _, _, _, tcfg, tm, tp = models("smollm-360m")
    batch = batch_to(pipeline(tcfg, batch=8, seq=32).batch_at(0), "cpu")
    p1, _, m1 = make_train_step(tm, TrainConfig(lr=LR))(tp, adamw_init(tp), batch)
    p2, _, m2 = make_train_step(tm, TrainConfig(lr=LR, grad_accum=4))(tp, adamw_init(tp),
                                                                      batch)
    assert m1["loss"].item() == pytest.approx(m2["loss"].item(), rel=1e-5)
    assert max((a - b).abs().max().item()
               for a, b in zip(tree_leaves(p1), tree_leaves(p2))) < 5e-5


@pytest.mark.parametrize("name", ["smollm-360m", "qwen3-moe-30b-a3b", "mamba2-780m",
                                  "hymba-1.5b", "phi-3-vision-4.2b",
                                  "seamless-m4t-large-v2"])
def test_remat_matches_no_remat(name):
    _, _, _, tcfg, tm, tp = models(name)
    batch = batch_to(pipeline(tcfg).batch_at(0), "cpu")
    l1, g1 = port_value_and_grad(tm, tp, batch)
    l2, g2 = port_value_and_grad(build_model(tcfg, device="cpu", remat=True), tp, batch)
    assert l1.item() == l2.item()
    assert max((a - b).abs().max().item() for a, b in zip(g1, g2)) < 1e-5


def test_global_norm():
    tree = {"a": torch.ones(3), "b": {"c": torch.full((4,), 2.0)}}
    assert global_norm(tree).item() == pytest.approx(np.sqrt(3 + 16))


# ---------------------------------------------------------------------------
# data, checkpoints, int8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab_size=256, seq_len=32, global_batch=8, seed=1),
    dict(vocab_size=49152, seq_len=100, global_batch=6, seed=7, noise_prob=0.3,
         host_id=1, num_hosts=3),
    dict(vocab_size=300, seq_len=16, global_batch=2, seed=2, family="vlm", d_model=8,
         num_patches=4),
    dict(vocab_size=300, seq_len=16, global_batch=2, seed=2, family="encdec", d_model=8,
         src_len=5),
])
def test_data_pipeline_is_the_references_bit_for_bit(kw):
    mine, ref = SyntheticDataPipeline(**kw), JaxPipeline(**kw)
    np.testing.assert_array_equal(mine.motifs, ref.motifs)
    for step in (0, 3, 1000):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def _bf16_tree():
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 3, generator=g).to(torch.bfloat16),
              "n": {"b": torch.randn(5, generator=g)}}
    return params


def test_checkpoint_roundtrip_is_bit_exact_for_bf16_and_f32(tmp_path):
    params = _bf16_tree()
    opt = adamw_init(params)
    opt = AdamWState(opt.step + 7, tree_map(lambda t: t + 0.25, opt.m), opt.v)
    save_checkpoint(str(tmp_path), 3, {"params": params, "opt": opt})
    import json
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
    assert {leaf["path"]: leaf["dtype"] for leaf in manifest["leaves"]}["params/w"] == \
        "bfloat16"
    template = tree_map(torch.zeros_like, {"params": params})
    restored, step = restore_checkpoint(
        str(tmp_path), {"params": template["params"], "opt": adamw_init(params)})
    assert step == 3
    assert isinstance(restored["opt"], AdamWState) and int(restored["opt"].step) == 7
    for a, b in zip(tree_leaves(restored["params"]), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(tree_leaves(restored["opt"].m), tree_leaves(opt.m)):
        assert torch.equal(a, b)


def test_checkpoint_resume_continues_bit_identically(tmp_path):
    _, _, _, tcfg, tm, tp = models("smollm-360m")
    data = pipeline(tcfg)
    step_fn = make_train_step(tm, TrainConfig(lr=LR))
    params, opt = tp, adamw_init(tp)
    for i in range(3):
        params, opt, _ = step_fn(params, opt, batch_to(data.batch_at(i), "cpu"))
    save_checkpoint(str(tmp_path), 3, {"params": params, "opt": opt})
    restored, step = restore_checkpoint(str(tmp_path), {"params": tp, "opt": adamw_init(tp)})
    assert step == 3
    for a, b in zip(tree_leaves(restored["params"]), tree_leaves(params)):
        assert torch.equal(a, b)
    p1, o1, p2, o2 = params, opt, restored["params"], restored["opt"]
    for i in range(3, 6):
        b = batch_to(data.batch_at(i), "cpu")
        p1, o1, m1 = step_fn(p1, o1, b)
        p2, o2, m2 = step_fn(p2, o2, b)
        assert m1["loss"].item() == m2["loss"].item()


def test_checkpoint_atomicity_torn_save_invisible(tmp_path):
    params = _bf16_tree()
    save_checkpoint(str(tmp_path), 1, {"params": params})
    torn = tmp_path / "step_00000002.tmp"      # a torn save: no manifest
    torn.mkdir()
    (torn / "garbage.npy").write_bytes(b"xx")
    half = tmp_path / "step_00000003"          # published dir whose manifest never landed
    half.mkdir()
    assert latest_step(str(tmp_path)) == 1
    _, step = restore_checkpoint(str(tmp_path), {"params": params})
    assert step == 1
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), {"params": params})


def test_checkpoint_gc_keeps_last_k(tmp_path):
    params = {"w": torch.ones(4)}
    for s in range(1, 6):
        save_checkpoint(str(tmp_path), s, params, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]
    _gc(str(tmp_path), 1)
    assert sorted(os.listdir(tmp_path)) == ["step_00000005"]


@settings(max_examples=50, deadline=None)
@given(st.lists(st.floats(-1e3, 1e3, allow_nan=False, width=32), min_size=1, max_size=64))
def test_int8_quantization_error_bound_and_reference(xs):
    x = np.array(xs, np.float32)
    q, scale = quantize_int8(torch.from_numpy(x))
    jq, jscale = jax_quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.item() == float(jscale)
    deq = q.float() * scale
    # error per element bounded by half a quantization step
    assert (deq - torch.from_numpy(x)).abs().max().item() <= scale.item() * 0.5 + 1e-6


def test_refuse_grad_names_the_kernel():
    a = torch.ones(2, requires_grad=True)
    refuse_grad("k", torch.ones(2), None)          # nothing requires grad
    with torch.no_grad():
        refuse_grad("k", a)                        # grad mode off
    with pytest.raises(RuntimeError, match="kv_pack has no backward"):
        refuse_grad("kv_pack", torch.ones(2), a)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_launch_train_runs_then_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    args = ["--arch", "smollm-360m", "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-dir", ckpt, "--ckpt-every", "2", "--log-every", "2"]
    n0 = dict(LAUNCHES)
    port_train.main(args + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "step     4 loss=" in out and "resumed" not in out
    assert latest_step(ckpt) == 4
    port_train.main(args + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "step     6 loss=" in out
    assert "step     2 loss=" not in out
    assert latest_step(ckpt) == 6
    assert LAUNCHES == n0, "a CPU run must not reach a kernel"


@pytest.mark.parametrize("name", ["phi-3-vision-4.2b", "seamless-m4t-large-v2"])
def test_launch_train_feeds_each_familys_embeddings(name, tmp_path, capsys, monkeypatch):
    """launch.train on a vlm and an encdec config: the patch embeddings or
    source frames reach the model's loss as tensors on its device, and the
    run trains and checkpoints."""
    seen = []
    cls = DecoderLM if FAMILIES[name] == "vlm" else EncDecLM
    loss = cls.loss

    def spy(self, params, batch):
        seen.append({k: (v.device.type, str(v.dtype), tuple(v.shape)) for k, v in batch.items()})
        return loss(self, params, batch)

    monkeypatch.setattr(cls, "loss", spy)
    ckpt = str(tmp_path / "ckpt")
    port_train.main(["--arch", name, "--reduced", "--device", "cpu", "--batch", "2",
                     "--seq", "16", "--steps", "2", "--ckpt-dir", ckpt, "--log-every", "1"])
    out = capsys.readouterr().out
    assert "step     2 loss=" in out and latest_step(ckpt) == 2
    cfg = get_arch(name).reduced()
    key, shape = (("patch_embeds", (2, cfg.num_patches, cfg.d_model)) if cfg.family == "vlm"
                  else ("src_embeds", (2, 16, cfg.d_model)))
    assert len(seen) == 2 and all(b[key] == ("cpu", "torch.float32", shape) for b in seen)


def test_launch_serve_gives_the_jax_drivers_tokens(monkeypatch, capsys):
    """Both drivers with the same flags, at fp32, the port's weights the
    reference's (bridged): the same report lines and tokens."""
    fp32 = lambda get: (lambda name: dataclasses.replace(get(name), dtype="float32"))  # noqa
    flags = ["--arch", "gpt2-1.5b", "--reduced", "--workers", "2", "--requests", "3",
             "--prompt-len", "8", "--max-new", "4"]
    monkeypatch.setattr(jax_serve, "get_arch", fp32(jax_get_arch))
    monkeypatch.setattr("sys.argv", ["serve"] + flags)
    jax_serve.main()
    want = capsys.readouterr().out
    jcfg = dataclasses.replace(jax_get_arch("gpt2-1.5b").reduced(), dtype="float32",
                               num_layers=8)
    tcfg = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), dtype="float32",
                               num_layers=8)
    bridged = port_tree(tcfg, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(port_serve, "get_arch", fp32(get_arch))
    monkeypatch.setattr(DecoderLM, "init", lambda self, generator: bridged)
    port_serve.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out
    lines = lambda out: [ln for ln in out.splitlines()  # noqa: E731
                         if ln.startswith(("req ", "steps="))]
    assert lines(got) == lines(want) and len(lines(got)) == 4
