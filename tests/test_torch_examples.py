"""The port's five examples (`examples/*_torch.py`) and the port's import rule.

Each example runs its `main` on the CPU (``--device cpu``) through its
`run`, and every identity it prints must hold; without a card and without
``--device cpu`` it must raise `resolve_device`'s error.  Two of them are
held against the JAX package here: `quickstart_torch.run` and
`serve_disaggregated_torch.run`, at fp32 with 4 layers (one a worker), on
weights the JAX package made and `params_from_jax` bridged, must give the
JAX `ServingEngine`'s tokens and bytes by transport for the same requests.
The other three paths are held against the JAX package elsewhere:
replication, failure and migration on `run()` in
`tests/test_torch_recovery.py`, swapping on `run()` in
`tests/test_torch_microbatch.py`, and the train step, its gradients and a
resumed run in `tests/test_torch_training.py`.

The import guard parses every module of `src/repro_torch/`, the port's
examples, `chip_smoke.py` and the port's chip tools with `ast`: none may
import `jax`, `jaxlib` or the JAX package `repro` (ROADMAP, Port
conventions, "Copy, never import").
"""
import ast
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread is faster, and steady on a shared host
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.registry import PAPER_ARCHS  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("quickstart", "fault_tolerance", "microbatch_swapping", "serve_disaggregated",
            "train_smollm")


def example(name: str):
    """The module examples/<name>_torch.py."""
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ints(tokens: dict) -> dict:
    return {int(rid): [int(t) for t in toks] for rid, toks in tokens.items()}


def check_quickstart(res, cfg):
    # 6 requests in microbatches of 2: 3 microbatches of 8 steps each
    assert res["steps_executed"] == 3 * 8
    assert sorted(res["tokens"]) == list(range(6))
    for rid, toks in res["tokens"].items():
        assert len(toks) == res["max_new"][rid] == 8
        assert all(0 <= t < cfg.vocab_size for t in toks)
    assert set(res["transfer_summary"]) == {"net", "hostlink", "local"}


def check_fault_tolerance(res, cfg):
    assert (res["failures"], res["recoveries"]) == (1, 1)
    assert res["tokens_identical"] and res["migration_tokens_identical"]
    assert [ev["kind"] for ev in res["events"]] == ["failure", "recovery"]
    assert res["events"][0]["wid"] == res["events"][1]["wid"] == 2
    assert not any("t" in ev for ev in res["events"])
    assert res["transfer_summary"]["net"] > 0          # the replicas streamed


def check_microbatch_swapping(res, cfg):
    assert res["tokens_identical"]
    assert res["transfer_summary"]["hostlink"] > 0
    # swapping keeps 2 of the 4 stages' microbatch caches resident
    assert res["resident_swap_bytes"] * 2 == res["resident_all_bytes"]
    assert res["machine_mem_bytes"] == 8 * 80e9


def check_serve_disaggregated(res, cfg):
    assert res["tokens_identical"]
    assert res["transfer_summary"]["net"] > 0
    assert res["colocated_transfer_summary"]["net"] == 0
    p = res["plan"]
    assert p["d_prompt"] + p["d_token"] == 8 and p["d_prompt"] >= 1
    assert p["speedup"] == pytest.approx(p["inv_tp_colocated"] / p["inv_tp_disagg"])


def check_train_smollm(res, cfg):
    assert res["identical"] and res["loss_at_60"] == res["loss_after_resume"]
    assert res["checkpoint_step"] == res["resumed_from"] == 50
    assert [s for s, _ in res["log"]] == [20, 40, 60, 60, 80, 100, 120]
    assert res["loss_at_120"] < res["loss_at_60"] < res["log"][0][1]
    assert all(np.isfinite(x) for _, x in res["log"])


CHECKS = {"quickstart": check_quickstart, "fault_tolerance": check_fault_tolerance,
          "microbatch_swapping": check_microbatch_swapping,
          "serve_disaggregated": check_serve_disaggregated,
          "train_smollm": check_train_smollm}


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_main_on_the_cpu_holds_its_claims(name, capsys):
    mod = example(name)
    res = mod.main(["--device", "cpu"])
    CHECKS[name](res, mod.config())
    # every identity it prints reads True
    out = capsys.readouterr().out
    assert "False" not in out
    assert ("True" in out) == (name != "quickstart")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_a_card_raises_and_names_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example(name).main([])


_MODELS: dict = {}


def models():
    """(jax cfg, jax model, jax params, port cfg, port model, port params):
    reduced gpt2-1.5b at fp32, 4 layers, the JAX weights bridged; made once."""
    if not _MODELS:
        kw = dict(dtype="float32", num_layers=4)
        jcfg = dataclasses.replace(PAPER_ARCHS["gpt2-1.5b"].reduced(), **kw)
        tcfg = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), **kw)
        jm = jax_build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS["gpt2"] = (jcfg, jm, jp, tcfg, DecoderLM(tcfg, device="cpu"),
                           params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODELS["gpt2"]


def test_quickstart_gives_the_jax_engines_tokens_and_bytes():
    """`examples/quickstart.py`'s requests and engine on the JAX package."""
    jcfg, jm, jp, tcfg, tm, tp = models()
    res = example("quickstart").run(tcfg, tm, tp, "cpu")
    rng = np.random.default_rng(0)
    requests = [JaxRequest(rid=i, prompt=rng.integers(0, jcfg.vocab_size, 12).astype(np.int32),
                           max_new=8) for i in range(6)]
    engine = JaxEngine(jcfg, jm, jp, n_workers=4, microbatch=2)
    report = engine.run(requests)
    assert res["tokens"] == _ints(report.tokens)
    assert res["steps_executed"] == report.steps_executed
    assert res["transfer_summary"] == engine.transfer_summary()


def test_serve_disaggregated_gives_the_jax_engines_tokens_and_bytes():
    """`examples/serve_disaggregated.py`'s requests and both engines on the
    JAX package: the same tokens, and the same prompt-KV bytes over `net`."""
    jcfg, jm, jp, tcfg, tm, tp = models()
    res = example("serve_disaggregated").run(tcfg, tm, tp, "cpu")
    rng = np.random.default_rng(1)
    requests = [JaxRequest(rid=i, prompt=rng.integers(0, jcfg.vocab_size, 12)
                           .astype(np.int32), max_new=6) for i in range(4)]
    dis = JaxEngine(jcfg, jm, jp, 4, mode="disaggregated", dp_split=(1, 3), microbatch=2)
    rd = dis.run(requests)
    assert res["tokens"] == _ints(rd.tokens)
    assert res["transfer_summary"] == dis.transfer_summary()
    assert res["transfer_summary"]["net"] > 0


def _guarded_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted((ROOT / "examples").glob("*_torch.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "kernel_ab.py",
              ROOT / "tools" / "serve_ab.py"]
    return [str(f.relative_to(ROOT)) for f in files]


FORBIDDEN = ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _guarded_files())
def test_port_module_imports_no_jax_and_no_reference(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
