"""`chip_smoke.py` rehearsed on the CPU at a tiny size.

The script drives the port on the card; here its parity and serve phases run
with reduced widths on the CPU (both sides of the parity check on the CPU),
so their checks and bookkeeping stay exercised between chip runs.  Without a
card the script itself must exit non-zero and print no result.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread is faster, and steady on a shared host
torch.set_num_threads(1)

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(**kw):
    return dataclasses.replace(get_arch("gpt2-1.5b").reduced(), max_seq_len=2048, **kw)


def test_parity_phase_trace_preempts_and_matches(smoke):
    """The parity trace with the script's pool preempts once, and two runs
    of the port agree row for row (on the card one of them is the card)."""
    cfg = _cfg(num_layers=2, dtype="float32")
    lens = [40, 41, 42, 150, 60, 70]
    res = smoke.run_parity(cfg, lambda: smoke._requests(lens, 8, cfg.vocab_size, seed=1),
                           pool_blocks=smoke.PARITY_POOL_BLOCKS, max_active=4, card="cpu")
    cpu, other = res["cpu"]["report"], res["card"]["report"]
    assert cpu.preemptions >= 1 and other.tokens == cpu.tokens
    assert res["max_logit_diff"] == 0.0 and res["n_logit_rows"] == 6 * 8
    assert not any(res["card"]["launches"].values())


def test_serve_phase_counts_passes(smoke):
    cfg = _cfg(num_layers=4, dtype="bfloat16")
    res, eng = smoke.run_serve(cfg, "cpu", [64, 300, 77, 129], max_new=6, max_active=3,
                               pool_blocks=256, generator=torch.Generator().manual_seed(0),
                               sync=lambda: None)
    pc = res["pass_counts"]
    assert res["tokens_generated"] == 4 * 6
    assert res["decode_passes"] == pc["fused_decode"]
    assert res["chunk_passes"] == pc["chunkset"]
    # the 129-token prompt ends in a one-token chunk that runs in a chunk-set
    # pass of its own: one more pass through the one-token attention kernel
    assert pc["one_token"] == pc["fused_decode"] + 1
    assert res["median_decode_pass_ms"] > 0 and eng.cluster.fused_ok


def test_mb_parity_phase_modes_agree(smoke):
    """The microbatch parity phase at a tiny width: every run() mode and
    run_continuous give one set of tokens, and swapping and disaggregation
    really moved bytes."""
    cfg = _cfg(num_layers=2, dtype="float32")
    res = smoke.run_mb_parity(cfg, lambda: smoke._requests([8] * 4, 4, cfg.vocab_size,
                                                           seed=4), card="cpu")
    toks = res["colocated"]["tokens"]
    assert all(res[m]["tokens"] == toks for m in smoke.MB_MODES)
    assert res["run_continuous_tokens"] == toks
    assert res["swapping"]["transfer_bytes"]["hostlink"] > 0
    assert res["disaggregated"]["transfer_bytes"]["net"] > 0
    assert res["colocated"]["max_abs_logit_diff"] == 0.0


@pytest.mark.parametrize("mode", ["colocated", "swapping", "disaggregated"])
def test_mb_serve_phase_counts_passes(smoke, mode):
    cfg = _cfg(num_layers=4, dtype="bfloat16")
    model = DecoderLM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    res, eng = smoke.run_mb_serve(cfg, "cpu", model, params, 4, 24, 5, 2,
                                  smoke.MB_MODES[mode], sync=lambda: None)
    pc = res["pass_counts"]
    assert res["tokens_generated"] == 4 * 5
    assert pc["mb_prefill"] == res["prefill_passes"] == 2
    assert pc["mb_decode"] == res["decode_passes"] == 2 * 4
    want = smoke.mb_expected_launches(eng, pc)
    assert want["flash_attention"] == 4 * 2 and want["decode_attention"] == 4 * 8
    assert want["kv_pack"] == {"colocated": 0, "swapping": 2 * 2 * 8,
                               "disaggregated": 2 * 2}[mode]
    assert want["kv_unpack"] == (2 * 2 if mode == "disaggregated" else 0)
    assert (res["transfer_bytes"]["hostlink"] > 0) == (mode == "swapping")
    assert (res["transfer_bytes"]["net"] > 0) == (mode == "disaggregated")


def test_without_a_card_the_script_prints_no_result(smoke, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    assert smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_bound_is_the_larger_of_bytes_and_operations(smoke):
    ms, by = smoke.bound_ms(3.35e9, 0.0, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = smoke.bound_ms(1.0, 989e9, "bfloat16")
    assert by == "operations" and ms == pytest.approx(1.0)
