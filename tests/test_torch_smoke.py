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
    # pass of its own: a one-token pass that is not a decode pass
    assert pc["one_token"] == pc["fused_decode"] + 1
    assert res["median_decode_pass_ms"] > 0 and eng.cluster.fused_ok
    # every stage reads the pages in place: the paged kernels run once per
    # layer per fused pass, the one-token chunk-set pass included, and only
    # the admissions' per-sequence first chunks gather and pack
    want = smoke.serve_expected_launches(eng, pc)
    assert want["paged_decode_attention"] == 4 * pc["fused_decode"] > 0
    assert want["paged_prefill_attention"] == 4 * pc["chunkset"] > 0
    assert want["kv_pack"] == 2 * 2 * pc["prefill_chunk"] > 0
    assert sum(want.values()) == (want["paged_decode_attention"]
                                  + want["paged_prefill_attention"] + want["kv_pack"])
    assert res["gather_dense_calls"] == {"fused": 0, "per_sequence": 2 * pc["prefill_chunk"]}


def test_parity_phase_window_meta_trace_takes_both_routes(smoke):
    """The parity phase's second trace at a tiny width: a sliding window
    with meta sinks on layer 1, so stage 0 reads the pages in place and
    stage 1 gathers them; it preempts, and two runs agree row for row."""
    kw, launched = smoke.PARITY_VARIANTS["window_meta"]
    cfg = _cfg(num_layers=2, dtype="float32", **kw)
    lens = [40, 41, 42, 150, 60, 70]
    res = smoke.run_parity(cfg, lambda: smoke._requests(lens, 8, cfg.vocab_size, seed=1),
                           pool_blocks=smoke.PARITY_POOL_BLOCKS, max_active=4, card="cpu")
    cpu, other = res["cpu"]["report"], res["card"]["report"]
    assert cpu.preemptions >= 1 and other.tokens == cpu.tokens
    assert res["max_logit_diff"] == 0.0
    assert set(launched) == set(smoke.PAGED_KERNELS + smoke.CONTINUOUS_KERNELS)


def test_parity_check_wants_exactly_the_route_kernels(smoke):
    """`check_parity` passes a run that launched exactly the kernels of its
    routes and fails one that launched fewer or others."""
    cfg = _cfg(num_layers=2, dtype="float32")
    lens = [40, 41, 42, 150, 60, 70]
    res = smoke.run_parity(cfg, lambda: smoke._requests(lens, 8, cfg.vocab_size, seed=1),
                           pool_blocks=smoke.PARITY_POOL_BLOCKS, max_active=4, card="cpu")
    _, launched = smoke.PARITY_VARIANTS["plain"]
    with pytest.raises(smoke.SmokeFailure, match="launched 0 times"):
        smoke.check_parity(res, 8, launched)         # the CPU run launches nothing
    # both sides ran on the CPU here: give the "card" side its own launches
    res["card"] = dict(res["card"], launches={k: int(k in launched)
                                              for k in res["cpu"]["launches"]})
    smoke.check_parity(res, 8, launched)
    res["card"]["launches"]["batched_decode_attention"] = 1
    with pytest.raises(smoke.SmokeFailure, match="batched_decode_attention launched 1"):
        smoke.check_parity(res, 8, launched)


def test_paged_kernel_inputs_are_a_strided_view_with_shuffled_pages(smoke):
    g = torch.Generator().manual_seed(0)
    k, v, tables = smoke.paged_inputs(g, [20, 3, 9], 2, 16, torch.float32, layers=3, layer=1)
    assert tuple(k.shape) == (3 + 1 + 2 + 4, 8, 2, 16) and not k.is_contiguous()
    assert k.stride(0) == 3 * 8 * 2 * 16 and v.stride() == k.stride()
    used = [p for row, n in zip(tables.tolist(), [3, 1, 2]) for p in row[:n]]
    assert len(set(used)) == len(used) == 6 and used != sorted(used)
    assert tables.tolist()[1][1:] == [0, 0]


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


@pytest.mark.parametrize("name", ["mamba2-780m", "hymba-1.5b"])
def test_ssm_parity_phase_agrees(smoke, name):
    """The ssm_parity phase at a tiny width (both sides on the CPU): the
    same tokens, states of one shape and size, and no kernel launched."""
    kw, n, _ = smoke.SSM_PARITY[name]
    cfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32", **kw)
    res = smoke.run_ssm_parity(cfg, n, 40, 8, "cpu")
    assert len(res["tokens"]) == n and all(len(t) == 8 for t in res["tokens"])
    assert res["max_abs_logit_diff"] == 0.0
    assert res["state_bytes"]["cpu"] == res["state_bytes"]["card"] > 0
    assert not any(res["launches"].values())
    if cfg.family == "hybrid":    # the prompts wrap the ring, as at full width
        assert cfg.num_meta_tokens + 40 > cfg.num_meta_tokens + cfg.sliding_window
        assert res["state_shapes"]["swa_pos"][0] == [cfg.num_meta_tokens + cfg.sliding_window]


@pytest.mark.parametrize("name", ["mamba2-780m", "hymba-1.5b"])
def test_ssm_serve_phase_counts_calls(smoke, name):
    cfg = dataclasses.replace(get_arch(name).reduced(), dtype="bfloat16", num_layers=3)
    from repro_torch.models import build_model
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    res = smoke.run_ssm_serve(cfg, "cpu", model, params, 4, 24, 5, 2, sync=lambda: None)
    assert res["tokens_generated"] == 2 * 4 * 5
    assert res["prefill_calls"] == 2 and res["decode_steps"] == 2 * 4
    want = smoke.ssm_expected_launches(cfg, res["prefill_calls"], res["decode_steps"])
    assert want["ssd_scan"] == 3 * 2
    assert want["decode_attention"] == (3 * 8 if cfg.family == "hybrid" else 0)
    # Hymba's one full-attention layer (layer 0) runs flash_attention per prefill
    assert want["flash_attention"] == (1 * 2 if cfg.family == "hybrid" else 0)
    assert sum(want.values()) == (want["ssd_scan"] + want["decode_attention"]
                                  + want["flash_attention"])
    assert res["state_bytes"] == 4 * res["state_bytes_per_sequence"] > 0


def test_ssd_bound_at_the_serving_shape_is_bytes(smoke):
    """mamba2-780m's prefill scan: about 8.1 GFLOP against 66 MB moved, so
    bytes bound it on the card at bf16 rates."""
    fl = smoke.ssd_flops(8, 512, 48, 64, 1, 128, 128)
    assert fl == pytest.approx(8.13e9, rel=1e-3)
    ms, by = smoke.bound_ms(65.9e6, fl, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(0.0197, rel=1e-2)
    # a ragged last chunk counts only its own rows
    assert smoke.ssd_flops(1, 200, 1, 1, 1, 1, 128) < smoke.ssd_flops(1, 256, 1, 1, 1, 1, 128)


def test_ssd_backward_bound_at_the_training_shape_is_bytes(smoke):
    """mamba2-780m's training scan, backward: about 90.8 GFLOP against the
    325 MB of the gradient's operands and results (x, dy, dx; B, C, dB,
    dC; dt, ddt; a, da) read and written once, so bytes bound it at bf16
    rates; a ragged last chunk counts only its own rows."""
    fl = smoke.ssd_bwd_flops(8, 2048, 48, 64, 1, 128, 128)
    assert fl == pytest.approx(90.77e9, rel=1e-3)
    nbytes = smoke.ssd_bwd_bytes(8, 2048, 48, 64, 1, 128, 2)
    x, bc, dt = 8 * 2048 * 48 * 64, 8 * 2048 * 128, 8 * 2048 * 48
    assert nbytes == 2 * (3 * x + 4 * bc) + 4 * (2 * dt + 2 * 48) == 325_058_944
    # h0, dh0 and dh_final, when given, are f32 [B, nh, hd, N] each
    assert (smoke.ssd_bwd_bytes(8, 2048, 48, 64, 1, 128, 2, True, True)
            == nbytes + 3 * 4 * 8 * 48 * 64 * 128)
    ms, by = smoke.bound_ms(nbytes, fl, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(0.0970, rel=1e-3)
    assert (smoke.ssd_bwd_flops(1, 200, 2, 8, 1, 4, 128)
            < smoke.ssd_bwd_flops(1, 256, 2, 8, 1, 4, 128))


@pytest.mark.parametrize("name,attn,ssd", [
    ("smollm-360m", 2, 0), ("qwen3-moe-30b-a3b", 2, 0), ("mamba2-780m", 0, 2),
    ("hymba-1.5b", 1, 2),                        # reduced Hymba: one global layer of two
    ("phi-3-vision-4.2b", 2, 0)])
def test_train_launches_follow_the_family(name, attn, ssd):
    from repro_torch.kernels import train_launches
    cfg = get_arch(name).reduced()
    assert train_launches(cfg, 3) == {
        "flash_attention": 3 * attn, "flash_attention_bwd": 3 * attn,
        "ssd_scan": 3 * ssd, "ssd_scan_bwd": 3 * ssd}
    assert train_launches(cfg, 3, remat=True) == {
        "flash_attention": 6 * attn, "flash_attention_bwd": 3 * attn,
        "ssd_scan": 6 * ssd, "ssd_scan_bwd": 3 * ssd}


def test_recover_phase_points_and_counts(smoke):
    """The recover phase at a tiny width: its three failure points exist in
    serve's trace, each run recovers once to the failure-free tokens, and a
    decode pass that a failure cut short adds the first stage's layers to
    the launches the passes imply."""
    import numpy as np
    cfg = _cfg(num_layers=4, dtype="float32")
    model = DecoderLM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    lens = [int(n) for n in np.random.default_rng(2).integers(64, 513, 16)]

    def trace():
        return smoke._requests(lens, 32, cfg.vocab_size, seed=3)

    clean = smoke.run_fused(cfg, model, params, trace, replication=True, record=True,
                            dev="cpu")
    points = smoke.fail_points(clean.pop("steps"))
    assert list(points) == ["fail_decode_w1", "fail_prefill_w0", "fail_inflight_w1"]
    assert [w for p in points.values() for w in p.values()] == [1, 0, 1]
    assert clean["transfer_bytes"]["net"] > 0 and clean["failures"] == 0
    for name, fail_at in points.items():
        res = smoke.run_fused(cfg, model, params, trace, replication=True,
                              fail_at=fail_at, dev="cpu")
        assert (res["failures"], res["recoveries"]) == (1, 1), name
        assert smoke.differing_tokens(res["tokens"], clean["tokens"]) == 0, name
        tag = res["fault_trace"][0]["tag"]
        assert tag.startswith("r" if name == "fail_prefill_w0" else "decode-"), tag
        rec = res["recovery"]
        assert rec["first_token_ms"] >= rec["rebuild_ms"] + rec["replica_ms"]


@pytest.mark.parametrize("mode", ["colocated", "swapping", "disaggregated"])
def test_mb_recover_phase_counts(smoke, mode):
    """The mb_recover phase at a tiny width: the failure lands where the
    script says (a decode step, or a prompt worker before a later prefill),
    recovery regenerates the failure-free tokens, and the launch count adds
    one kv_pack per leaf per token stage per pass and per re-replicated
    microbatch."""
    cfg = _cfg(num_layers=4, dtype="float32")
    model = DecoderLM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    _, fail_at = smoke.MB_RECOVER[mode]
    clean = smoke.run_mb_recover(cfg, model, params, mode, dev="cpu", plen=16)
    res = smoke.run_mb_recover(cfg, model, params, mode, fail_at, dev="cpu", plen=16)
    assert (res["failures"], res["recoveries"]) == (1, 1)
    assert res["tokens"] == clean["tokens"]
    pc = res["pass_counts"]
    assert pc["mb_prefill"] == 4 and pc["mb_decode"] == 4 * 31
    assert res["fault_trace"][0]["n"] == next(iter(fail_at))
    n_token = 2 if mode == "disaggregated" else 4
    replicated = 2 * n_token * (pc["mb_prefill"] + pc["mb_decode"])
    # colocated: all 4 microbatches in flight roll back; a prompt worker's
    # recovery rolls back nothing
    assert res["resumed"] == (0 if mode == "disaggregated" else 4)
    extra = {"colocated": 2 * 4,                       # re-replication
             "swapping": 2 * 4 + 2 * 4 * pc["mb_decode"],   # and the swap deltas
             "disaggregated": 2 * 2 * pc["mb_prefill"]}[mode]  # the prompt KV stream
    want = res["expected_launches"]
    assert want["kv_pack"] == replicated + extra
    assert want["flash_attention"] == 4 * pc["mb_prefill"]
    # a token worker dies before a decode step: the stages before it ran
    dead_lo = {"colocated": 2, "swapping": 1, "disaggregated": 0}[mode]
    assert want["decode_attention"] == 4 * pc["mb_decode"] + dead_lo


def test_telemetry_phase_rehearsed(smoke):
    """The telemetry phase at a tiny width on serve's trace: every
    instrumented run gives the same snapshot and dump (checked inside), all
    modes the same tokens, each pass kind a modeled time (an 8-GPU stage,
    and one card: 8 times the compute-bound prefill passes) and a measured
    time, the counted instrument calls a cost, and the run that loses worker 1 a
    modeled recovery time."""
    import numpy as np
    cfg = _cfg(num_layers=2, dtype="float32")
    lens = [int(n) for n in np.random.default_rng(2).integers(64, 513, 16)]
    out = smoke.run_telemetry(cfg, "cpu", lens, torch.Generator().manual_seed(0),
                              lambda: None, pool_blocks=512)
    assert out["identical_snapshots_and_dumps"]
    assert sorted(out["tokens_per_s_in_turns"]) == sorted(smoke.TELEMETRY_MODES)
    assert all(len(v) == smoke.TELEMETRY_ROUNDS for v in out["tokens_per_s_in_turns"].values())
    rows = out["pass_times_modeled_vs_measured"]
    assert sorted(rows) == sorted(smoke.PASS_METHODS)
    assert all(r["passes"] > 0 and r["modeled_ms_one_h100"] > r["modeled_ms"] > 0
               for r in rows.values())
    for kind in ("chunkset", "prefill_chunk"):
        assert rows[kind]["modeled_ms_one_h100"] == pytest.approx(8 * rows[kind]["modeled_ms"],
                                                                  rel=1e-9)
    cost = out["instrument_cost"]
    assert cost["calls_per_run"]["Tracer.span"] == cost["calls_per_run"]["Telemetry.span"] > 0
    assert 0 < cost["estimated_s_per_run"] < cost["run_wall_s"]
    slo = out["recover_run"]["modeled_h100_datasheet_slo"]
    assert slo["cluster.recovery_s"]["count"] == 1
    assert slo["engine.ttft_s"]["count"] == len(lens)


def test_paged_modes_phase_rehearsed(smoke, tmp_path, monkeypatch):
    """(a)-(d) of the paged_modes phase at a tiny width: the serve trace
    swapped and disaggregated, the shared-prefix trace at the script's pool
    and host tier (a preemption through the tiers, a spill, adoptions from
    both tiers: the trace's geometry, not the width, decides them), and a
    failure while a sequence is swapped out; then the exact gate's runs,
    every one giving the plain run's tokens."""
    import tempfile

    import numpy as np
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cfg = _cfg(num_layers=2, dtype="float32")
    model = DecoderLM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    lens = [int(n) for n in np.random.default_rng(2).integers(64, 513, 16)]

    def serve_trace():
        return smoke._requests(lens, 32, cfg.vocab_size, seed=3)

    def tiered_trace():
        return smoke.shared_prefix_trace(cfg.vocab_size)

    out = smoke.paged_modes_runs(cfg, model, params, "cpu", serve_trace, tiered_trace)
    for mode in ("swapping", "disaggregated"):
        assert out[mode]["differing_tokens"] == 0       # fp32: the colocated tokens
    assert out["swapping"]["transfer_bytes"]["hostlink"] > 0
    assert out["disaggregated"]["transfer_bytes"]["net"] > 0
    tv = out["tiered_vs_not"]
    assert tv["differing_tokens"] == 0 and tv["prefill_saved_share"] > 0.3
    ad = tv["tiered"]["adoptions_from"]
    assert ad["host_blocks"] > 0 and ad["ssd_blocks"] > 0
    assert tv["tiered"]["transfer_bytes"]["ssd"] > 0
    fail = out["tiered_failure"]
    assert fail["differing_tokens"] == 0
    rec = fail["failure"]["recovery"]
    assert rec["reattach_ms"] >= 0.0 and rec["first_token_ms"] > 0.0
    assert not list(tmp_path.iterdir())          # every tier's disk was removed
    exact = smoke.exact_paged_modes(cfg, serve_trace, tiered_trace, devs=("cpu",))
    assert exact["tokens_identical"] and exact["fail_at"]


def test_moe_phase_rehearsed(smoke):
    """The moe phase at a tiny width (reduced qwen3-moe, 4 experts top 2):
    serve's trace through fused rounds with the launches the passes imply,
    then the exact runs (fused, per sequence, replicated, a worker lost),
    every one giving the fused run's tokens."""
    import numpy as np
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").reduced(), max_seq_len=2048,
                              dtype="float32")
    lens = [int(n) for n in np.random.default_rng(2).integers(64, 513, 6)]
    res, eng = smoke.run_serve(cfg, "cpu", lens, max_new=6, max_active=3, pool_blocks=256,
                               generator=torch.Generator().manual_seed(0),
                               sync=lambda: None)
    assert res["tokens_generated"] == 6 * 6 and res["chunk_passes"] > 0
    assert "moe" in eng.cluster.workers()[0].sp["layers"]
    exact = smoke.moe_exact(cfg, lambda: smoke._requests([16, 40, 23, 31], 8, cfg.vocab_size,
                                                         seed=6), devs=("cpu",))
    assert exact["tokens_identical"] and exact["fail_at"]
    assert exact["runs"] == ["fused", "per_sequence", "replicated", "failure"]


def test_wide_heads_phase_rehearsed(smoke):
    """The wide_heads phase at a tiny width with nemotron's head dim of 192
    (reduced nemotron-4-340b: relu2, layernorm): both serving paths with
    their launch counts, then the exact runs on both paths."""
    cfg = dataclasses.replace(get_arch("nemotron-4-340b").reduced(), max_seq_len=2048,
                              head_dim=192, dtype="float32")
    model = DecoderLM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    out = smoke.wide_heads_runs(cfg, model, params, "cpu", [64, 200, 77, 129],
                                sync=lambda: None)
    a, b = out["run_continuous"], out["run"]
    assert a["tokens_generated"] == 4 * 16 and a["chunk_passes"] > 0
    assert b["tokens_generated"] == 4 * 16 and b["prefill_passes"] == 2
    exact = smoke.wide_heads_exact(cfg, [16, 40, 23, 31], devs=("cpu",))
    assert exact["tokens_identical"]


@pytest.mark.parametrize("name", ["phi-3-vision-4.2b", "seamless-m4t-large-v2"])
def test_mm_models_phase_rehearsed(smoke, name):
    """The mm_models phase at a tiny width: (a)'s exact run (both sides on
    the CPU: logits, state, tokens), and (b)'s serving run with the launches
    its calls imply and the decode step's bytes."""
    cfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32")
    exact = smoke.mm_exact(cfg, devs=("cpu", "cpu"))
    assert exact["tokens_identical"] and exact["max_abs_prefill_diff"] == 0.0
    assert len(exact["tokens"]) == 2 and all(len(t) == 8 for t in exact["tokens"])
    from repro_torch.models import build_model
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    src = 12 if cfg.family == "encdec" else 0
    res = smoke.mm_serve(cfg, "cpu", model, params, 3, 20, src, 5, 2, sync=lambda: None)
    assert res["tokens_generated"] == 2 * 3 * 5
    assert res["prefill_calls"] == 2 and res["decode_steps"] == 2 * 4
    want = smoke.mm_expected_launches(cfg, 2, 8)
    n = cfg.num_layers
    assert want["decode_attention"] == n * 8
    assert want["flash_attention"] == ((2 + 2 * n) * 2 + n * 8 if cfg.family == "encdec"
                                       else n * 2)
    assert sum(want.values()) == want["flash_attention"] + want["decode_attention"]
    # a decode step reads the decoder's weights and head, not the embedding
    weights, cache = smoke.decode_bytes(cfg, params, 3, 10)
    head = params["lm_head"].numel() * 4
    assert head < weights < sum(t.numel() * 4 for t in smoke._leaves(params)) - head
    assert cache == cfg.num_layers * 3 * cfg.kv_dim * 2 * 4 * 11


def test_train_launches_of_the_encdec_family():
    """seamless: flash and its backward for each encoder layer and each
    decoder layer's self- and cross-attention; remat reruns the decoder's
    forward alone, as the reference's jax.checkpoint does."""
    from repro_torch.kernels import train_launches
    cfg = get_arch("seamless-m4t-large-v2").reduced()      # 2 encoder, 2 decoder layers
    assert train_launches(cfg, 3) == {"flash_attention": 3 * 6, "flash_attention_bwd": 3 * 6,
                                      "ssd_scan": 0, "ssd_scan_bwd": 0}
    assert train_launches(cfg, 3, remat=True)["flash_attention"] == 3 * (2 + 2 * 4)
