"""The port's planning layer against the JAX package's: the configs' analytic
sizes, every `costmodel` function, `plan` and `replan_after_failure`, the
round-robin schedule and the event engine, the Appendix-B simulator, and
the exporters.

Both sides get the same inputs: the three paper architectures
(`PAPER_ARCHS`: opt-66b, bloom-176b, gpt2-1.5b), the same workloads, and
the reference's `HardwareModel` and `MachineSpec`, built from its fields
(the port's defaults describe an H100 node, not the reference's).  Numbers
must agree to a relative 1e-12; the exporters' output byte for byte, on a
snapshot and a dump that the JAX engine recorded.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import registry as jax_registry  # noqa: E402
from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.base import supports_shape as jax_supports_shape  # noqa: E402
from repro.core import costmodel as jcm  # noqa: E402
from repro.core import exporters as jax_exporters  # noqa: E402
from repro.core import planner as jpl  # noqa: E402
from repro.core import schedule as jsch  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import telemetry as jax_telemetry  # noqa: E402
from repro.core import tracing as jax_tracing  # noqa: E402
from repro.core.dejavulib import faults as jax_faults  # noqa: E402
from repro.core.dejavulib.transport import HardwareModel as JaxHardwareModel  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import ARCHS, PAPER_ARCHS, SHAPES, get_arch, supports_shape  # noqa: E402
from repro_torch.core import costmodel as cm  # noqa: E402
from repro_torch.core import exporters  # noqa: E402
from repro_torch.core import planner as pl  # noqa: E402
from repro_torch.core import schedule as sch  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core.dejavulib.transport import DEFAULT_HW, HardwareModel  # noqa: E402

HW = HardwareModel(**dataclasses.asdict(JaxHardwareModel()))
JHW = JaxHardwareModel()
MACH = pl.MachineSpec(**dataclasses.asdict(jpl.MachineSpec()))
JMACH = jpl.MachineSpec()
NAMES = list(jax_registry.PAPER_ARCHS)


def close(a, b, path="") -> None:
    """`a` (the port's) equals `b` (the reference's) to a relative 1e-12:
    numbers, and the same structure around them."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        close(dataclasses.asdict(a), dataclasses.asdict(b), path)
    elif isinstance(a, dict):
        assert sorted(a, key=repr) == sorted(b, key=repr), path
        for k in a:
            close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple, np.ndarray)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, f"{path}[{i}]")
    elif isinstance(a, (float, np.floating)) or isinstance(b, (float, np.floating)):
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), path
        else:
            assert a == b or math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_paper_archs_are_the_reference_configs():
    assert list(PAPER_ARCHS) == NAMES == ["opt-66b", "bloom-176b", "gpt2-1.5b"]
    for name in NAMES:
        assert dataclasses.asdict(PAPER_ARCHS[name]) == \
            dataclasses.asdict(jax_registry.PAPER_ARCHS[name])


@pytest.mark.parametrize("name", NAMES + sorted(ARCHS))
def test_config_sizes_match(name):
    for cfg, ref in ((get_arch(name), jax_registry.get_arch(name)),
                     (get_arch(name).reduced(), jax_registry.get_arch(name).reduced())):
        assert cfg.param_count() == ref.param_count()
        assert cfg.active_param_count() == ref.active_param_count()
        for dtype_bytes in (2, 4):
            assert cfg.kv_bytes_per_token(dtype_bytes) == ref.kv_bytes_per_token(dtype_bytes)
            for n in (1, 7, 128, 2049, 32768):
                assert cfg.decode_state_bytes(n, dtype_bytes) == \
                    ref.decode_state_bytes(n, dtype_bytes)
                assert cfg.paged_state_bytes(n, dtype_bytes) == \
                    ref.paged_state_bytes(n, dtype_bytes)
        for shape in SHAPES:
            assert supports_shape(cfg, SHAPES[shape])[0] == \
                jax_supports_shape(ref, JAX_SHAPES[shape])[0]


# workloads of the grid: (prompt_len, new_tokens, microbatch)
WORKLOADS = [(p, n, b) for p in (128, 1000) for n in (50, 220) for b in (1, 16)]


def costmodel_values(m, cfg, hw, wl) -> dict:
    """Every function of cost-model module `m` on one config and workload."""
    w = m.WorkloadSpec(*wl)
    L = cfg.num_layers
    lq = -(-L // 4)
    ctx = wl[0] + wl[1]
    out = {"layer_param_bytes": m.layer_param_bytes(cfg),
           "layer_prompt_kv_bytes": m.layer_prompt_kv_bytes(cfg, w),
           "layer_token_kv_bytes": m.layer_token_kv_bytes(cfg, w),
           "prompt_kv_stream_time": m.prompt_kv_stream_time(cfg, w, hw),
           "token_kv_stream_time": m.token_kv_stream_time(cfg, w, hw),
           "fused_round_supported": m.fused_round_supported(cfg),
           "kv_block_bytes": m.kv_block_bytes(cfg)}
    for n_layers in (L, lq):
        for chips in (8, 16):
            k = f"{n_layers}x{chips}"
            out[f"stage_prompt_time/{k}"] = m.stage_prompt_time(cfg, w, n_layers, chips, hw,
                                                                0.45)
            out[f"stage_token_time/{k}"] = m.stage_token_time(cfg, w, n_layers, chips, ctx, hw,
                                                              0.6)
            out[f"swap_transfer_time/{k}"] = m.swap_transfer_time(cfg, w, n_layers, ctx, hw)
            out[f"chunked_prefill_pass_time/{k}"] = m.chunked_prefill_pass_time(
                cfg, min(64, wl[0]), wl[0], n_layers, chips, hw)
            for chunk in (0, 64, 512):
                out[f"chunked_prefill_time/{k}/{chunk}"] = m.chunked_prefill_time(
                    cfg, wl[0], chunk, n_layers, chips, hw, 0.5, start=wl[0] // 3)
                out[f"prefill_stall_time/{k}/{chunk}"] = m.prefill_stall_time(
                    cfg, w, chunk, n_layers, chips, hw)
                out[f"prefill_bubble_frac/{k}/{chunk}"] = m.prefill_bubble_frac(
                    cfg, w, chunk, n_layers, chips, ctx, hw)
            for fused in (True, False):
                out[f"decode_round_time/{k}/{fused}"] = m.decode_round_time(
                    cfg, wl[2], ctx, n_layers, chips, hw, fused=fused)
    for tier in (1, 2):
        out[f"promotion_time/{tier}"] = m.promotion_time(cfg, 37.5, tier, hw)
        out[f"write_behind_time/{tier}"] = m.write_behind_time(cfg, 12, tier, hw)
        for hit in (0.0, 0.4, 1.0):
            out[f"prefix_reuse_prefill_time/{tier}/{hit}"] = m.prefix_reuse_prefill_time(
                cfg, w, 0.25, hit, tier, hw, n_stages=3)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_costmodel_matches_on_the_grid(name):
    assert cm.DTYPE_BYTES == jcm.DTYPE_BYTES == 2
    for wl in WORKLOADS:
        close(costmodel_values(cm, PAPER_ARCHS[name], HW, wl),
              costmodel_values(jcm, jax_registry.PAPER_ARCHS[name], JHW, wl), f"{name}{wl}")


def _plans(p_mod, m_mod, cfg, hw, mach, tierspec):
    """Plans over the grid of tests/test_planner.py and its variants."""
    out = {}
    for d in range(4, 25):
        for prompt in (500, 1000, 2000):
            for new in (50, 150, 400):
                for mb in (4, 8, 16):
                    out[(d, prompt, new, mb)] = p_mod.plan(cfg, m_mod.WorkloadSpec(prompt, new, mb),
                                                           d, mach, hw)
    wl = m_mod.WorkloadSpec(1000, 220, 16)
    for d in (6, 12):
        out[("paged", d)] = p_mod.plan(cfg, wl, d, mach, hw, paged=True, kv_util=0.4)
        out[("tiers", d)] = p_mod.plan(cfg, wl, d, mach, hw, tiers=tierspec,
                                       prefix_hit_rate=0.3, prefix_src_tier=2,
                                       prefill_chunk_tokens=256)
        out[("replan", d)] = p_mod.replan_after_failure(out[("paged", d)], cfg, wl, d - 1,
                                                        mach=mach, hw=hw)
    small = type(mach)(chips=2, mem_bytes=2 * 16e9)
    out["infeasible"] = p_mod.plan(cfg, m_mod.WorkloadSpec(4000, 500, 64), 4, small, hw)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_plan_and_replan_match_on_the_grid(name):
    mine = _plans(pl, cm, PAPER_ARCHS[name], HW, MACH,
                  pl.TierSpec(host_blocks=4096, ssd_blocks=16384))
    ref = _plans(jpl, jcm, jax_registry.PAPER_ARCHS[name], JHW, JMACH,
                 jpl.TierSpec(host_blocks=4096, ssd_blocks=16384))
    assert list(mine) == list(ref)
    for k in mine:
        close(mine[k], ref[k], f"{name}{k}")
        for prop in ("speedup", "fused_round_speedup"):
            close(getattr(mine[k], prop), getattr(ref[k], prop), f"{name}{k}.{prop}")
    assert any(p.feasible for p in mine.values()) and not mine["infeasible"].feasible


def _rr_case(m, depth, njobs, seed, gate: bool):
    rng = np.random.default_rng(seed)
    p, t = 0.1 + 1.9 * rng.random(), 0.01 + 0.19 * rng.random()
    jobs = [m.Job(i, float(rng.random() * 2), int(rng.integers(1, 6))) for i in range(njobs)]
    kw = dict(do_prompt=False, token_gate={j.mb: 0.5 * j.mb for j in jobs}) if gate else {}
    tr, items = m.rr_schedule(jobs, pipeline="m", depth=depth, p_dur=p, t_dur=t,
                              max_inflight=max(1, depth - 1), **kw)
    return {"start": tr.start, "finish": tr.finish, "makespan": tr.makespan,
            "items": [(it.key, it.duration) for it in items]}


@pytest.mark.parametrize("depth", [1, 2, 3, 5])
def test_rr_schedule_matches(depth):
    for njobs in (1, 4, 8):
        for seed in (0, 3, 5):
            for gate in (False, True):
                close(_rr_case(sch, depth, njobs, seed, gate),
                      _rr_case(jsch, depth, njobs, seed, gate), f"{depth}/{njobs}/{seed}")


def _event_engine_case(m):
    eng = m.EventEngine()
    jobs = [m.Job(i, 0.3 * i, 2 + i % 3) for i in range(5)]
    m.build_pipeline_items(eng, jobs, pipeline="prompt", depth=2, p_dur=0.7, t_dur=0.0,
                           do_tokens=False, max_inflight=2)
    m.build_pipeline_items(eng, jobs, pipeline="token", depth=3, p_dur=0.0, t_dur=0.05,
                           do_prompt=False, max_inflight=3,
                           token_release={j.mb: 1.0 + j.mb for j in jobs},
                           token_extra_dep={j.mb: ("prompt", j.mb, "P", 0, 1) for j in jobs},
                           t_extra_delay=0.01)
    tr = eng.run()
    return {"start": tr.start, "finish": tr.finish, "makespan": tr.makespan}


def test_event_engine_matches():
    close(_event_engine_case(sch), _event_engine_case(jsch))


def _simulated(m, s, job, cfg, hw, mach):
    """Simulator results with cost-model module `m`, simulator `s` and the
    schedule's `Job` class `job`."""
    wl = m.WorkloadSpec(prompt_len=1000, new_tokens=150, microbatch=16)
    toks = s.lmsys_like_tokens(32, seed=0, mean_target=150)
    arr = s.poisson_arrivals(32, rate=2.0, seed=1)
    jobs = [job(i, float(arr[i]), int(toks[i])) for i in range(32)]
    out = {"tokens": toks, "arrivals": arr,
           "lmsys": s.lmsys_like_tokens(100, seed=3), "poisson": s.poisson_arrivals(50, 2.0, 1)}
    for swapping in (False, True):
        out[f"baseline/{swapping}"] = s.simulate_baseline(cfg, wl, 8, jobs, mach, hw,
                                                          swapping=swapping)
        out[f"dejavu/{swapping}"] = s.simulate_dejavu(cfg, wl, 8, jobs, mach, hw,
                                                      swapping=swapping)
    out["dp"] = s.simulate_dp(cfg, wl, 8, 2, jobs, mach, hw)
    fwl = m.WorkloadSpec(prompt_len=500, new_tokens=1000, microbatch=8)
    for dejavu in (True, False):
        out[f"failure/{dejavu}"] = s.failure_latency(cfg, fwl, 4, fail_step=500, dejavu=dejavu,
                                                     mach=mach, hw=hw)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_simulator_matches(name):
    mine = _simulated(cm, sim, sch.Job, PAPER_ARCHS[name], HW, MACH)
    ref = _simulated(jcm, jsim, jsch.Job, jax_registry.PAPER_ARCHS[name], JHW, JMACH)
    for k in ("tokens", "arrivals", "lmsys", "poisson"):
        np.testing.assert_array_equal(mine[k], ref[k])
    close({k: v for k, v in mine.items() if k not in ("tokens", "arrivals", "lmsys", "poisson")},
          {k: v for k, v in ref.items() if k not in ("tokens", "arrivals", "lmsys", "poisson")},
          name)


def test_defaults_describe_an_h100_node():
    """The port's defaults are the H100's own (the tests above pass the
    reference's figures explicitly)."""
    assert DEFAULT_HW.peak_flops == 989e12 and DEFAULT_HW.hbm_bw == 3.35e12
    assert DEFAULT_HW.chips_per_host == pl.MachineSpec().chips == 8
    assert pl.MachineSpec().mem_bytes == 8 * 80e9
    assert cm.stage_prompt_time.__defaults__[-2] is DEFAULT_HW


# ---------------------------------------------------------------------------
# exporters: byte for byte on what the JAX engine recorded
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_record():
    """A snapshot and a dump from one JAX engine run with a worker death and
    an injected streamer delay."""
    cfg = dataclasses.replace(jax_registry.PAPER_ARCHS["gpt2-1.5b"].reduced(), dtype="float32",
                              num_layers=2)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(0, 256, (3, 8)).astype(np.int32)
    reg, tracer = jax_telemetry.Telemetry(), jax_tracing.Tracer()
    prev_t, prev_r = jax_telemetry.install(reg), jax_tracing.install(tracer)
    try:
        eng = JaxEngine(cfg, model, params, 2, paged=True, kv_pool_blocks=128,
                        replication=True)
        plan = jax_faults.FaultPlan([jax_faults.FaultSpec("stream.task", nth=2, kind="delay",
                                                          delay_s=1e-3)])
        eng.run_continuous([JaxRequest(rid=i, prompt=p.copy(), max_new=4)
                            for i, p in enumerate(prompts)],
                           max_active=2, fail_at={5: 1}, fault_plan=plan)
    finally:
        jax_tracing.uninstall(prev_r)
        jax_telemetry.uninstall(prev_t)
    return reg.snapshot(), json.loads(tracer.to_json())


def test_exporters_match_byte_for_byte(reference_record):
    snap, trace = reference_record
    assert exporters.telemetry_to_prometheus(snap) == \
        jax_exporters.telemetry_to_prometheus(snap)
    for name in ("trace_to_perfetto", "trace_to_otlp"):
        mine = exporters.dumps(getattr(exporters, name)(trace))
        assert mine == jax_exporters.dumps(getattr(jax_exporters, name)(trace)), name
    assert exporters.dumps(exporters.trace_to_otlp(trace, service_name="port")) == \
        jax_exporters.dumps(jax_exporters.trace_to_otlp(trace, service_name="port"))
    with pytest.raises(ValueError):
        exporters.telemetry_to_prometheus(trace)
    with pytest.raises(ValueError):
        exporters.trace_to_perfetto(snap)
