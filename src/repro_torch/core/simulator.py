"""Cluster simulator for the planner studies (paper Appendix B) and the
failure experiments (Figs. 14–15); the port's copy of `repro.core.simulator`.

Three serving policies, matching the paper exactly:
  Baseline      — one TP+PP pipeline of depth D; every stage does P and T
  Baseline-DP   — d independent pipelines of depth D/d (round-robin jobs)
  DéjàVu        — disaggregated: prompt pipeline depth D_p + token pipeline
                  depth D_t, prompt KV streamed P→T (overlap-adjusted)

The generated-token distribution follows an LMSys-like long-tailed lognormal
(the real dataset is not redistributable offline; parameters are matched to
its published summary stats, as in the JAX package's
benchmarks/planner_study.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core import costmodel as cm
from repro_torch.core.dejavulib.transport import DEFAULT_HW, HardwareModel
from repro_torch.core.planner import MachineSpec, Plan, plan
from repro_torch.core.schedule import Job, rr_schedule


def lmsys_like_tokens(n: int, seed: int = 0, mean_target: float = 220.0,
                      sigma: float = 1.1, max_tokens: int = 1024) -> np.ndarray:
    """Long-tailed generated-token counts (deterministic given seed)."""
    rng = np.random.default_rng(seed)
    mu = np.log(mean_target) - sigma ** 2 / 2
    x = rng.lognormal(mu, sigma, size=n)
    return np.clip(x, 8, max_tokens).astype(int)


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    gaps = rng.exponential(1.0 / rate, size=n)
    return np.cumsum(gaps)


@dataclass
class SimResult:
    makespan: float
    per_mb_finish: dict
    normalized_latency: float       # median s/token over microbatches
    policy: str

    def cost(self, n_machines: int, hourly: float = 1.0) -> float:
        return self.makespan / 3600.0 * n_machines * hourly


def _norm_latency(trace, jobs, pipeline: str, depth: int, arrivals) -> float:
    vals = []
    for job in jobs:
        key = (pipeline, job.mb, "T", job.n_tokens - 1, depth - 1)
        if key in trace.finish:
            lat = trace.finish[key] - arrivals[job.mb]
            vals.append(lat / job.n_tokens)
    return float(np.median(vals)) if vals else float("nan")


def simulate_baseline(cfg: ArchConfig, wl: cm.WorkloadSpec, d: int,
                      jobs: List[Job], mach: MachineSpec = MachineSpec(),
                      hw: HardwareModel = DEFAULT_HW, mfu=0.5, beff=0.7,
                      swapping: bool = False) -> SimResult:
    lps = -(-cfg.num_layers // d)  # layers per stage
    ctx = wl.prompt_len + wl.new_tokens
    y_s = cm.stage_prompt_time(cfg, wl, lps, mach.chips, hw, mfu)
    t_s = cm.stage_token_time(cfg, wl, lps, mach.chips, ctx, hw, beff)
    if swapping:
        t_s = max(t_s, cm.swap_transfer_time(cfg, wl, lps, ctx, hw))
    tr, _ = rr_schedule(jobs, pipeline="main", depth=d, p_dur=y_s, t_dur=t_s)
    arrivals = {j.mb: j.arrival for j in jobs}
    return SimResult(tr.makespan, dict(tr.finish),
                     _norm_latency(tr, jobs, "main", d, arrivals), "baseline")


def simulate_dp(cfg: ArchConfig, wl: cm.WorkloadSpec, d: int, n_pipelines: int,
                jobs: List[Job], mach: MachineSpec = MachineSpec(),
                hw: HardwareModel = DEFAULT_HW, mfu=0.5, beff=0.7) -> SimResult:
    depth = d // n_pipelines
    assert depth >= 1
    lps = -(-cfg.num_layers // depth)
    ctx = wl.prompt_len + wl.new_tokens
    y_s = cm.stage_prompt_time(cfg, wl, lps, mach.chips, hw, mfu)
    t_s = cm.stage_token_time(cfg, wl, lps, mach.chips, ctx, hw, beff)
    buckets: List[List[Job]] = [[] for _ in range(n_pipelines)]
    for i, j in enumerate(jobs):
        buckets[i % n_pipelines].append(j)
    makespan, vals, finishes = 0.0, [], {}
    arrivals = {j.mb: j.arrival for j in jobs}
    for pi, bucket in enumerate(buckets):
        tr, _ = rr_schedule(bucket, pipeline=f"dp{pi}", depth=depth,
                            p_dur=y_s, t_dur=t_s)
        makespan = max(makespan, tr.makespan)
        finishes.update(tr.finish)
        for job in bucket:
            key = (f"dp{pi}", job.mb, "T", job.n_tokens - 1, depth - 1)
            if key in tr.finish:
                vals.append((tr.finish[key] - arrivals[job.mb]) / job.n_tokens)
    return SimResult(makespan, finishes,
                     float(np.median(vals)) if vals else float("nan"), "baseline-dp")


def simulate_dejavu(cfg: ArchConfig, wl: cm.WorkloadSpec, d: int, jobs: List[Job],
                    mach: MachineSpec = MachineSpec(),
                    hw: HardwareModel = DEFAULT_HW, mfu=0.5, beff=0.7,
                    the_plan: Optional[Plan] = None,
                    swapping: bool = False) -> SimResult:
    p = the_plan or plan(cfg, wl, d, mach, hw, mfu, beff)
    if not p.feasible:
        return SimResult(float("inf"), {}, float("inf"), "dejavu")
    dp, dt = p.d_prompt, p.d_token
    ctx = wl.prompt_len + wl.new_tokens
    lp_p = -(-cfg.num_layers // dp)
    lp_t = -(-cfg.num_layers // dt)
    y_s = cm.stage_prompt_time(cfg, wl, lp_p, mach.chips, hw, mfu)
    t_s = cm.stage_token_time(cfg, wl, lp_t, mach.chips, ctx, hw, beff)
    if swapping:
        t_s = max(t_s, cm.swap_transfer_time(cfg, wl, lp_t, ctx, hw))
    stream = cm.prompt_kv_stream_time(cfg, wl, hw)
    exposed_stream = max(0.0, stream - y_s) * 0.1  # layer-wise overlap hides ~90%

    # prompt pipeline (P only), then token pipeline gated on handoff
    tr_p, _ = rr_schedule(jobs, pipeline="prompt", depth=dp, p_dur=y_s,
                          t_dur=0.0, do_tokens=False)
    gate = {j.mb: tr_p.finish[("prompt", j.mb, "P", 0, dp - 1)] + exposed_stream
            for j in jobs}
    tr_t, _ = rr_schedule(jobs, pipeline="token", depth=dt, p_dur=0.0,
                          t_dur=t_s, do_prompt=False, token_gate=gate)
    finishes = {**tr_p.finish, **tr_t.finish}
    arrivals = {j.mb: j.arrival for j in jobs}
    makespan = max(tr_p.makespan, tr_t.makespan)
    nl = _norm_latency(tr_t, jobs, "token", dt, arrivals)
    return SimResult(makespan, finishes, nl, "dejavu")


# ---------------------------------------------------------------------------
# Failure modeling (Figs. 14–15): latency inflation of in-flight microbatches
# ---------------------------------------------------------------------------

def failure_latency(cfg: ArchConfig, wl: cm.WorkloadSpec, d: int,
                    fail_step: int, *, dejavu: bool,
                    mach: MachineSpec = MachineSpec(),
                    hw: HardwareModel = DEFAULT_HW,
                    detect_s: float = 1.0, restart_s: float = 30.0,
                    replication_lag: int = 1, mfu=0.5, beff=0.7) -> dict:
    """Cumulative latency of one microbatch when a stage fails at token
    `fail_step`.  Baseline restarts the request from scratch (prompt + all
    tokens); DéjàVu resumes from the last replicated step."""
    lps = -(-cfg.num_layers // d)
    ctx = wl.prompt_len + wl.new_tokens
    y_s = cm.stage_prompt_time(cfg, wl, lps, mach.chips, hw, mfu) * d
    t_s = cm.stage_token_time(cfg, wl, lps, mach.chips, ctx, hw, beff) * d
    n = wl.new_tokens
    no_fail = y_s + n * t_s
    pre = y_s + fail_step * t_s
    if dejavu:
        # restore = fetch replica of the failed stage's KV (host->device)
        kv_bytes = cfg.decode_state_bytes(wl.prompt_len + fail_step) * \
            wl.microbatch / d
        restore = kv_bytes / hw.host_link_bw + kv_bytes / hw.dcn_stream_bw
        redo = replication_lag * t_s
        total = pre + detect_s + restore + redo + (n - fail_step) * t_s
    else:
        total = pre + detect_s + restart_s + no_fail
    return {"no_fail_s": no_fail, "with_fail_s": total,
            "slowdown": total / no_fail}
