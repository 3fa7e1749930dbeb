"""DéjàVu resource-allocation planner (paper §4.2.1, Eqs. 1–6; the port's
copy of `repro.core.planner`).

Given D machines (each: `chips` accelerators, M bytes aggregate device
memory), partition them into a prompt pipeline (depth D_p) and a token
pipeline (depth D_t = D − D_p) such that

  (1) memory feasibility:  D_p ≥ ⌈L·(C0+W0)/M⌉            (Eq. 1)
                           D_t ≥ L·W0 / (M − L·(C0+K0))    (Eq. 2)
  (2) throughput:          minimize I_dis = max(I_t, I_p); the continuous
      optimum is D_t = D·N·t/(m·Y + N·t) (Eq. 5); disaggregation wins iff
      Y/t > (D−1)/(D·(2−m)−1) with m ∈ [1,2) (Eq. 4).

The integer split searches around the continuous optimum subject to (1).
`m` (prompt-streaming overhead factor) is derived from the transport model
instead of being guessed — DéjàVuLib's layer-wise overlap hides streaming
behind the NEXT microbatch's prompt compute, so only the non-hidden
remainder inflates m.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core import costmodel as cm
from repro_torch.core.dejavulib.transport import DEFAULT_HW, HardwareModel


@dataclass(frozen=True)
class MachineSpec:
    """One 'machine' = one pipeline stage = an 8-GPU H100 node (HGX H100:
    8 GPUs running tensor parallelism inside, joined by NVLink 4 through
    NVSwitch; the counterpart of the paper's 2×A100 VM)."""
    chips: int = 8
    mem_bytes: float = 8 * 80e9      # 8 × H100 SXM5 80 GB HBM3, aggregate per node


@dataclass(frozen=True)
class TierSpec:
    """Off-device KV tiers available to each token-pipeline stage (the JAX
    package's `repro.kvcache.tiers.KVTierManager`): cold blocks spill to
    host RAM and SSD, so only a working-set fraction of the generated-token
    KV must stay resident in HBM."""
    host_blocks: int = 0             # host-RAM tier capacity per stage
    ssd_blocks: int = 0              # SSD tier capacity per stage
    min_resident_frac: float = 0.25  # working set that must stay in HBM


@dataclass
class Plan:
    d: int
    d_prompt: int
    d_token: int
    feasible: bool
    disagg_beneficial: bool
    m_overhead: float
    inv_tp_colocated: float      # I_c  (s per microbatch completion)
    inv_tp_disagg: float         # I_dis
    prompt_stage_time: float     # Y_dis / D_p
    token_stage_time: float      # t_dis / D_t
    # colocated decode-stall bound: the longest a decode step can wait behind
    # an in-flight prompt pass (one chunk with chunk-interleaving, the whole
    # prompt without) and the bubble fraction of a decode round it implies
    decode_stall_s: float = 0.0
    bubble_frac: float = 0.0
    # continuous-batching round time at `microbatch` live sequences: one pass
    # per sequence (oracle path) vs ONE fused batched pass per round — both
    # derived from the same stage_token_time term (cm.decode_round_time).
    # For families the engine cannot fuse (cm.fused_round_supported) the
    # fused term equals the per-seq term, so fused_round_speedup reads 1.0
    round_time_perseq_s: float = 0.0
    round_time_fused_s: float = 0.0
    note: str = ""

    @property
    def speedup(self) -> float:
        return self.inv_tp_colocated / self.inv_tp_disagg if self.inv_tp_disagg else 0.0

    @property
    def fused_round_speedup(self) -> float:
        return (self.round_time_perseq_s / self.round_time_fused_s
                if self.round_time_fused_s else 0.0)


def paged_token_kv_bytes(cfg: ArchConfig, wl: cm.WorkloadSpec,
                         kv_util: float = 0.5) -> float:
    """K_0 under the paged pool: continuous batching keeps only the LIVE
    prefix of each request's growth window resident (mean occupancy
    `kv_util` of `new_tokens`, ~0.5 for arrival-mixed traces since retired
    requests free immediately), plus at most one partially-filled block per
    sequence of internal fragmentation."""
    k0 = cm.layer_token_kv_bytes(cfg, wl) * kv_util
    slack = (0.5 * cfg.kv_block_size * cfg.kv_bytes_per_token()
             / max(cfg.num_layers, 1) * wl.microbatch)
    return k0 + slack


def min_prompt_depth(cfg: ArchConfig, wl: cm.WorkloadSpec, mach: MachineSpec) -> int:
    w0 = cm.layer_param_bytes(cfg)
    c0 = cm.layer_prompt_kv_bytes(cfg, wl)
    return max(1, math.ceil(cfg.num_layers * (c0 + w0) / mach.mem_bytes))


def tiered_token_kv_bytes(cfg: ArchConfig, wl: cm.WorkloadSpec,
                          tiers: TierSpec, kv_util: float = 0.5) -> float:
    """K_0 with the tier hierarchy behind the pool: host/SSD-backed blocks
    absorb the cold tail of the live KV, so HBM only needs the hot working
    set (floored at `min_resident_frac` — promotion latency makes an
    all-cold pool useless)."""
    k0 = paged_token_kv_bytes(cfg, wl, kv_util)
    backed = ((tiers.host_blocks + tiers.ssd_blocks) * cm.kv_block_bytes(cfg)
              / max(cfg.num_layers, 1))
    return max(k0 - backed, k0 * tiers.min_resident_frac)


def min_token_depth(cfg: ArchConfig, wl: cm.WorkloadSpec, mach: MachineSpec,
                    *, paged: bool = False, kv_util: float = 0.5,
                    tiers: Optional[TierSpec] = None) -> int:
    w0 = cm.layer_param_bytes(cfg)
    c0 = cm.layer_prompt_kv_bytes(cfg, wl)
    if tiers is not None:
        k0 = tiered_token_kv_bytes(cfg, wl, tiers, kv_util)
    elif paged:
        k0 = paged_token_kv_bytes(cfg, wl, kv_util)
    else:
        k0 = cm.layer_token_kv_bytes(cfg, wl)
    denom = mach.mem_bytes - cfg.num_layers * (c0 + k0)
    if denom <= 0:
        return -1  # even one stage per layer can't hold the KV — infeasible
    return max(1, math.ceil(cfg.num_layers * w0 / denom))


def colocated_inverse_throughput(d: int, y: float, t: float, n: int) -> float:
    """Eq. 3: I_c = (D−1)(Y−t)/D + Y + N·t  (per-microbatch steady state)."""
    return (d - 1) * (y - t) / d + y + n * t


def estimate_m(cfg: ArchConfig, wl: cm.WorkloadSpec, y_total: float, dp: int,
               mach: MachineSpec, hw: HardwareModel) -> float:
    """Prompt-stream overhead factor m ≥ 1 for a prompt pipeline of depth dp.

    P→T streaming rides the chip-to-chip link (`ici_bw`: NVLink on the H100),
    drained by a background thread layer-by-layer while the stage prefills the
    NEXT microbatch (paper §4.1 opt-2).  The stage only stalls (inflating m)
    when its per-microbatch KV production outruns its aggregate link egress
    during one steady-state prompt slot; a ~2% residual (paper App. D)
    accounts for pack-kernel + dispatch overheads."""
    kv_per_stage = cfg.decode_state_bytes(wl.prompt_len) * wl.microbatch / dp
    window = y_total * 1.0 / dp          # stage busy-time per microbatch slot
    egress_bw = hw.ici_bw * mach.chips   # one link per chip toward the T-group
    drain = kv_per_stage / egress_bw
    exposed = max(0.0, drain - window)
    m = 1.02 + exposed / max(window, 1e-9)
    return min(max(m, 1.0), 2.5)


def plan(cfg: ArchConfig, wl: cm.WorkloadSpec, d: int,
         mach: MachineSpec = MachineSpec(), hw: HardwareModel = DEFAULT_HW,
         mfu: float = 0.5, beff: float = 0.7, *, paged: bool = False,
         kv_util: float = 0.5, tiers: Optional[TierSpec] = None,
         prefix_hit_rate: float = 0.0, prefix_src_tier: int = 1,
         prefill_chunk_tokens: int = 0) -> Plan:
    """`paged=True` plans against the paged pool's live-block footprint
    (continuous batching) instead of the static prompt+new reservation —
    the same D often becomes feasible at larger microbatches.

    `tiers` additionally credits host/SSD-backed capacity against the
    token-side HBM requirement (Eq. 2's K_0 shrinks to the hot working set),
    and `prefix_hit_rate` models cross-request prefix reuse: that fraction
    of every prompt is served by promoting cached blocks from
    `prefix_src_tier` instead of prefill compute.

    `prefill_chunk_tokens` (0 = no chunking) bounds the colocated
    decode-stall: with chunk-interleaved scheduling a decode step waits at
    most one chunk pass of a co-scheduled prompt, not the whole prompt —
    reported as `Plan.decode_stall_s` / `Plan.bubble_frac`."""
    l = cfg.num_layers
    ctx = wl.prompt_len + wl.new_tokens
    # whole-model times with all D machines (the paper's Y and t)
    y = cm.stage_prompt_time(cfg, wl, l, d * mach.chips, hw, mfu)
    t = cm.stage_token_time(cfg, wl, l, d * mach.chips, ctx, hw, beff)
    n = wl.new_tokens
    ic = colocated_inverse_throughput(d, y, t, n)
    stall = cm.prefill_stall_time(cfg, wl, prefill_chunk_tokens, l,
                                  d * mach.chips, hw, mfu)
    bubble = cm.prefill_bubble_frac(cfg, wl, prefill_chunk_tokens, l,
                                    d * mach.chips, ctx, hw, mfu, beff)
    rt_seq = cm.decode_round_time(cfg, wl.microbatch, ctx, l, d * mach.chips,
                                  hw, beff, fused=False)
    rt_fused = cm.decode_round_time(cfg, wl.microbatch, ctx, l,
                                    d * mach.chips, hw, beff, fused=True)

    dp_min = min_prompt_depth(cfg, wl, mach)
    dt_min = min_token_depth(cfg, wl, mach, paged=paged, kv_util=kv_util,
                             tiers=tiers)
    if dt_min < 0 or dp_min + max(dt_min, 1) > d:
        return Plan(d, 0, 0, False, False, 1.0, ic, float("inf"), 0, 0,
                    decode_stall_s=stall, bubble_frac=bubble,
                    round_time_perseq_s=rt_seq, round_time_fused_s=rt_fused,
                    note="memory-infeasible for this D")

    # continuous optimum (Eq. 5) then integer search subject to Eqs. 1–2;
    # m depends on the prompt depth, so it is evaluated per candidate split
    best: Optional[Plan] = None
    for dt in range(max(dt_min, 1), d - dp_min + 1):
        dp = d - dt
        m = estimate_m(cfg, wl, y, dp, mach, hw)
        y_dis = y * d / dp           # fewer machines → slower prompt
        if prefix_hit_rate > 0:
            y_dis = cm.prefix_reuse_prefill_time(cfg, wl, y_dis,
                                                 prefix_hit_rate,
                                                 prefix_src_tier, hw,
                                                 n_stages=dp)
        t_dis = t * d / dt
        # steady-state per-microbatch slot of each pipeline
        i_p = m * y_dis
        i_t = n * t_dis
        i_dis = max(i_p, i_t)
        cand = Plan(d, dp, dt, True, i_dis < ic, m, ic, i_dis,
                    y_dis / dp, t_dis / dt,
                    decode_stall_s=stall, bubble_frac=bubble,
                    round_time_perseq_s=rt_seq, round_time_fused_s=rt_fused)
        if best is None or cand.inv_tp_disagg < best.inv_tp_disagg:
            best = cand
    assert best is not None
    # Eq. 4 sanity check (continuous-form benefit condition)
    denom = d * (2 - best.m_overhead) - 1
    cond = (y / t) > ((d - 1) / denom) if denom > 0 else False
    best.note = f"eq4_benefit_condition={cond}"
    return best


def replan_after_failure(current: Plan, cfg: ArchConfig, wl: cm.WorkloadSpec,
                         d_new: int, **kw) -> Plan:
    """Elastic re-planning when workers join/leave (beyond-paper feature)."""
    return plan(cfg, wl, d_new, **kw)
