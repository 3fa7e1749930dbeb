"""Analytic per-stage cost model (prompt Y, per-token t) for the planner,
the discrete-event simulator, and the cluster's modeled timeline (the
port's copy of `repro.core.costmodel`, every function included).

Prompt processing is compute-bound (matmul FLOPs / peak·MFU); token
generation is bandwidth-bound (weight + KV bytes / HBM bw) — the paper's
bimodal-latency premise (§2.2.1).  The figures come from a `HardwareModel`,
by default `DEFAULT_HW`, the H100's datasheet figures.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig
from repro_torch.core.dejavulib.transport import DEFAULT_HW, HardwareModel

DTYPE_BYTES = 2  # bf16


@dataclass(frozen=True)
class WorkloadSpec:
    prompt_len: int
    new_tokens: int          # mean generated tokens per microbatch
    microbatch: int


def layer_param_bytes(cfg: ArchConfig) -> float:
    """W_0 in the paper: per-layer weight bytes (active params for MoE)."""
    per_layer = cfg.active_param_count() / max(cfg.num_layers, 1)
    return per_layer * DTYPE_BYTES


def layer_prompt_kv_bytes(cfg: ArchConfig, wl: WorkloadSpec) -> float:
    """C_0: per-layer prompt KV bytes for one microbatch."""
    return (cfg.decode_state_bytes(wl.prompt_len) / max(cfg.num_layers, 1)
            * wl.microbatch)


def layer_token_kv_bytes(cfg: ArchConfig, wl: WorkloadSpec) -> float:
    """K_0: per-layer generated-token KV bytes for one microbatch."""
    return cfg.kv_bytes_per_token() / max(cfg.num_layers, 1) * wl.new_tokens * wl.microbatch


def stage_prompt_time(cfg: ArchConfig, wl: WorkloadSpec, n_layers: int,
                      chips: int, hw: HardwareModel = DEFAULT_HW,
                      mfu: float = 0.5) -> float:
    """Y per stage (seconds) — compute-bound."""
    per_layer_params = cfg.active_param_count() / max(cfg.num_layers, 1)
    tokens = wl.prompt_len * wl.microbatch
    flops = 2.0 * per_layer_params * tokens * n_layers
    if cfg.family != "ssm":
        flops += 2.0 * wl.microbatch * wl.prompt_len ** 2 * cfg.q_dim * n_layers
    return flops / (chips * hw.peak_flops * mfu)


def stage_token_time(cfg: ArchConfig, wl: WorkloadSpec, n_layers: int,
                     chips: int, context_len: int,
                     hw: HardwareModel = DEFAULT_HW, beff: float = 0.7) -> float:
    """t per stage (seconds) — HBM-bandwidth-bound (weights + KV read)."""
    w_bytes = layer_param_bytes(cfg) * n_layers
    kv_bytes = (cfg.decode_state_bytes(context_len) / max(cfg.num_layers, 1)
                * n_layers * wl.microbatch)
    return (w_bytes + kv_bytes) / (chips * hw.hbm_bw * beff)


def prompt_kv_stream_time(cfg: ArchConfig, wl: WorkloadSpec,
                          hw: HardwareModel = DEFAULT_HW) -> float:
    """Time to move one microbatch's prompt KV P→T over the network."""
    nbytes = cfg.decode_state_bytes(wl.prompt_len) * wl.microbatch
    return hw.net_latency + nbytes / hw.dcn_stream_bw


def token_kv_stream_time(cfg: ArchConfig, wl: WorkloadSpec,
                         hw: HardwareModel = DEFAULT_HW) -> float:
    """Per-step replication bytes → peer (token-level, buffered copies)."""
    nbytes = cfg.kv_bytes_per_token() * wl.microbatch
    return hw.net_latency + nbytes / hw.dcn_stream_bw


def swap_transfer_time(cfg: ArchConfig, wl: WorkloadSpec, n_layers: int,
                       context_len: int, hw: HardwareModel = DEFAULT_HW) -> float:
    """transf_i of App. E: bring one microbatch's stage KV back from host."""
    nbytes = (cfg.decode_state_bytes(context_len) / max(cfg.num_layers, 1)
              * n_layers * wl.microbatch)
    return hw.transfer_latency + nbytes / hw.host_link_bw


# ---------------------------------------------------------------------------
# chunked prefill (prefill-with-prefix-cache + chunk-interleaved scheduling)
# ---------------------------------------------------------------------------

def chunked_prefill_pass_time(cfg: ArchConfig, n_q: int, ctx: int,
                              n_layers: int, chips: int,
                              hw: HardwareModel = DEFAULT_HW,
                              mfu: float = 0.5) -> float:
    """One chunked-prefill pipeline pass: `n_q` new Q tokens ending at
    absolute context position `ctx` — compute-bound like Y.  The attention
    term is EXACT causal accounting (query at position p reads p+1 KV
    slots), so summing passes over a prompt gives the same FLOPs no matter
    how it is chunked — chunking's only modeled overhead is the per-pass
    dispatch latency `chunked_prefill_time` adds."""
    n_q = max(n_q, 0)
    per_layer_params = cfg.active_param_count() / max(cfg.num_layers, 1)
    flops = 2.0 * per_layer_params * n_q * n_layers
    if cfg.family != "ssm":
        # sum_{p=ctx-n_q..ctx-1} (p+1) = n_q*(ctx - n_q) + n_q*(n_q+1)/2
        kv_reads = n_q * max(ctx - n_q, 0) + n_q * (n_q + 1) / 2.0
        flops += 2.0 * kv_reads * cfg.q_dim * n_layers
    return flops / (chips * hw.peak_flops * mfu)


def chunked_prefill_time(cfg: ArchConfig, plen: int, chunk: int,
                         n_layers: int, chips: int,
                         hw: HardwareModel = DEFAULT_HW, mfu: float = 0.5,
                         start: int = 0) -> float:
    """Total prompt-processing time when tokens [start, plen) run in
    fixed-size chunks: the matmul/attention FLOPs equal the one-pass prefill
    of the same tokens (exact causal accounting above), plus one
    pipeline-dispatch latency per pass — the price chunking pays for
    bounding decode stalls (`chunk<=0` means one unchunked pass)."""
    chunk = chunk if chunk > 0 else max(plen - start, 1)
    total, pos = 0.0, start
    while pos < plen:
        c = min(chunk, plen - pos)
        total += chunked_prefill_pass_time(cfg, c, pos + c, n_layers, chips,
                                           hw, mfu)
        total += hw.net_latency           # per-pass stage-hop/dispatch cost
        pos += c
    return total


def prefill_stall_time(cfg: ArchConfig, wl: WorkloadSpec, chunk: int,
                       n_layers: int, chips: int,
                       hw: HardwareModel = DEFAULT_HW,
                       mfu: float = 0.5) -> float:
    """Longest a co-scheduled decode step waits behind an in-flight prompt
    pass: the final chunk (worst context) of every prompt in the microbatch
    with interleaving, the whole prompt without."""
    n_q = (min(chunk, wl.prompt_len) if chunk > 0 else wl.prompt_len)
    return wl.microbatch * chunked_prefill_pass_time(
        cfg, n_q, wl.prompt_len, n_layers, chips, hw, mfu)


def prefill_bubble_frac(cfg: ArchConfig, wl: WorkloadSpec, chunk: int,
                        n_layers: int, chips: int, ctx: int,
                        hw: HardwareModel = DEFAULT_HW, mfu: float = 0.5,
                        beff: float = 0.7) -> float:
    """Fraction of a co-scheduled decode round occupied by an in-flight
    prefill pass (the pipeline 'bubble' a decode step waits out), computed
    from the SAME stall `prefill_stall_time` reports.  In [0, 1)."""
    stall = prefill_stall_time(cfg, wl, chunk, n_layers, chips, hw, mfu)
    t = stage_token_time(cfg, wl, n_layers, chips, ctx, hw, beff)
    return stall / max(stall + t, 1e-30)


# ---------------------------------------------------------------------------
# fused batched rounds (continuous batching: ONE pipeline pass per round)
# ---------------------------------------------------------------------------

def fused_round_supported(cfg: ArchConfig) -> bool:
    """Whether the engine's fused batched round path serves this config —
    the cost-model mirror of the cluster gate (`cluster.fused_supported`):
    every dense/moe attention variant (full-causal, ALiBi, sliding-window
    +meta) fuses; ssm/hybrid/encdec recurrence and vlm patch slots run
    per-sequence."""
    return cfg.family in ("dense", "moe") and not cfg.num_patches


def decode_round_time(cfg: ArchConfig, n_active: int, ctx: int,
                      n_layers: int, chips: int,
                      hw: HardwareModel = DEFAULT_HW, beff: float = 0.7,
                      *, fused: bool = True) -> float:
    """Modeled wall time of ONE continuous-batching decode round with
    `n_active` live sequences at mean context `ctx`.

    Fused: one bandwidth-bound pass reads the stage weights ONCE plus every
    sequence's KV, plus a single dispatch latency — round time is O(1) in
    pass count and grows only with the aggregate KV bytes.  Per-sequence
    (the oracle path): one pass per live sequence, each pass re-reading the
    full stage weights and paying its own dispatch latency — exactly the
    O(n_active) round the fused refactor removes.  Both sides are built from
    the SAME `stage_token_time` term, so their ratio isolates the
    weight-re-read + dispatch overhead.

    `fused=True` degrades to the per-sequence time for families the engine
    cannot fuse (`fused_round_supported`), so planner round terms reflect
    the path the engine will actually take."""
    fused = fused and fused_round_supported(cfg)
    wl1 = WorkloadSpec(prompt_len=ctx, new_tokens=1, microbatch=1)
    one = stage_token_time(cfg, wl1, n_layers, chips, ctx, hw, beff)
    if not fused:
        return n_active * (one + hw.net_latency)
    wlb = WorkloadSpec(prompt_len=ctx, new_tokens=1, microbatch=n_active)
    return (stage_token_time(cfg, wlb, n_layers, chips, ctx, hw, beff)
            + hw.net_latency)


# ---------------------------------------------------------------------------
# tiered KV-cache hierarchy (HBM -> host -> SSD; repro.kvcache.tiers)
# ---------------------------------------------------------------------------

def kv_block_bytes(cfg: ArchConfig, dtype_bytes: int = DTYPE_BYTES) -> float:
    """Bytes of one whole-model KV block (`kv_block_size` token slots)."""
    return cfg.decode_state_bytes(cfg.kv_block_size, dtype_bytes)


def promotion_time(cfg: ArchConfig, n_blocks: float, src_tier: int,
                   hw: HardwareModel = DEFAULT_HW) -> float:
    """Time to bring `n_blocks` KV blocks back into HBM from `src_tier`
    (1 = host RAM over the host link; 2 = SSD read, then the host link)."""
    nbytes = n_blocks * kv_block_bytes(cfg)
    t = hw.transfer_latency + nbytes / hw.host_link_bw
    if src_tier >= 2:
        t += hw.transfer_latency + nbytes / hw.ssd_bw
    return t


def write_behind_time(cfg: ArchConfig, n_blocks: float, dst_tier: int,
                      hw: HardwareModel = DEFAULT_HW) -> float:
    """Time to demote `n_blocks` KV blocks down to `dst_tier`.  Run as
    write-behind on the streaming thread, this is HIDDEN whenever per-step
    compute exceeds it (the `StreamEngine` overlap report measures the
    remainder)."""
    nbytes = n_blocks * kv_block_bytes(cfg)
    t = hw.transfer_latency + nbytes / hw.host_link_bw
    if dst_tier >= 2:
        t += hw.transfer_latency + nbytes / hw.ssd_bw
    return t


def prefix_reuse_prefill_time(cfg: ArchConfig, wl: WorkloadSpec,
                              base_y: float, hit_frac: float, src_tier: int,
                              hw: HardwareModel = DEFAULT_HW,
                              n_stages: int = 1) -> float:
    """Effective prompt time when `hit_frac` of each prompt is served by
    cross-request prefix hits: that fraction of prefill compute is replaced
    by promoting the matching blocks.  Each of the `n_stages` pipeline
    stages promotes only its own layer slice, concurrently over its own
    host link.  Only the chain head's latency is truly exposed — the rest
    prefetches behind the suffix compute — so charging the full per-stage
    promotion time keeps this an upper bound."""
    hit_frac = min(max(hit_frac, 0.0), 1.0)
    n_blocks = (hit_frac * wl.prompt_len / max(cfg.kv_block_size, 1)
                * wl.microbatch / max(n_stages, 1))
    return base_y * (1.0 - hit_frac) + promotion_time(cfg, n_blocks, src_tier, hw)
