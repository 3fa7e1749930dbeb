#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) end to end on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --phases env,kernels
    python3 chip_smoke.py --profile --out DIR    # and a device-time table in DIR

Phases, each printing one JSON line with its seconds:

1. ``env``     the card (nvidia-smi name and power limit) and the build of
               every CUDA kernel of the serving path from ``csrc/``.
2. ``kernels`` each hand-written kernel against its plain PyTorch version on
               the card (TF32 off), rows 4-7 also at head dims 96 and 192,
               with CUDA-event times beside the bound,
               the plain version and one library call of the same function,
               and the profiler's device time of the kernel and the library
               call; a decode or paged row must show its body's name in the
               profile, and the bf16 bodies of ``flash_attention``,
               ``paged_prefill_attention`` and ``flash_attention_bwd``
               HGMMA in their libraries, and the bf16 body of
               ``ssd_scan_bwd`` and the decode body's tensor-core instance
               HMMA in theirs.
               ``flash_attention_bwd`` against autograd through the plain
               version (both dtypes, six head dims, causal and full, GQA,
               keys ending mid-tile), the forward's row LSE against the
               f32 log-sum-exp, the backward timed beside SDPA's backward
               at smollm-360m's and qwen3-moe's training shapes (the
               profile must name its wgmma kernels), and the forward with
               and without its LSE in turns, beside its bound and SDPA's
               forward.  ``ssd_scan_bwd`` against autograd through the
               plain version (both dtypes, ragged S, two groups, h0 and
               dh_final, mamba2's and Hymba's heads; a repeated call
               bit-identical), timed at mamba2-780m's and hymba-1.5b's
               training shapes (the profile must name its mma.sync chunk
               kernels), and the SSD forward with and without its chunk
               states in turns.  The shapes of ``mm_models``: full flash
               over seamless-m4t-large-v2's encoder and its cross-attention
               (the prompt's 64 queries and decode's one over 1,024 source
               rows), causal flash over phi-3-vision-4.2b's 576 patch slots
               and 512 prompt tokens at head dim 96, and decode over both
               models' serving caches, each timed beside its bound and SDPA.
               The decode body's tensor-core instance (bf16 groups of 6 or
               more) at nemotron-4-340b's, yi-34b's and qwen3-moe-30b-a3b's
               heads, each timed beside its bound (and SDPA, but for the
               paged row); each decode row's profile must name the
               instance its (dtype, group) takes, and flash at head dim 192
               the two-consumer body where the call does not split.
3. ``parity``  gpt2-1.5b at full width, cut to 2 layers, fp32: the engine on
               the card against the port on the CPU, same seeded weights, a
               trace that chunks its prompts and preempts; once plain (both
               stages read the pages in place) and once with a sliding
               window and meta sinks on layer 1 (stage 1 gathers the pages
               dense).  Greedy tokens must be identical, and each run must
               launch the kernels of its routes and no other.
4. ``serve``   gpt2-1.5b, 48 layers, bf16, 2 stage workers: 16 requests
               through fused continuous batching over the pages in place.
               The paged kernels' launches must be the layers times the
               fused passes the engine ran, and no fused pass may gather
               the pages dense (each admission's first chunk, a
               per-sequence pass, still does).
5. ``mb_parity`` the microbatch round-robin path (`ServingEngine.run`) at
               the parity phase's size: colocated, with swapping and
               disaggregated, each on the card against the port on the CPU,
               and against `run_continuous` on the card.
6. ``mb_serve`` gpt2-1.5b, 48 layers, bf16, 2 stage workers: 512-token
               prompts in microbatches of 4 through `run()`, colocated, then
               with swapping and disaggregated.  Launch counts must match
               the passes, as in ``serve``.
7. ``ssm_parity`` the Model API (`prefill`, then `decode_step`) of
               mamba2-780m (2 layers) and hymba-1.5b (3 layers, one global)
               at full width, fp32: the card against the port on the CPU,
               same seeded weights.  Greedy tokens must be identical.
8. ``ssm_serve`` mamba2-780m (48 layers) and hymba-1.5b (32 layers) in
               bf16 through prefill and the decode_step loop.  The launches
               of ``ssd_scan`` (and Hymba's ``decode_attention``) must match
               the prefill calls and decode steps.
9. ``recover`` ring replication and 4-step recovery on `run_continuous`:
               ``serve``'s model and trace, with and without replication in
               turns, then worker 1 lost mid-decode and worker 0 mid-prefill,
               each with no other prefill in flight (tokens as the
               failure-free run's), and worker 1 lost while prefills are in
               flight (they restart: its differing bf16 tokens are shown
               beside those of a max_active change); then all three exactly
               at fp32 with 4 layers.  Prints tokens/s, the replicated
               bytes, the replication barrier's and the streamer's seconds,
               and time to recover split into its parts.
10. ``mb_recover`` the same on `run()`: ``mb_serve``'s model and trace on 4
               workers with replication, colocated, swapping and
               disaggregated (2, 2), a worker lost in each (a prompt worker
               when disaggregated); tokens bit for bit as the failure-free
               run's.  Both phases check launches exactly: the passes, each
               replicated window (``kv_pack``), and the stages a failed pass
               ran before the dead worker.
11. ``telemetry`` ``serve``'s model and trace with the telemetry registry
               and the tracer installed: two such runs must give
               byte-identical snapshots and dumps; tokens/s instrumented,
               with the engine's own registry and with none, in turns; each
               pass kind's modeled time for one H100 beside its measured
               median; the modeled (H100 datasheet) time to first token,
               token gap and recovery time, p50 and p99, of a run whose
               worker 1 dies; and the host copy and host-link rates that
               `HardwareModel`'s host figures assume.
12. ``paged_modes`` paged swapping and disaggregation and the KV tiers on
               `run_continuous`: ``serve``'s model at 24 layers; (a)
               swapping and (b)
               disaggregated (1, 1) on its trace, in turns with colocated;
               (c) a shared-system-prompt trace through the tiers (pool 120
               blocks, host tier 96: it must preempt, spill, and adopt from
               the host tier and from SSD), in turns without them; (d) (c)
               with replication, worker 1 lost while a sequence is swapped
               out.  Launches exact in every run; bf16 differing tokens
               beside a control; then the same four at 4 layers in fp32,
               card tokens = CPU tokens = the plain run's.  Prints tokens/s
               by mode, prefill tokens saved, the tier counters, bytes by
               transport, the tier copies' rates and the time to recover.
13. ``moe``    qwen3-moe-30b-a3b at full width (128 experts, top 8), 8
               layers, bf16, on ``serve``'s trace through fused rounds:
               tokens/s, pass medians and launches exact, as ``serve``; then
               2 layers in fp32, the card against the CPU, fused, per
               sequence and with replication losing worker 1.
14. ``wide_heads`` nemotron-4-340b at full width (96:8 heads of 192), 2
               layers, bf16: `run_continuous` (the paged kernels at head
               dim 192) and `run()` (flash and decode at 192), launches
               exact; a short profiled run of each path must name the
               decode body's tensor-core instance (rows 4 and 5, G 12) and
               the two-consumer flash body; then the card against the CPU
               in fp32 at nemotron's attention widths with the MLP and
               vocabulary cut.
15. ``train``  training through the flash and SSD forward and backward
               kernels: (a) reduced smollm-360m, qwen3-moe-30b-a3b,
               mamba2-780m and hymba-1.5b, 4 layers, fp32, card = CPU
               (loss, every gradient leaf, three steps with grad_accum 1
               and 2, launches exact per family); (b) smollm-360m at full
               width and depth, bf16, remat, batch 8 x 2048, 20 steps: the
               loss falls by more than 0.1, launches exact, a checkpoint at
               step 10 restored bit for bit and run on to the
               uninterrupted run's losses and weights, bit for bit; (c)
               qwen3-moe-30b-a3b at full width, 4 layers, bf16, batch 4 x
               1024, 5 steps, then the loss and every gradient leaf on the
               next batch taken twice from the same weights, bit for bit
               (a resumed run at (c)'s size does not fit the card); (d)
               mamba2-780m at full width and depth
               (780,148,992 parameters), bf16, remat, batch 8 x 2048, 10
               steps, the loss falling by more than 0.1, a checkpoint at
               step 5 restored and run on, as (b); (e) hymba-1.5b at full
               width and depth (1,641,179,520 parameters), bf16, remat,
               batch 4 x 2048, 5 steps, its gradient repeated as (c)'s.
               ``--profile`` writes one
               profiled step of each into <model>_profile.txt
               (``train_profile.txt`` for smollm).
16. ``examples`` the port's five examples (`examples/*_torch.py`: quickstart,
               fault_tolerance, microbatch_swapping, serve_disaggregated,
               train_smollm), each example's `run` on the card at its own
               reduced configuration and seeded weights: every identity it
               prints holds (tokens with a failure, a migration, swapping
               and disaggregation equal the plain run's; the loss after a
               resume equals the loss before the crash), each serving
               example's bytes by transport, and fault_tolerance's
               failures, recoveries and steps redone, equal the same run's
               on the CPU, and the kernels of its path launched (flash and
               decode; `kv_pack` with replication, swapping and
               disaggregation; `kv_unpack` disaggregated;
               `flash_attention_bwd` in training).
17. ``mm_models`` the vlm and encdec families through the Model API: (a)
               reduced phi-3-vision-4.2b and seamless-m4t-large-v2 at fp32,
               the card against the CPU (prefill logits and state, 8 greedy
               decode steps with tokens identical, the loss and every
               gradient leaf, three train steps, launches exact); (b) both
               served at full width and depth in bf16 through prefill and
               decode_step (phi-3-vision: 4 requests of 576 patch
               embeddings and 512 tokens; seamless: 4 requests of 1,024
               source frames and 64 tokens; 32 new tokens each): tokens/s,
               prefill ms, the decode step beside its weight-read bound,
               peak memory and exact launches; (c) training in bf16 with
               remat: seamless at full width and depth, batch 4 x 1024
               tokens over 1,024 frames, 10 steps, the loss falling by more
               than 0.1, a checkpoint at step 5 restored and run on bit for
               bit as the uninterrupted run; phi-3-vision at full width and
               depth, batch 2 x 1024 tokens after 576 patches, 5 steps.
               ``--profile`` writes <model>_profile.txt for each served
               model.
18. ``dist``   the distributed layer on a world of one (NCCL, a file
               store, `make_local_mesh("cuda")`): smollm-360m at full width
               and depth, bf16, remat, batch 8 x 2048, 3 steps of the
               sharded train step (parameters and moments as DTensors under
               the rules) and 3 of `make_train_step` from the same seeded
               weights, in turns: losses, gradient norms, parameters and
               moments bit-identical, and the launches of
               ``flash_attention`` and ``flash_attention_bwd`` equal
               between the two; both step times.  The sharded step is
               the split one (`distributed.tensor_parallel`: per-layer
               hook, vocabulary-parallel embedding and loss).  Then
               `make_sharded_prefill` and `make_sharded_decode_step` on the
               same mesh against the unsharded `prefill` and `decode_step`
               (smollm-360m, full width and depth, bf16, 4 prompts of 512,
               32 greedy tokens): the same tokens, the same decode-state
               bits, the same launches of ``flash_attention`` and
               ``decode_attention``; then, both warm, timed in the order
               sharded, plain, plain, sharded, and 8 decode steps of each
               profiled (wall and device time, device launches).  Then ``decode_attention`` with its
               LSE at smollm-360m's and yi-34b's decode heads (8 x 2048
               slots, bf16): its output the same bits as without, its LSE
               within 5e-3 of the plain version's, and the kernel over
               each half of the cache merged by `tensor_parallel.combine`
               within 2e-2 of the largest |o| of the kernel over the whole
               (once with an empty second half), with and without the LSE
               timed in turns.  Then
               `compressed_allreduce` over NCCL on one of the model's
               gradients in f32: bit for bit the plain ``q.float() *
               scale``, its all-gathered payload int8, numel bytes.  Then
               the other families split on the same mesh, at full width in
               bf16 with their depth cut (mamba2-780m 8 of 48 layers;
               hymba-1.5b 4 of 32, layer 0 global; seamless-m4t-large-v2 4
               + 4 of 24 + 24; `DIST_FAMILIES`): 3 split and 3 unsharded
               train steps in turns (remat), bit for bit, with the
               launches of ``ssd_scan``, ``ssd_scan_bwd``,
               ``flash_attention`` and ``flash_attention_bwd`` per step as
               `train_launches` counts them; then sharded prefill and 32
               greedy steps against `prefill` and `decode_step` (Hymba's
               prompts wrap its window ring): the same tokens and
               decode-state bits, the launches of ``ssd_scan``,
               ``flash_attention`` and ``decode_attention`` as the model
               runs them; step ms, generation seconds and peak GiB for
               each.  Last the reference's opt variants (`dist_opt`):
               smollm-360m at (b)'s shape, one unsharded step and one
               split step under opt (sequence parallelism) and opt-zmlp
               (FSDP-only MLP on the rank's tokens), the same bits and
               flash launches; mamba2-780m at the families' depth, opt
               prefill and 32 greedy steps on opt-rowssm's row-split SSM
               weights against the unsharded ones, the same tokens, state
               bits and ``ssd_scan`` launches.

Each phase's line carries the peak device memory it allocated; the models
of a phase are freed before the next begins.

The whole script, the kernels' build included, must finish within 1200 s
on one H100 and aims at half of that: a phase that grows the script past
it cuts the depth of a bf16 serving run, never a width or a check.

Then one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Any failed check exits non-zero.  Without a CUDA device, or
without the repository's ``src/repro_torch`` beside this file, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # dense, same source
PHASES = ("env", "kernels", "parity", "serve", "mb_parity", "mb_serve", "ssm_parity",
          "ssm_serve", "recover", "mb_recover", "telemetry", "paged_modes", "moe",
          "wide_heads", "train", "examples", "mm_models", "dist")
PARITY_POOL_BLOCKS = 38     # small enough that the parity trace preempts once
# the kernels of the continuous-batching path (phases parity and serve)
CONTINUOUS_KERNELS = ("batched_decode_attention", "kv_pack_ragged", "kv_pack")
# the kernels of the fused passes of plain causal stages, which read the pages
PAGED_KERNELS = ("paged_decode_attention", "paged_prefill_attention")
# the kernels' names in a profile: the f32 body, then the bf16 ones (the
# two-consumer body runs the unsplit calls at head dim 192)
FLASH_NAMES = ("flash_kernel", "flash_wgmma_kernel", "flash_wgmma_ws_kernel")
SSD_NAMES = ("ssd_kernel", "ssd_mma_kernel")


class SmokeFailure(RuntimeError):
    pass


def decode_body(mode: str, dtype, g: int) -> str:
    """The split decode body a call's profile must name, `mode` "valid",
    "paged" or "batched": bf16 groups of 6 or more take the tensor-core
    instance, the rest the CUDA-core one."""
    import torch
    kind = "mma" if dtype == torch.bfloat16 and g >= 6 else "split"
    return f"{mode}_decode_{kind}_kernel"


def flash_body(dtype, d: int, splits: int) -> str:
    """The flash_attention kernel a call's profile must name: f32's body, or
    bf16's template instance (whether it split; at head dim 192 the calls
    that do not split take the two-consumer body)."""
    import torch
    if dtype != torch.bfloat16:
        return FLASH_NAMES[0]
    if splits == 1 and d == 192:
        return "flash_wgmma_ws_kernel<192>"
    return f"flash_wgmma_kernel<{d}, {'true' if splits > 1 else 'false'}>"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


PROFILE_TRIES = 3


def device_ms(fn, iters: int = 50, warmup: int = 5):
    """Mean device time of one call: the kernels' own time under
    torch.profiler, without the gaps where the device waits for the host
    (which `cuda_ms` counts when a call's host work outlasts its kernels).
    Returns (ms, {name: mean device ms per call} of the device kernels the
    calls ran, by name).  A profile that recorded no device kernel at all
    (CUPTI has returned an empty one mid-phase on this card) is taken
    again, up to PROFILE_TRIES times; if none records one, the script
    fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ran = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if ran:
            by = {}
            for e in ran:
                by[e.key] = by.get(e.key, 0.0) + e.self_device_time_total / 1e3 / iters
            return sum(by.values()), dict(sorted(by.items()))
    raise SmokeFailure(f"the profiler recorded no device kernel in {PROFILE_TRIES} tries")


def bound_ms(nbytes: float, flops: float, dtype: str):
    """Least time for the work on an H100 SXM: the larger of bytes over the
    memory rate and operations over the peak rate of the inputs' type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: environment and build
# ---------------------------------------------------------------------------

def phase_env(state: dict) -> dict:
    import torch

    from repro_torch.kernels import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    state["card"] = card
    t = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t
    state["out"].mkdir(parents=True, exist_ok=True)
    (state["out"] / "ptxas.txt").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    sass = sass_counts()
    emit({"sass": sass})
    if isinstance(sass, dict):      # the bf16 bodies run on wgmma
        for lib in ("flash_attention", "paged_prefill", "flash_attention_bwd"):
            check(sass[lib]["HGMMA"] > 0, f"no HGMMA in the {lib} library")
        # the backward keeps its mma.sync body at head dim 192; the SSD
        # backward's bf16 body and the decode body's tensor-core instance
        # run on mma.sync
        for lib in ("flash_attention_bwd", "ssd_scan_bwd", "decode_attention"):
            check(sass[lib]["HMMA"] > 0, f"no HMMA in the {lib} library")
    return {"card": card, "device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "build_s": build_s, "built": sorted(logs)}


def sass_counts():
    """Tensor-core instructions in each built library's SASS: HGMMA
    (wgmma) and HMMA (mma.sync), by `cuobjdump -sass` from the toolkit; a
    string saying so where cuobjdump is missing."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        return f"cuobjdump not found (looked on PATH and beside {_build._nvcc()})"

    def count(name):      # one cuobjdump a library, all at once
        sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True, timeout=120).stdout
        return {op: len(re.findall(rf"\b{op}\.", sass)) for op in ("HGMMA", "HMMA")}

    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        return dict(zip(_build.SOURCES, pool.map(count, _build.SOURCES)))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the reference's bands (tests/test_kernels.py)


def phase_kernels(state: dict) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (batched_decode_attention,
                                                      decode_attention, split_plan)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import split_plan as flash_split_plan
    from repro_torch.kernels.kv_pack import kv_pack, kv_pack_ragged, kv_unpack
    from repro_torch.kernels.ssd_scan import ssd_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows, checks = {}, []

    def times(mine, plain, lib=None, plain_iters=50, body=None):
        """Event times of a kernel, its plain version and its library call,
        and the profiler's device times of the kernel and the library call
        (at these sizes a call's host work can outlast its kernel), with the
        names of the device kernels the kernel's calls ran; `body`, where
        given, must be among them."""
        dms, names = device_ms(mine)
        if body is not None:
            check(any(body in n for n in names), f"the calls ran {names}, not {body}")
        return {"ms": cuda_ms(mine), "plain_ms": cuda_ms(plain, iters=plain_iters),
                "library_ms": None if lib is None else cuda_ms(lib),
                "device_ms": dms, "device_kernels": names,
                "library_device_ms": None if lib is None else device_ms(lib)[0]}

    def held(kernel, name, out, exp, tname, tol=TOL):
        """Max |err| of a kernel's output against its plain version, checked
        against the dtype's band."""
        err = (out.float() - exp.float()).abs().max().item()
        checks.append({"case": f"{kernel} {name}", "dtype": tname, "max_abs_err": err,
                       "tol": tol[tname]})
        check(err <= tol[tname], f"{kernel} {name} {tname}: max |err| {err} > {tol[tname]}")
        return err

    def attn_case(name, b, hq, hkv, d, s, lengths, dtype, win=None, meta=0,
                  slopes=None, time_it=None):
        """Checks batched_decode_attention on one shape; `time_it` names the
        row its times go to."""
        q = torch.randn(b, hq, d, generator=g, device=dev).to(dtype)
        k = torch.randn(b, s, hkv, d, generator=g, device=dev).to(dtype)
        v = torch.randn(b, s, hkv, d, generator=g, device=dev).to(dtype)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        ws = None if win is None else (lens - win).clamp(min=0)
        sl = None if slopes is None else torch.tensor(slopes, dtype=torch.float32,
                                                      device=dev)
        out = batched_decode_attention(q, k, v, lens, ws, sl, num_meta=meta)
        exp = ref.batched_decode_attention_ref(q, k, v, lens, ws, sl, num_meta=meta)
        tname = str(dtype).replace("torch.", "")
        err = held("batched_decode_attention", name, out, exp, tname)
        if not time_it:
            return err
        # yardstick: SDPA over the same K/V, the visible slots as a boolean
        # mask, or with ALiBi as a float mask holding the bias
        pos = torch.arange(s, device=dev)[None, :]
        vis = pos < lens[:, None]                                        # [B,S]
        if ws is not None:
            vis &= (pos >= ws[:, None]) | (pos < meta)
        if sl is None:
            mask = vis[:, None, None, :]
        else:
            bias = -sl[None, :, None] * (lens[:, None] - 1 - pos).clamp(min=0)[:, None, :]
            mask = torch.where(vis[:, None, :], bias, float("-inf")).to(dtype)[:, :, None, :]
        qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        es = q.element_size()
        live = int(vis.sum())           # the keys this call has to read
        nbytes = (2 * q.numel() * es + 2 * live * hkv * d * es
                  + 4 * b * (1 if ws is None else 2) + (0 if sl is None else 4 * hq))
        bms, by = bound_ms(nbytes, 4.0 * live * hq * d, tname)
        splits, stages, _ = split_plan(dtype, b, s, hq, hkv, d)
        rows[time_it] = {
            **times(lambda: batched_decode_attention(q, k, v, lens, ws, sl, num_meta=meta),
                    lambda: ref.batched_decode_attention_ref(q, k, v, lens, ws, sl,
                                                             num_meta=meta),
                    lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                           enable_gqa=hq != hkv),
                    body=decode_body("batched", dtype, hq // hkv)),
            "bound_ms": bms, "bound_by": by, "max_abs_err": err,
            "cluster": splits, "stages": stages,
            "shape": f"q[{b},{hq},{d}] kv[{b},{s},{hkv},{d}] {tname} "
                     f"lengths {list(lengths)}"
                     + ("" if win is None else f" window {win} meta {meta}")
                     + ("" if sl is None else " alibi")}
        return err

    # gpt2-1.5b decode shapes: B 8, Hq = Hkv = 25, D 64, S 1024, ragged
    lengths = [1024, 977, 613, 512, 301, 129, 64, 1]
    attn_case("gpt2", 8, 25, 25, 64, 1024, lengths, torch.float32)
    attn_case("gpt2", 8, 25, 25, 64, 1024, lengths, torch.bfloat16,
              time_it="batched_decode_attention")
    # the gather route's own setting (the parity phase's windowed layer): a
    # 32-slot window, 4 meta sinks, ALiBi, at row 1's lengths
    gpt2_slopes = [2.0 ** -(8 * (i + 1) / 25) for i in range(25)]
    for dt in (torch.float32, torch.bfloat16):
        attn_case("gpt2_window_meta_alibi", 8, 25, 25, 64, 1024, lengths, dt, win=32, meta=4,
                  slopes=gpt2_slopes,
                  time_it="batched_decode_attention window" if dt == torch.bfloat16 else None)
    # GQA with sliding-window starts, meta sinks and ALiBi slopes
    slopes = [2.0 ** -(i + 1) / 4 for i in range(16)]
    for dt in (torch.float32, torch.bfloat16):
        attn_case("gqa_window_meta_alibi", 4, 16, 4, 64, 300, [300, 257, 64, 9], dt,
                  win=96, meta=4, slopes=slopes)
        # a row at length 0 gets the sum of V over the S slots over S, or at
        # S = 544 (past 512) over the Pallas kernel's padded 1024
        attn_case("length_zero", 3, 4, 2, 16, 300, [0, 77, 300], dt)
        attn_case("length_zero_padded", 3, 4, 2, 16, 544, [0, 77, 544], dt)

    # the buffered copies at [L 24, B 8, S 1024, H 25, D 64] bf16: bit-exact
    L, B, S, H, D = 24, 8, 1024, 25, 64
    cache = torch.randn(L, B, S, H, D, generator=g, device=dev).to(torch.bfloat16)
    es = cache.element_size()
    t0, w_chunk = 448, 64
    out = kv_pack(cache, t0, width=w_chunk)
    exp = ref.kv_pack_ref(cache, t0, w_chunk)
    check(torch.equal(out, exp), "kv_pack differs from its plain version")
    pack_err = (out.float() - exp.float()).abs().max().item()
    # a one-row view of the batch, as the chunk write-back passes it
    one = kv_pack(cache[:, 3:4], 64, width=w_chunk)
    check(torch.equal(one, ref.kv_pack_ref(cache[:, 3:4], 64, w_chunk)),
          "kv_pack of a strided row view differs")
    nb = 2 * L * B * w_chunk * H * D * es
    bms, by = bound_ms(nb, 0.0, "bfloat16")
    rows["kv_pack"] = {
        **times(lambda: kv_pack(cache, t0, width=w_chunk),
                lambda: ref.kv_pack_ref(cache, t0, w_chunk),
                lambda: cache[:, :, t0:t0 + w_chunk].contiguous()),
        "bound_ms": bms, "bound_by": by, "max_abs_err": pack_err,
        "shape": f"cache[{L},{B},{S},{H},{D}] bf16 t0 {t0} width {w_chunk}"}
    starts = [1016, 8, 504, 0, 256, 1000, 64, 128]
    wd = 8
    out = kv_pack_ragged(cache, starts, width=wd)
    exp = ref.kv_pack_ragged_ref(cache, starts, wd)
    check(torch.equal(out, exp), "kv_pack_ragged differs from its plain version")
    ragged_err = (out.float() - exp.float()).abs().max().item()
    st = torch.tensor(starts, device=dev)
    idx = st[:, None] + torch.arange(wd, device=dev)[None, :]
    bidx = torch.arange(B, device=dev)[:, None]
    nb = 2 * L * B * wd * H * D * es
    bms, by = bound_ms(nb, 0.0, "bfloat16")
    rows["kv_pack_ragged"] = {
        **times(lambda: kv_pack_ragged(cache, starts, width=wd),
                lambda: ref.kv_pack_ragged_ref(cache, starts, wd),
                lambda: cache[:, bidx, idx]),
        "bound_ms": bms, "bound_by": by, "max_abs_err": ragged_err,
        "shape": f"cache[{L},{B},{S},{H},{D}] bf16 starts {starts} width {wd}"}
    del cache

    def flash_case(name, b, sq, skv, hq, hkv, d, dtype, causal=True, time_it=None,
                   with_lse=False):
        """Checks the kernel on one shape (with `with_lse`, its row LSE too,
        against the f32 log-sum-exp within LSE_TOL); `time_it` names the row
        its times go to."""
        q = torch.randn(b, sq, hq, d, generator=g, device=dev).to(dtype)
        k = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(dtype)
        v = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(dtype)
        tname = str(dtype).replace("torch.", "")
        err = held("flash_attention", name, flash_attention(q, k, v, causal=causal),
                   ref.flash_attention_ref(q, k, v, causal=causal), tname)
        splits = flash_split_plan(dtype, b, sq, skv, hq, d)
        if with_lse:
            lse_err = (flash_attention(q, k, v, causal=causal, with_lse=True)[1]
                       - plain_lse(q, k, causal)).abs().max().item()
            checks.append({"case": f"flash_attention lse {name}", "dtype": tname,
                           "cluster": splits, "max_abs_err": lse_err, "tol": LSE_TOL})
            check(lse_err <= LSE_TOL, f"flash lse {name} {tname}: {lse_err} > {LSE_TOL}")
        if not time_it:
            return
        # visible (query, key) pairs: what this causal call has to compute
        pairs = (sum(min(skv, i + skv - sq + 1) for i in range(sq)) if causal
                 else sq * skv)
        es = q.element_size()
        bms, by = bound_ms(es * (2 * q.numel() + 2 * k.numel()), 4.0 * b * hq * d * pairs,
                           tname)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def mine():
            return flash_attention(q, k, v, causal=causal)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=hq != hkv)

        rows[time_it] = {
            **times(mine, lambda: ref.flash_attention_ref(q, k, v, causal=causal), sdpa,
                    body=flash_body(dtype, d, splits)),
            "bound_ms": bms, "bound_by": by, "max_abs_err": err, "cluster": splits,
            "shape": f"q[{b},{sq},{hq},{d}] kv[{b},{skv},{hkv},{d}] {tname} "
                     f"{'causal' if causal else 'full'}"}

    # the mb_serve prefill: microbatch 4 of 512-token prompts, gpt2 heads
    flash_case("gpt2_prefill", 4, 512, 512, 25, 25, 64, torch.float32,
               time_it="flash_attention float32")
    flash_case("gpt2_prefill", 4, 512, 512, 25, 25, 64, torch.bfloat16,
               time_it="flash_attention")
    for dt in (torch.float32, torch.bfloat16):      # a query block at the end of the keys
        flash_case("sq_lt_skv", 2, 100, 512, 25, 25, 64, dt)
        flash_case("gqa_head16_full", 2, 70, 70, 4, 2, 16, dt, causal=False)
    # Hymba's full-attention layers, 25:5 GQA over 128 meta + prompt tokens:
    # the ssm_serve prefill (bf16) and the ssm_parity one (fp32)
    flash_case("hymba_full_layer", 4, 1664, 1664, 25, 5, 64, torch.bfloat16,
               time_it="flash_attention hymba")
    flash_case("hymba_full_layer", 2, 1228, 1228, 25, 5, 64, torch.float32)

    def decode_case(name, b, s, hq, hkv, d, valid, dtype, time_it=None):
        """Checks decode_attention on one shape; `time_it` names the row its
        times go to."""
        q = torch.randn(b, hq, d, generator=g, device=dev).to(dtype)
        k = torch.randn(b, s, hkv, d, generator=g, device=dev).to(dtype)
        v = torch.randn(b, s, hkv, d, generator=g, device=dev).to(dtype)
        tname = str(dtype).replace("torch.", "")
        err = held("decode_attention", name, decode_attention(q, k, v, valid),
                   ref.decode_attention_ref(q, k, v, valid), tname)
        if not time_it:
            return
        n_valid = int(valid.sum())
        es = q.element_size()
        bms, by = bound_ms(es * (2 * q.numel() + 2 * b * n_valid * hkv * d) + s,
                           4.0 * b * hq * d * n_valid, tname)
        qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        mask = valid[None, None, None, :]
        splits, stages, _ = split_plan(dtype, b, s, hq, hkv, d)
        rows[time_it] = {
            **times(lambda: decode_attention(q, k, v, valid),
                    lambda: ref.decode_attention_ref(q, k, v, valid),
                    lambda: F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=mask, enable_gqa=hq != hkv),
                    body=decode_body("valid", dtype, hq // hkv)),
            "bound_ms": bms, "bound_by": by, "max_abs_err": err,
            "cluster": splits, "stages": stages,
            "shape": f"q[{b},{hq},{d}] kv[{b},{s},{hkv},{d}] {tname} valid {n_valid}/{s}"}

    # the mb_serve decode: microbatch 4, cache of 544 slots, query at 527
    slots = torch.arange(544, device=dev)
    decode_case("gpt2_mb_decode", 4, 544, 25, 25, 64, slots <= 527, torch.float32)
    decode_case("gpt2_mb_decode", 4, 544, 25, 25, 64, slots <= 527, torch.bfloat16,
                time_it="decode_attention")
    window_meta = (slots <= 300) & ((slots > 300 - 96) | (slots < 4))
    for dt in (torch.float32, torch.bfloat16):      # not a prefix: window + sinks
        decode_case("gqa_window_meta", 3, 544, 16, 4, 64, window_meta, dt)
        # no valid key: the sum of V over the S slots over the padded 1024
        decode_case("none_valid", 3, 544, 16, 4, 64, slots < 0, dt)
    # Hymba's decode: 25:5 heads over its full ring of 1024 window + 128 meta slots
    ring = torch.ones(1152, dtype=torch.bool, device=dev)
    decode_case("hymba_ring", 4, 1152, 25, 5, 64, ring, torch.float32)
    decode_case("hymba_ring", 4, 1152, 25, 5, 64, ring, torch.bfloat16,
                time_it="decode_attention hymba")

    # the disaggregated landing: one stage's 24 layers of a microbatch of 4,
    # 512 prompt tokens into a 544-slot cache, bf16: bit-exact
    L, B, S, W = 24, 4, 544, 512
    buf = torch.randn(L, B, W, H, D, generator=g, device=dev).to(torch.bfloat16)
    mine = torch.zeros(L, B, S, H, D, dtype=torch.bfloat16, device=dev)
    plain = mine.clone()
    kv_unpack(mine, buf, 0)
    ref.kv_unpack_ref(plain, buf, 0)
    check(torch.equal(mine, plain), "kv_unpack differs from its plain version")
    bms, by = bound_ms(2 * buf.numel() * buf.element_size(), 0.0, "bfloat16")
    rows["kv_unpack"] = {
        **times(lambda: kv_unpack(mine, buf, 0), lambda: ref.kv_unpack_ref(plain, buf, 0),
                lambda: plain[:, :, 0:W].copy_(buf)),
        "bound_ms": bms, "bound_by": by,
        "max_abs_err": (mine.float() - plain.float()).abs().max().item(),
        "shape": f"cache[{L},{B},{S},{H},{D}] bf16 t0 0 width {W}"}

    def ssd_case(name, b, s, nh, hd, ng, n, dtype, with_h0=False, time_it=None):
        # scaled so that |y| stays below 4, where one bf16 step (1/64) is
        # inside the 2e-2 band: kernel and plain version round their f32
        # results to bf16 on their own, and may land one step apart.  C enters
        # y alone (the read-out), so its scale sets |y| and leaves the state,
        # and h_final's check, as they are; the premise is checked below
        x = (0.5 * torch.randn(b, s, nh, hd, generator=g, device=dev)).to(dtype)
        dt = F.softplus(torch.randn(b, s, nh, generator=g, device=dev))
        a_neg = -torch.exp(0.3 * torch.randn(nh, generator=g, device=dev))
        bm = (0.25 * torch.randn(b, s, ng, n, generator=g, device=dev)).to(dtype)
        cm = (0.0625 * torch.randn(b, s, ng, n, generator=g, device=dev)).to(dtype)
        h0 = (0.1 * torch.randn(b, nh, hd, n, generator=g, device=dev)) if with_h0 else None
        q = min(128, s)
        tname = str(dtype).replace("torch.", "")
        y, hf = ssd_scan(x, dt, a_neg, bm, cm, h0, chunk=q)
        ye, he = ref.ssd_scan_ref(x, dt, a_neg, bm, cm, h0=h0, chunk=q)
        tag = f"{name}{' h0' if with_h0 else ''}"
        ymax = ye.float().abs().max().item()
        check(ymax < 4, f"ssd_scan {tag}: the plain |y| reaches {ymax}, past the 4 below "
              "which one bf16 step fits the band")
        # h_final is f32 on both sides whatever x's dtype: the f32 band
        err = max(held("ssd_scan", f"{tag} y", y, ye, tname, SSD_TOL),
                  held("ssd_scan", f"{tag} h_final", hf, he, "float32", SSD_TOL))
        if not time_it:
            return
        fl = ssd_flops(b, s, nh, hd, ng, n, q)
        es = x.element_size()
        nbytes = (2 * x.numel() * es + (bm.numel() + cm.numel()) * es + 4 * dt.numel()
                  + 4 * nh + 4 * hf.numel() * (2 if with_h0 else 1))
        bms, by = bound_ms(nbytes, fl, tname)
        rows[time_it] = {
            # no one PyTorch call computes the SSD scan
            **times(lambda: ssd_scan(x, dt, a_neg, bm, cm, h0, chunk=q),
                    lambda: ref.ssd_scan_ref(x, dt, a_neg, bm, cm, h0=h0, chunk=q),
                    plain_iters=10),
            "bound_ms": bms, "bound_by": by, "max_abs_err": err, "flops": fl,
            "bytes": nbytes,
            "shape": f"x[{b},{s},{nh},{hd}] B/C[{b},{s},{ng},{n}] {tname} chunk {q}"
                     f"{' h0' if with_h0 else ''}"}

    # the mamba2-780m ssm_serve prefill: 8 prompts of 512 tokens, 48 heads of
    # 64, one group of state 128; with and without an initial state
    for dt_ in (torch.float32, torch.bfloat16):
        for h0_ in (False, True):
            timed = dt_ == torch.bfloat16 and not h0_
            ssd_case("mamba2_prefill", 8, 512, 48, 64, 1, 128, dt_, with_h0=h0_,
                     time_it="ssd_scan" if timed else None)
        ssd_case("ragged_s200", 4, 200, 48, 64, 1, 128, dt_, with_h0=True)
        ssd_case("groups2_s50", 2, 50, 4, 16, 2, 8, dt_)
    # the hymba-1.5b ssm_serve prefill: 4 x (128 meta + 1536) tokens, 50 heads, N 16
    ssd_case("hymba_prefill", 4, 1664, 50, 64, 1, 16, torch.bfloat16,
             time_it="ssd_scan hymba")

    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.paged_prefill import paged_prefill_attention

    def paged_decode_case(name, lengths, hq, hkv, dtype, time_it=None, d=64):
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kp, vp, tables = paged_inputs(g, lengths, hkv, d, dtype)
        q = torch.randn(len(lengths), hq, d, generator=g, device=dev).to(dtype)
        tname = str(dtype).replace("torch.", "")
        err = held("paged_decode_attention", name,
                   paged_decode_attention(q, kp, vp, tables, lens),
                   ref.paged_decode_attention_ref(q, kp, vp, tables, lens), tname)
        if time_it:
            es = q.element_size()
            live = int(sum(lengths))
            nbytes = 2 * q.numel() * es + 2 * live * hkv * d * es + 4 * (tables.numel()
                                                                          + len(lengths))
            bms, by = bound_ms(nbytes, 4.0 * live * hq * d, tname)
            splits, stages, _ = split_plan(dtype, len(lengths), tables.shape[1] * kp.shape[1],
                                           hq, hkv, d)
            rows[time_it] = {
                # no one PyTorch call reads pages through a table
                **times(lambda: paged_decode_attention(q, kp, vp, tables, lens),
                        lambda: ref.paged_decode_attention_ref(q, kp, vp, tables, lens),
                        body=decode_body("paged", dtype, hq // hkv)),
                "bound_ms": bms, "bound_by": by, "max_abs_err": err,
                "cluster": splits, "stages": stages,
                "shape": f"q[{len(lengths)},{hq},{d}] pages {list(kp.shape)} of a 24-layer "
                         f"pool, {tname}, lengths {list(lengths)}"}
        del kp, vp

    def paged_prefill_case(name, starts, qlens, c, hq, hkv, dtype, time_it=None, d=64):
        """Checks the kernel on one shape; `time_it` names the row its times
        go to."""
        ends = [s_ + n for s_, n in zip(starts, qlens)]
        kp, vp, tables = paged_inputs(g, ends, hkv, d, dtype)
        q = torch.randn(len(starts), c, hq, d, generator=g, device=dev).to(dtype)
        qs = torch.tensor(starts, dtype=torch.int32, device=dev)
        ql = torch.tensor(qlens, dtype=torch.int32, device=dev)
        out = paged_prefill_attention(q, kp, vp, tables, qs, ql)
        exp = ref.paged_prefill_attention_ref(q, kp, vp, tables, qs, ql)
        # rows past q_lens[b] are don't-care: only valid rows are compared
        valid = torch.arange(c, device=dev)[None, :] < ql[:, None]
        tname = str(dtype).replace("torch.", "")
        err = held("paged_prefill_attention", name, out[valid], exp[valid], tname)
        if time_it:
            es = q.element_size()
            pairs = sum(s_ * n + n * (n + 1) // 2 for s_, n in zip(starts, qlens))
            nvalid = int(sum(qlens))
            nbytes = (2 * nvalid * hq * d * es + 2 * int(sum(ends)) * hkv * d * es
                      + 4 * (tables.numel() + 2 * len(starts)))
            bms, by = bound_ms(nbytes, 4.0 * pairs * hq * d, tname)
            rows[time_it] = {
                # no one PyTorch call reads pages through a table
                **times(lambda: paged_prefill_attention(q, kp, vp, tables, qs, ql),
                        lambda: ref.paged_prefill_attention_ref(q, kp, vp, tables, qs, ql),
                        body="paged_prefill_wgmma_kernel"),
                "bound_ms": bms, "bound_by": by, "max_abs_err": err,
                "shape": f"q[{len(starts)},{c},{hq},{d}] pages {list(kp.shape)} of a 24-layer "
                         f"pool, {tname}, q_starts {list(starts)} q_lens {list(qlens)}"}
        del kp, vp

    # the serve decode pass at row 1's lengths, one layer of a [N,24,8,25,64]
    # pool with shuffled page ids; GQA 25:5 beside it
    for dt_ in (torch.float32, torch.bfloat16):
        paged_decode_case("gpt2", lengths, 25, 25, dt_,
                          time_it="paged_decode_attention" if dt_ == torch.bfloat16 else None)
        paged_decode_case("gqa_25_5", [700, 9, 1, 333], 25, 5, dt_)
        # a row at length 0 reads its whole table and averages V over its slots
        paged_decode_case("length_zero", [300, 0, 77], 25, 5, dt_)
    # the serve chunk-set pass: 8 chunks of 64 over prefixes of 0-448 tokens,
    # one short final chunk of 5 whose padded rows are not compared
    starts, qlens = [0, 64, 448, 128, 320, 192, 384, 256], [64] * 7 + [5]
    for dt_ in (torch.float32, torch.bfloat16):
        paged_prefill_case("gpt2_chunkset", starts, qlens, 64, 25, 25, dt_,
                           time_it="paged_prefill_attention" if dt_ == torch.bfloat16 else None)
        paged_prefill_case("gqa_25_5", [0, 40, 197], [64, 17, 64], 64, 25, 5, dt_)

    # head dims 192 (nemotron-4-340b, 96:8 heads) and 96 (phi-3-vision-4.2b,
    # 32:32 heads): the chunk-set pass of 8 chunks of 64, a whole 512-token
    # prompt through flash, and the decode entries beside them
    for d, hq, hkv in ((192, 96, 8), (96, 32, 32)):
        for dt_ in (torch.float32, torch.bfloat16):
            bf16 = dt_ == torch.bfloat16
            paged_prefill_case(f"d{d}_chunkset", starts, qlens, 64, hq, hkv, dt_, d=d,
                               time_it=f"paged_prefill_attention d{d}" if bf16 else None)
            flash_case(f"d{d}_prefill", 1, 512, 512, hq, hkv, d, dt_,
                       time_it=f"flash_attention d{d}" if bf16 else None)
            flash_case(f"d{d}_sq_lt_skv_full", 1, 70, 150, hq, hkv, d, dt_, causal=False)
            paged_decode_case(f"d{d}", lengths, hq, hkv, dt_, d=d)
            # timed at 192: G = 12 takes the tensor-core instance in bf16
            decode_case(f"d{d}", 2, 544, hq, hkv, d, slots <= 527, dt_,
                        time_it="decode_attention d192" if bf16 and d == 192 else None)
    # the other groups of 6 or more, on the tensor cores in bf16: yi-34b's
    # decode over its 2,048-slot cache (56:8 heads of 128, G 7, the dist
    # phase's LSE shape), and qwen3-moe-30b-a3b's fused decode pass in the moe
    # phase (32:4 heads of 128, G 8): 8 of serve's prompts, 16 tokens in
    yi_slots = torch.ones(2048, dtype=torch.bool, device=dev)
    moe_lengths = [int(n) + 16 for n in np.random.default_rng(2).integers(64, 513, 16)[:8]]
    for dt_ in (torch.float32, torch.bfloat16):
        bf16 = dt_ == torch.bfloat16
        decode_case("yi34b", 8, 2048, 56, 8, 128, yi_slots, dt_,
                    time_it="decode_attention yi34b" if bf16 else None)
        paged_decode_case("qwen3_moe", moe_lengths, 32, 4, dt_, d=128,
                          time_it="paged_decode_attention qwen3_moe" if bf16 else None)
    # flash at head dim 128 (qwen3-moe's 32:4 heads), beside 64 and 192 above:
    # the K/V stages of the bf16 body are chosen by head dim
    flash_case("d128_prefill", 1, 512, 512, 32, 4, 128, torch.bfloat16,
               time_it="flash_attention d128")
    # the mm_models phase's serving shapes: seamless-m4t-large-v2's encoder
    # over 1,024 frames and its cross-attention over them (the prompt's 64
    # queries, and decode's one: a 64-row tile with one live row), full, 16:16
    # heads of 64; phi-3-vision-4.2b's prefill, causal over 576 patch slots
    # and 512 prompt tokens, 32:32 heads of 96; and decode over both models'
    # caches at the last of 32 new tokens (phi-3-vision's 1,120 slots with
    # the query at 1,118, seamless's 96 with the query at 94)
    phi3v_slots, seamless_slots = torch.arange(1120, device=dev), torch.arange(96, device=dev)
    for dt_ in (torch.float32, torch.bfloat16):
        bf16 = dt_ == torch.bfloat16
        for name, sq in (("encoder", 1024), ("prompt_cross", 64), ("decode_cross", 1)):
            # the cross-attention calls split over a cluster in bf16: their
            # LSE is the combined one
            flash_case(f"seamless_{name}", 4, sq, 1024, 16, 16, 64, dt_, causal=False,
                       time_it=f"flash_attention seamless {name}" if bf16 else None,
                       with_lse=name != "encoder")
        flash_case("phi3v_prefill", 4, 1088, 1088, 32, 32, 96, dt_,
                   time_it="flash_attention phi3v prefill" if bf16 else None)
        decode_case("phi3v_decode", 4, 1120, 32, 32, 96, phi3v_slots <= 1118, dt_,
                    time_it="decode_attention phi3v" if bf16 else None)
        decode_case("seamless_decode", 4, 96, 16, 16, 64, seamless_slots <= 94, dt_,
                    time_it="decode_attention seamless" if bf16 else None)
    flash_backward_cases(g, rows, checks)
    ssd_backward_cases(g, rows, checks)
    state["kernel_rows"] = rows
    return {"checks": checks, "timed": rows}


# the backward's band, relative to the largest |gradient| of the f32 plain
# version: its sums run over up to G * Sq rows in another order (f32), and
# in bf16 P and dS enter their products, and dq/dk/dv are stored, rounded
# to 8 bits of mantissa
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_TOL = 1e-4       # the forward's row log-sum-exp, absolute, both bodies


def plain_lse(q, k, causal: bool):
    """Each query row's log-sum-exp of its scaled f32 scores, [B,Hq,Sq]:
    what `flash_attention(..., with_lse=True)` returns beside its output."""
    import torch

    from repro_torch.kernels import ref
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float().reshape(b, sq, hkv, -1, d),
                          k.float()) * d ** -0.5
    if causal:
        vis = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril(skv - sq)
        scores = torch.where(vis, scores, ref.NEG_INF)
    return torch.logsumexp(scores, -1).reshape(b, hq, sq)


def visible_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs a causal (offset Skv - Sq) or full call computes."""
    return sum(min(skv, i + skv - sq + 1) for i in range(sq)) if causal else sq * skv


def flash_backward_cases(g, rows: dict, checks: list) -> None:
    """`flash_attention_bwd` against autograd through the plain version on
    the card, at every head dim, both dtypes, causal and full, GQA and keys
    ending mid-tile; the forward's LSE against the f32 log-sum-exp.  Times
    the backward at smollm-360m's training shape [8,2048,15:5,64] and
    qwen3-moe's [4,1024,32:4,128] beside SDPA's backward (its profile must
    name the wgmma kernels, not the mma.sync ones), and the forward with
    and without its LSE in turns, beside the forward's bound (2 products)
    and SDPA's forward."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    dev = g.device

    def case(name, b, sq, skv, hq, hkv, d, dtype, causal=True, time_it=None):
        tname = str(dtype).replace("torch.", "")
        q = torch.randn(b, sq, hq, d, generator=g, device=dev).to(dtype)
        k = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(dtype)
        v = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(dtype)
        dout = torch.randn(b, sq, hq, d, generator=g, device=dev).to(dtype)
        out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
        grads = flash_attention_bwd(dout, q, k, v, out, lse, causal=causal)
        # the plain version in f32 on the same values, under autograd
        q32, k32, v32 = (t.float().requires_grad_() for t in (q, k, v))
        o32 = ref.flash_attention_ref(q32, k32, v32, causal=causal)
        exp = torch.autograd.grad(o32, (q32, k32, v32), dout.float())
        lse_err = (lse - plain_lse(q, k, causal)).abs().max().item()
        checks.append({"case": f"flash_attention lse {name}", "dtype": tname,
                       "max_abs_err": lse_err, "tol": LSE_TOL})
        check(lse_err <= LSE_TOL, f"flash lse {name} {tname}: {lse_err} > {LSE_TOL}")
        errs = {}
        for gname, mine, want in zip(("dq", "dk", "dv"), grads, exp):
            scale = max(1.0, want.abs().max().item())
            err = (mine.float() - want).abs().max().item()
            errs[gname] = err
            checks.append({"case": f"flash_attention_bwd {name} {gname}", "dtype": tname,
                           "max_abs_err": err, "tol": BWD_TOL[tname] * scale})
            check(err <= BWD_TOL[tname] * scale,
                  f"flash_attention_bwd {name} {tname} {gname}: max |err| {err} > "
                  f"{BWD_TOL[tname]} * {scale}")
        if not time_it:
            return
        es = q.element_size()
        # q, k, v, out, dout and lse read once; dq, dk, dv written once
        nbytes = es * (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) + 4 * lse.numel()
        flops = 10.0 * b * hq * d * visible_pairs(sq, skv, causal)   # 5 products
        bms, by = bound_ms(nbytes, flops, tname)
        qp, kp, vp = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o_plain = ref.flash_attention_ref(qp, kp, vp, causal=causal)
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
        o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                enable_gqa=hq != hkv)
        dout_t = dout.transpose(1, 2)

        def mine():
            return flash_attention_bwd(dout, q, k, v, out, lse, causal=causal)

        def sdpa():
            return torch.autograd.grad(o_sdpa, (qt, kt, vt), dout_t, retain_graph=True)

        dms, names = device_ms(mine, iters=20, warmup=2)
        check(any("dkdv_wgmma_kernel" in n for n in names)
              and any("dq_wgmma_kernel" in n for n in names)
              and not any("_mma_kernel" in n for n in names), f"the backward ran {names}")
        rows[time_it] = {
            "ms": cuda_ms(mine, iters=20, warmup=2),
            "plain_ms": cuda_ms(lambda: torch.autograd.grad(o_plain, (qp, kp, vp), dout,
                                                            retain_graph=True),
                                iters=5, warmup=1),
            "library_ms": cuda_ms(sdpa, iters=20, warmup=2),
            "device_ms": dms, "device_kernels": names,
            "library_device_ms": device_ms(sdpa, iters=20, warmup=2)[0],
            "bound_ms": bms, "bound_by": by, "max_abs_err": max(errs.values()),
            "shape": f"q[{b},{sq},{hq},{d}] kv[{b},{skv},{hkv},{d}] {tname} "
                     f"{'causal' if causal else 'full'}; 5 products counted"}
        # the serving launch (no LSE) and the training one, in turns
        turns = []
        for with_lse in (False, True, True, False):
            turns.append({"with_lse": with_lse, "device_ms": device_ms(
                lambda: flash_attention(q, k, v, causal=causal, with_lse=with_lse),
                iters=20, warmup=2)[0]})
        rows[time_it]["forward_turns"] = turns
        # the forward with its LSE: q, k, v read, out and lse written once;
        # 2 products of 2 * pairs * D
        fbms, fby = bound_ms(es * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel(),
                             4.0 * b * hq * d * visible_pairs(sq, skv, causal), tname)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qt.detach(), kt.detach(), vt.detach(),
                                                  is_causal=causal, enable_gqa=hq != hkv)

        rows[time_it]["forward"] = {
            "bound_ms": fbms, "bound_by": fby,
            # the plain version of the same function: its output and its LSE
            "plain_ms": cuda_ms(lambda: (ref.flash_attention_ref(q, k, v, causal=causal),
                                         plain_lse(q, k, causal)), iters=3, warmup=1),
            "library_ms": cuda_ms(sdpa_fwd, iters=20, warmup=2),
            "library_device_ms": device_ms(sdpa_fwd, iters=20, warmup=2)[0]}
        del o_plain, o_sdpa

    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 32, 64, 96, 128, 192):      # keys end mid-tile: 150 = 2 * 64 + 22
            case(f"d{d}_gqa_4_2", 1, 150, 150, 4, 2, d, dtype)
        case("full_sq_ne_skv", 2, 70, 130, 4, 1, 64, dtype, causal=False)
        case("sq_lt_skv", 1, 100, 260, 6, 2, 32, dtype)
    case("smollm_train", 8, 2048, 2048, 15, 5, 64, torch.bfloat16,
         time_it="flash_attention_bwd")
    case("qwen3_moe_train", 4, 1024, 1024, 32, 4, 128, torch.bfloat16,
         time_it="flash_attention_bwd d128")


def paged_inputs(g, lengths, hkv: int, d: int, dtype, layers: int = 24, bs: int = 8,
                 layer: int = 5):
    """Random K/V pages for sequences of `lengths` tokens: a pool [N, layers,
    bs, hkv, d] whose pages go to the sequences in a shuffled order, its
    layer `layer` as the strided view [N, bs, hkv, d] the paged kernels read,
    and the int32 block tables [B, nb], short rows padded with page 0.
    Returns (k view, v view, tables) on `g`'s device."""
    import torch
    dev = g.device
    nbs = [-(-int(n) // bs) for n in lengths]
    n_pages = sum(nbs) + 4
    order = torch.randperm(n_pages, generator=torch.Generator().manual_seed(n_pages)).tolist()
    rows, o = [], 0
    for nb in nbs:
        rows.append(order[o:o + nb] + [0] * (max(nbs) - nb))
        o += nb
    tables = torch.tensor(rows, dtype=torch.int32, device=dev)
    views = []
    for _ in range(2):
        pool = torch.zeros(n_pages, layers, bs, hkv, d, dtype=dtype, device=dev)
        pool[:, layer] = torch.randn(n_pages, bs, hkv, d, generator=g, device=dev).to(dtype)
        views.append(pool[:, layer])
    return views[0], views[1], tables


SSD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py SSD band


def ssd_bwd_flops(b: int, s: int, nh: int, hd: int, ng: int, n: int, q: int) -> float:
    """Operations the chunked SSD's gradient needs: per chunk of m rows,
    C.B^T over the m(m+1)/2 causal pairs once per group; per head dy.x^T,
    the decayed scores' product with dy (dx), G.B (dC) and G^T.C (dB) over
    those pairs, and four products of m * hd * N with the chunk's states
    (B.dh_out^T, x.dh_out, dy.h_in and the reverse state pass's dy^T.C)."""
    total = 0.0
    for t0 in range(0, s, q):
        m = min(q, s - t0)
        pairs = m * (m + 1) / 2
        total += b * (ng * 2 * pairs * n + nh * (4 * pairs * hd + 4 * pairs * n
                                                 + 8 * m * hd * n))
    return total


def ssd_bwd_bytes(b: int, s: int, nh: int, hd: int, ng: int, n: int, es: int,
                  h0: bool = False, dh_final: bool = False) -> int:
    """Bytes the SSD's gradient must move, each of its operands read once
    and each result written once: x, dy and dx, B, C, dB and dC in the
    input type (`es` bytes); dt, ddt, a and da in f32; h0, dh0 and
    dh_final where given.  The chunk states the backward reads are not
    counted: they are intermediates a design may keep or recompute."""
    states = b * nh * hd * n
    return (es * (3 * b * s * nh * hd + 4 * b * s * ng * n)
            + 4 * (2 * b * s * nh + 2 * nh + (2 * h0 + dh_final) * states))


def ssd_backward_cases(g, rows: dict, checks: list) -> None:
    """`ssd_scan_bwd` against autograd through the plain version on the
    card, both dtypes: ragged S, two groups, h0 and dh_final given or not,
    mamba2-780m's and hymba-1.5b's heads; a repeated call bit-identical.
    Timed at mamba2-780m's training shape [8,2048,48,64] (N 128) and
    hymba-1.5b's [4,2176,50,64] (N 16; 2,048 tokens and 128 meta tokens),
    both bf16, Q 128, no h0 and no dh_final as the losses call it; and, at
    mamba2's, the forward with and without its chunk states in turns.
    At the timed shapes the plain version is `ssd_scan_bwd_ref` in f32
    (held to that autograd and to JAX's in tests/test_torch_ssd_grad.py):
    autograd's backward through the plain scan there asks for a 24 GiB
    intermediate [B, nc, nh, Q, Q, hd] on top of its graph."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    dev = g.device

    def case(name, b, s, nh, hd, ng, n, q, dtype, with_h0=False, with_dhf=False,
             time_it=None):
        tname = str(dtype).replace("torch.", "")
        # the forward cases' scales (ssd_case)
        x = (0.5 * torch.randn(b, s, nh, hd, generator=g, device=dev)).to(dtype)
        dt = F.softplus(torch.randn(b, s, nh, generator=g, device=dev))
        a_neg = -torch.exp(0.3 * torch.randn(nh, generator=g, device=dev))
        bm = (0.25 * torch.randn(b, s, ng, n, generator=g, device=dev)).to(dtype)
        cm = (0.25 * torch.randn(b, s, ng, n, generator=g, device=dev)).to(dtype)
        h0 = (0.1 * torch.randn(b, nh, hd, n, generator=g, device=dev)) if with_h0 else None
        dy = torch.randn(b, s, nh, hd, generator=g, device=dev).to(dtype)
        dhf = torch.randn(b, nh, hd, n, generator=g, device=dev) if with_dhf else None
        _, hf, states = ssd_scan(x, dt, a_neg, bm, cm, h0, chunk=q, with_states=True)
        grads = ssd_scan_bwd(dy, dhf, x, dt, a_neg, bm, cm, h0, states, hf, chunk=q)
        again = ssd_scan_bwd(dy, dhf, x, dt, a_neg, bm, cm, h0, states, hf, chunk=q)
        check(all(torch.equal(p, r) for p, r in zip(grads, again) if p is not None),
              f"ssd_scan_bwd {name} {tname}: two calls differ")
        # the plain version in f32 on the same values: under autograd, or
        # written out where autograd's backward does not fit the card
        ins = [t.float().requires_grad_(not time_it) for t in (x, dt, a_neg, bm, cm)]
        h0g = None if h0 is None else h0.clone().requires_grad_(not time_it)
        dy32 = dy.float()

        def plain():
            if time_it:
                return ref.ssd_scan_bwd_ref(dy32, dhf, *ins, h0=h0g, chunk=q)
            y, hfin = ref.ssd_scan_ref(*ins, h0=h0g, chunk=q)
            outs, cots = [y], [dy32]
            if dhf is not None:
                outs.append(hfin)
                cots.append(dhf)
            return torch.autograd.grad(outs, ins + ([h0g] if h0g is not None else []), cots)

        exp = plain()
        errs = {}
        for gname, mine, want in zip(("dx", "ddt", "da", "dB", "dC", "dh0"), grads, exp):
            if mine is None:
                continue
            scale = max(1.0, want.abs().max().item())
            err = (mine.float() - want).abs().max().item()
            errs[gname] = err / scale
            checks.append({"case": f"ssd_scan_bwd {name} {gname}", "dtype": tname,
                           "max_abs_err": err, "tol": SSD_TOL[tname] * scale})
            check(err <= SSD_TOL[tname] * scale, f"ssd_scan_bwd {name} {tname} {gname}: "
                  f"max |err| {err} > {SSD_TOL[tname]} * {scale}")
        del exp
        if not time_it:
            return
        es = x.element_size()
        nbytes = ssd_bwd_bytes(b, s, nh, hd, ng, n, es, h0 is not None, dhf is not None)
        flops = ssd_bwd_flops(b, s, nh, hd, ng, n, q)
        bms, by = bound_ms(nbytes, flops, tname)

        def mine():
            return ssd_scan_bwd(dy, dhf, x, dt, a_neg, bm, cm, h0, states, hf, chunk=q)

        dms, names = device_ms(mine, iters=5, warmup=1)
        # the bf16 body: its two chunk passes on the tensor cores
        for body in ("ssd_bwd_dc_mma_kernel", "ssd_bwd_dx_mma_kernel"):
            check(any(body in k for k in names), f"the backward ran {names}")
        rows[time_it] = {
            "ms": cuda_ms(mine, iters=5, warmup=1),
            "plain_ms": cuda_ms(plain, iters=2, warmup=1),
            # no one PyTorch call computes the SSD scan or its gradient
            "library_ms": None, "device_ms": dms, "device_kernels": names,
            "library_device_ms": None, "bound_ms": bms, "bound_by": by,
            "max_abs_err": max(errs.values()), "max_rel_err": errs, "flops": flops,
            "bytes": nbytes,
            "shape": f"x[{b},{s},{nh},{hd}] B/C[{b},{s},{ng},{n}] {tname} chunk {q}, "
                     "no h0, no dh_final; plain: ssd_scan_bwd_ref in f32"}
        if time_it == "ssd_scan_bwd":
            # the serving launch (no states) and the training one, in turns
            turns = []
            for with_states in (False, True, True, False):
                turns.append({"with_states": with_states, "device_ms": device_ms(
                    lambda: ssd_scan(x, dt, a_neg, bm, cm, h0, chunk=q,
                                     with_states=with_states), iters=10, warmup=2)[0]})
            rows[time_it]["forward_turns"] = turns
            # the forward with its states: x, B, C, dt and a read once; y,
            # h_final and the states written once
            fbytes = (es * (2 * x.numel() + bm.numel() + cm.numel()) + 4 * (dt.numel() + nh)
                      + 4 * (hf.numel() + states.numel()))
            fbms, fby = bound_ms(fbytes, ssd_flops(b, s, nh, hd, ng, n, q), tname)
            rows[time_it]["forward"] = {
                "bound_ms": fbms, "bound_by": fby, "bytes": fbytes,
                # the plain scan (no chunk states: autograd keeps its own)
                "plain_ms": cuda_ms(lambda: ref.ssd_scan_ref(x, dt, a_neg, bm, cm, h0, chunk=q),
                                    iters=2, warmup=1)}

    for dtype in (torch.float32, torch.bfloat16):
        case("ragged_s200_g2", 2, 200, 6, 16, 2, 16, 64, dtype, with_h0=True, with_dhf=True)
        case("s50_q16", 2, 50, 4, 8, 2, 8, 16, dtype, with_dhf=True)
        case("mamba2_heads", 2, 300, 48, 64, 1, 128, 128, dtype, with_dhf=True)
        case("hymba_heads", 1, 300, 50, 64, 1, 16, 128, dtype, with_h0=True)
    case("mamba2_train", 8, 2048, 48, 64, 1, 128, 128, torch.bfloat16, time_it="ssd_scan_bwd")
    case("hymba_train", 4, 2176, 50, 64, 1, 16, 128, torch.bfloat16,
         time_it="ssd_scan_bwd hymba")


def ssd_flops(b: int, s: int, nh: int, hd: int, ng: int, n: int, q: int) -> float:
    """Operations the chunked SSD needs for these shapes: per chunk of m
    rows, C.B^T over the m(m+1)/2 causal pairs once per group, and per head
    the intra-chunk product over those pairs, the read-out of the incoming
    state and the state update (two flops per multiply-add)."""
    total = 0.0
    for t0 in range(0, s, q):
        m = min(q, s - t0)
        pairs = m * (m + 1) / 2
        total += b * (ng * 2 * pairs * n + nh * (2 * pairs * hd + 4 * m * hd * n))
    return total


# ---------------------------------------------------------------------------
# phase 3: engine on the card against the port on the CPU
# ---------------------------------------------------------------------------

class RecordingSampler:
    """Greedy sampling that keeps every logits row it saw (on the CPU) or
    only whether all were finite."""

    def __init__(self, keep: bool):
        self.keep = keep
        self.rows = []
        self.finite = True

    def __call__(self, logits, step):
        import torch

        from repro_torch.serving.sampling import greedy
        if self.keep:
            self.rows.append(logits.float().cpu())
        else:
            self.finite &= bool(torch.isfinite(logits).all())
        return greedy(logits, step)


def _requests(lens, max_new, vocab, seed):
    import numpy as np

    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, (n,)).astype(np.int32),
                    max_new=max_new) for i, n in enumerate(lens)]


def run_parity(cfg, trace, pool_blocks: int, max_active: int, card: str) -> dict:
    """The same trace and weights through the engine on `card` and on the
    CPU; tokens, batch shape and preemptions must agree."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serving import ServingEngine

    params = DecoderLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", card):
        sampler = RecordingSampler(keep=True)
        eng = ServingEngine(cfg, DecoderLM(cfg, device=dev), params, 2, paged=True,
                            kv_pool_blocks=pool_blocks, sampler=sampler, device=dev)
        reset_launches()
        t = time.perf_counter()
        rep = eng.run_continuous(trace(), max_active=max_active)
        runs[dev] = {"report": rep, "seconds": time.perf_counter() - t,
                     "launches": dict(LAUNCHES), "logits": sampler.rows}
    diffs = [(a - b).abs().max().item()
             for a, b in zip(runs["cpu"]["logits"], runs[card]["logits"])]
    return {"cpu": runs["cpu"], "card": runs[card],
            "max_logit_diff": max(diffs) if diffs else None, "n_logit_rows": len(diffs)}


PARITY_VARIANTS = {         # name -> (config changes, kernels the card run must launch)
    # every stage plain causal: both fused passes read the pages in place;
    # each admission's first chunk (a per-sequence pass) packs its window back
    "plain": ({}, PAGED_KERNELS + ("kv_pack",)),
    # stage 0 (layer 0, full attention) reads the pages; stage 1 (windowed,
    # meta sinks) gathers them dense and packs its windows back
    "window_meta": (dict(sliding_window=32, num_meta_tokens=4, full_attn_layers=(0,)),
                    PAGED_KERNELS + CONTINUOUS_KERNELS),
}


def check_parity(res: dict, max_new: int, launched: tuple) -> None:
    """Tokens, schedule and preemption of a `run_parity` result, and the
    kernels its card run must have launched (and no other kernel)."""
    cpu, card = res["cpu"]["report"], res["card"]["report"]
    check(card.tokens == cpu.tokens, f"card tokens differ from CPU tokens: "
          f"{card.tokens} vs {cpu.tokens}")
    check(card.batch_trace == cpu.batch_trace and card.pass_trace == cpu.pass_trace,
          "card and CPU ran different schedules")
    check(card.preemptions >= 1, f"the trace did not preempt ({card.preemptions})")
    check(all(len(t) == max_new for t in card.tokens.values()), "a request fell short")
    check(not any(res["cpu"]["launches"].values()), "a kernel launched on the CPU run")
    for name, n in res["card"]["launches"].items():
        check((n > 0) == (name in launched),
              f"{name} launched {n} times; the path launches {launched}")


def phase_parity(state: dict) -> dict:
    import torch

    from repro_torch.configs import get_arch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lens, out = [40, 41, 42, 150, 60, 70], {}
    for name, (kw, launched) in PARITY_VARIANTS.items():
        cfg = dataclasses.replace(get_arch("gpt2-1.5b"), num_layers=2, dtype="float32", **kw)
        res = run_parity(cfg, lambda: _requests(lens, 8, cfg.vocab_size, seed=1),
                         pool_blocks=PARITY_POOL_BLOCKS, max_active=4, card="cuda")
        check_parity(res, 8, launched)
        out[name] = {"config": f"gpt2-1.5b full width, 2 layers, fp32, 2 workers {kw}",
                     "tokens_identical": True,
                     "preemptions": res["card"]["report"].preemptions,
                     "max_abs_logit_diff": res["max_logit_diff"],
                     "logit_rows": res["n_logit_rows"],
                     "card_launches": res["card"]["launches"],
                     "cpu_s": res["cpu"]["seconds"], "card_s": res["card"]["seconds"]}
    # the gather route's kernels run on the windowed stage of this path
    state["launches"].update({k: out["window_meta"]["card_launches"][k]
                              for k in CONTINUOUS_KERNELS})
    return {"prompt_lens": lens, "max_new": 8, "kv_pool_blocks": PARITY_POOL_BLOCKS, **out}


# ---------------------------------------------------------------------------
# phase 4: the full model on the card
# ---------------------------------------------------------------------------

def _timed(fn, bucket, sync):
    def wrapper(*a, **kw):
        sync()
        t = time.perf_counter()
        out = fn(*a, **kw)
        sync()
        bucket.append((time.perf_counter() - t) * 1e3)
        return out
    return wrapper


def count_gathers(eng) -> dict:
    """Count the calls of every worker's `PagedKVCache.gather_dense` from
    now on: {"fused": calls for a batch of sequences (a fused pass),
    "per_sequence": calls for one sequence}."""
    n = {"fused": 0, "per_sequence": 0}
    for w in eng.cluster.workers():
        def counted(seqs, pad_to, _f=w.pages.gather_dense):
            n["per_sequence" if isinstance(seqs, int) else "fused"] += 1
            return _f(seqs, pad_to)
        w.pages.gather_dense = counted
    return n


def serve_expected_launches(eng, pc: dict) -> dict:
    """The launches a continuous run implies where every stage reads the
    pages in place: one paged_decode_attention per layer per fused decode
    pass and one paged_prefill_attention per layer per chunk-set pass.  A
    prefill chunk on the per-sequence path (each admitted request's first,
    the engine's admission step, and every chunk without fused rounds)
    gathers its pages, attends with the plain `attend` (a chunk of more than
    one token: every prompt here has 16 or more) and packs its window back
    with one kv_pack per leaf per stage.  Without fused rounds a prompt no
    longer than a chunk prefills whole, one flash_attention per layer, and
    a decode pass gathers its pages and runs one decode_attention per layer.
    No other kernel runs."""
    from repro_torch.kernels import KERNELS
    cl = eng.cluster
    check(all(w.reads_pages() for w in cl.workers()), "a stage gathers its pages")
    other = {k: n for k, n in pc.items()
             if k not in ("fused_decode", "chunkset", "prefill_chunk", "prefill_batch",
                          "perseq_decode", "one_token")}
    check(not any(other.values()), f"passes off the paged path: {other}")
    want = dict.fromkeys(KERNELS, 0)
    want["paged_decode_attention"] = cl.cfg.num_layers * pc.get("fused_decode", 0)
    want["paged_prefill_attention"] = cl.cfg.num_layers * pc.get("chunkset", 0)
    want["kv_pack"] = 2 * len(cl.prompt_group) * pc.get("prefill_chunk", 0)
    want["flash_attention"] = cl.cfg.num_layers * pc.get("prefill_batch", 0)
    want["decode_attention"] = cl.cfg.num_layers * pc.get("perseq_decode", 0)
    return want


def run_serve(cfg, dev: str, lens, max_new: int, max_active: int, pool_blocks: int,
              generator, sync, weights=None):
    """Serve `lens`-long prompts through fused continuous batching on `dev`
    and check tokens, logits and the kernels' launch counts against the
    passes the engine ran.  The model's weights are drawn from `generator`,
    or given as `weights` = (model, params).  Returns (results, the
    engine)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serving import ServingEngine

    t = time.perf_counter()
    if weights is None:
        model = DecoderLM(cfg, device=dev)
        params = model.init(generator)
    else:
        model, params = weights
    sync()
    init_s = time.perf_counter() - t
    sampler = RecordingSampler(keep=False)
    eng = ServingEngine(cfg, model, params, 2, paged=True, kv_pool_blocks=pool_blocks,
                        sampler=sampler, device=dev)
    # warm-up: library handles and the first launch of every path
    eng.run_continuous(_requests([70, 9], 3, cfg.vocab_size, seed=7), max_active=2)
    dec_ms, chunk_ms = [], []
    cl = eng.cluster
    cl.decode_batch = _timed(cl.decode_batch, dec_ms, sync)
    cl.prefill_chunkset_pass = _timed(cl.prefill_chunkset_pass, chunk_ms, sync)
    reqs = _requests(lens, max_new, cfg.vocab_size, seed=3)
    sampler.finite = True
    gathers = count_gathers(eng)
    reset_launches()
    sync()
    t = time.perf_counter()
    rep = eng.run_continuous(reqs, max_active=max_active)
    sync()
    wall = time.perf_counter() - t
    launches = dict(LAUNCHES)
    pc = rep.pass_counts
    check(all(len(r.tokens) == max_new for r in reqs),
          "a request did not emit max_new tokens")
    check(sampler.finite, "non-finite logits")
    want = serve_expected_launches(eng, pc)
    if dev != "cpu":
        check(launches == want, f"launches {launches}, the passes say {want}")
    check(gathers["fused"] == 0, f"a fused pass gathered its pages {gathers['fused']} times")
    check(gathers["per_sequence"] == len(cl.prompt_group) * pc.get("prefill_chunk", 0),
          f"{gathers['per_sequence']} per-sequence gathers for {pc.get('prefill_chunk', 0)} "
          "per-sequence chunk passes")
    gen = sum(len(r.tokens) for r in reqs)
    return {"requests": len(reqs), "prompt_lens": list(lens), "max_new": max_new,
            "max_active": max_active, "kv_pool_blocks": pool_blocks, "init_s": init_s,
            "wall_s": wall, "tokens_generated": gen, "tokens_per_s": gen / wall,
            "prompt_tokens": int(sum(lens)),
            "median_decode_pass_ms": statistics.median(dec_ms),
            "median_chunk_pass_ms": statistics.median(chunk_ms),
            "decode_passes": len(dec_ms), "chunk_passes": len(chunk_ms),
            "gather_dense_calls": dict(gathers), "pass_counts": pc, "launches": launches}, eng


def phase_serve(state: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch("gpt2-1.5b"), dtype="bfloat16")
    lens = [int(n) for n in np.random.default_rng(2).integers(64, 513, 16)]
    torch.cuda.reset_peak_memory_stats()
    res, eng = run_serve(cfg, "cuda", lens, max_new=32, max_active=8, pool_blocks=1024,
                         generator=torch.Generator(device="cuda").manual_seed(0),
                         sync=torch.cuda.synchronize)
    state["launches"].update({k: res["launches"][k] for k in PAGED_KERNELS})
    out = {"config": "gpt2-1.5b, 48 layers, bf16, 2 workers", **res,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    if state.get("profile"):
        out["profile"] = profile_serve(eng, cfg, state["out"])
    return out


def profile_serve(eng, cfg, out_dir: Path) -> dict:
    """Device time by kernel over a short serve window (8 requests of 128
    prompt tokens, 8 new tokens each).  The table goes to
    `out_dir`/serve_profile.txt."""
    return _profile(lambda: _passes(eng.run_continuous(
                        _requests([128] * 8, 8, cfg.vocab_size, seed=11), max_active=8)),
                    out_dir / "serve_profile.txt",
                    {"paged_decode_attention": ("paged_decode",),
                     "paged_prefill_attention": ("paged_prefill",),
                     "batched_decode_attention": ("batched_decode",),
                     "kv_pack": ("kv_pack", "window_copy"),
                     "matmul": ("gemm", "nvjet", "xmma", "cutlass"),
                     "gather_scatter": ("index", "gather", "scatter")})


def _passes(rep) -> int:
    """Pipeline passes of an engine report."""
    return sum(n for k, n in rep.pass_counts.items() if k != "one_token")


def _profile(window_fn, table: Path, groups: dict) -> dict:
    """Run `window_fn` (which returns the pipeline passes or model calls it
    ran) once plainly for its wall time, then again under
    torch.profiler for the kernels' device time.  The busy share divides the
    second by the first (the profiler's own host cost would inflate a
    profiled wall time).  Device time is summed by name `groups`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def window():
        rep = window_fn()
        torch.cuda.synchronize()
        return rep

    torch.cuda.synchronize()
    t = time.perf_counter()
    rep = window()
    wall_us = (time.perf_counter() - t) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window()
    avgs = prof.key_averages()
    table.parent.mkdir(parents=True, exist_ok=True)
    table.write_text(avgs.table(sort_by="self_cuda_time_total", row_limit=40))
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats the time of the kernels it launched
    kernels = sorted(((e.key, e.self_device_time_total, e.count) for e in avgs
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    dev_us = sum(us for _, us, _ in kernels)
    by_group = {g: sum(us for k, us, _ in kernels if any(m in k.lower() for m in ms))
                for g, ms in groups.items()}
    by_group["other"] = dev_us - sum(by_group.values())
    return {"window_wall_ms": wall_us / 1e3, "window_calls": rep,
            "device_ms": dev_us / 1e3, "device_busy_share": dev_us / wall_us,
            "device_launches": sum(n for _, _, n in kernels),
            "device_ms_by_group": {g: us / 1e3 for g, us in by_group.items()},
            "top_kernels": [{"name": k[:80], "ms": us / 1e3, "calls": n}
                            for k, us, n in kernels[:8]]}


# ---------------------------------------------------------------------------
# phases 5 and 6: the microbatch round-robin path (ServingEngine.run)
# ---------------------------------------------------------------------------

MB_MODES = {                     # mode -> (stage workers, engine kwargs)
    "colocated": (2, {}),
    "swapping": (2, {"swapping": True}),
    "disaggregated": (2, {"mode": "disaggregated", "dp_split": (1, 1)}),
}


def run_mb_parity(cfg, trace, card: str) -> dict:
    """The same trace and weights through run() on `card` and on the CPU in
    every mode, and through run_continuous on `card`; tokens must agree."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serving import ServingEngine

    params = DecoderLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    out = {}
    for mode, (n, kw) in MB_MODES.items():
        runs = {}
        for dev in ("cpu", card):
            sampler = RecordingSampler(keep=True)
            eng = ServingEngine(cfg, DecoderLM(cfg, device=dev), params, n, microbatch=2,
                                sampler=sampler, device=dev, **kw)
            reset_launches()
            rep = eng.run(trace())
            runs[dev] = {"tokens": rep.tokens, "launches": dict(LAUNCHES),
                         "logits": sampler.rows, "xfer": eng.transfer_summary(),
                         "peak_kv_bytes": rep.peak_kv_bytes}
        check(runs[card]["tokens"] == runs["cpu"]["tokens"],
              f"run() {mode}: card tokens differ from CPU tokens")
        check(runs[card]["xfer"] == runs["cpu"]["xfer"]
              and runs[card]["peak_kv_bytes"] == runs["cpu"]["peak_kv_bytes"],
              f"run() {mode}: card and CPU moved or kept different bytes")
        check(not any(runs["cpu"]["launches"].values()), "a kernel launched on the CPU run")
        diffs = [(a - b).abs().max().item()
                 for a, b in zip(runs["cpu"]["logits"], runs[card]["logits"])]
        out[mode] = {"tokens": runs[card]["tokens"], "launches": runs[card]["launches"],
                     "transfer_bytes": runs[card]["xfer"],
                     "max_abs_logit_diff": max(diffs), "logit_rows": len(diffs)}
    eng = ServingEngine(cfg, DecoderLM(cfg, device=card), params, 2, paged=True,
                        device=card)
    out["run_continuous_tokens"] = eng.run_continuous(trace(), max_active=4).tokens
    return out


def phase_mb_parity(state: dict) -> dict:
    import torch

    from repro_torch.configs import get_arch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("gpt2-1.5b"), num_layers=2, dtype="float32")
    lens, max_new = [40] * 4, 8
    res = run_mb_parity(cfg, lambda: _requests(lens, max_new, cfg.vocab_size, seed=4),
                        card="cuda")
    toks = res["colocated"]["tokens"]
    for mode in MB_MODES:
        check(res[mode]["tokens"] == toks, f"run() {mode} gave other tokens than colocated")
    check(res["run_continuous_tokens"] == toks, "run() and run_continuous differ")
    check(all(len(t) == max_new for t in toks.values()), "a request fell short")
    for mode, name in (("colocated", "flash_attention"), ("colocated", "decode_attention"),
                       ("swapping", "kv_pack"), ("disaggregated", "kv_unpack")):
        check(res[mode]["launches"][name] > 0, f"{name} was not launched in run() {mode}")
    check(res["swapping"]["transfer_bytes"]["hostlink"] > 0, "swapping moved no bytes")
    check(res["disaggregated"]["transfer_bytes"]["net"] > 0, "no prompt KV was streamed")
    return {"config": "gpt2-1.5b full width, 2 layers, fp32, 2 workers, microbatch 2",
            "prompt_lens": lens, "max_new": max_new, "tokens_identical": True,
            **{m: {k: v for k, v in res[m].items() if k != "tokens"} for m in MB_MODES}}


def mb_expected_launches(eng, pc: dict) -> dict:
    """The launches a run() implies: one attention kernel per layer per
    pass, one kv_pack per leaf per token stage per swapped decode step, and
    one kv_pack and kv_unpack per leaf per streamed chunk."""
    from repro_torch.core.dejavulib import PipelineTopo, plan_repartition
    from repro_torch.kernels import KERNELS
    cl = eng.cluster
    layers = cl.cfg.num_layers
    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention"] = layers * pc.get("mb_prefill", 0)
    want["decode_attention"] = layers * pc.get("mb_decode", 0)
    if cl.swapping:
        want["kv_pack"] = 2 * len(cl.token_group) * pc.get("mb_decode", 0)
    if cl.mode == "disaggregated":
        chunks = len(plan_repartition(PipelineTopo(len(cl.prompt_group), layers, 1),
                                      PipelineTopo(len(cl.token_group), layers, 1)))
        want["kv_pack"] = want["kv_unpack"] = 2 * chunks * pc.get("mb_prefill", 0)
    return want


def run_mb_serve(cfg, dev: str, model, params, n_requests: int, plen: int, max_new: int,
                 microbatch: int, mode: tuple, sync) -> dict:
    """Serve `n_requests` prompts of `plen` tokens through run() on `dev`
    with `mode` = (stage workers, engine kwargs) and check tokens, logits
    and the kernels' launch counts against the passes.  Returns (results,
    the engine)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import ServingEngine

    n, kw = mode
    sampler = RecordingSampler(keep=False)
    eng = ServingEngine(cfg, model, params, n, microbatch=microbatch, sampler=sampler,
                        device=dev, **kw)
    # warm-up: library handles and the first launch of every path
    eng.run(_requests([16] * microbatch, 3, cfg.vocab_size, seed=7))
    pre_ms, dec_ms = [], []
    cl = eng.cluster
    cl.prefill_mb = _timed(cl.prefill_mb, pre_ms, sync)
    cl.decode_mb = _timed(cl.decode_mb, dec_ms, sync)
    xfer0 = eng.transfer_summary()
    reqs = _requests([plen] * n_requests, max_new, cfg.vocab_size, seed=5)
    sampler.finite = True
    reset_launches()
    sync()
    t = time.perf_counter()
    rep = eng.run(reqs)
    sync()
    wall = time.perf_counter() - t
    launches = dict(LAUNCHES)
    pc = rep.pass_counts
    check(all(len(r.tokens) == max_new for r in reqs), "a request did not emit max_new tokens")
    check(sampler.finite, "non-finite logits")
    if dev != "cpu":
        want = mb_expected_launches(eng, pc)
        check(launches == want, f"launches {launches}, the passes say {want}")
    gen = sum(len(r.tokens) for r in reqs)
    xfer = {k: v - xfer0.get(k, 0) for k, v in eng.transfer_summary().items()}
    return {"requests": n_requests, "prompt_len": plen, "max_new": max_new,
            "microbatch": microbatch, "workers": n, "engine": kw, "wall_s": wall,
            "tokens_generated": gen, "tokens_per_s": gen / wall,
            "median_prefill_pass_ms": statistics.median(pre_ms),
            "median_decode_pass_ms": statistics.median(dec_ms),
            "prefill_passes": len(pre_ms), "decode_passes": len(dec_ms),
            "peak_kv_bytes": rep.peak_kv_bytes, "transfer_bytes": xfer,
            "pass_counts": pc, "launches": launches}, eng


def phase_mb_serve(state: dict) -> dict:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import DecoderLM
    cfg = dataclasses.replace(get_arch("gpt2-1.5b"), dtype="bfloat16")
    t = time.perf_counter()
    model = DecoderLM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    out = {"config": "gpt2-1.5b, 48 layers, bf16, microbatch 4, 512-token prompts",
           "init_s": time.perf_counter() - t}
    for mode, n_requests in (("colocated", 16), ("swapping", 16), ("disaggregated", 8)):
        torch.cuda.reset_peak_memory_stats()
        res, _ = run_mb_serve(cfg, "cuda", model, params, n_requests, 512, 32, 4,
                              MB_MODES[mode], torch.cuda.synchronize)
        out[mode] = {**res, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    state["launches"].update(
        flash_attention=out["colocated"]["launches"]["flash_attention"],
        decode_attention=out["colocated"]["launches"]["decode_attention"],
        kv_unpack=out["disaggregated"]["launches"]["kv_unpack"])
    if state.get("profile"):
        out["profile"] = profile_mb(model, params, cfg, state["out"])
    return out


def profile_mb(model, params, cfg, out_dir: Path) -> dict:
    """Device time by kernel over one microbatch of run() (4 prompts of 512
    tokens, 8 new tokens: one prefill pass and seven decode passes), as
    `profile_serve` does for the paged path.  The table goes to
    `out_dir`/mb_profile.txt."""
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(cfg, model, params, 2, microbatch=4, device="cuda")
    eng.run(_requests([16] * 4, 3, cfg.vocab_size, seed=7))          # warm-up
    return _profile(lambda: _passes(eng.run(_requests([512] * 4, 8, cfg.vocab_size,
                                                      seed=11))),
                    out_dir / "mb_profile.txt",
                    {"flash_attention": FLASH_NAMES,
                     "decode_attention": ("valid_decode",), "kv_pack": ("kv_pack", "window_copy"),
                     "matmul": ("gemm", "nvjet", "xmma", "cutlass"),
                     "gather_scatter": ("index", "gather", "scatter")})


# ---------------------------------------------------------------------------
# phases 7 and 8: the Mamba-2 and Hymba families through prefill / decode_step
# ---------------------------------------------------------------------------

def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def generate(model, params, prompts, max_new: int, sync, pre_ms=None, dec_ms=None,
             extra=None):
    """Greedy generation through the Model API: one `prefill` of the prompts
    [B,S] (with `extra`, the batch's other inputs: a vlm's patch_embeds, an
    encdec's src_embeds) and `max_new - 1` decode steps.  Returns (tokens
    [B,max_new], the logits rows on the CPU, the final decode state), the
    host times of each call appended to `pre_ms` / `dec_ms`."""
    import torch
    pre_ms = [] if pre_ms is None else pre_ms
    dec_ms = [] if dec_ms is None else dec_ms
    tokens = torch.as_tensor(prompts, device=model.device)
    max_len = model.cfg.context_overhead + tokens.shape[1] + max_new
    sync()
    t = time.perf_counter()
    logits, state, pos = model.prefill(params, {"tokens": tokens, **(extra or {})},
                                       max_len=max_len)
    sync()
    pre_ms.append((time.perf_counter() - t) * 1e3)
    out, rows = [], []
    for i in range(max_new):
        rows.append(logits.float().cpu())
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
        if i == max_new - 1:
            break
        t = time.perf_counter()
        logits, state = model.decode_step(params, state, tok, pos)
        sync()
        dec_ms.append((time.perf_counter() - t) * 1e3)
        pos += 1
    return torch.stack(out, dim=1).cpu(), rows, state


def _shapes(state):
    if isinstance(state, dict):
        return {k: _shapes(v) for k, v in state.items()}
    return [list(state.shape), str(state.dtype)]


def run_ssm_parity(cfg, n_prompts: int, plen: int, max_new: int, card: str) -> dict:
    """One model and seeded weights through prefill and greedy decode on the
    CPU and on `card`; tokens, state shapes and launches are compared."""
    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kvcache.cache import state_bytes
    from repro_torch.models import build_model
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, (n_prompts, plen))
    runs = {}
    for dev in ("cpu", card):
        sync = torch.cuda.synchronize if dev != "cpu" else (lambda: None)
        reset_launches()
        t = time.perf_counter()
        toks, rows, st = generate(build_model(cfg, device=dev), _to(params, dev), prompts,
                                  max_new, sync)
        runs[dev] = {"tokens": toks, "rows": rows, "shapes": _shapes(st),
                     "state_bytes": state_bytes(st), "launches": dict(LAUNCHES),
                     "seconds": time.perf_counter() - t}
    cpu, other = runs["cpu"], runs[card]
    check(torch.equal(cpu["tokens"], other["tokens"]),
          f"{cfg.name}: card tokens {other['tokens'].tolist()} differ from CPU tokens "
          f"{cpu['tokens'].tolist()}")
    check(cpu["shapes"] == other["shapes"], f"{cfg.name}: card and CPU states differ in shape")
    check(not any(cpu["launches"].values()), "a kernel launched on the CPU run")
    diff = max((a - b).abs().max().item() for a, b in zip(cpu["rows"], other["rows"]))
    return {"tokens": other["tokens"].tolist(), "max_abs_logit_diff": diff,
            "state_bytes": {"cpu": cpu["state_bytes"], "card": other["state_bytes"]},
            "state_shapes": other["shapes"], "launches": other["launches"],
            "cpu_s": cpu["seconds"], "card_s": other["seconds"]}


SSM_PARITY = {              # name -> (config changes, prompts, prompt tokens)
    "mamba2-780m": ({"num_layers": 2}, 4, 200),
    # 128 meta + 1100 prompt tokens wrap the 1152-slot ring during prefill
    "hymba-1.5b": ({"num_layers": 3, "full_attn_layers": (0,)}, 2, 1100),
}


def phase_ssm_parity(state: dict) -> dict:
    import torch

    from repro_torch.configs import get_arch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, (kw, n, plen) in SSM_PARITY.items():
        cfg = dataclasses.replace(get_arch(name), dtype="float32", **kw)
        res = run_ssm_parity(cfg, n, plen, 8, "cuda")
        check(res["launches"]["ssd_scan"] == cfg.num_layers,
              f"{name}: {res['launches']['ssd_scan']} ssd_scan launches for "
              f"{cfg.num_layers} layers and one prefill")
        if cfg.family == "hybrid":
            check(res["launches"]["decode_attention"] == cfg.num_layers * 7,
                  f"{name}: decode_attention launched {res['launches']['decode_attention']} "
                  "times for 7 decode steps")
            check(res["launches"]["flash_attention"] == len(cfg.full_attn_layers),
                  f"{name}: flash_attention launched {res['launches']['flash_attention']} "
                  f"times for {len(cfg.full_attn_layers)} full-attention layers")
        out[name] = {"config": f"{name} full width, {cfg.num_layers} layers, fp32",
                     "prompts": n, "prompt_len": plen, "max_new": 8,
                     "tokens_identical": True, **res}
    return out


def ssm_expected_launches(cfg, prefills: int, decode_steps: int) -> dict:
    """One ssd_scan per layer per prefill; Hymba also runs one
    flash_attention per full-attention layer per prefill and one
    decode_attention per layer per decode step."""
    from repro_torch.kernels import KERNELS
    want = dict.fromkeys(KERNELS, 0)
    want["ssd_scan"] = cfg.num_layers * prefills
    if cfg.family == "hybrid":
        want["flash_attention"] = len(cfg.full_attn_layers) * prefills
        want["decode_attention"] = cfg.num_layers * decode_steps
    return want


def run_ssm_serve(cfg, dev: str, model, params, n_requests: int, plen: int, max_new: int,
                  repeats: int, sync) -> dict:
    """`repeats` generations of `n_requests` prompts of `plen` tokens after a
    warm-up; tokens/s, median call times, state bytes and launch counts."""
    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kvcache.cache import state_bytes
    rng = np.random.default_rng(8)
    # warm-up: library handles and the first launch of every path
    generate(model, params, rng.integers(0, cfg.vocab_size, (n_requests, 16)), 3, sync)
    pre_ms, dec_ms = [], []
    prompts = rng.integers(0, cfg.vocab_size, (n_requests, plen))
    reset_launches()
    sync()
    t = time.perf_counter()
    for _ in range(repeats):
        toks, _, st = generate(model, params, prompts, max_new, sync, pre_ms, dec_ms)
    wall = time.perf_counter() - t
    launches = dict(LAUNCHES)
    check(toks.shape == (n_requests, max_new), f"tokens of shape {tuple(toks.shape)}")
    finite = all(bool(torch.isfinite(v).all()) for v in (st["ssd"], st["conv"]))
    check(finite, "non-finite decode state")
    if dev != "cpu":
        want = ssm_expected_launches(cfg, len(pre_ms), len(dec_ms))
        check(launches == want, f"launches {launches}, the calls say {want}")
    gen = repeats * n_requests * max_new
    return {"requests": n_requests, "prompt_len": plen, "max_new": max_new,
            "repeats": repeats, "wall_s": wall, "tokens_generated": gen,
            "tokens_per_s": gen / wall, "prefill_ms": pre_ms,
            "median_prefill_ms": statistics.median(pre_ms),
            "median_decode_step_ms": statistics.median(dec_ms),
            "prefill_calls": len(pre_ms), "decode_steps": len(dec_ms),
            "state_bytes": state_bytes(st),
            "state_bytes_per_sequence": state_bytes(st) / n_requests, "launches": launches}


SSM_SERVE = {               # name -> (requests, prompt tokens)
    "mamba2-780m": (8, 512),
    "hymba-1.5b": (4, 1536),
}


def phase_ssm_serve(state: dict) -> dict:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    out = {}
    ssd_launches = 0
    for name, (n, plen) in SSM_SERVE.items():
        cfg = dataclasses.replace(get_arch(name), dtype="bfloat16")
        t = time.perf_counter()
        model = build_model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
        res = run_ssm_serve(cfg, "cuda", model, params, n, plen, 32, 3, torch.cuda.synchronize)
        out[name] = {"config": f"{name}, {cfg.num_layers} layers, bf16", "init_s": init_s,
                     **res, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        ssd_launches += res["launches"]["ssd_scan"]
        if cfg.family == "hybrid":     # where mb_serve did not run, these are the path's
            for k in ("flash_attention", "decode_attention"):
                state["launches"].setdefault(k, res["launches"][k])
        if state.get("profile"):
            out[name]["profile"] = profile_generation(model, params, n, plen, state["out"])
        del model, params
    state["launches"]["ssd_scan"] = ssd_launches
    return out


def profile_generation(model, params, n: int, plen: int, out_dir: Path,
                       extra=None) -> dict:
    """Device time by kernel over one generation through the Model API (n
    prompts of plen tokens and `extra` as `generate` takes it, 8 new tokens:
    one prefill and seven decode steps), as `profile_serve` does for the
    paged path.  The table goes to `out_dir`/<model>_profile.txt."""
    import numpy as np
    import torch
    prompts = np.random.default_rng(11).integers(0, model.cfg.vocab_size, (n, plen))

    def window():
        generate(model, params, prompts, 8, torch.cuda.synchronize, extra=extra)
        return 8
    return _profile(window, out_dir / f"{model.cfg.name}_profile.txt",
                    {"ssd_scan": SSD_NAMES, "flash_attention": FLASH_NAMES,
                     "decode_attention": ("valid_decode",),
                     "matmul": ("gemm", "nvjet", "xmma", "cutlass"),
                     "softmax": ("softmax",)})


# ---------------------------------------------------------------------------
# phases 9 and 10: ring replication and 4-step recovery
# ---------------------------------------------------------------------------

def _recovery_times(rep) -> dict:
    """Time to recover, in wall ms: from the kill to the first token emitted
    after the recovery, split into its parts.  `recompute_ms` is what is
    left: the first re-executed pass (the rolled-back steps run from it)."""
    rec = rep.recovery_log[0]
    parts = ("detect_ms", "rebuild_ms", "reattach_ms", "replica_ms", "rereplicate_ms",
             "rollback_ms")
    out = {k: rec.get(k, 0.0) for k in parts}
    out["first_token_ms"] = rec["first_token_ms"]
    out["recompute_ms"] = rec["first_token_ms"] - sum(out[k] for k in parts)
    return out


def _resumed_units(eng) -> int:
    """Microbatches (or sequences) the recoveries rolled back."""
    return sum(len(e.get("resume", {})) for e in eng.cluster.controller.events
               if e["kind"] == "recovery")


def differing_tokens(a: dict, b: dict) -> int:
    return sum(x != y for rid in a for x, y in zip(a[rid], b[rid])) + \
        sum(abs(len(a[rid]) - len(b[rid])) for rid in a)


def run_fused(cfg, model, params, trace, *, dev: str = "cuda", max_active: int = 8,
              pool_blocks: int = 1024, fail_at=None, record: bool = False, **ekw) -> dict:
    """One continuous run of `trace` through 2 stage workers on `dev` with
    the engine options `ekw` (replication, swapping, the split, the tiers;
    fused rounds unless ``fused_rounds=False``) and `fail_at`; with `record`, a recording fault injector and the
    engine.step count at each preemption and resumption.  Checks the
    tokens' count, the leaks and the kernels' launches: those of the passes
    the engine reports (as `serve`) plus, for a decode pass that a failure
    cut short, one launch per layer of the stages before the dead worker.
    The streamer is closed and the tiers' disks are removed after the
    run."""
    import shutil

    import torch

    from repro_torch.core.dejavulib import FaultInjector, assert_no_leaks
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import ServingEngine

    ekw = {"kv_pool_blocks": pool_blocks, **ekw}
    eng = ServingEngine(cfg, model, params, 2, paged=True, device=dev, **ekw)
    cl = eng.cluster
    adoptions = _count_adoptions(eng)
    inj = FaultInjector(record=True) if record else None
    marks = _mark_swaps(eng, inj) if record else None
    reqs = trace()
    sync = torch.cuda.synchronize if dev != "cpu" else (lambda: None)
    reset_launches()
    sync()
    t = time.perf_counter()
    rep = eng.run_continuous(reqs, max_active=max_active, fail_at=fail_at, fault_injector=inj)
    sync()
    wall = time.perf_counter() - t
    launches = dict(LAUNCHES)
    cl.streamer.drain()              # the last write-behinds land before the counts
    cl.streamer.close()
    try:
        check(all(len(r.tokens) == r.max_new for r in reqs), "a request fell short")
        assert_no_leaks(cl)
        want = serve_expected_launches(eng, rep.pass_counts)
        for f in rep.fault_trace:
            dead = next(w for w in cl.workers() if w.wid == f["wid"])
            if f["tag"].startswith("decode-"):
                want["paged_decode_attention"] += dead.lo
            else:                    # a prefill: stage 0 is the dead one
                check(dead.lo == 0, f"no launch count for a failure at {f}")
        if dev != "cpu":
            check(launches == want, f"launches {launches}, the passes and failures say {want}")
    finally:
        for w in cl.workers():
            if w.tier is not None:
                shutil.rmtree(w.tier.ssd.root, ignore_errors=True)
    gen = sum(len(r.tokens) for r in reqs)
    out = {"wall_s": wall, "tokens_per_s": gen / wall, "tokens": rep.tokens,
           "preemptions": rep.preemptions, "failures": rep.failures,
           "recoveries": rep.recoveries, "steps_redone": rep.steps_redone,
           "fault_trace": rep.fault_trace, "pass_counts": rep.pass_counts,
           "launches": launches, "expected_launches": want,
           "transfer_bytes": eng.transfer_summary(), "replication_s": cl.replication_s,
           "stream_busy_s": cl.streamer.busy_s,
           "prefill_tokens_saved": rep.prefill_tokens_saved,
           "prefill_tokens_total": rep.prefill_tokens_total}
    if cl.tiered:
        out["tier_stats"] = rep.tier_stats
        out["adoptions_from"] = adoptions
        out["stream_overlap_modeled"] = cl.streamer.overlap_report()
    if rep.recovery_log:
        out["recovery"] = _recovery_times(rep)
    if record:
        out["steps"] = [(n, tag) for p, n, tag in inj.trace if p == "engine.step"]
        out["swap_marks"] = marks
    return out


def _count_adoptions(eng) -> dict:
    """Count the tier hits of prefix adoptions, by tier, from now on (swap
    restores are counted apart, in `tier_stats`)."""
    n = {"host_blocks": 0, "ssd_blocks": 0, "chains": 0}
    for w in eng.cluster.workers():
        if w.tier is None:
            continue
        def counted(hashes, _t=w.tier, _f=w.tier.fetch_prefix_chain):
            h0, s0 = _t.stats().get("host_hits", 0), _t.stats().get("ssd_hits", 0)
            out = _f(hashes)
            n["host_blocks"] += _t.stats().get("host_hits", 0) - h0
            n["ssd_blocks"] += _t.stats().get("ssd_hits", 0) - s0
            n["chains"] += 1
            return out
        w.tier.fetch_prefix_chain = counted
    return n


def _mark_swaps(eng, inj) -> list:
    """Record ("out" | "in", rid, engine.step occurrences so far) at each
    preemption and resumption from now on."""
    marks = []
    cl = eng.cluster
    for kind, name in (("out", "preempt_seq"), ("in", "resume_seq")):
        def marked(rid, _f=getattr(cl, name), _k=kind):
            marks.append((_k, rid, inj.counts.get("engine.step", 0)))
            return _f(rid)
        setattr(cl, name, marked)
    return marks


def fail_points(steps) -> dict:
    """Failure points from a recorded engine.step trace, each the middle of
    its candidates, all while decodes run:

    - ``fail_decode_w1``: worker 1 dies before a fused decode pass, no
      prefill in flight;
    - ``fail_prefill_w0``: worker 0 dies as a prompt's prefill begins (its
      admission step), no other prefill in flight;
    - ``fail_inflight_w1``: worker 1 dies before a fused decode pass while
      prefills are in flight.  Those lose their partial pages and begin
      again, as in the reference, which moves every later batch's shapes."""
    first, last = {}, {}         # rid -> its admission step, its last prefill step
    for n, tag in steps:
        if tag.startswith("r"):
            first.setdefault(int(tag[1:]), n)
        elif tag.startswith("prefill-r"):
            last[int(tag[len("prefill-r"):])] = n

    def in_flight(n):
        return any(first[o] < n <= last.get(o, -1) for o in first)

    dec = [n for n, tag in steps if tag.startswith("decode-")]
    quiet = [n for n in dec if not in_flight(n)]
    busy = [n for n in dec if in_flight(n)]
    alone = sorted(n for rid, n in first.items()
                   if dec[0] < n < dec[-1] and rid in last and not in_flight(n))
    check(bool(quiet) and bool(busy) and bool(alone), "the trace lacks a failure point")
    return {"fail_decode_w1": {quiet[len(quiet) // 2]: 1},
            "fail_prefill_w0": {alone[len(alone) // 2]: 0},
            "fail_inflight_w1": {busy[len(busy) // 2]: 1}}


def phase_recover(state: dict) -> dict:
    """run_continuous with replication: serve's model and trace (bf16, 48
    layers), failure-free with and without replication, then the failures
    of `fail_points`; the same at 4 layers in fp32, where every failure must
    give the failure-free tokens.  At bf16 the first two must too (their
    recovery rolls nothing back, so every later pass has the failure-free
    run's shapes); the third restarts the prefills in flight, and its
    differing tokens are shown beside those of the failure-free run with
    max_active 7 (a GEMM of another M rounds bf16 otherwise)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import DecoderLM
    lens = [int(n) for n in np.random.default_rng(2).integers(64, 513, 16)]   # serve's
    cfg = dataclasses.replace(get_arch("gpt2-1.5b"), dtype="bfloat16")
    t = time.perf_counter()
    model = DecoderLM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    out = {"config": "gpt2-1.5b, 48 layers, bf16, 2 workers, serve's trace",
           "init_s": time.perf_counter() - t}

    def trace():
        return _requests(lens, 32, cfg.vocab_size, seed=3)

    # warm-up: library handles and the first launch of every path
    run_fused(cfg, model, params, lambda: _requests([70, 9], 3, cfg.vocab_size, seed=7),
                replication=True, max_active=2)
    torch.cuda.reset_peak_memory_stats()
    # without and with replication in turns, as the host's noise moves a
    # run's rate by tens of percent
    plain = run_fused(cfg, model, params, trace, replication=False)
    clean = run_fused(cfg, model, params, trace, replication=True, record=True)
    check(clean["tokens"] == plain["tokens"], "replication changed the tokens")
    points = fail_points(clean.pop("steps"))
    out["no_replication"] = {k: v for k, v in plain.items() if k != "tokens"}
    out["replication"] = {k: v for k, v in clean.items() if k != "tokens"}
    again = [run_fused(cfg, model, params, trace, replication=r) for r in (True, False)]
    out["tokens_per_s_in_turns"] = {
        "no_replication": [plain["tokens_per_s"], again[1]["tokens_per_s"]],
        "replication": [clean["tokens_per_s"], again[0]["tokens_per_s"]]}
    control = None
    for name, fail_at in points.items():
        res = run_fused(cfg, model, params, trace, replication=True, fail_at=fail_at)
        check(res["failures"] == 1 and res["recoveries"] == 1, f"{name}: {res['failures']} "
              f"failures, {res['recoveries']} recoveries")
        diff = differing_tokens(res.pop("tokens"), clean["tokens"])
        res.update(fail_at=fail_at, differing_tokens=diff)
        if diff or name == "fail_inflight_w1":
            if control is None:
                ctl = run_fused(cfg, model, params, trace, replication=True, max_active=7)
                control = differing_tokens(ctl["tokens"], clean["tokens"])
            res["control_differing_tokens"] = control
        if name != "fail_inflight_w1":
            check(diff == 0, f"{name}: {diff} tokens differ from the failure-free run "
                  f"({control} in the max_active control)")
        out[name] = res
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model, params
    # the exact gate: fp32, 4 layers, the same trace and failure points
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=4)
    model = DecoderLM(cfg32, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    ref = run_fused(cfg32, model, params, trace, replication=True)
    out["fp32_4_layers"] = {"tokens_per_s": ref["tokens_per_s"]}
    for name, fail_at in points.items():
        res = run_fused(cfg32, model, params, trace, replication=True, fail_at=fail_at)
        check(res["failures"] == 1 and res["recoveries"] == 1, f"fp32 {name}: no recovery")
        check(res["tokens"] == ref["tokens"], f"fp32 {name}: tokens differ from the "
              "failure-free run")
        out["fp32_4_layers"][name] = {"tokens_identical": True,
                                      "steps_redone": res["steps_redone"],
                                      "recovery": res["recovery"]}
    return out


MB_RECOVER = {   # mode -> (engine kwargs, fail_at: {global step: wid})
    # 4 slots: steps 1-4 prefill microbatches 0-3, then 4 decode steps a round
    "colocated": ({}, {67: 2}),
    "swapping": ({"swapping": True}, {67: 1}),
    # 2 slots: microbatch 2's prefill is step 65; its prompt worker dies first
    "disaggregated": ({"mode": "disaggregated", "dp_split": (2, 2)}, {65: 0}),
}


def mb_recover_expected_launches(eng, pc: dict, failed: dict, resumed: int) -> dict:
    """`mb_expected_launches` with replication: one kv_pack per leaf per
    token stage per pass (each replicates its window), one per leaf per
    microbatch the predecessor re-replicated in a recovery, and, for a
    decode pass that a failure cut short, one decode_attention per layer of
    the stages before the dead worker."""
    want = mb_expected_launches(eng, pc)
    cl = eng.cluster
    if cl.replication:
        want["kv_pack"] += 2 * len(cl.token_group) * (pc.get("mb_prefill", 0)
                                                      + pc.get("mb_decode", 0))
    want["kv_pack"] += 2 * resumed
    if failed.get("decode"):
        want["decode_attention"] += failed["decode"]
    return want


def run_mb_recover(cfg, model, params, mode: str, fail_at=None, dev: str = "cuda",
                   plen: int = 512, replication: bool = True) -> dict:
    """run() of mb_serve's trace (16 prompts of `plen` tokens, 32 new,
    microbatch 4) on 4 workers on `dev`, in `mode`, with `fail_at`."""
    import torch

    from repro_torch.core.dejavulib import assert_no_leaks
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import ServingEngine

    kw, _ = MB_RECOVER[mode]
    eng = ServingEngine(cfg, model, params, 4, microbatch=4, replication=replication,
                        device=dev, **kw)
    reqs = _requests([plen] * 16, 32, cfg.vocab_size, seed=5)
    sync = torch.cuda.synchronize if dev != "cpu" else (lambda: None)
    reset_launches()
    sync()
    t = time.perf_counter()
    rep = eng.run(reqs, fail_at=fail_at)
    sync()
    wall = time.perf_counter() - t
    launches = dict(LAUNCHES)
    check(all(len(r.tokens) == 32 for r in reqs), "a request did not emit 32 tokens")
    assert_no_leaks(eng.cluster)
    failed = {}
    for f in rep.fault_trace:       # a token worker dies before a decode step
        dead = next(w for w in eng.cluster.workers() if w.wid == f["wid"])
        if dead in eng.cluster.token_group and mode != "disaggregated":
            failed["decode"] = dead.lo
    want = mb_recover_expected_launches(eng, rep.pass_counts, failed, _resumed_units(eng))
    if dev != "cpu":
        check(launches == want, f"run() {mode}: launches {launches}, the passes say {want}")
    gen = sum(len(r.tokens) for r in reqs)
    out = {"wall_s": wall, "tokens_per_s": gen / wall, "tokens": rep.tokens,
           "failures": rep.failures, "recoveries": rep.recoveries,
           "steps_redone": rep.steps_redone, "fault_trace": rep.fault_trace,
           "pass_counts": rep.pass_counts, "launches": launches, "expected_launches": want,
           "resumed": _resumed_units(eng), "transfer_bytes": eng.transfer_summary(),
           "replication_s": eng.cluster.replication_s,
           "stream_busy_s": eng.cluster.streamer.busy_s}
    if rep.recovery_log:
        out["recovery"] = _recovery_times(rep)
    return out


def phase_mb_recover(state: dict) -> dict:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import DecoderLM
    cfg = dataclasses.replace(get_arch("gpt2-1.5b"), dtype="bfloat16")
    t = time.perf_counter()
    model = DecoderLM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    out = {"config": "gpt2-1.5b, 48 layers, bf16, 4 workers, microbatch 4, "
                     "16 prompts of 512 tokens, 32 new, replication",
           "init_s": time.perf_counter() - t}
    # warm-up: library handles and the first launch of every path
    from repro_torch.serving import ServingEngine
    ServingEngine(cfg, model, params, 4, microbatch=4, replication=True,
                  device="cuda").run(_requests([16] * 4, 3, cfg.vocab_size, seed=7))
    plain = run_mb_recover(cfg, model, params, "colocated", replication=False)
    out["colocated_no_replication"] = {k: v for k, v in plain.items() if k != "tokens"}
    for mode, (_, fail_at) in MB_RECOVER.items():
        clean = run_mb_recover(cfg, model, params, mode)
        if mode == "colocated":
            check(clean["tokens"] == plain["tokens"], "replication changed the tokens")
        res = run_mb_recover(cfg, model, params, mode, fail_at)
        check(res["failures"] == 1 and res["recoveries"] == 1,
              f"run() {mode}: {res['failures']} failures, {res['recoveries']} recoveries")
        # a re-executed step has the same microbatch and shapes: bit for bit
        check(res.pop("tokens") == clean.pop("tokens"),
              f"run() {mode}: tokens differ from the failure-free run")
        out[mode] = {"fail_at": fail_at, "tokens_identical": True,
                     "replication": clean, "failure": res}
    return out


# ---------------------------------------------------------------------------
# phase 11: telemetry, tracing and the modeled clock
# ---------------------------------------------------------------------------

# the serving modes the phase runs in turns: a registry and a tracer
# installed around the run; the engine's own registry for the run
TELEMETRY_MODES = ("instrumented", "default")
# rounds of the two modes, the order flipped each round: the host's rate
# drifts by tens of percent within a call, so a mode never runs only early
# or only late
TELEMETRY_ROUNDS = 6
# the pass kinds of a fused continuous run, and the cluster method of each
PASS_METHODS = {"fused_decode": "decode_batch", "chunkset": "prefill_chunkset_pass",
                "prefill_chunk": "prefill_seq_step"}


def observed_run(eng, trace, mode: str, sync, *, fail_at=None, inj=None,
                 instruments=None) -> dict:
    """One `run_continuous` of `trace()` in `mode` (`TELEMETRY_MODES`),
    instrumented with `instruments` (a registry and a tracer) or fresh
    ones.  Returns its tokens/s and report and, instrumented, the
    registry's and the tracer's JSON."""
    from repro_torch.core import telemetry, tracing
    reqs = trace()
    reg = tracer = None
    if mode == "instrumented":
        reg, tracer = instruments or (telemetry.Telemetry(), tracing.Tracer())
        prev_t, prev_r = telemetry.install(reg), tracing.install(tracer)
    try:
        sync()
        t = time.perf_counter()
        rep = eng.run_continuous(reqs, max_active=8, fail_at=fail_at, fault_injector=inj)
        sync()
        wall = time.perf_counter() - t
    finally:
        if reg is not None:
            tracing.uninstall(prev_r)
            telemetry.uninstall(prev_t)
    check(all(len(r.tokens) == r.max_new for r in reqs), "a request fell short")
    out = {"tokens_per_s": sum(len(r.tokens) for r in reqs) / wall, "wall_s": wall,
           "report": rep}
    if reg is not None:
        out["snapshot"], out["trace"] = reg.to_json(), tracer.to_json()
    return out


def slo_quantiles(snapshot: dict) -> dict:
    """p50 and p99, in modeled ms, of the SLO histograms of a snapshot."""
    return {name: {"count": h["count"], "p50_ms": h["p50_s"] * 1e3, "p99_ms": h["p99_s"] * 1e3}
            for name, h in snapshot["histograms"].items()
            if name in ("engine.ttft_s", "engine.inter_token_s", "cluster.recovery_s",
                        "engine.queue_wait_s")}


def counted_instruments():
    """A registry and a tracer that count the calls of each of their
    recording methods.  Returns (registry, tracer, {method: calls})."""
    from collections import Counter

    from repro_torch.core import telemetry, tracing
    calls = Counter()
    reg, tracer = telemetry.Telemetry(), tracing.Tracer()
    for obj, names in ((reg, ("count", "observe", "gauge", "advance", "span")),
                       (tracer, ("event", "span"))):
        for name in names:
            def counted(*a, _fn=getattr(obj, name), _key=f"{type(obj).__name__}.{name}", **kw):
                calls[_key] += 1
                return _fn(*a, **kw)
            setattr(obj, name, counted)
    return reg, tracer, calls


def per_call_us(cfg) -> dict:
    """Host µs of one call of each recording method through its module
    helper, with a registry and a tracer installed ("off": with none, the
    `is None` check), and of one cost-model evaluation of a pass."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core import telemetry, tracing
    from repro_torch.core.dejavulib.transport import DEFAULT_HW
    rids = list(range(8))

    def span_t():
        with telemetry.span("pass", kind="fused_decode"):
            pass

    def span_r():
        with tracing.span("pass", kind="fused_decode", rids=rids):
            pass

    fns = {"Telemetry.count": lambda: telemetry.count("worker.stage_calls", 1, wid=1),
           "Telemetry.observe": lambda: telemetry.observe("engine.inter_token_s", 3e-4),
           "Telemetry.gauge": lambda: telemetry.gauge("engine.bubble_frac", 0.5),
           "Telemetry.advance": lambda: telemetry.advance(1e-4),
           "Telemetry.span": span_t,
           "Tracer.event": lambda: tracing.event("stage.decode_batch", track="w1", n=8),
           "Tracer.span": span_r,
           "costmodel": lambda: cm.decode_round_time(cfg, 8, 450, cfg.num_layers, 8,
                                                     DEFAULT_HW)}

    def timed(fn, n=20000):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) / n * 1e6

    out = {"off": timed(fns["Telemetry.count"])}
    prev_t = telemetry.install(telemetry.Telemetry())
    prev_r = tracing.install(tracing.Tracer())
    try:
        out.update({k: timed(fn) for k, fn in fns.items()})
    finally:
        tracing.uninstall(prev_r)
        telemetry.uninstall(prev_t)
    return out


# the cost-model functions the cluster charges its passes with
PASS_COSTS = ("stage_prompt_time", "stage_token_time", "chunked_prefill_pass_time",
              "decode_round_time")


def one_card_costmodel(running: list, one_card: dict):
    """A stand-in for the cluster's `costmodel`: each of `PASS_COSTS`
    returns the engine's modeled time (an 8-GPU node per stage) and adds
    the same call's time on one card (``chips=1``) to
    ``one_card[running[-1]]``, the pass kind being timed."""
    import inspect
    import types

    from repro_torch.core import costmodel as cm

    def on_one_card(fn):
        sig = inspect.signature(fn)

        def wrapper(*a, **kw):
            if running:
                bound = sig.bind(*a, **kw)
                bound.arguments["chips"] = 1
                one_card[running[-1]] += fn(*bound.args, **bound.kwargs)
            return fn(*a, **kw)
        return wrapper
    names = {k: v for k, v in vars(cm).items() if not k.startswith("__")}
    names.update({k: on_one_card(names[k]) for k in PASS_COSTS})
    return types.SimpleNamespace(**names)


def modeled_against_measured(eng, trace, sync) -> dict:
    """An instrumented run with each pass kind's wall time taken around it
    (synchronised), its modeled time from the snapshot's span aggregates
    (the engine's model: an 8-GPU node per stage) and from the same
    cost-model calls charged to the one card that ran the pipeline.  Also
    records the `engine.step` trace, which picks the failure point of the
    recovery run, and counts the recording calls.  Returns ({kind: modeled
    and measured ms}, the recorded steps, {method: calls})."""
    from repro_torch.core import cluster as cluster_mod
    from repro_torch.core.dejavulib import FaultInjector
    cl = eng.cluster
    buckets = {kind: [] for kind in PASS_METHODS}
    one_card = dict.fromkeys(PASS_METHODS, 0.0)
    running = []

    def timed_pass(fn, kind):
        timed = _timed(fn, buckets[kind], sync)

        def wrapper(*a, **kw):
            running.append(kind)
            try:
                return timed(*a, **kw)
            finally:
                running.pop()
        return wrapper
    for kind, name in PASS_METHODS.items():
        setattr(cl, name, timed_pass(getattr(cl, name), kind))
    cm = cluster_mod.cm
    cluster_mod.cm = one_card_costmodel(running, one_card)
    inj = FaultInjector(record=True)
    reg, tracer, calls = counted_instruments()
    try:
        res = observed_run(eng, trace, "instrumented", sync, inj=inj, instruments=(reg, tracer))
    finally:
        cluster_mod.cm = cm
        for name in PASS_METHODS.values():
            vars(cl).pop(name)
    spans = json.loads(res["snapshot"])["spans"]
    rows = {}
    for kind, ms in buckets.items():
        agg = spans.get(f"round/pass[kind={kind}]")
        check(agg is not None and agg["count"] == len(ms),
              f"{kind}: {len(ms)} timed passes, spans {agg}")
        modeled = agg["total_s"] / agg["count"] * 1e3
        one = one_card[kind] / len(ms) * 1e3
        measured = statistics.median(ms)
        rows[kind] = {"passes": len(ms), "modeled_ms": modeled, "modeled_ms_one_h100": one,
                      "measured_median_wall_ms": measured,
                      "measured_over_modeled": measured / modeled,
                      "measured_over_modeled_one_h100": measured / one}
    steps = [(n, tag) for p, n, tag in inj.trace if p == "engine.step"]
    return rows, steps, dict(calls)


def link_rates(nbytes: int = 1 << 28) -> dict:
    """Measured GB/s of what `HardwareModel`'s host figures describe: a copy
    in host memory and pinned copies over the host link, each direction."""
    import torch
    host_a = torch.empty(nbytes, dtype=torch.uint8)
    host_b = torch.empty(nbytes, dtype=torch.uint8)
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")

    def rate(fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        return 3 * nbytes / (time.perf_counter() - t) / 1e9

    return {"host_memcpy_gb_s": rate(lambda: host_b.copy_(host_a)),
            "pinned_to_device_gb_s": rate(lambda: dev.copy_(pinned, non_blocking=True)),
            "device_to_pinned_gb_s": rate(lambda: pinned.copy_(dev, non_blocking=True))}


def run_telemetry(cfg, dev: str, lens, generator, sync, pool_blocks: int = 1024) -> dict:
    """(a)-(d) of the `telemetry` phase for `lens`-long prompts (32 new
    tokens each, at most 8 active) on `dev`.  Launches are checked on a
    card only."""
    from repro_torch.core.dejavulib.transport import DEFAULT_HW
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serving import ServingEngine
    model = DecoderLM(cfg, device=dev)
    params = model.init(generator)

    def trace():
        return _requests(lens, 32, cfg.vocab_size, seed=3)

    eng = ServingEngine(cfg, model, params, 2, paged=True, kv_pool_blocks=pool_blocks,
                        device=dev)
    eng.run_continuous(_requests([70, 9], 3, cfg.vocab_size, seed=7), max_active=2)   # warm-up
    runs = {m: [] for m in TELEMETRY_MODES}
    order = []
    for r in range(TELEMETRY_ROUNDS):
        order += TELEMETRY_MODES[::-1] if r % 2 else TELEMETRY_MODES
    for mode in order:
        reset_launches()
        res = observed_run(eng, trace, mode, sync)
        res["launches"] = dict(LAUNCHES)
        runs[mode].append(res)
    first = runs["instrumented"][0]
    for again in runs["instrumented"][1:]:
        check(again["snapshot"] == first["snapshot"], "instrumented runs gave other snapshots")
        check(again["trace"] == first["trace"], "instrumented runs gave other dumps")
    want = serve_expected_launches(eng, first["report"].pass_counts)
    if dev != "cpu":
        check(first["launches"] == want, f"launches {first['launches']}, the passes say {want}")
    tokens = first["report"].tokens
    for mode, rs in runs.items():
        check(all(r["report"].tokens == tokens for r in rs), f"{mode}: other tokens")
        check(all(r["launches"] == first["launches"] for r in rs), f"{mode}: other launches")
    snap = json.loads(first["snapshot"])
    dump = json.loads(first["trace"])
    out = {"hardware_model": dataclasses.asdict(DEFAULT_HW),
           "identical_snapshots_and_dumps": True,
           "snapshot_bytes": len(first["snapshot"]), "trace_bytes": len(first["trace"]),
           "trace_events": sum(t["emitted"] for t in dump["tracks"].values()),
           "turn_order": order,
           "tokens_per_s_in_turns": {m: [r["tokens_per_s"] for r in rs]
                                     for m, rs in runs.items()},
           "median_tokens_per_s": {m: statistics.median(r["tokens_per_s"] for r in rs)
                                   for m, rs in runs.items()},
           "modeled_clock_s": snap["clock_s"],
           "modeled_h100_datasheet_slo": slo_quantiles(snap)}
    rows, steps, calls = modeled_against_measured(eng, trace, sync)
    out["pass_times_modeled_vs_measured"] = rows
    # the instruments' host cost: each recording method's calls in one run
    # times its measured cost per call, against the run's wall time
    us = per_call_us(cfg)
    passes = sum(n for k, n in first["report"].pass_counts.items() if k != "one_token")
    cost_s = (sum(n * us[k] for k, n in calls.items()) + passes * us["costmodel"]) / 1e6
    wall = statistics.median(r["wall_s"] for r in runs["instrumented"])
    out["instrument_cost"] = {"calls_per_run": calls, "per_call_us": us, "passes": passes,
                              "estimated_s_per_run": cost_s, "run_wall_s": wall,
                              "estimated_share": cost_s / wall}
    # (d): a recover-style run, worker 1 lost before a fused decode pass
    fail_at = fail_points(steps)["fail_decode_w1"]
    rep_eng = ServingEngine(cfg, model, params, 2, paged=True, kv_pool_blocks=pool_blocks,
                            replication=True, device=dev)
    res = observed_run(rep_eng, trace, "instrumented", sync, fail_at=fail_at)
    fsnap = json.loads(res["snapshot"])
    check(res["report"].recoveries == 1 and
          fsnap["histograms"]["cluster.recovery_s"]["count"] == 1, "no modeled recovery time")
    out["recover_run"] = {"fail_at": fail_at, "tokens_per_s": res["tokens_per_s"],
                          "modeled_h100_datasheet_slo": slo_quantiles(fsnap),
                          "wall_recovery": res["report"].recovery_log[0]}
    return out


def phase_telemetry(state: dict) -> dict:
    """`serve`'s model and trace (gpt2-1.5b, 48 layers, bf16, 2 workers),
    with the telemetry registry and the tracer: (a) every instrumented run
    must give the same snapshot and dump, byte for byte, and launch the
    kernels as its passes say; (b) tokens/s instrumented and with the
    engine's own registry, in `TELEMETRY_ROUNDS` rounds of turns, all with
    the same tokens, and the instruments' host cost from their calls; (c)
    each pass kind's modeled time, for the engine's 8-GPU stage and for
    one H100, beside its measured median wall time; (d) the modeled SLO quantiles of
    a run with replication whose worker 1 dies before a fused decode pass.
    Modeled times use the H100 datasheet figures (`DEFAULT_HW`)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    lens = [int(n) for n in np.random.default_rng(2).integers(64, 513, 16)]   # serve's
    cfg = dataclasses.replace(get_arch("gpt2-1.5b"), dtype="bfloat16")
    out = {"config": "gpt2-1.5b, 48 layers, bf16, 2 workers, serve's trace",
           **run_telemetry(cfg, "cuda", lens, torch.Generator(device="cuda").manual_seed(0),
                           torch.cuda.synchronize)}
    out["link_rates_measured"] = link_rates()
    return out


# ---------------------------------------------------------------------------
# phase 12: paged swapping, disaggregation and the KV tiers
# ---------------------------------------------------------------------------

# the serve trace's modes (2 stage workers): (a) swapping, (b) the
# prompt/token split, and the colocated run both are held against
PAGED_MODES = {"colocated": {}, "swapping": {"swapping": True},
               "disaggregated": {"mode": "disaggregated", "dp_split": (1, 1)}}
# (c) the shared-prefix trace through the tiers: a pool of 120 blocks a
# stage holds three or four of its requests, so decodes preempt through
# the tiers, and a host tier of 96 blocks spills to SSD, so an adopted
# system prompt comes from the host tier one time and from SSD another
# (sized by running the trace's geometry through the port on the CPU)
TIERED = {"kv_pool_blocks": 120, "tiered": True, "host_cache_blocks": 96,
          "ssd_cache_blocks": 4096}
NOT_TIERED = {"kv_pool_blocks": 120}
# the pool holds at most four of the trace's requests at once, so the bf16
# control of (c) and (d), the tiered run at another max_active, takes 3 (7,
# as for serve's trace, would change no batch)
TIERED_CONTROL_ACTIVE = 3
SYSTEM_PROMPT_TOKENS = 256
# the phase runs some fifteen bf16 serving runs and an exact gate on the
# CPU: half of serve's depth keeps the whole script near half its 1200 s
# (the schedule, and so every count but the bytes, does not depend on the
# depth); the gate keeps 4 layers, 2 a stage, so the layer axis of the
# packed blocks is held exactly
PAGED_MODES_LAYERS = 24
PAGED_MODES_EXACT_LAYERS = 4


def shared_prefix_trace(vocab: int, seed: int = 4, max_new: int = 32):
    """16 requests: one 256-token system prompt (32 blocks of 8), then a
    64-256-token suffix each, drawn from `seed`: chat and agent serving,
    where every request opens with the same instructions."""
    import numpy as np

    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, SYSTEM_PROMPT_TOKENS).astype(np.int32)
    return [Request(rid=i, prompt=np.concatenate(
                [system, rng.integers(0, vocab, int(n)).astype(np.int32)]), max_new=max_new)
            for i, n in enumerate(rng.integers(64, 257, 16))]


def swapped_out_fail_point(steps, marks) -> dict:
    """Worker 1 dies before a fused decode pass while a sequence is swapped
    out through the tiers: the middle such step of a recorded run."""
    def out_at(n):
        state = {}
        for kind, rid, c in marks:
            if c < n:
                state[rid] = kind
        return any(k == "out" for k in state.values())

    cands = [n for n, tag in steps if tag.startswith("decode-") and out_at(n)]
    check(bool(cands), "no decode pass ran while a sequence was swapped out")
    return {cands[len(cands) // 2]: 1}


def tier_link_rates(shape, dtype, n: int = 128) -> dict:
    """Measured GB/s of the tiers' copies at the run's block shape: pinned
    copies over the host link each way (queued, then synchronised), and
    `SSDStore` puts (fsync'd) and gets of whole blocks."""
    import shutil
    import tempfile

    import torch

    from repro_torch.core.dejavulib import SSDStore
    dev = torch.randn((n,) + tuple(shape), device="cuda").to(dtype)
    host = torch.empty(dev.shape, dtype=dtype, pin_memory=True)
    nbytes = dev.numel() * dev.element_size()

    def rate(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return reps * nbytes / (time.perf_counter() - t) / 1e9

    def per_block(dst, src):
        for i in range(n):
            dst[i].copy_(src[i], non_blocking=True)

    root = tempfile.mkdtemp(prefix="chip-smoke-ssd-")
    try:
        store = SSDStore(root)
        t = time.perf_counter()
        for i in range(n):
            store.put(f"b{i}", host[i])
        put_s = time.perf_counter() - t
        t = time.perf_counter()
        for i in range(n):
            store.get(f"b{i}", dtype=dtype)
        get_s = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"block_bytes": nbytes // n, "blocks": n,
            "device_to_pinned_gb_s": rate(lambda: per_block(host, dev)),
            "pinned_to_device_gb_s": rate(lambda: per_block(dev, host)),
            "ssd_put_fsync_gb_s": nbytes / put_s / 1e9, "ssd_get_gb_s": nbytes / get_s / 1e9}


def _without(res: dict, *keys) -> dict:
    return {k: v for k, v in res.items() if k not in keys}


def paged_modes_exact(cfg, model, params, dev: str, serve_trace, tiered_trace,
                      fail_at=None) -> dict:
    """The phase's four runs on `dev`: (a) swapping and (b) disaggregated
    on the serve trace, (c) tiered on the shared-prefix trace, (d) tiered
    with replication and worker 1 lost while a sequence is swapped out (at
    `fail_at`, else at the point a recorded run picks, and then the plain
    run of each trace, the colocated run without tiers or swapping, too).
    Returns the tokens of each, the plain runs' and the failure point."""
    def tokens(trace, **kw):
        return run_fused(cfg, model, params, trace, dev=dev, **kw)["tokens"]

    out = {mode: tokens(serve_trace, **PAGED_MODES[mode])
           for mode in ("swapping", "disaggregated")}
    out["tiered"] = tokens(tiered_trace, **TIERED)
    plain = None
    if fail_at is None:
        plain = {"swapping": tokens(serve_trace)}
        plain["disaggregated"] = plain["swapping"]
        plain["tiered"] = plain["tiered_failure"] = tokens(tiered_trace, **NOT_TIERED)
        clean = run_fused(cfg, model, params, tiered_trace, dev=dev, replication=True,
                          record=True, **TIERED)
        fail_at = swapped_out_fail_point(clean["steps"], clean["swap_marks"])
    res = run_fused(cfg, model, params, tiered_trace, dev=dev, replication=True,
                    fail_at=fail_at, **TIERED)
    check(res["failures"] == 1 and res["recoveries"] == 1, f"{dev}: no recovery")
    out["tiered_failure"] = res["tokens"]
    return {"tokens": out, "plain": plain, "fail_at": fail_at}


def paged_modes_runs(cfg, model, params, dev: str, serve_trace, tiered_trace) -> dict:
    """(a)-(d) of the `paged_modes` phase on `dev`: the serve trace's modes
    in turns, the shared-prefix trace with and without the tiers in turns,
    and the failure under the tiers; every run's launches checked, each
    mode's differing tokens beside a control's (another max_active)."""
    out = {}
    runs = {m: [] for m in PAGED_MODES}
    for mode in list(PAGED_MODES) + list(PAGED_MODES)[::-1]:
        runs[mode].append(run_fused(cfg, model, params, serve_trace, dev=dev,
                                         **PAGED_MODES[mode]))
    base = runs["colocated"][0]["tokens"]
    control = differing_tokens(run_fused(cfg, model, params, serve_trace, dev=dev,
                                              max_active=7)["tokens"], base)
    for mode, rs in runs.items():
        out[mode] = {"tokens_per_s_in_turns": [r["tokens_per_s"] for r in rs],
                     "differing_tokens": differing_tokens(rs[0]["tokens"], base),
                     "control_differing_tokens": control, **_without(rs[0], "tokens")}
    # (c): the shared-prefix trace with and without the tiers, in turns
    tiered, plain = [], []
    for tiers in (True, False, False, True):
        r = run_fused(cfg, model, params, tiered_trace, dev=dev,
                           **(TIERED if tiers else NOT_TIERED))
        (tiered if tiers else plain).append(r)
    t0 = tiered[0]
    st, ad = t0["tier_stats"], t0["adoptions_from"]
    check(t0["preemptions"] >= 1, "no preemption through the tiers")
    check(st.get("spills", 0) >= 1, "no spill to SSD")
    check(ad["host_blocks"] >= 1 and ad["ssd_blocks"] >= 1,
          f"adoptions not served from both tiers: {ad}")
    check(all(r["tokens"] == t0["tokens"] for r in tiered[1:]), "tiered runs disagree")
    ctl = run_fused(cfg, model, params, tiered_trace, dev=dev,
                         max_active=TIERED_CONTROL_ACTIVE, **TIERED)
    out["tiered_vs_not"] = {
        "tokens_per_s_in_turns": {"tiered": [r["tokens_per_s"] for r in tiered],
                                  "not_tiered": [r["tokens_per_s"] for r in plain]},
        "prefill_saved_share": t0["prefill_tokens_saved"] / t0["prefill_tokens_total"],
        "differing_tokens": differing_tokens(t0["tokens"], plain[0]["tokens"]),
        "control_differing_tokens": differing_tokens(ctl["tokens"], t0["tokens"]),
        "tiered": _without(t0, "tokens"), "not_tiered": _without(plain[0], "tokens")}
    # (d): a failure under the tiers while a sequence is swapped out
    clean = run_fused(cfg, model, params, tiered_trace, dev=dev, replication=True,
                           record=True, **TIERED)
    fail_at = swapped_out_fail_point(clean.pop("steps"), clean.pop("swap_marks"))
    res = run_fused(cfg, model, params, tiered_trace, dev=dev, replication=True,
                         fail_at=fail_at, **TIERED)
    check(res["failures"] == 1 and res["recoveries"] == 1, "(d): no recovery")
    ctl = run_fused(cfg, model, params, tiered_trace, dev=dev, replication=True,
                         max_active=TIERED_CONTROL_ACTIVE, **TIERED)
    out["tiered_failure"] = {
        "fail_at": fail_at, "differing_tokens": differing_tokens(res["tokens"], clean["tokens"]),
        "control_differing_tokens": differing_tokens(ctl["tokens"], clean["tokens"]),
        "replication": _without(clean, "tokens"), "failure": _without(res, "tokens")}
    return out


def tokens_across_devices(cfg, runs, devs=("cuda", "cpu")) -> tuple:
    """One set of weights, drawn on the first of `devs` and copied to each,
    through ``runs(model, params, dev, first)`` on each device, `first`
    being what the call on the first device returned (None there): a dict
    whose "tokens" maps each run's name to its tokens.  Every run's tokens
    must equal those of the first device's run of that name.  Returns the
    first device's result and the seconds on each device."""
    import torch

    from repro_torch.models.transformer import DecoderLM
    params0 = DecoderLM(cfg, device=devs[0]).init(
        torch.Generator(device=devs[0]).manual_seed(0))
    res, seconds = {}, {}
    for dev in devs:
        t = time.perf_counter()
        res[dev] = runs(DecoderLM(cfg, device=dev), _to(params0, dev), dev, res.get(devs[0]))
        seconds[dev] = time.perf_counter() - t
    first = res[devs[0]]
    for dev in devs[1:]:
        for k, toks in res[dev]["tokens"].items():
            check(toks == first["tokens"][k], f"{cfg.name} {cfg.dtype} {k}: {dev} tokens "
                  f"differ from {devs[0]}'s")
    return first, seconds


def exact_paged_modes(cfg, serve_trace, tiered_trace, devs=("cuda", "cpu")) -> dict:
    """`paged_modes_exact` on each of `devs` with one set of weights, the
    plain runs and the failure point on the first: every run's tokens equal
    across the devices and equal to the plain run of its trace."""
    def runs(model, params, dev, first):
        return paged_modes_exact(cfg, model, params, dev, serve_trace, tiered_trace,
                                 fail_at=None if first is None else first["fail_at"])

    first, seconds = tokens_across_devices(cfg, runs, devs)
    for k, toks in first["tokens"].items():
        check(toks == first["plain"][k], f"{cfg.dtype} {k}: tokens differ from the plain run")
    return {"tokens_identical": True, "fail_at": first["fail_at"], "seconds": seconds}


def phase_paged_modes(state: dict) -> dict:
    """gpt2-1.5b at full width, 24 layers, bf16, 2 workers, fused rounds:
    (a) swapping and (b) disaggregated (1, 1) on serve's trace, in turns
    with the colocated run; (c) the shared-prefix trace through the KV
    tiers, in turns with the same trace without them; (d) (c) with
    replication, worker 1 lost while a sequence is swapped out.  Every run's
    launches exact; the bf16 differing tokens of each beside a control (the
    run with another max_active); then the same four at 4 layers in fp32,
    whose tokens must equal the port's on the CPU and the plain run's.  Prints
    tokens/s by mode, the prefill tokens saved, the tier counters, bytes by
    transport, the tier copies' rates and the time to recover by step.  The
    tiers' disks lie under `--out` and are removed after each run."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import DecoderLM
    lens = [int(n) for n in np.random.default_rng(2).integers(64, 513, 16)]   # serve's
    cfg = dataclasses.replace(get_arch("gpt2-1.5b"), num_layers=PAGED_MODES_LAYERS,
                              dtype="bfloat16")

    def serve_trace():
        return _requests(lens, 32, cfg.vocab_size, seed=3)

    def tiered_trace():
        return shared_prefix_trace(cfg.vocab_size)

    prev_tmp = tempfile.tempdir
    ssd = Path(state["out"]) / "ssd"
    ssd.mkdir(parents=True, exist_ok=True)
    tempfile.tempdir = str(ssd)
    try:
        t = time.perf_counter()
        model = DecoderLM(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        out = {"config": f"gpt2-1.5b, {PAGED_MODES_LAYERS} layers, bf16, 2 workers, "
                         "fused rounds",
               "init_s": time.perf_counter() - t, "tiers": dict(TIERED)}
        # warm-up: library handles and the first launch of every path
        run_fused(cfg, model, params,
                  lambda: _requests([70, 9], 3, cfg.vocab_size, seed=7), max_active=2,
                  **TIERED)
        torch.cuda.reset_peak_memory_stats()
        out.update(paged_modes_runs(cfg, model, params, "cuda", serve_trace, tiered_trace))
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["tier_link_rates"] = tier_link_rates(
            (2, cfg.num_layers // 2, cfg.kv_block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim), torch.bfloat16)
        del model, params
        # the exact gate: fp32, the card against the port on the CPU
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out[f"fp32_{PAGED_MODES_EXACT_LAYERS}_layers"] = exact_paged_modes(
            dataclasses.replace(cfg, dtype="float32", num_layers=PAGED_MODES_EXACT_LAYERS),
            serve_trace, tiered_trace)
    finally:
        tempfile.tempdir = prev_tmp
    return out

# ---------------------------------------------------------------------------
# phases 13 and 14: the moe family, and nemotron's head dim of 192
# ---------------------------------------------------------------------------

MOE_SERVE_LAYERS = 8      # 4 a worker: about 11.2 GB of bf16 weights at full width


def moe_exact(cfg, trace, devs=("cuda", "cpu")) -> dict:
    """`trace` through `run_continuous` on each of `devs` with one set of
    weights: fused rounds, the per-sequence path, a replicated run, and the
    replicated run losing worker 1 at the middle fused decode step of the
    first device's recorded run; launches exact on the card.  Every run's
    tokens must equal the first device's fused run's."""
    def runs(model, params, dev, first):
        kw = dict(dev=dev, max_active=4, pool_blocks=64)
        out = {"fused": run_fused(cfg, model, params, trace, **kw)["tokens"],
               "per_sequence": run_fused(cfg, model, params, trace, fused_rounds=False,
                                         **kw)["tokens"]}
        fail_at = None if first is None else first["fail_at"]
        clean = run_fused(cfg, model, params, trace, replication=True, record=fail_at is None,
                          **kw)
        if fail_at is None:
            dec = [n for n, tag in clean["steps"] if tag.startswith("decode-")]
            fail_at = {dec[len(dec) // 2]: 1}
        res = run_fused(cfg, model, params, trace, replication=True, fail_at=fail_at, **kw)
        check(res["failures"] == 1 and res["recoveries"] == 1, f"{dev}: no recovery")
        out.update(replicated=clean["tokens"], failure=res["tokens"])
        return {"tokens": out, "fail_at": fail_at}

    first, seconds = tokens_across_devices(cfg, runs, devs)
    for k, toks in first["tokens"].items():
        check(toks == first["tokens"]["fused"], f"{cfg.name} fp32 {k}: tokens differ from "
              "the fused run")
    return {"tokens_identical": True, "runs": list(first["tokens"]),
            "fail_at": first["fail_at"], "seconds": seconds}


def phase_moe(state: dict) -> dict:
    """qwen3-moe-30b-a3b at full width (d 2048, 32:4 heads of 128, 128
    experts top-8 of d_ff 768, vocab 151,936), cut to 8 layers, bf16, 2
    workers, on serve's trace (16 prompts of 64-512 tokens, 32 new, 8
    active): tokens/s, the pass medians, launches exact.  Then at 2 layers
    in fp32 on 4 requests of 16-40 tokens: the card's tokens equal the
    CPU's, fused, per sequence and with replication losing worker 1."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    lens = [int(n) for n in np.random.default_rng(2).integers(64, 513, 16)]   # serve's
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b"), num_layers=MOE_SERVE_LAYERS,
                              dtype="bfloat16")
    res, eng = run_serve(cfg, "cuda", lens, max_new=32, max_active=8, pool_blocks=1024,
                         generator=torch.Generator(device="cuda").manual_seed(0),
                         sync=torch.cuda.synchronize)
    out = {"config": f"qwen3-moe-30b-a3b full width, {MOE_SERVE_LAYERS} layers, bf16, "
                     "2 workers", **res,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    del eng
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    out["fp32_2_layers"] = moe_exact(
        cfg32, lambda: _requests([16, 40, 23, 31], 8, cfg32.vocab_size, seed=6))
    return out


def wide_heads_runs(cfg, model, params, dev: str, lens, sync) -> dict:
    """(a) `run_continuous` of `lens`-long prompts, 16 new tokens each, and
    (b) `run()` of 4 prompts of 256 tokens in microbatches of 2, colocated;
    launches exact in both."""
    a, eng = run_serve(cfg, dev, lens, max_new=16, max_active=8, pool_blocks=512,
                       generator=None, sync=sync, weights=(model, params))
    del eng
    b, eng = run_mb_serve(cfg, dev, model, params, 4, 256, 16, 2, MB_MODES["colocated"], sync)
    return {"run_continuous": a, "run": b}


# the bodies nemotron's attention must run at head dim 192 in bf16, by the
# names in a profile: rows 4 and 5 on the decode body's tensor-core instance
# (G 12), row 7's unsplit prefill on the two-consumer flash body
WIDE_HEADS_BODIES = ("valid_decode_mma_kernel<192>", "paged_decode_mma_kernel<192>",
                     "flash_wgmma_ws_kernel<192>")


def wide_heads_bodies(cfg, model, params) -> list:
    """The attention kernels that a short run of each path launches, by the
    profiler's names: `run_continuous` on two prompts (rows 5 and 6) and
    `run()` on a microbatch of two (rows 7 and 4), 4 new tokens each.  Each
    of WIDE_HEADS_BODIES must be among them, and no CUDA-core decode body."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import ServingEngine
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_fused(cfg, model, params, lambda: _requests([40, 70], 4, cfg.vocab_size, seed=8),
                  max_active=2, pool_blocks=64)
        ServingEngine(cfg, model, params, 2, microbatch=2, device="cuda").run(
            _requests([64, 64], 4, cfg.vocab_size, seed=8))
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if any(w in e.key for w in ("decode", "flash", "prefill"))})
    for body in WIDE_HEADS_BODIES:
        check(any(body in n for n in names), f"nemotron's heads did not run {body}: {names}")
    check(not any("decode_split_kernel" in n for n in names),
          f"nemotron's bf16 decode ran a CUDA-core body: {names}")
    return names


def wide_heads_exact(cfg, lens, devs=("cuda", "cpu")) -> dict:
    """The tokens of `run_continuous` on `lens`-long prompts and of `run()`
    (microbatches of 2) on each of `devs`, with one set of weights: equal
    across the devices."""
    from repro_torch.serving import ServingEngine

    def runs(model, params, dev, first):
        def trace():
            return _requests(lens, 8, cfg.vocab_size, seed=8)
        mb = ServingEngine(cfg, model, params, 2, microbatch=2, device=dev)
        return {"tokens": {
            "run_continuous": run_fused(cfg, model, params, trace, dev=dev, max_active=4,
                                        pool_blocks=64)["tokens"],
            "run": mb.run(trace()).tokens}}

    _, seconds = tokens_across_devices(cfg, runs, devs)
    return {"tokens_identical": True, "seconds": seconds}


def phase_wide_heads(state: dict) -> dict:
    """nemotron-4-340b at full width (d 18,432, 96:8 heads of 192, relu2
    d_ff 73,728, layernorm, vocab 256,000), cut to 2 layers, bf16, 2
    workers: (a) `run_continuous` on 8 prompts of 64-256 tokens, 16 new,
    which runs rows 5 and 6 at head dim 192; (b) `run()` in microbatches
    of 2, colocated, which runs rows 4 and 7 there; a short profiled run of
    each path names the bodies (`WIDE_HEADS_BODIES`).  Then the card against
    the CPU in fp32 at nemotron's attention widths (96:8 heads of 192, d
    18,432), cut to d_ff 1,024, vocab 4,096 and 2 layers: tokens equal on
    both paths."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import DecoderLM
    cfg = dataclasses.replace(get_arch("nemotron-4-340b"), num_layers=2, dtype="bfloat16")
    t = time.perf_counter()
    model = DecoderLM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    out = {"config": "nemotron-4-340b full width, 2 layers, bf16, 2 workers",
           "init_s": time.perf_counter() - t,
           "init_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "weights_gib": sum(p.numel() * p.element_size()
                              for p in _leaves(params)) / 2**30}
    lens = [int(n) for n in np.random.default_rng(9).integers(64, 257, 8)]
    out.update(wide_heads_runs(cfg, model, params, "cuda", lens, torch.cuda.synchronize))
    for path, kernels in (("run_continuous", PAGED_KERNELS),
                          ("run", ("flash_attention", "decode_attention"))):
        check(all(out[path]["launches"][k] > 0 for k in kernels),
              f"{path} did not launch {kernels} at head dim 192")
    out["attention_kernels"] = wide_heads_bodies(cfg, model, params)
    del model, params
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32", d_ff=1024, vocab_size=4096)
    out["fp32_attention_widths"] = {
        "cuts": "d_ff 73,728 -> 1,024, vocab 256,000 -> 4,096, 96 -> 2 layers",
        **wide_heads_exact(cfg32, [16, 40, 23, 31])}
    return out


# ---------------------------------------------------------------------------
# phase 15: training (dense and moe), through the flash forward and backward
# ---------------------------------------------------------------------------

TRAIN_LR = 1e-3              # launch/train.py's default
# parameters of the reference's init at full width and depth (its analytic
# ArchConfig.param_count() leaves some per-layer vectors out: 779,911,680
# and 1,640,868,096)
MAMBA2_PARAMS = 780_148_992
HYMBA_PARAMS = 1_641_179_520
TRAIN_GRAD_TOL = 1e-4        # a gradient leaf, relative to max(1, max|g_cpu|)


def value_and_grad(model, params, batch):
    """(loss, the gradient leaves in `tree_leaves` order)."""
    import torch

    from repro_torch.training.optimizer import tree_leaves, tree_map
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = model.loss(live, batch)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(live))


def train_exact(name: str, layers: int = 4) -> dict:
    """Reduced `name` at fp32 and `layers` layers, one set of weights on the
    card and on the CPU, one synthetic batch: the loss and every gradient
    leaf agree (the card's attention through the flash forward and
    backward kernels, its SSD scan through the scan and its backward);
    then three train steps with grad_accum 1 and 2, the losses within 1e-4
    relative and the parameters within 2 lr (a sign of a near-zero
    gradient may flip between devices and move a parameter by up to 2 lr
    in AdamW's first steps).  Launches exact on the card."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, TRAIN_KERNELS, reset_launches, train_launches
    from repro_torch.models import build_model
    from repro_torch.training import TrainConfig, adamw_init, make_train_step
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train import batch_to
    cfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32", num_layers=layers)
    params0 = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    data = pipeline_of(cfg, 64, 4, seed=1)
    res = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev)
        params = _to(params0, dev)
        reset_launches()
        loss, grads = value_and_grad(model, params, batch_to(data.batch_at(0), dev))
        torch.cuda.synchronize()
        runs = {"loss": loss.item(), "grads": [g.cpu() for g in grads],
                "launches": {k: LAUNCHES[k] for k in TRAIN_KERNELS}}
        for accum in (1, 2):
            step = make_train_step(model, TrainConfig(lr=TRAIN_LR, grad_accum=accum))
            p, o, losses = params, adamw_init(params), []
            for i in range(3):
                p, o, m = step(p, o, batch_to(data.batch_at(i), dev))
                losses.append(m["loss"].item())
            runs[f"accum{accum}"] = {"losses": losses,
                                     "params": [t.cpu() for t in tree_leaves(p)]}
        runs["launches_all"] = {k: LAUNCHES[k] for k in TRAIN_KERNELS}
        res[dev] = runs
    card, cpu = res["cuda"], res["cpu"]
    check(not any(cpu["launches_all"].values()), "a kernel launched on the CPU run")
    # one loss; then 3 steps of 1 and 3 of 2 microbatches
    check(card["launches"] == train_launches(cfg, 1), f"{name}: loss launches "
          f"{card['launches']}, want {train_launches(cfg, 1)}")
    want = train_launches(cfg, 1 + 3 + 6)
    check(card["launches_all"] == want, f"{name}: launches {card['launches_all']}, "
          f"want {want}")
    rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    check(rel <= 1e-5, f"{name}: card loss {card['loss']} vs CPU {cpu['loss']}")
    worst = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                for a, b in zip(card["grads"], cpu["grads"]))
    check(worst <= TRAIN_GRAD_TOL, f"{name}: a gradient leaf off by {worst} (relative)")
    out = {"config": f"{name} reduced, {layers} layers, fp32", "loss_card": card["loss"],
           "loss_cpu": cpu["loss"], "loss_rel_err": rel, "worst_grad_rel_err": worst,
           "launches": card["launches_all"]}
    for accum in (1, 2):
        a, b = card[f"accum{accum}"], cpu[f"accum{accum}"]
        lrel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"]))
        pmax = max((x - y).abs().max().item() for x, y in zip(a["params"], b["params"]))
        check(lrel <= 1e-4, f"{name} grad_accum {accum}: losses {a['losses']} vs "
              f"{b['losses']}")
        check(pmax <= 2 * TRAIN_LR, f"{name} grad_accum {accum}: a parameter off by {pmax}")
        out[f"grad_accum_{accum}"] = {"losses_card": a["losses"], "losses_cpu": b["losses"],
                                      "loss_rel_err": lrel, "param_max_abs_err": pmax}
    return out


def pipeline_of(cfg, seq: int, batch: int, seed: int):
    """The synthetic batches of `cfg`, with a vlm's patch embeddings and an
    encdec's source frames (min(max_source_len, seq) of them), as
    launch/train makes them."""
    from repro_torch.training import SyntheticDataPipeline
    return SyntheticDataPipeline(cfg.vocab_size, seq, batch, seed=seed, family=cfg.family,
                                 d_model=cfg.d_model, num_patches=cfg.num_patches,
                                 src_len=min(cfg.max_source_len, seq))


def train_run(model, params, data, steps, *, start=0, ckpt=None, save_at=None):
    """`steps` train steps from `start` on the card; `params` may be a
    (params, opt state) pair to go on from.  Saves a checkpoint after step
    `save_at`.  Returns (params, opt state, per-step losses, grad norms and
    ms, and the (params, opt state) saved)."""
    import torch

    from repro_torch.training import (TrainConfig, adamw_init, make_train_step,
                                      save_checkpoint)
    from repro_torch.training.optimizer import AdamWState, tree_map
    from repro_torch.training.train import batch_to
    params, opt = params if isinstance(params, tuple) else (params, adamw_init(params))
    step = make_train_step(model, TrainConfig(lr=TRAIN_LR))
    losses, norms, ms, saved = [], [], [], None
    for i in range(start, start + steps):
        batch = batch_to(data.batch_at(i), "cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if save_at is not None and i + 1 == save_at:
            save_checkpoint(str(ckpt), i + 1, {"params": params, "opt": opt})
            # the step makes new parameters but moves the moments in place
            saved = (params, AdamWState(opt.step, tree_map(torch.clone, opt.m),
                                        tree_map(torch.clone, opt.v)))
    return params, opt, {"losses": losses, "grad_norms": norms, "step_ms": ms}, saved


def equal_trees(a, b) -> bool:
    """Same leaves, dtypes and bits."""
    import torch

    from repro_torch.training.optimizer import tree_leaves
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def profile_train(model, params, opt, data, at: int, table: Path) -> dict:
    """Device time by kernel over one train step on batch `at` of the
    pipeline (after a run of `at` steps), into `table`."""
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.training.train import batch_to
    step = make_train_step(model, TrainConfig(lr=TRAIN_LR))
    batch = batch_to(data.batch_at(at), "cuda")

    def window():
        step(params, opt, batch)
        return 1

    return _profile(window, table,
                    {"flash_attention_bwd": ("dkdv_", "dq_wgmma", "dq_mma", "dq_kernel",
                                             "delta_kernel"),
                     "flash_attention": ("flash_wgmma", "flash_kernel"),
                     "ssd_scan_bwd": ("ssd_bwd_",),
                     "ssd_scan": ("ssd_mma_kernel", "ssd_kernel"),
                     "matmul": ("gemm", "nvjet", "xmma", "cutlass", "sm90_")})


def leaf_paths(tree, prefix: str = "") -> list:
    """The paths of a parameter tree's leaves in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def grad_repeat(model, params, batch) -> dict:
    """The loss and its gradient taken twice from the same weights and
    batch: whether they repeat bit for bit, and the paths of the leaves
    that do not.  The first gradient goes to the host before the second is
    taken, so the card holds one gradient at a time."""
    import torch
    loss1, grads = value_and_grad(model, params, batch)
    first = [g.cpu() for g in grads]
    del grads
    loss2, grads = value_and_grad(model, params, batch)
    paths = leaf_paths(params)
    differ = [p for p, a, b in zip(paths, first, grads) if not torch.equal(a, b.cpu())]
    del grads, first
    return {"bit_identical": not differ and torch.equal(loss1, loss2),
            "loss": loss1.item(), "loss_repeats": torch.equal(loss1, loss2),
            "leaves": len(paths), "differing_leaves": differ}


def train_full(state: dict, cfg, key: str, batch: int, seq: int, steps: int,
               save_at=None, n_params=None, fall=None, repeat_grad=False) -> dict:
    """`cfg` (bf16) trained `steps` steps from seeded weights with remat on
    the card, batch x seq of the synthetic pipeline: the losses and
    gradient norms finite, launches exact (remat runs each forward kernel
    twice), the parameter count `n_params` where given, and the loss
    falling by more than `fall` where given.  With `save_at`, a checkpoint
    after that step is restored bit for bit into fresh tensors and run on
    to `steps`: its losses and final parameters must equal the
    uninterrupted run's bit for bit.  With `repeat_grad`, the loss and
    gradient on the next batch are taken twice from the final weights
    (`grad_repeat`), reported under "grad_repeat" for the phase to check.
    Step 1 builds and warms up, so the step times are steps 2 on.
    `--profile` adds one profiled step after the run, into
    <out>/<key>_profile.txt."""
    import shutil

    import torch

    from repro_torch.kernels import LAUNCHES, TRAIN_KERNELS, reset_launches, train_launches
    from repro_torch.models import build_model
    from repro_torch.training import adamw_init, restore_checkpoint
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.train import batch_to
    model = build_model(cfg, device="cuda", remat=True)
    # held by the list alone, so the first step frees the initial weights
    init = [model.init(torch.Generator(device="cuda").manual_seed(0))]
    count = sum(p.numel() for p in tree_leaves(init[0]))
    check(n_params is None or count == n_params, f"{key}: {count} parameters, not {n_params}")
    data = pipeline_of(cfg, seq, batch, seed=0)
    ckpt = state["out"] / f"{key}_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    p_end, o_end, run, saved = train_run(model, init.pop(), data, steps, ckpt=ckpt,
                                         save_at=save_at)
    launches = {k: LAUNCHES[k] for k in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = train_launches(cfg, steps, remat=True)
    check(launches == want, f"{key} launches {launches}, want {want}")
    losses = run["losses"]
    check(all(map(lambda x: x == x and abs(x) < float("inf"), losses + run["grad_norms"])),
          f"{key}: a non-finite loss or gradient norm")
    check(fall is None or losses[0] - losses[-1] > fall,
          f"{key}: loss {losses[0]} -> {losses[-1]}: fell by <= {fall}")
    ms = sorted(run["step_ms"][1:])
    med = statistics.median(ms)
    quart = statistics.quantiles(ms, n=4) if len(ms) > 1 else [ms[0]] * 3
    out = {"params": count, "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "grad_norms": run["grad_norms"],
           "step_ms_median": med, "step_ms_min": ms[0], "step_ms_max": ms[-1],
           "step_ms_iqr": quart[2] - quart[0], "tokens_per_s": batch * seq / (med / 1e3),
           "peak_mem_gib": peak, "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()}}
    if save_at is not None:
        p_s, o_s = saved
        del saved
        template = {"params": tree_map(torch.zeros_like, p_s), "opt": adamw_init(p_s)}
        restored, at = restore_checkpoint(str(ckpt), template)
        del template
        check(at == save_at, f"{key}: latest checkpoint at step {at}, not {save_at}")
        check(equal_trees(restored["params"], p_s) and equal_trees(restored["opt"].m, o_s.m)
              and equal_trees(restored["opt"].v, o_s.v)
              and int(restored["opt"].step) == int(o_s.step) == save_at,
              f"{key}: the restored step-{save_at} state differs from the saved one")
        del p_s, o_s
        # the uninterrupted run's end, on the host where the bits are compared
        p_full = tree_map(lambda t: t.cpu(), p_end)
        del p_end, o_end
        p_end, o_end, resumed, _ = train_run(
            model, (restored.pop("params"), restored.pop("opt")), data, steps - save_at,
            start=save_at)
        check(resumed["losses"] == losses[save_at:]
              and equal_trees(tree_map(lambda t: t.cpu(), p_end), p_full),
              f"{key}: the resumed run differs from the uninterrupted one in its bits "
              f"(losses {resumed['losses']} against {losses[save_at:]})")
        del p_full
        out["checkpoint"] = {
            "restored_bit_exact": True, "resumed_losses": resumed["losses"],
            "bit_identical_to_uninterrupted": True,
            "deterministic_algorithms": torch.are_deterministic_algorithms_enabled()}
    shutil.rmtree(ckpt, ignore_errors=True)
    if repeat_grad:
        # AdamW is elementwise and (b), (d) restore bit for bit: a resumed
        # run equals the uninterrupted one exactly when the step's gradient
        # repeats
        out["grad_repeat"] = {
            **grad_repeat(model, p_end, batch_to(data.batch_at(steps), "cuda")),
            # the run's peak and the probe's together: the probe's own is lower
            # where this equals peak_mem_gib
            "peak_mem_gib_with_run": torch.cuda.max_memory_allocated() / 2**30}
    if state.get("profile"):
        out["profile"] = profile_train(model, p_end, o_end, data, steps,
                                       state["out"] / f"{key}_profile.txt")
    return out


def phase_train(state: dict) -> dict:
    """(a) train_exact on reduced smollm-360m, qwen3-moe-30b-a3b,
    mamba2-780m and hymba-1.5b; (b) smollm-360m at its published width and
    depth (d 960, 32 layers, 15:5 heads of 64, vocab 49,152), bf16, remat,
    batch 8 x 2048, 20 steps on the synthetic pipeline: the loss falls by
    more than 0.1, launches exact, a checkpoint at step 10 restored bit for
    bit into fresh tensors and run on to step 20, equal to the
    uninterrupted run bit for bit; (c) qwen3-moe at full width with 4 of its 48 layers, bf16, remat,
    batch 4 x 1024, 5 steps (capacity-bounded dispatch and the aux loss), then
    the loss and gradient on the next batch taken twice, bit for bit;
    (d) mamba2-780m at its published width and depth (48 layers, d 1536, 48
    SSD heads of 64, N 128, vocab 50,280), bf16, remat, batch 8 x 2048, 10
    steps, checkpoint at step 5; (e) hymba-1.5b at full width and depth (32
    layers, d 1600, 25:5 attention heads and 50 SSD heads of 64, N 16, 128
    meta tokens), bf16, remat, batch 4 x 2048, 5 steps, its gradient
    repeated as (c)'s."""
    import torch

    from repro_torch.configs import get_arch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"exact": {n: train_exact(n) for n in ("smollm-360m", "qwen3-moe-30b-a3b",
                                                 "mamba2-780m", "hymba-1.5b")}}

    def bf16(name, **kw):
        return dataclasses.replace(get_arch(name), dtype="bfloat16", **kw)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out["smollm_full"] = {
        "config": "smollm-360m, 32 layers, d 960, 15:5 heads of 64, vocab 49,152, bf16, "
                  "remat, batch 8 x 2048, lr 1e-3",
        **train_full(state, bf16("smollm-360m"), "train", 8, 2048, 20, save_at=10, fall=0.1)}
    state["launches"]["flash_attention_bwd"] = out["smollm_full"]["launches"][
        "flash_attention_bwd"]
    free()
    out["moe_full"] = {
        "config": "qwen3-moe-30b-a3b, 4 of 48 layers, d 2048, 32:4 heads of 128, 128 "
                  "experts top-8 of d_ff 768, bf16, remat, batch 4 x 1024, lr 1e-3",
        **train_full(state, bf16("qwen3-moe-30b-a3b", num_layers=4), "moe_train", 4, 1024,
                     5, repeat_grad=True)}
    free()
    out["mamba2_full"] = {
        "config": "mamba2-780m, 48 layers, d 1536, 48 SSD heads of 64, N 128, vocab 50,280, "
                  "bf16, remat, batch 8 x 2048, lr 1e-3",
        **train_full(state, bf16("mamba2-780m"), "mamba2_train", 8, 2048, 10, save_at=5,
                     n_params=MAMBA2_PARAMS, fall=0.1)}
    state["launches"]["ssd_scan_bwd"] = out["mamba2_full"]["launches"]["ssd_scan_bwd"]
    free()
    out["hymba_full"] = {
        "config": "hymba-1.5b, 32 layers, d 1600, 25:5 attention heads and 50 SSD heads of "
                  "64, N 16, 128 meta tokens, bf16, remat, batch 4 x 2048, lr 1e-3",
        **train_full(state, bf16("hymba-1.5b"), "hymba_train", 4, 2048, 5,
                     n_params=HYMBA_PARAMS, repeat_grad=True)}
    # checked once both ran, so that a failure shows both results
    repeats = {k: out[k]["grad_repeat"] for k in ("moe_full", "hymba_full")}
    check(all(r["bit_identical"] for r in repeats.values()),
          f"a gradient does not repeat bit for bit: {json.dumps(repeats)}")
    return out


# ---------------------------------------------------------------------------
# phase 16: the port's examples
# ---------------------------------------------------------------------------

# example -> the kernels its run must launch on the card (PERF.md §6 rows 7,
# 4, 3, 8 and 7b)
EXAMPLE_KERNELS = {
    "quickstart": ("flash_attention", "decode_attention"),
    "fault_tolerance": ("flash_attention", "decode_attention", "kv_pack"),
    "microbatch_swapping": ("flash_attention", "decode_attention", "kv_pack"),
    "serve_disaggregated": ("flash_attention", "decode_attention", "kv_pack", "kv_unpack"),
    "train_smollm": ("flash_attention", "flash_attention_bwd"),
}


def load_example(name: str):
    """The module examples/<name>_torch.py of this checkout."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"{name}_torch",
                                                  ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_claims(name: str, res: dict) -> list:
    """The identities example `name` prints, as (what, holds) pairs."""
    if name == "quickstart":
        return [("every request got its max_new tokens",
                 all(len(t) == res["max_new"][r] for r, t in res["tokens"].items())),
                ("24 pipeline steps", res["steps_executed"] == 24)]
    if name == "fault_tolerance":
        return [("one failure, one recovery", (res["failures"], res["recoveries"]) == (1, 1)),
                ("tokens identical to the failure-free run", res["tokens_identical"]),
                ("migration keeps tokens identical", res["migration_tokens_identical"])]
    if name == "microbatch_swapping":
        return [("tokens identical with swapping", res["tokens_identical"]),
                ("hostlink bytes moved", res["transfer_summary"]["hostlink"] > 0)]
    if name == "serve_disaggregated":
        return [("tokens identical to colocated", res["tokens_identical"]),
                ("prompt KV over net", res["transfer_summary"]["net"] > 0)]
    return [("loss after the resume identical", res["identical"]),
            ("resumed from step 50", res["resumed_from"] == 50)]


def phase_examples(state: dict) -> dict:
    """Each example's `run(cfg, model, params, "cuda")` in this process (the
    kernels' build shared), its printed lines sent to stderr: the claims it
    prints hold, its kernels launched, and a serving example's bytes by
    transport (and fault_tolerance's failures, recoveries and steps redone)
    equal the same `run` on the CPU with the same weights."""
    import contextlib

    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    out = {}
    for name, kernels in EXAMPLE_KERNELS.items():
        mod = load_example(name)
        cfg = mod.config()
        train = name == "train_smollm"
        model = build_model(cfg, device="cuda", remat=train)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        kw = {"ckpt_dir": str(state["out"] / "example_ckpt")} if train else {}
        reset_launches()
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res = mod.run(cfg, model, params, "cuda", **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = {k: v for k, v in LAUNCHES.items() if v}
        claims = example_claims(name, res)
        for what, holds in claims:
            check(holds, f"{name}: {what} does not hold")
        missing = [k for k in kernels if not launches.get(k)]
        check(not missing, f"{name}: {missing} never launched ({launches})")
        line = {"config": f"{cfg.name} reduced, {cfg.num_layers} layers, {cfg.dtype}",
                "seconds": seconds, "claims": [w for w, _ in claims], "launches": launches}
        if train:
            line.update(loss_at_60=res["loss_at_60"], loss_after_resume=res["loss_after_resume"],
                        loss_at_120=res["loss_at_120"])
        else:
            with contextlib.redirect_stdout(sys.stderr):
                cpu = mod.run(cfg, build_model(cfg, device="cpu"), _to(params, "cpu"), "cpu")
            check(not any(LAUNCHES[k] != launches.get(k, 0) for k in LAUNCHES),
                  f"{name}: a kernel launched on the CPU run")
            keys = [k for k in res if k.endswith("transfer_summary")]
            if name == "fault_tolerance":
                keys += ["failures", "recoveries", "steps_redone"]
            for k in keys:
                check(res[k] == cpu[k], f"{name}: {k} {res[k]} on the card, {cpu[k]} on the CPU")
            line["same_as_cpu"] = {k: res[k] for k in keys}
        out[name] = line
        del model, params
        gc.collect()
    return out


# ---------------------------------------------------------------------------
# phase 17: the vlm and encdec families through the Model API
# ---------------------------------------------------------------------------

# parameters of the reference's init at full width and depth (its analytic
# ArchConfig.param_count() leaves the position tables, patch_proj and the
# norms out: 3,821,076,480 and 1,632,129,024)
PHI3V_PARAMS = 3_830_516_736
SEAMLESS_PARAMS = 1_670_004_736
MM_TOL = 1e-4            # fp32 logits and decode state, card against CPU (absolute)
MM_SERVE = {             # name -> (requests, prompt tokens, source frames)
    "phi-3-vision-4.2b": (4, 512, 0),
    "seamless-m4t-large-v2": (4, 64, 1024),
}
MM_NEW_TOKENS = 32


def mm_inputs(cfg, n: int, rng, dev, src: int = 0) -> dict:
    """The stub frontends' inputs of n requests, f32 from numpy's `rng`, on
    `dev`: a vlm's patch embeddings [n, num_patches, d], an encdec's `src`
    source frames [n, src, d]."""
    import torch
    if cfg.family == "vlm":
        shape, key = (n, cfg.num_patches, cfg.d_model), "patch_embeds"
    else:
        shape, key = (n, src, cfg.d_model), "src_embeds"
    return {key: torch.from_numpy(rng.standard_normal(shape).astype("float32")).to(dev)}


def mm_expected_launches(cfg, prefills: int, decode_steps: int) -> dict:
    """A prefill runs flash_attention once per decoder layer, an encdec's
    also once per encoder layer and once per decoder layer's
    cross-attention; a decode step runs decode_attention once per decoder
    layer, and an encdec's flash_attention once more per layer (the one
    query's cross-attention)."""
    from repro_torch.kernels import KERNELS
    want = dict.fromkeys(KERNELS, 0)
    n = cfg.num_layers
    if cfg.family == "encdec":
        want["flash_attention"] = (cfg.num_encoder_layers + 2 * n) * prefills + n * decode_steps
    else:
        want["flash_attention"] = n * prefills
    want["decode_attention"] = n * decode_steps
    return want


def mm_exact(cfg, devs=("cuda", "cpu")) -> dict:
    """One set of seeded weights on each device (the last is the CPU): the
    prefill's logits and every leaf of its decode state within MM_TOL of
    the CPU's, then 8 greedy tokens identical, launches exact on the card
    and none on the CPU."""
    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    n, plen, max_new = 2, 24, 8
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, cfg.vocab_size, (n, plen))
    # reduced seamless: 20 of its 32 source slots, fewer than the prompt's 24
    extra = mm_inputs(cfg, n, rng, "cpu", src=20)
    runs = {}
    for dev in devs:
        sync = torch.cuda.synchronize if dev != "cpu" else (lambda: None)
        model, p = build_model(cfg, device=dev), _to(params, dev)
        ex = _to(extra, dev)
        reset_launches()
        logits, st, _ = model.prefill(p, {"tokens": torch.as_tensor(prompts, device=dev), **ex},
                                      max_len=cfg.context_overhead + plen + max_new)
        sync()
        pre = {"logits": logits.cpu(), "state": [t.cpu() for t in _leaves(st)],
               "launches": dict(LAUNCHES)}
        reset_launches()
        toks, rows, _ = generate(model, p, prompts, max_new, sync, extra=ex)
        runs[dev] = {"prefill": pre, "tokens": toks, "rows": rows, "launches": dict(LAUNCHES)}
    cpu = runs[devs[-1]]
    check(not any(cpu["launches"].values()) and not any(cpu["prefill"]["launches"].values()),
          "a kernel launched on the CPU run")
    out = {"config": f"{cfg.name} reduced, fp32", "prompts": n, "prompt_len": plen,
           "max_new": max_new, "tokens": cpu["tokens"].tolist()}
    for dev in devs[:-1]:
        r = runs[dev]
        diffs = [(a - b).abs().max().item() for a, b in
                 zip([r["prefill"]["logits"]] + r["prefill"]["state"],
                     [cpu["prefill"]["logits"]] + cpu["prefill"]["state"])]
        check(max(diffs) <= MM_TOL, f"{cfg.name}: prefill logits or state off by {max(diffs)}")
        check(torch.equal(r["tokens"], cpu["tokens"]),
              f"{cfg.name}: card tokens {r['tokens'].tolist()} differ from CPU tokens "
              f"{cpu['tokens'].tolist()}")
        if dev != "cpu":
            want = mm_expected_launches(cfg, 1, 0)
            check(r["prefill"]["launches"] == want,
                  f"{cfg.name}: prefill launches {r['prefill']['launches']}, want {want}")
            want = mm_expected_launches(cfg, 1, max_new - 1)
            check(r["launches"] == want, f"{cfg.name}: launches {r['launches']}, want {want}")
        out.update({"tokens_identical": True, "max_abs_prefill_diff": max(diffs),
                    "max_abs_logit_diff": max((a - b).abs().max().item()
                                              for a, b in zip(r["rows"], cpu["rows"])),
                    "launches": r["launches"]})
    return out


def decode_bytes(cfg, params, batch: int, pos: int) -> tuple:
    """(weight bytes, cache bytes) one decode step at position `pos` must
    read: every weight but the embedding rows it gathers (and a vlm's
    patch_proj, an encdec's encoder and position tables), and the live
    self-attention K/V plus an encdec's cross K/V."""
    skip = ("embed", "patch_proj", "pos_table", "src_pos", "enc_layers", "enc_final")
    weights = sum(t.numel() * t.element_size() for k, v in params.items() if k not in skip
                  for t in _leaves(v))
    if cfg.tie_embeddings:
        weights += params["embed"].numel() * params["embed"].element_size()
    es = params["final_norm"]["scale"].element_size()
    row = cfg.num_layers * batch * cfg.kv_dim * 2 * es          # k and v of one slot
    return weights, row * (pos + 1)


def mm_serve(cfg, dev: str, model, params, n: int, plen: int, src: int, max_new: int,
             repeats: int, sync) -> dict:
    """`repeats` generations of n requests (plen prompt tokens, and the
    family's frontend inputs) after a warm-up: tokens/s, the prefill's and
    the decode step's times, the decode step's bound, and launches exact."""
    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    rng = np.random.default_rng(8)
    # warm-up: library handles and the first launch of every path
    generate(model, params, rng.integers(0, cfg.vocab_size, (n, 16)), 3, sync,
             extra=mm_inputs(cfg, n, rng, dev, src))
    prompts = rng.integers(0, cfg.vocab_size, (n, plen))
    extra = mm_inputs(cfg, n, rng, dev, src)
    pre_ms, dec_ms = [], []
    reset_launches()
    sync()
    t = time.perf_counter()
    for _ in range(repeats):
        toks, _, st = generate(model, params, prompts, max_new, sync, pre_ms, dec_ms,
                               extra=extra)
    wall = time.perf_counter() - t
    launches = dict(LAUNCHES)
    check(toks.shape == (n, max_new), f"tokens of shape {tuple(toks.shape)}")
    check(all(bool(torch.isfinite(v).all()) for v in _leaves(st)), "non-finite decode state")
    if dev != "cpu":
        want = mm_expected_launches(cfg, len(pre_ms), len(dec_ms))
        check(launches == want, f"launches {launches}, the calls say {want}")
    pos_mid = cfg.context_overhead + plen + max_new // 2
    w_bytes, kv_bytes = decode_bytes(cfg, params, n, pos_mid)
    cross = 0 if src == 0 else st["cross"]["k"].numel() * st["cross"]["k"].element_size() * 2
    gen = repeats * n * max_new
    return {"requests": n, "prompt_len": plen, "source_frames": src,
            "patch_slots": cfg.num_patches, "max_new": max_new, "repeats": repeats,
            "wall_s": wall, "tokens_generated": gen, "tokens_per_s": gen / wall,
            "prefill_ms": pre_ms, "median_prefill_ms": statistics.median(pre_ms),
            "median_decode_step_ms": statistics.median(dec_ms),
            "decode_step_weight_bytes": w_bytes,
            "decode_step_cache_bytes_mid": kv_bytes + cross,
            "decode_step_weight_bound_ms": w_bytes / HBM_BYTES_PER_S * 1e3,
            "decode_step_bound_ms": (w_bytes + kv_bytes + cross) / HBM_BYTES_PER_S * 1e3,
            "prefill_calls": len(pre_ms), "decode_steps": len(dec_ms), "launches": launches}


def phase_mm_models(state: dict) -> dict:
    """(a) reduced phi-3-vision-4.2b and seamless-m4t-large-v2 at fp32, the
    card against the CPU: `mm_exact`, then `train_exact` (loss, every
    gradient leaf, three steps with grad_accum 1 and 2, launches exact);
    (b) both at full width and depth in bf16 through prefill and
    decode_step, `MM_SERVE`'s requests and 32 new tokens, three times after
    a warm-up; (c) seamless trained at full width and depth (bf16, remat,
    batch 4 x 1024 tokens over 1,024 frames, 10 steps, the loss falling by
    more than 0.1, a checkpoint at step 5 resumed bit for bit), then
    phi-3-vision at full width and depth (batch 2 x 1024 tokens after 576
    patches, 5 steps)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out = {"exact": {}, "serve": {}}
    for name in MM_SERVE:
        cfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32")
        out["exact"][name] = {**mm_exact(cfg), "train": train_exact(name)}
    free()
    for name, (n, plen, src) in MM_SERVE.items():
        cfg = dataclasses.replace(get_arch(name), dtype="bfloat16")
        t = time.perf_counter()
        model = build_model(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        count = sum(p.numel() for p in _leaves(params))
        want = {"vlm": PHI3V_PARAMS, "encdec": SEAMLESS_PARAMS}[cfg.family]
        check(count == want, f"{name}: {count} parameters, not {want}")
        torch.cuda.reset_peak_memory_stats()
        res = mm_serve(cfg, "cuda", model, params, n, plen, src, MM_NEW_TOKENS, 3,
                       torch.cuda.synchronize)
        out["serve"][name] = {
            "config": f"{name}, {cfg.num_layers} layers"
                      + (f" + {cfg.num_encoder_layers} encoder" if src else "") + ", bf16",
            "params": count, "init_s": init_s, **res,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        for k in ("flash_attention", "decode_attention"):   # where mb_serve did not run
            state["launches"].setdefault(k, res["launches"][k])
        if state.get("profile"):
            extra = mm_inputs(cfg, n, np.random.default_rng(11), "cuda", src)
            out["serve"][name]["profile"] = profile_generation(model, params, n, plen,
                                                               state["out"], extra)
        del model, params
        free()

    def bf16(name, **kw):
        return dataclasses.replace(get_arch(name), dtype="bfloat16", **kw)

    out["seamless_train"] = {
        "config": "seamless-m4t-large-v2, 24 + 24 layers, d 1024, 16:16 heads of 64, vocab "
                  "256,206, bf16, remat (decoder), batch 4 x 1024 tokens over 1,024 source "
                  "frames, lr 1e-3",
        **train_full(state, bf16("seamless-m4t-large-v2"), "seamless_train", 4, 1024, 10,
                     save_at=5, n_params=SEAMLESS_PARAMS, fall=0.1)}
    free()
    out["phi3v_train"] = {
        "config": "phi-3-vision-4.2b, 32 layers, d 3072, 32:32 heads of 96, bf16, remat, "
                  "batch 2 x (576 patches + 1024 tokens), lr 1e-3",
        **train_full(state, bf16("phi-3-vision-4.2b"), "phi3v_train", 2, 1024, 5,
                     n_params=PHI3V_PARAMS)}
    return out


# ---------------------------------------------------------------------------
# phase 18: the distributed layer on a world of one
# ---------------------------------------------------------------------------

DIST_STEPS = 3
DIST_WINDOW = 8       # decode steps of each serve path profiled
DIST_KERNELS = ("flash_attention", "flash_attention_bwd")


def dist_steps(cfg, mesh, batch: int, seq: int, kernels=DIST_KERNELS) -> tuple:
    """`cfg` trained DIST_STEPS steps by the sharded step and by
    `make_train_step` from one set of seeded weights, a step of each in
    turn: per step, each run's loss, gradient norm, ms and launches of
    `kernels` (the counts set to 0 before the step); both end states,
    gathered; and the model."""
    import torch

    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.distributed.train_step import make_sharded_train_step, shard_train_state
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.training import TrainConfig, adamw_init, make_train_step
    from repro_torch.training.train import batch_to
    model = build_model(cfg, device="cuda", remat=True)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    sharded = shard_train_state(params, adamw_init(params), cfg, mesh)
    runs = {"sharded": [sharded, make_sharded_train_step(model, TrainConfig(lr=TRAIN_LR), mesh)],
            "plain": [(params, adamw_init(params)), make_train_step(model,
                                                                     TrainConfig(lr=TRAIN_LR))]}
    del params, sharded
    data = pipeline_of(cfg, seq, batch, seed=0)
    out = {k: {"loss": [], "grad_norm": [], "step_ms": [], "launches": []} for k in runs}
    for i in range(DIST_STEPS):
        b = batch_to(data.batch_at(i), "cuda")
        for name, run in runs.items():
            (p, o), step = run
            torch.cuda.synchronize()
            reset_launches()
            t = time.perf_counter()
            p, o, m = step(p, o, b)
            torch.cuda.synchronize()
            out[name]["step_ms"].append((time.perf_counter() - t) * 1e3)
            out[name]["launches"].append({k: LAUNCHES[k] for k in kernels})
            out[name]["loss"].append(m["loss"].item())
            out[name]["grad_norm"].append(m["grad_norm"].item())
            if name == "sharded":
                out[name]["collective_bytes"] = m["collective_bytes"]
            run[0] = (p, o)
    ends = {}
    for name, run in runs.items():
        (p, o), _ = run
        ends[name] = gather_tree({"params": p, "m": o.m, "v": o.v, "step": o.step})
    return out, ends, model


def dist_serve(cfg, mesh, batch: int, plen: int, new: int, out_dir: Path) -> dict:
    """`make_sharded_prefill` and `make_sharded_decode_step` on `mesh`
    against the unsharded `prefill` and `decode_step` from one set of
    seeded weights: `new` greedy tokens of `batch` random prompts of `plen`,
    each run's tokens, the decode kernel's launches (the counts set to 0
    before each run) and whether the end states are the same bits.  Then,
    both paths warm, four timed runs in the order sharded, plain, plain,
    sharded, and a window of DIST_WINDOW decode steps of each profiled
    (`_profile`: wall and device time, device launches; tables in
    `out_dir`)."""
    import torch

    from repro_torch.distributed.serve_step import make_sharded_decode_step, make_sharded_prefill
    from repro_torch.distributed.train_step import shard_train_state
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.training import adamw_init
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    sharded, _ = shard_train_state(params, adamw_init(params), cfg, mesh)
    prompts = {"tokens": torch.randint(0, cfg.vocab_size, (batch, plen), device="cuda",
                                       generator=torch.Generator(device="cuda").manual_seed(1))}
    pre, dec = make_sharded_prefill(model, mesh), make_sharded_decode_step(model, mesh)
    runs = {"sharded": (lambda b, m: pre(sharded, b, m),
                        lambda st, t, p: dec(sharded, st, t, p, pre.state_specs)),
            "plain": (lambda b, m: model.prefill(params, b, max_len=m),
                      lambda st, t, p: model.decode_step(params, st, t, p))}

    def generate_(name):
        prefill, decode = runs[name]
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, st, pos = prefill(prompts, plen + new)
        toks = []
        for _ in range(new):
            tok = logits.argmax(-1)
            toks.append(tok)
            logits, st = decode(st, tok, pos)
            pos += 1
        torch.cuda.synchronize()
        return toks, st, time.perf_counter() - t

    out, states = {}, {}
    for name in runs:
        reset_launches()
        toks, states[name], s = generate_(name)
        out[name] = {"tokens": torch.stack(toks, 1).tolist(), "s": s,
                     "launches": {k: LAUNCHES[k] for k in ("flash_attention",
                                                          "decode_attention")},
                     "warm_s": []}
    out["state_bit_identical"] = equal_trees(states["sharded"], states["plain"])
    out["decode_bytes"] = dict(dec.comm.bytes)
    for name in ("sharded", "plain", "plain", "sharded"):
        out[name]["warm_s"].append(generate_(name)[2])
    # the last DIST_WINDOW slots of each end state decoded again: timing only
    tok = torch.zeros(batch, dtype=torch.int64, device="cuda")
    for name, (_, decode) in runs.items():
        st = states[name]

        def window(decode=decode, st=st):
            for i in range(DIST_WINDOW):
                decode(st, tok, plen + new - DIST_WINDOW + i)
            return DIST_WINDOW
        out[name]["decode_window"] = _profile(
            window, out_dir / f"dist_decode_{name}.txt",
            {"decode_attention": ("decode",), "matmul": ("gemm", "sm90", "cutlass")})
    return out


# decode_attention's LSE against its plain version, absolute (bf16 inputs; a
# cluster block's (m, l) left out of one row's LSE of 8 blocks moves it by
# log(8/7) = 0.13); and the two halves combined against the whole cache,
# relative to the whole output's largest |value|
DECODE_LSE_TOL = 5e-3
COMBINE_REL = 2e-2


def lse_combine_cases(shapes, b: int = 8, s: int = 2048) -> dict:
    """`decode_attention` with its LSE against its plain version, and the
    kernel over each half of a cache merged by `tensor_parallel.combine`
    against the kernel over the whole cache (bf16; DECODE_LSE_TOL,
    COMBINE_REL), at the
    decode head shapes `shapes` {name: (Hq, Hkv, D)}: the second half holds
    no valid key in one case and some in the other.  Times with and without
    the LSE, in turns."""
    import torch

    from repro_torch.distributed.tensor_parallel import combine
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    g = torch.Generator(device="cuda").manual_seed(5)
    res = {}
    for name, (hq, hkv, d) in shapes.items():
        q = torch.randn(b, hq, d, generator=g, device="cuda").bfloat16()
        k = torch.randn(b, s, hkv, d, generator=g, device="cuda").bfloat16()
        v = torch.randn(b, s, hkv, d, generator=g, device="cuda").bfloat16()
        slots = torch.arange(s, device="cuda")
        errs = {}
        for tag, n_valid in (("second_half_empty", s // 2 - 100), ("both_halves", s - 100)):
            valid = slots < n_valid
            o, lse = decode_attention(q, k, v, valid, with_lse=True)
            check(torch.equal(o, decode_attention(q, k, v, valid)),
                  f"{name}: decode_attention's output moves with its LSE")
            po, plse = ref.decode_attention_ref(q, k, v, valid, with_lse=True)
            check(torch.isfinite(lse).all().item(), f"{name}: a non-finite LSE")
            lse_err = (lse - plse).abs().max().item()
            check(lse_err <= DECODE_LSE_TOL,
                  f"{name} {tag}: LSE off its plain version by {lse_err} > {DECODE_LSE_TOL}")
            halves = [decode_attention(q, k[:, a:a + s // 2].contiguous(),
                                       v[:, a:a + s // 2].contiguous(),
                                       valid[a:a + s // 2].contiguous(), with_lse=True)
                      for a in (0, s // 2)]
            got = combine(torch.stack([h[0] for h in halves]),
                          torch.stack([h[1] for h in halves]),
                          lambda t: t.amax(0), lambda t: t.sum(0))
            err = (got.float() - o.float()).abs().max().item()
            o_max = o.float().abs().max().item()
            check(torch.isfinite(got.float()).all().item() and err <= COMBINE_REL * o_max,
                  f"{name} {tag}: halves combined off the whole cache by {err} > "
                  f"{COMBINE_REL} x max|o| {o_max}")
            errs[tag] = {"combine_max_abs_err": err, "combine_tol": COMBINE_REL * o_max,
                         "o_max_abs": o_max, "lse_max_abs_err": lse_err,
                         "lse_tol": DECODE_LSE_TOL,
                         "out_max_abs_err": (o.float() - po.float()).abs().max().item()}
        valid = slots < s - 100
        ms = {"with_lse": [], "without": []}
        for _ in range(3):
            ms["without"].append(cuda_ms(lambda: decode_attention(q, k, v, valid), iters=20))
            ms["with_lse"].append(cuda_ms(lambda: decode_attention(q, k, v, valid,
                                                                   with_lse=True), iters=20))
        res[name] = {"shape": f"q[{b},{hq},{d}] kv[{b},{s},{hkv},{d}] bf16", **errs,
                     "ms_median": {k: statistics.median(x) for k, x in ms.items()}}
    return res


# the other families split on the 1 x 1 mesh, at full width and cut depth:
# name -> (layer cut, train batch x seq, serve rows, prompt tokens, source frames)
DIST_FAMILIES = {
    "mamba2-780m": ({"num_layers": 8}, (4, 2048), 4, 512, 0),
    "hymba-1.5b": ({"num_layers": 4, "full_attn_layers": (0,)}, (4, 2048), 4, 1200, 0),
    "seamless-m4t-large-v2": ({"num_layers": 4, "num_encoder_layers": 4}, (4, 1024), 4, 64,
                              1024)}


def dist_family(name: str, mesh, new: int = 32) -> dict:
    """One of DIST_FAMILIES on `mesh`: DIST_STEPS split and unsharded train
    steps in turns (bit for bit, launches per step as `train_launches`
    counts them), then sharded prefill and `new` greedy decode steps
    against the unsharded `prefill` and `decode_step` from the same seeded
    weights (the same tokens and state bits, the launches as the model runs
    them), each generation timed once more warm, split then plain."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed.serve_step import make_sharded_decode_step, make_sharded_prefill
    from repro_torch.distributed.train_step import shard_train_state
    from repro_torch.kernels import KERNELS, LAUNCHES, TRAIN_KERNELS, reset_launches
    from repro_torch.kernels import train_launches
    from repro_torch.models import build_model
    from repro_torch.training import adamw_init
    cut, (tb, ts), rows, plen, src = DIST_FAMILIES[name]
    cfg = dataclasses.replace(get_arch(name), dtype="bfloat16", **cut)
    torch.cuda.reset_peak_memory_stats()
    runs, ends, _ = dist_steps(cfg, mesh, tb, ts, kernels=TRAIN_KERNELS)
    sh, pl = runs["sharded"], runs["plain"]
    check(sh["loss"] == pl["loss"] and sh["grad_norm"] == pl["grad_norm"],
          f"{name}: split losses {sh['loss']} / norms {sh['grad_norm']} against unsharded "
          f"{pl['loss']} / {pl['grad_norm']}")
    check(all(x == x and abs(x) < float("inf") for x in sh["loss"]),
          f"{name}: a non-finite loss {sh['loss']}")
    check(equal_trees(ends["sharded"], ends["plain"]),
          f"{name}: the split run's parameters or moments differ from the unsharded run's")
    want = train_launches(cfg, 1, remat=True)
    check(all(n == want for n in sh["launches"] + pl["launches"]),
          f"{name}: launches a step, split {sh['launches']}, unsharded {pl['launches']}, "
          f"want {want}")
    del ends
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # serving: the split steps and the unsharded ones from one set of weights
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    sharded, _ = shard_train_state(params, adamw_init(params), cfg, mesh)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows, plen), device="cuda",
                                     generator=torch.Generator(device="cuda").manual_seed(1))}
    if src:
        batch.update(mm_inputs(cfg, rows, np.random.default_rng(2), "cuda", src))
    slots = cfg.context_overhead + plen + new
    pre, dec = make_sharded_prefill(model, mesh), make_sharded_decode_step(model, mesh)
    paths = {"sharded": (lambda: pre(sharded, batch, slots),
                         lambda st, t, p: dec(sharded, st, t, p, pre.state_specs)),
             "plain": (lambda: model.prefill(params, batch, max_len=slots),
                       lambda st, t, p: model.decode_step(params, st, t, p))}

    def generate_(path):
        prefill, decode = paths[path]
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, st, pos = prefill()
        toks = []
        for _ in range(new):
            tok = logits.argmax(-1)
            toks.append(tok)
            logits, st = decode(st, tok, pos)
            pos += 1
        torch.cuda.synchronize()
        return torch.stack(toks, 1).tolist(), st, time.perf_counter() - t

    serve, states = {}, {}
    for path in paths:
        reset_launches()
        toks, states[path], s = generate_(path)
        serve[path] = {"tokens": toks, "s": [s],
                       "launches": {k: LAUNCHES[k] for k in KERNELS if LAUNCHES[k]}}
    for path in paths:
        serve[path]["s"].append(generate_(path)[2])
    check(serve["sharded"]["tokens"] == serve["plain"]["tokens"],
          f"{name}: the sharded serve steps' tokens differ from the unsharded ones'")
    check(equal_trees(states["sharded"], states["plain"]),
          f"{name}: the sharded decode state differs from the unsharded one's bits")
    want_serve = (mm_expected_launches if cfg.family == "encdec" else ssm_expected_launches)(
        cfg, 1, new)
    want_serve = {k: n for k, n in want_serve.items() if n}
    check(serve["sharded"]["launches"] == serve["plain"]["launches"] == want_serve,
          f"{name}: serve launches split {serve['sharded']['launches']}, unsharded "
          f"{serve['plain']['launches']}, want {want_serve}")
    out = {"config": f"{name}, {cut}, bf16, remat, train {tb} x {ts}; serve {rows} prompts "
                     f"of {plen}" + (f" over {src} source frames" if src else "")
                     + f", {new} greedy tokens, 1 x 1 mesh on NCCL",
           "bit_identical": True, "train_launches_a_step": want,
           "step_ms": {"sharded": sh["step_ms"], "unsharded": pl["step_ms"]},
           "step_ms_median": {"sharded": statistics.median(sh["step_ms"][1:]),
                              "unsharded": statistics.median(pl["step_ms"][1:])},
           "loss": sh["loss"], "train_peak_gib": train_peak,
           "serve_launches": want_serve,
           "serve_s": {k: v["s"] for k, v in serve.items()},
           "serve_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit({"dist_family": name, **out})
    return out


# the reference's opt variants on the 1 x 1 mesh: smollm-360m train (b)'s
# shape, one split step of each variant against one unsharded step; mamba2
# at DIST_FAMILIES' depth, prefill and greedy steps under opt (opt-rowssm's
# row-split SSM weights in decode) against the unsharded ones
OPT_VARIANTS = ("opt", "opt-zmlp")


def dist_opt(mesh, new: int = 32) -> dict:
    """The opt variants on `mesh`, from seeded weights: (a) smollm-360m at
    full width and depth, bf16, remat, 8 x 2048: one unsharded step, then
    one split step under each of OPT_VARIANTS (sequence parallelism;
    opt-zmlp's FSDP-only MLP, its moments under the baseline placements),
    each of the same bits (loss, norm, parameters, moments) and the same
    flash launches; (b) mamba2-780m cut as DIST_FAMILIES cuts it: prefill
    and `new` greedy steps under opt (parameters placed for prefill, then
    for decode: opt-rowssm) against `prefill` and `decode_step`, the same
    tokens and state bits and the same ``ssd_scan`` launches.  Step ms and
    generation seconds of each."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed.serve_step import make_sharded_decode_step, make_sharded_prefill
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.distributed.train_step import (make_sharded_train_step, shard_params,
                                                    shard_train_state)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.training import TrainConfig, adamw_init, make_train_step
    from repro_torch.training.train import batch_to
    cfg = dataclasses.replace(get_arch("smollm-360m"), dtype="bfloat16")
    model = build_model(cfg, device="cuda", remat=True)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    batch = batch_to(pipeline_of(cfg, 2048, 8, seed=0).batch_at(0), "cuda")
    tcfg = TrainConfig(lr=TRAIN_LR)
    steps = {"unsharded": lambda: make_train_step(model, tcfg)(params, adamw_init(params), batch)}
    for v in OPT_VARIANTS:
        def split(v=v):
            sp, so = shard_train_state(params, adamw_init(params), cfg, mesh, v)
            return make_sharded_train_step(model, tcfg, mesh, v)(sp, so, batch)
        steps[v] = split
    train, ends = {}, {}
    for name, step in steps.items():
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        p, o, m = step()
        torch.cuda.synchronize()
        train[name] = {"ms": (time.perf_counter() - t) * 1e3, "loss": m["loss"].item(),
                       "grad_norm": m["grad_norm"].item(),
                       "launches": {k: LAUNCHES[k] for k in DIST_KERNELS}}
        if name != "unsharded":
            train[name]["collective_bytes"] = m["collective_bytes"]
        ends[name] = gather_tree({"params": p, "m": o.m, "v": o.v, "step": o.step})
    want = {"flash_attention": 2 * cfg.num_layers, "flash_attention_bwd": cfg.num_layers}
    for v in OPT_VARIANTS:
        check(train[v]["loss"] == train["unsharded"]["loss"]
              and train[v]["grad_norm"] == train["unsharded"]["grad_norm"],
              f"smollm-360m {v}: loss / norm {train[v]['loss']} / {train[v]['grad_norm']} "
              f"against unsharded {train['unsharded']['loss']} / "
              f"{train['unsharded']['grad_norm']}")
        check(equal_trees(ends[v], ends["unsharded"]),
              f"smollm-360m {v}: the split step's parameters or moments differ from the "
              "unsharded step's bits")
        check(train[v]["launches"] == train["unsharded"]["launches"] == want,
              f"smollm-360m {v}: launches {train[v]['launches']}, unsharded "
              f"{train['unsharded']['launches']}, want {want}")
    del model, params, ends, batch
    gc.collect()
    torch.cuda.empty_cache()
    # (b) mamba2 under opt: prefill placements, then opt-rowssm's in decode
    cut, _, rows, plen, _ = DIST_FAMILIES["mamba2-780m"]
    mcfg = dataclasses.replace(get_arch("mamba2-780m"), dtype="bfloat16", **cut)
    model = build_model(mcfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    pre_p = shard_params(params, mcfg, mesh, "opt", "prefill")
    dec_p = shard_params(params, mcfg, mesh, "opt", "decode")
    prompts = {"tokens": torch.randint(0, mcfg.vocab_size, (rows, plen), device="cuda",
                                       generator=torch.Generator(device="cuda").manual_seed(1))}
    pre = make_sharded_prefill(model, mesh, "opt")
    dec = make_sharded_decode_step(model, mesh, "opt")
    paths = {"opt": (lambda: pre(pre_p, prompts, plen + new),
                     lambda st, t, p: dec(dec_p, st, t, p, pre.state_specs)),
             "unsharded": (lambda: model.prefill(params, prompts, max_len=plen + new),
                           lambda st, t, p: model.decode_step(params, st, t, p))}
    serve, states = {}, {}
    for name, (prefill, decode) in paths.items():
        reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, st, pos = prefill()
        toks = []
        for _ in range(new):
            tok = logits.argmax(-1)
            toks.append(tok)
            logits, st = decode(st, tok, pos)
            pos += 1
        torch.cuda.synchronize()
        serve[name] = {"s": time.perf_counter() - t, "tokens": torch.stack(toks, 1).tolist(),
                       "launches": {k: LAUNCHES[k] for k in ("ssd_scan",)}}
        states[name] = st
    serve["decode_bytes"] = dict(dec.comm.bytes)
    check(serve["opt"]["tokens"] == serve["unsharded"]["tokens"],
          "mamba2-780m opt: the split serve steps' tokens differ from the unsharded ones'")
    check(equal_trees(states["opt"], states["unsharded"]),
          "mamba2-780m opt: the split decode state differs from the unsharded one's bits")
    check(serve["opt"]["launches"] == serve["unsharded"]["launches"]
          == {"ssd_scan": mcfg.num_layers},
          f"mamba2-780m opt: ssd_scan launches {serve['opt']['launches']}, unsharded "
          f"{serve['unsharded']['launches']}, want {mcfg.num_layers}")
    for name in paths:
        del serve[name]["tokens"]
    out = {"config": "smollm-360m, 32 layers, bf16, remat, batch 8 x 2048, one step each; "
                     f"mamba2-780m {cut}, bf16, {rows} prompts of {plen}, {new} greedy "
                     "tokens; 1 x 1 mesh on NCCL",
           "bit_identical": True, "train": train, "serve": serve}
    emit({"dist_opt": out})
    return out


def phase_dist(state: dict) -> dict:
    """The sharded train step against `make_train_step` on a world of one,
    the sharded serve steps against `prefill` and `decode_step`, the decode
    kernel's LSE and the cross-slice combine, and `compressed_allreduce`
    over NCCL (see the module docstring)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import MeshShape, make_local_mesh
    from repro_torch.training import TrainConfig
    from repro_torch.training.optimizer import (all_gather_fn, compressed_allreduce,
                                                quantize_int8)
    from repro_torch.training.train import batch_to, loss_and_grads
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    mesh = make_local_mesh("cuda")
    try:
        # NCCL makes each group's communicator at its first collective
        for group in [None] + [mesh.get_group(a) for a in mesh.mesh_dim_names]:
            dist.all_reduce(torch.zeros(1, device="cuda"), group=group)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        check(MeshShape.of(mesh) == MeshShape(("data", "model"), (1, 1))
              and dist.get_backend() == "nccl", f"the local mesh is {mesh} on "
              f"{dist.get_backend()}")
        cfg = dataclasses.replace(get_arch("smollm-360m"), dtype="bfloat16")
        runs, ends, model = dist_steps(cfg, mesh, 8, 2048)
        sh, pl = runs["sharded"], runs["plain"]
        check(sh["loss"] == pl["loss"] and sh["grad_norm"] == pl["grad_norm"],
              f"sharded losses {sh['loss']} / norms {sh['grad_norm']} against unsharded "
              f"{pl['loss']} / {pl['grad_norm']}")
        check(all(map(lambda x: x == x and abs(x) < float("inf"), sh["loss"])),
              f"a non-finite loss {sh['loss']}")
        check(equal_trees(ends["sharded"], ends["plain"]),
              "the sharded run's parameters or moments differ from the unsharded run's bits")
        check(sh["launches"] == pl["launches"] and all(
            n == {"flash_attention": 2 * cfg.num_layers, "flash_attention_bwd": cfg.num_layers}
            for n in sh["launches"]), f"launches: sharded {sh['launches']}, unsharded "
              f"{pl['launches']}")
        del ends
        # (b) the split serve steps on the world of one: the same greedy tokens
        serve_cfg = dataclasses.replace(get_arch("smollm-360m"), dtype="bfloat16")
        serve = dist_serve(serve_cfg, mesh, batch=4, plen=512, new=32,
                           out_dir=state["out"])
        sv = serve["sharded"]
        check(sv["tokens"] == serve["plain"]["tokens"], "the sharded serve steps' tokens "
              "differ from the unsharded prefill and decode_step's")
        check(serve["state_bit_identical"], "the sharded decode state differs from the "
              "unsharded one's bits")
        check(sv["launches"] == serve["plain"]["launches"] == {
            "flash_attention": serve_cfg.num_layers,
            "decode_attention": serve_cfg.num_layers * 32},
            f"serve launches: sharded {sv['launches']}, unsharded {serve['plain']['launches']}")
        # (c) the LSE and the cross-slice combine at smollm's and yi-34b's decode heads
        lse = lse_combine_cases({"smollm-360m": (15, 5, 64), "yi-34b": (56, 8, 128)})
        # compressed_allreduce over NCCL on one gradient, in f32
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        _, grads = loss_and_grads(model, TrainConfig(), params,
                                  batch_to(pipeline_of(cfg, 2048, 8, seed=0).batch_at(0), "cuda"))
        g = grads["embed"].float()
        del params, grads
        real, sent = all_gather_fn(), []
        name = real.__name__

        def recording(output, inp, *a, **kw):
            sent.append((inp.dtype, inp.numel() * inp.element_size()))
            return real(output, inp, *a, **kw)
        setattr(dist, name, recording)
        try:
            got = compressed_allreduce(g)
        finally:
            setattr(dist, name, real)
        q, scale = quantize_int8(g)
        plain = q.float() * scale
        torch.cuda.synchronize()
        check(torch.equal(got, plain), "compressed_allreduce over NCCL differs from "
              "q.float() * scale on one rank")
        check(sent[0] == (torch.int8, g.numel()), f"payload {sent[0]}, want int8 of "
              f"{g.numel()} bytes")
        car_ms = cuda_ms(lambda: compressed_allreduce(g), iters=10, warmup=2)
        del g
        gc.collect()
        torch.cuda.empty_cache()
        # each family resets the peak: the phase's is the largest of them all
        peak = torch.cuda.max_memory_allocated() / 2**30
        t_fam = time.perf_counter()
        families = {name: dist_family(name, mesh) for name in DIST_FAMILIES}
        families_s = time.perf_counter() - t_fam
        t_opt = time.perf_counter()
        opt = dist_opt(mesh)
        opt_s = time.perf_counter() - t_opt
        peak = max([peak] + [f[k] for f in families.values()
                             for k in ("train_peak_gib", "serve_peak_gib")])
        return {"max_memory_allocated_gib": peak,"config": "smollm-360m, 32 layers, d 960, 15:5 heads of 64, vocab 49,152, "
                          "bf16, remat, batch 8 x 2048, 1 x 1 mesh (data, model) on NCCL",
                "setup_s": setup_s, "sharded": sh, "unsharded": pl,
                "bit_identical": True,
                "step_ms_median": {"sharded": statistics.median(sh["step_ms"][1:]),
                                   "unsharded": statistics.median(pl["step_ms"][1:])},
                "serve": {"config": "smollm-360m, 32 layers, bf16, 4 prompts of 512, 32 "
                                    "greedy tokens, 1 x 1 mesh on NCCL", **serve},
                "lse_combine": lse,
                "compressed_allreduce": {"numel": plain.numel(),
                                         "payload_bytes": sent[0][1],
                                         "scale_bytes": sent[1][1], "bit_identical": True,
                                         "ms": car_ms},
                "families": families, "families_s": families_s, "opt": opt,
                "opt_s": opt_s}
    finally:
        dist.destroy_process_group()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


KERNEL_META = {
    "batched_decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                 "src/repro/kernels/decode_attention.py:179"),
    "kv_pack_ragged": ("src/repro_torch/kernels/csrc/kv_pack.cu",
                       "src/repro/kernels/kv_pack.py:56"),
    "kv_pack": ("src/repro_torch/kernels/csrc/kv_pack.cu",
                "src/repro/kernels/kv_pack.py:33"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:243"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:60"),
    "kv_unpack": ("src/repro_torch/kernels/csrc/kv_pack.cu",
                  "src/repro/kernels/kv_pack.py:92"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:65"),
    "paged_decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:90"),
    "paged_prefill_attention": ("src/repro_torch/kernels/csrc/paged_prefill.cu",
                                "src/repro/kernels/paged_prefill.py:71"),
    # no TPU counterpart: the reference differentiates XLA's attention
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:60 (its backward)"),
    # no TPU counterpart: the reference differentiates XLA's ssd_chunked
    "ssd_scan_bwd": ("src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                     "src/repro/kernels/ssd_scan.py:65 (its backward; the reference "
                     "differentiates ssd_chunked, src/repro/models/ssm.py:97)"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run (default: all)")
    ap.add_argument("--profile", action="store_true",
                    help="after the serve, mb_serve, ssm_serve, train and mm_models "
                         "phases, profile a short window of each (one step of each train "
                         "run)")
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke"),
                    help="directory for the build log and the profile table")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    bad = [p for p in phases if p not in PHASES]
    if bad:
        ap.error(f"unknown phases {bad}; choose from {PHASES}")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    fns = {"env": phase_env, "kernels": phase_kernels, "parity": phase_parity,
           "serve": phase_serve, "mb_parity": phase_mb_parity, "mb_serve": phase_mb_serve,
           "ssm_parity": phase_ssm_parity, "ssm_serve": phase_ssm_serve,
           "recover": phase_recover, "mb_recover": phase_mb_recover,
           "telemetry": phase_telemetry, "paged_modes": phase_paged_modes,
           "moe": phase_moe, "wide_heads": phase_wide_heads, "train": phase_train,
           "examples": phase_examples, "mm_models": phase_mm_models, "dist": phase_dist}
    state: dict = {"profile": args.profile, "out": Path(args.out), "launches": {}}
    (state["out"] / "phases.jsonl").unlink(missing_ok=True)
    if "env" not in phases:
        phases.insert(0, "env")
    for p in phases:
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        try:
            res = fns[p](state)
        except Exception as e:        # noqa: BLE001 -- reported, then the script fails
            emit({"phase": p, "ok": False, "error": f"{type(e).__name__}: {e}",
                  "seconds": time.perf_counter() - t})
            raise
        # the phase's models are gone with its frame: free their memory
        gc.collect()
        torch.cuda.empty_cache()
        line = {"phase": p, "ok": True, "seconds": time.perf_counter() - t,
                "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30, **res}
        emit(line)
        # whole, for runners that keep only the end of the output
        with open(state["out"] / "phases.jsonl", "a") as f:
            f.write(json.dumps(line) + "\n")
    rows = state.get("kernel_rows", {})
    launches = state.get("launches", {})
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        r = rows.get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches.get(name),
                        "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
                        "device_ms": r.get("device_ms"),
                        "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
                        "bound_by": r.get("bound_by"),
                        "library_ms": r.get("library_ms"),
                        "library_device_ms": r.get("library_device_ms")})
    print(state["card"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
