#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) end to end on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --phases env,kernels
    python3 chip_smoke.py --profile --out DIR    # and a device-time table in DIR

Phases, each printing one JSON line with its seconds:

1. ``env``     the card (nvidia-smi name and power limit) and the build of
               every CUDA kernel of the serving path from ``csrc/``.
2. ``kernels`` each hand-written kernel against its plain PyTorch version on
               the card (TF32 off), with CUDA-event times beside the bound,
               the plain version and one library call of the same function,
               and the profiler's device time of the kernel and the library
               call; a decode or paged row must show its body's name in the
               profile, and the bf16 bodies of ``flash_attention`` and
               ``paged_prefill_attention`` HGMMA in their libraries.
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

Then one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Any failed check exits non-zero.  Without a CUDA device, or
without the repository's ``src/repro_torch`` beside this file, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
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
          "ssm_serve")
PARITY_POOL_BLOCKS = 38     # small enough that the parity trace preempts once
# the kernels of the continuous-batching path (phases parity and serve)
CONTINUOUS_KERNELS = ("batched_decode_attention", "kv_pack_ragged", "kv_pack")
# the kernels of the fused passes of plain causal stages, which read the pages
PAGED_KERNELS = ("paged_decode_attention", "paged_prefill_attention")
# the kernels' names in a profile: the f32 body, then the bf16 one
FLASH_NAMES = ("flash_kernel", "flash_wgmma_kernel")
SSD_NAMES = ("ssd_kernel", "ssd_mma_kernel")


class SmokeFailure(RuntimeError):
    pass


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


def device_ms(fn, iters: int = 50, warmup: int = 5):
    """Mean device time of one call: the kernels' own time under
    torch.profiler, without the gaps where the device waits for the host
    (which `cuda_ms` counts when a call's host work outlasts its kernels).
    Returns (ms, the names of the device kernels the calls ran)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ran = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in ran) / 1e3 / iters,
            sorted({e.key for e in ran}))


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
        for lib in ("flash_attention", "paged_prefill"):
            check(sass[lib]["HGMMA"] > 0, f"no HGMMA in the {lib} library")
    return {"card": card, "device": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "build_s": build_s, "built": sorted(logs)}


def sass_counts():
    """Tensor-core instructions in each built library's SASS: HGMMA
    (wgmma) and HMMA (mma.sync), by `cuobjdump -sass` from the toolkit; a
    string saying so where cuobjdump is missing."""
    import shutil

    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        return f"cuobjdump not found (looked on PATH and beside {_build._nvcc()})"
    counts = {}
    for name in _build.SOURCES:
        sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True, timeout=120).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\.", sass)) for op in ("HGMMA", "HMMA")}
    return counts


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the reference's bands (tests/test_kernels.py)


def phase_kernels(state: dict) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (batched_decode_attention,
                                                      decode_attention, split_plan)
    from repro_torch.kernels.flash_attention import flash_attention
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
                    body="batched_decode_split_kernel"),
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

    def flash_case(name, b, sq, skv, hq, hkv, d, dtype, causal=True, time_it=None):
        """Checks the kernel on one shape; `time_it` names the row its times
        go to."""
        q = torch.randn(b, sq, hq, d, generator=g, device=dev).to(dtype)
        k = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(dtype)
        v = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(dtype)
        tname = str(dtype).replace("torch.", "")
        err = held("flash_attention", name, flash_attention(q, k, v, causal=causal),
                   ref.flash_attention_ref(q, k, v, causal=causal), tname)
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
            **times(mine, lambda: ref.flash_attention_ref(q, k, v, causal=causal), sdpa),
            "bound_ms": bms, "bound_by": by, "max_abs_err": err,
            "shape": f"q[{b},{sq},{hq},{d}] kv[{b},{skv},{hkv},{d}] {tname} causal"}

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
                    body="valid_decode_split_kernel"),
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

    def paged_decode_case(name, lengths, hq, hkv, dtype, time_it=False):
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kp, vp, tables = paged_inputs(g, lengths, hkv, 64, dtype)
        q = torch.randn(len(lengths), hq, 64, generator=g, device=dev).to(dtype)
        tname = str(dtype).replace("torch.", "")
        err = held("paged_decode_attention", name,
                   paged_decode_attention(q, kp, vp, tables, lens),
                   ref.paged_decode_attention_ref(q, kp, vp, tables, lens), tname)
        if time_it:
            es = q.element_size()
            live = int(sum(lengths))
            nbytes = 2 * q.numel() * es + 2 * live * hkv * 64 * es + 4 * (tables.numel()
                                                                          + len(lengths))
            bms, by = bound_ms(nbytes, 4.0 * live * hq * 64, tname)
            splits, stages, _ = split_plan(dtype, len(lengths), tables.shape[1] * kp.shape[1],
                                           hq, hkv, 64)
            rows["paged_decode_attention"] = {
                # no one PyTorch call reads pages through a table
                **times(lambda: paged_decode_attention(q, kp, vp, tables, lens),
                        lambda: ref.paged_decode_attention_ref(q, kp, vp, tables, lens),
                        body="paged_decode_split_kernel"),
                "bound_ms": bms, "bound_by": by, "max_abs_err": err,
                "cluster": splits, "stages": stages,
                "shape": f"q[{len(lengths)},{hq},64] pages {list(kp.shape)} of a 24-layer "
                         f"pool, {tname}, lengths {list(lengths)}"}
        del kp, vp

    def paged_prefill_case(name, starts, qlens, c, hq, hkv, dtype, time_it=False):
        ends = [s_ + n for s_, n in zip(starts, qlens)]
        kp, vp, tables = paged_inputs(g, ends, hkv, 64, dtype)
        q = torch.randn(len(starts), c, hq, 64, generator=g, device=dev).to(dtype)
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
            nbytes = (2 * nvalid * hq * 64 * es + 2 * int(sum(ends)) * hkv * 64 * es
                      + 4 * (tables.numel() + 2 * len(starts)))
            bms, by = bound_ms(nbytes, 4.0 * pairs * hq * 64, tname)
            rows["paged_prefill_attention"] = {
                # no one PyTorch call reads pages through a table
                **times(lambda: paged_prefill_attention(q, kp, vp, tables, qs, ql),
                        lambda: ref.paged_prefill_attention_ref(q, kp, vp, tables, qs, ql),
                        body="paged_prefill_wgmma_kernel"),
                "bound_ms": bms, "bound_by": by, "max_abs_err": err,
                "shape": f"q[{len(starts)},{c},{hq},64] pages {list(kp.shape)} of a 24-layer "
                         f"pool, {tname}, q_starts {list(starts)} q_lens {list(qlens)}"}
        del kp, vp

    # the serve decode pass at row 1's lengths, one layer of a [N,24,8,25,64]
    # pool with shuffled page ids; GQA 25:5 beside it
    for dt_ in (torch.float32, torch.bfloat16):
        paged_decode_case("gpt2", lengths, 25, 25, dt_, time_it=dt_ == torch.bfloat16)
        paged_decode_case("gqa_25_5", [700, 9, 1, 333], 25, 5, dt_)
        # a row at length 0 reads its whole table and averages V over its slots
        paged_decode_case("length_zero", [300, 0, 77], 25, 5, dt_)
    # the serve chunk-set pass: 8 chunks of 64 over prefixes of 0-448 tokens,
    # one short final chunk of 5 whose padded rows are not compared
    starts, qlens = [0, 64, 448, 128, 320, 192, 384, 256], [64] * 7 + [5]
    for dt_ in (torch.float32, torch.bfloat16):
        paged_prefill_case("gpt2_chunkset", starts, qlens, 64, 25, 25, dt_,
                           time_it=dt_ == torch.bfloat16)
        paged_prefill_case("gqa_25_5", [0, 40, 197], [64, 17, 64], 64, 25, 5, dt_)
    state["kernel_rows"] = rows
    return {"checks": checks, "timed": rows}


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
    """The launches a fused continuous run implies where every stage reads
    the pages in place: one paged_decode_attention per layer per fused
    decode pass and one paged_prefill_attention per layer per chunk-set
    pass.  Each admitted request's first chunk runs on the per-sequence path
    (the engine's admission step), which gathers its pages, attends with the
    plain `attend` (a chunk of more than one token: every prompt here has
    64 or more) and packs its window back with one kv_pack per leaf per
    stage.  No other kernel runs."""
    from repro_torch.kernels import KERNELS
    cl = eng.cluster
    check(all(w.reads_pages() for w in cl.workers()), "a stage gathers its pages")
    other = {k: n for k, n in pc.items()
             if k not in ("fused_decode", "chunkset", "prefill_chunk", "one_token")}
    check(not any(other.values()), f"passes off the fused paged path: {other}")
    want = dict.fromkeys(KERNELS, 0)
    want["paged_decode_attention"] = cl.cfg.num_layers * pc.get("fused_decode", 0)
    want["paged_prefill_attention"] = cl.cfg.num_layers * pc.get("chunkset", 0)
    want["kv_pack"] = 2 * len(cl.prompt_group) * pc.get("prefill_chunk", 0)
    return want


def run_serve(cfg, dev: str, lens, max_new: int, max_active: int, pool_blocks: int,
              generator, sync):
    """Serve `lens`-long prompts through fused continuous batching on `dev`
    and check tokens, logits and the kernels' launch counts against the
    passes the engine ran.  Returns (results, the engine)."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serving import ServingEngine

    t = time.perf_counter()
    model = DecoderLM(cfg, device=dev)
    params = model.init(generator)
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


def generate(model, params, prompts, max_new: int, sync, pre_ms=None, dec_ms=None):
    """Greedy generation through the Model API: one `prefill` of the prompts
    [B,S] and `max_new - 1` decode steps.  Returns (tokens [B,max_new], the
    logits rows on the CPU, the final decode state), the host times of each
    call appended to `pre_ms` / `dec_ms`."""
    import torch
    pre_ms = [] if pre_ms is None else pre_ms
    dec_ms = [] if dec_ms is None else dec_ms
    tokens = torch.as_tensor(prompts, device=model.device)
    max_len = model.cfg.context_overhead + tokens.shape[1] + max_new
    sync()
    t = time.perf_counter()
    logits, state, pos = model.prefill(params, {"tokens": tokens}, max_len=max_len)
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
            out[name]["profile"] = profile_ssm(model, params, n, plen, state["out"])
        del model, params
    state["launches"]["ssd_scan"] = ssd_launches
    return out


def profile_ssm(model, params, n: int, plen: int, out_dir: Path) -> dict:
    """Device time by kernel over one generation (n prompts of plen tokens,
    8 new tokens: one prefill and seven decode steps), as `profile_serve`
    does for the paged path.  The table goes to
    `out_dir`/<model>_profile.txt."""
    import numpy as np
    import torch
    prompts = np.random.default_rng(11).integers(0, model.cfg.vocab_size, (n, plen))

    def window():
        generate(model, params, prompts, 8, torch.cuda.synchronize)
        return 8
    return _profile(window, out_dir / f"{model.cfg.name}_profile.txt",
                    {"ssd_scan": SSD_NAMES, "flash_attention": FLASH_NAMES,
                     "decode_attention": ("valid_decode",),
                     "matmul": ("gemm", "nvjet", "xmma", "cutlass"),
                     "softmax": ("softmax",)})


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
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run (default: all)")
    ap.add_argument("--profile", action="store_true",
                    help="after the serve, mb_serve and ssm_serve phases, profile a "
                         "short window of each")
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
           "ssm_parity": phase_ssm_parity, "ssm_serve": phase_ssm_serve}
    state: dict = {"profile": args.profile, "out": Path(args.out), "launches": {}}
    if "env" not in phases:
        phases.insert(0, "env")
    for p in phases:
        t = time.perf_counter()
        try:
            res = fns[p](state)
        except Exception as e:        # noqa: BLE001 -- reported, then the script fails
            emit({"phase": p, "ok": False, "error": f"{type(e).__name__}: {e}",
                  "seconds": time.perf_counter() - t})
            raise
        emit({"phase": p, "ok": True, "seconds": time.perf_counter() - t, **res})
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
