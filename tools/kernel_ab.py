#!/usr/bin/env python3
"""Time a kernel's public wrapper in two checkouts, in turns, on one card.

    python3 tools/kernel_ab.py --base DIR [--case NAME ...]

DIR is another commit's tree (e.g. unpacked with ``git archive``).  Both
checkouts' ``repro_torch`` packages are imported into this one process, each
building its kernels from its own sources into its own ``build/``; a case
calls the same wrapper of each on the same inputs.  Every output tensor of
the two must agree within the case's tolerance times max(1, max |base
output|), as the repo's bands are stated, then each case is timed base,
this, this, base: the profiler's device time and the CUDA-event time per
call (`chip_smoke.device_ms`, `chip_smoke.cuda_ms`).  Prints the card (nvidia-smi
name and power limit) and one JSON line with the turns and this checkout's
mean device time over the base's.  A case names a wrapper whose signature
both checkouts share.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def ssd_inputs(b, s, nh, hd, ng, n):
    """The `kernels` phase's ssd_scan inputs, bf16, chunk 128, no h0."""
    def make(g):
        import torch
        import torch.nn.functional as F
        x = (0.5 * torch.randn(b, s, nh, hd, generator=g, device="cuda")).bfloat16()
        dt = F.softplus(torch.randn(b, s, nh, generator=g, device="cuda"))
        a = -torch.exp(0.3 * torch.randn(nh, generator=g, device="cuda"))
        bm = (0.25 * torch.randn(b, s, ng, n, generator=g, device="cuda")).bfloat16()
        cm = (0.0625 * torch.randn(b, s, ng, n, generator=g, device="cuda")).bfloat16()
        return (x, dt, a, bm, cm, None), {"chunk": 128}
    return make


def ssd_bwd_inputs(b, s, nh, hd, ng, n, dtype: str):
    """The `kernels` phase's ssd_scan_bwd inputs at a timed shape: chunk
    128, no h0 and no dh_final as the losses call it, with the chunk states
    and h_final of this checkout's forward (which both checkouts share)."""
    def make(g):
        import torch
        import torch.nn.functional as F

        from repro_torch.kernels.ssd_scan import ssd_scan
        dt_ = getattr(torch, dtype)
        x = (0.5 * torch.randn(b, s, nh, hd, generator=g, device="cuda")).to(dt_)
        dt = F.softplus(torch.randn(b, s, nh, generator=g, device="cuda"))
        a = -torch.exp(0.3 * torch.randn(nh, generator=g, device="cuda"))
        bm = (0.25 * torch.randn(b, s, ng, n, generator=g, device="cuda")).to(dt_)
        cm = (0.25 * torch.randn(b, s, ng, n, generator=g, device="cuda")).to(dt_)
        dy = torch.randn(b, s, nh, hd, generator=g, device="cuda").to(dt_)
        _, hf, states = ssd_scan(x, dt, a, bm, cm, None, chunk=128, with_states=True)
        return (dy, None, x, dt, a, bm, cm, None, states, hf), {"chunk": 128}
    return make


def flash_inputs(b, sq, skv, hq, hkv, d, causal, with_lse=False, dtype="bfloat16"):
    """q [b,sq,hq,d], k/v [b,skv,hkv,d] unit normals, as the `kernels` phase
    makes them."""
    def make(g):
        import torch
        dt_ = getattr(torch, dtype)
        q = torch.randn(b, sq, hq, d, generator=g, device="cuda").to(dt_)
        k = torch.randn(b, skv, hkv, d, generator=g, device="cuda").to(dt_)
        v = torch.randn(b, skv, hkv, d, generator=g, device="cuda").to(dt_)
        return (q, k, v), {"causal": causal, "with_lse": with_lse}
    return make


def decode_inputs(b, s, hq, hkv, d, n_valid):
    """`decode_attention`'s inputs, bf16, slots [0, n_valid) valid."""
    def make(g):
        import torch
        q = torch.randn(b, hq, d, generator=g, device="cuda").bfloat16()
        k = torch.randn(b, s, hkv, d, generator=g, device="cuda").bfloat16()
        v = torch.randn(b, s, hkv, d, generator=g, device="cuda").bfloat16()
        return (q, k, v, torch.arange(s, device="cuda") < n_valid), {}
    return make


def batched_inputs(b, s, hq, hkv, d, lengths, win=None, meta=0, alibi=False):
    """`batched_decode_attention`'s inputs, bf16, at the `kernels` phase's
    lengths, window, meta sinks and ALiBi slopes."""
    def make(g):
        import torch
        q = torch.randn(b, hq, d, generator=g, device="cuda").bfloat16()
        k = torch.randn(b, s, hkv, d, generator=g, device="cuda").bfloat16()
        v = torch.randn(b, s, hkv, d, generator=g, device="cuda").bfloat16()
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        ws = None if win is None else (lens - win).clamp(min=0)
        sl = (torch.tensor([2.0 ** -(8 * (i + 1) / hq) for i in range(hq)], device="cuda")
              if alibi else None)
        return (q, k, v, lens, ws, sl), {"num_meta": meta}
    return make


def paged_case_inputs(lengths, hq, hkv, d):
    """`paged_decode_attention`'s inputs, bf16: one layer of a 24-layer pool
    with shuffled pages (`chip_smoke.paged_inputs`)."""
    def make(g):
        import torch

        from chip_smoke import paged_inputs
        kp, vp, tables = paged_inputs(g, lengths, hkv, d, torch.bfloat16)
        q = torch.randn(len(lengths), hq, d, generator=g, device="cuda").bfloat16()
        return (q, kp, vp, tables,
                torch.tensor(lengths, dtype=torch.int32, device="cuda")), {}
    return make


GPT2_LENGTHS = [1024, 977, 613, 512, 301, 129, 64, 1]
# the `kernels` phase's qwen3-moe decode pass: 8 of serve's prompts, 16 tokens in
MOE_LENGTHS = [456, 197, 129, 214, 265, 445, 282, 121]
FLASH = ("repro_torch.kernels.flash_attention", "flash_attention")
DECODE = "repro_torch.kernels.decode_attention"
BF16_TOL = 2e-2       # the reference's bf16 band (tests/test_kernels.py)

# name: (module, wrapper, inputs, tolerance on the outputs' difference, in
# units of max(1, max |base output|))
CASES = {
    # flash_attention (row 7): the `kernels` phase's timed shapes.  The
    # cross-attention calls split over a cluster (the bf16 band); the rest,
    # d96 and d128 included (two blocks a tile would not all be resident),
    # run the unsplit body, bit for bit
    "flash_attention seamless decode_cross": (*FLASH, flash_inputs(4, 1, 1024, 16, 16, 64,
                                                                   False), BF16_TOL),
    "flash_attention seamless prompt_cross": (*FLASH, flash_inputs(4, 64, 1024, 16, 16, 64,
                                                                   False), BF16_TOL),
    "flash_attention seamless encoder": (*FLASH, flash_inputs(4, 1024, 1024, 16, 16, 64,
                                                              False), 0.0),
    "flash_attention d96": (*FLASH, flash_inputs(1, 512, 512, 32, 32, 96, True), 0.0),
    "flash_attention d128": (*FLASH, flash_inputs(1, 512, 512, 32, 4, 128, True), 0.0),
    # D = 192: the unsplit calls take the two-consumer body (the parent's
    # bits); few query tiles keep the split one-warpgroup body
    "flash_attention d192": (*FLASH, flash_inputs(1, 512, 512, 96, 8, 192, True), 0.0),
    "flash_attention d192 split": (*FLASH, flash_inputs(1, 64, 1024, 16, 2, 192, False), 0.0),
    "flash_attention gpt2_prefill": (*FLASH, flash_inputs(4, 512, 512, 25, 25, 64, True), 0.0),
    "flash_attention hymba": (*FLASH, flash_inputs(4, 1664, 1664, 25, 5, 64, True), 0.0),
    "flash_attention phi3v prefill": (*FLASH, flash_inputs(4, 1088, 1088, 32, 32, 96, True),
                                      0.0),
    "flash_attention float32": (*FLASH, flash_inputs(4, 512, 512, 25, 25, 64, True,
                                                     dtype="float32"), 0.0),
    # the training forward with its LSE, which the backward reads
    "flash_attention smollm_train lse": (*FLASH, flash_inputs(8, 2048, 2048, 15, 5, 64, True,
                                                              with_lse=True), 0.0),
    # the split decode body (rows 4, 1, 5): bf16 groups of 6 or more take the
    # tensor-core instance (the bf16 band: its sums run in another order),
    # nemotron's 96:8 heads of 192, yi-34b's 56:8 and qwen3-moe's 32:4 heads
    # of 128; phi-3-vision's D = 96 keeps the band its 3-chunk lane plan took;
    # the CUDA-core instances at G <= 5 keep their bits
    "decode_attention d192": (DECODE, "decode_attention",
                              decode_inputs(2, 544, 96, 8, 192, 528), BF16_TOL),
    "decode_attention yi34b": (DECODE, "decode_attention",
                               decode_inputs(8, 2048, 56, 8, 128, 2048), BF16_TOL),
    "paged_decode_attention qwen3_moe": (DECODE, "paged_decode_attention",
                                         paged_case_inputs(MOE_LENGTHS, 32, 4, 128), BF16_TOL),
    "decode_attention phi3v": (DECODE, "decode_attention",
                               decode_inputs(4, 1120, 32, 32, 96, 1119), BF16_TOL),
    "decode_attention": (DECODE, "decode_attention", decode_inputs(4, 544, 25, 25, 64, 528),
                         0.0),
    "decode_attention hymba": (DECODE, "decode_attention",
                               decode_inputs(4, 1152, 25, 5, 64, 1152), 0.0),
    "decode_attention seamless": (DECODE, "decode_attention",
                                  decode_inputs(4, 96, 16, 16, 64, 95), 0.0),
    "batched_decode_attention": (DECODE, "batched_decode_attention",
                                 batched_inputs(8, 1024, 25, 25, 64, GPT2_LENGTHS), 0.0),
    "batched_decode_attention window": (DECODE, "batched_decode_attention",
                                        batched_inputs(8, 1024, 25, 25, 64, GPT2_LENGTHS,
                                                       win=32, meta=4, alibi=True), 0.0),
    "paged_decode_attention": (DECODE, "paged_decode_attention",
                               paged_case_inputs(GPT2_LENGTHS, 25, 25, 64), 0.0),

    "ssd_scan mamba2_prefill": ("repro_torch.kernels.ssd_scan", "ssd_scan",
                                ssd_inputs(8, 512, 48, 64, 1, 128), 0.0),
    "ssd_scan hymba_prefill": ("repro_torch.kernels.ssd_scan", "ssd_scan",
                               ssd_inputs(4, 1664, 50, 64, 1, 16), 0.0),
    # the bf16 band (chip_smoke.SSD_TOL): two bodies, each inside it
    "ssd_scan_bwd mamba2_train": ("repro_torch.kernels.ssd_scan", "ssd_scan_bwd",
                                  ssd_bwd_inputs(8, 2048, 48, 64, 1, 128, "bfloat16"), 2e-2),
    "ssd_scan_bwd hymba_train": ("repro_torch.kernels.ssd_scan", "ssd_scan_bwd",
                                 ssd_bwd_inputs(4, 2176, 50, 64, 1, 16, "bfloat16"), 2e-2),
    # the f32 body bit for bit
    "ssd_scan_bwd mamba2_train f32": ("repro_torch.kernels.ssd_scan", "ssd_scan_bwd",
                                      ssd_bwd_inputs(8, 2048, 48, 64, 1, 128, "float32"), 0.0),
}


class Checkout:
    """One tree's `repro_torch`, imported under its own name set: `use`
    puts its modules into `sys.modules`, so imports made at call time
    resolve to the same tree."""

    def __init__(self, tree: Path):
        self.src = str(tree.resolve() / "src")
        self.modules = {}

    def use(self) -> None:
        for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
            del sys.modules[name]
        sys.modules.update(self.modules)

    def wrapper(self, module: str, name: str):
        self.use()
        sys.path.insert(0, self.src)
        try:
            fn = getattr(importlib.import_module(module), name)
        finally:
            sys.path.remove(self.src)
        self.keep()
        return fn

    def keep(self) -> None:
        """Records the tree's modules now loaded (those a call imported too)."""
        self.modules = {m: v for m, v in sys.modules.items() if m.split(".")[0] == "repro_torch"}


def tensors(out):
    """The output tensors of a call, in order (None outputs dropped)."""
    return [t for t in (out if isinstance(out, (tuple, list)) else (out,)) if t is not None]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="the other checkout's root")
    ap.add_argument("--case", action="append", choices=sorted(CASES),
                    help="a case to time (default: all)")
    args = ap.parse_args()
    import torch

    from chip_smoke import cuda_ms, device_ms
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    trees = {"base": Checkout(Path(args.base)), "this": Checkout(ROOT)}
    res = {"card": card}
    for case in args.case or sorted(CASES):
        module, name, make, tol = CASES[case]
        fns = {w: t.wrapper(module, name) for w, t in trees.items()}
        a, kw = make(torch.Generator(device="cuda").manual_seed(0))
        outs = {}
        for w, fn in fns.items():
            trees[w].use()
            outs[w] = [t.float() for t in tensors(fn(*a, **kw))]
        diff = 0.0        # the largest difference over the outputs, in the tolerance's unit
        for p, q in zip(outs["base"], outs["this"]):
            d = (p - q).abs().max().item() / max(1.0, p.abs().max().item())
            if not d <= tol:
                raise RuntimeError(f"{case}: an output differs by {d} > {tol} "
                                   "(times max(1, max |output|))")
            diff = max(diff, d)
        del outs
        turns = []
        for w in ("base", "this", "this", "base"):
            trees[w].use()
            turns.append({"which": w, "device_ms": device_ms(lambda: fns[w](*a, **kw))[0],
                          "ms": cuda_ms(lambda: fns[w](*a, **kw))})
        mean = {w: sum(t["device_ms"] for t in turns if t["which"] == w) / 2 for w in trees}
        res[case] = {"turns": turns, "max_scaled_diff": diff,
                     "this_over_base": mean["this"] / mean["base"]}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
