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


# name: (module, wrapper, inputs, tolerance on the outputs' difference, in
# units of max(1, max |base output|))
CASES = {
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
        self.modules = {m: v for m, v in sys.modules.items() if m.split(".")[0] == "repro_torch"}
        return fn


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
