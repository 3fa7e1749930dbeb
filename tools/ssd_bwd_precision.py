#!/usr/bin/env python3
"""How far the SSD scan's gradients sit from a float64 recurrence, with
B = C (where dcum_i = C_i . dC_i - B_i . dB_i cancels) and with B and C
drawn apart.

    PYTHONPATH=src python3 tools/ssd_bwd_precision.py [--device cuda] [--seeds 3]

At mamba2-780m's widths on one sequence (x [1,300,6,64], N 128, chunk 128,
h0 and dh_final given): autograd through the port's plain `ssd_scan_ref`
(f32) on the CPU, and with ``--device cuda`` `ssd_scan_bwd`'s f32 and bf16
bodies on the card.  The yardstick is autograd through
`ssd_sequential_ref` in float64 on the same values.  Prints one JSON line
per (seed, case, body): max |err| / max(1, max |g|) per gradient, the unit
of the repo's bands (2e-4 for f32, 2e-2 for bf16).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

NAMES = ("dx", "ddt", "da", "dB", "dC", "dh0")
SHAPE = (1, 300, 6, 64, 1, 128)           # b, s, nh, hd, G, N
CHUNK = 128


def inputs(seed: int, same_bc: bool, device):
    """The card tests' scales (tests/test_torch_cuda.py `_ssd_inputs`)."""
    import torch
    b, s, nh, hd, g, n = SHAPE
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *sh: torch.randn(*sh, generator=gen, device=device)   # noqa: E731
    x, dt = 0.5 * r(b, s, nh, hd), torch.nn.functional.softplus(r(b, s, nh))
    a, bm = -torch.exp(0.3 * r(nh)), 0.25 * r(b, s, g, n)
    cm = bm.clone() if same_bc else 0.25 * r(b, s, g, n)
    h0, dy, dhf = 0.1 * r(b, nh, hd, n), r(b, s, nh, hd), r(b, nh, hd, n)
    return (x, dt, a, bm, cm, h0), dy, dhf


def grads(fn, vals, dy, dhf, dtype):
    """autograd of fn's (y, h_final) at `vals` cast to dtype (dt, a and h0
    stay f32 where dtype is bf16, as the kernels take them)."""
    import torch
    keep = dtype if dtype == torch.float64 else torch.float32
    ins = [v.to(dtype if i in (0, 3, 4) else keep).requires_grad_() for i, v in enumerate(vals)]
    y, hf = fn(*ins)
    return torch.autograd.grad([y, hf], ins, [dy.to(y.dtype), dhf.to(hf.dtype)])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    import torch

    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    bodies = {"plain f32": ("cpu", torch.float32,
                            lambda *t: ref.ssd_scan_ref(*t[:5], h0=t[5], chunk=CHUNK))}
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("ssd_bwd_precision: no CUDA device is available", file=sys.stderr)
            return 2
        from repro_torch.kernels.ssd_scan import SSDScanFn
        for name, dtype in (("ssd_scan_bwd f32", torch.float32),
                            ("ssd_scan_bwd bf16", torch.bfloat16)):
            bodies[name] = ("cuda", dtype, lambda *t: SSDScanFn.apply(*t, CHUNK))
    for seed in range(args.seeds):
        for same_bc in (True, False):
            for body, (dev, dtype, fn) in bodies.items():
                vals, dy, dhf = inputs(seed, same_bc, dev)
                # the yardstick sees the values the body sees (bf16-rounded)
                seen = [v.to(dtype).to(torch.float32) if i in (0, 3, 4) else v
                        for i, v in enumerate(vals)]
                dy_seen = dy.to(dtype).to(torch.float32)
                want = grads(lambda *t: ref.ssd_sequential_ref(*t[:5], h0=t[5]), seen, dy_seen,
                             dhf, torch.float64)
                got = grads(fn, vals, dy, dhf, dtype)
                err = {nm: (g.double() - w).abs().max().item() / max(1.0, w.abs().max().item())
                       for nm, g, w in zip(NAMES, got, want)}
                print(json.dumps({"seed": seed, "case": "B = C" if same_bc else "B != C",
                                  "body": body, "rel_err": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
