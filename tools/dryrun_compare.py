#!/usr/bin/env python3
"""Compare two records of the port's dry run (`python -m
repro_torch.launch.dryrun --out FILE`), cell by cell: per-device FLOPs,
temporary bytes, collective bytes by kind, useful FLOPs and whether the
cell fits 80 GB, before and after, as a markdown table; then the cells
that fit, and the cells whose argument bytes differ or that went from ok
to an error.

    python3 tools/dryrun_compare.py BEFORE.json AFTER.json [--arch A ...]

Each file may be several runs' records (the dry run appends); a cell is
(arch, shape, mesh), the last record of it counts.
"""
from __future__ import annotations

import argparse
import json
import sys


def _cells(path: str) -> dict:
    with open(path) as f:
        return {(r["arch"], r["shape"], r["mesh"]): r for r in json.load(f)}


def _g(x: float) -> str:
    return f"{x:.4g}"


def _gb(x: float) -> str:
    return f"{x / 1e9:.4g}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--arch", nargs="*", help="the archs whose rows to print (default all)")
    args = ap.parse_args(argv)
    before, after = _cells(args.before), _cells(args.after)
    kinds = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
    print("| arch | shape | mesh | flops / device | temp GB | " +
          " | ".join(f"{k} GB" for k in kinds) + " | useful FLOPs | fits 80 GB |")
    print("| --- " * (7 + len(kinds)) + "|")
    bad = []
    for key in sorted(after):
        a, b = after[key], before.get(key)
        if b is None:
            continue
        if b["status"] == "ok" and a["status"] != "ok":
            bad.append(f"{key}: ok -> {a['status']}")
        if a["status"] != "ok" or b["status"] != "ok":
            continue
        if a["per_device"]["argument_bytes"] != b["per_device"]["argument_bytes"]:
            bad.append(f"{key}: argument bytes {b['per_device']['argument_bytes']} -> "
                       f"{a['per_device']['argument_bytes']}")
        if args.arch and key[0] not in args.arch:
            continue
        pa, pb = a["per_device"], b["per_device"]
        ca, cb = a["collective_breakdown"], b["collective_breakdown"]
        ua, ub = a["roofline"]["useful_flops_ratio"], b["roofline"]["useful_flops_ratio"]
        cols = [f"{_g(pb['flops'])} → {_g(pa['flops'])}",
                f"{_gb(pb['temp_bytes'])} → {_gb(pa['temp_bytes'])}"]
        cols += [f"{_gb(cb[k])} → {_gb(ca[k])}" for k in kinds]
        cols += [f"{100 * ub:.2f}% → {100 * ua:.2f}%",
                 f"{'yes' if b['fits_hbm'] else 'no'} → {'yes' if a['fits_hbm'] else 'no'}"]
        print(f"| {key[0]} | {key[1]} | {key[2]} | " + " | ".join(cols) + " |")
    for name, recs in (("before", before), ("after", after)):
        ok = [r for r in recs.values() if r["status"] == "ok"]
        print(f"\n{name}: {sum(r['fits_hbm'] for r in ok)} of {len(ok)} ok cells fit 80 GB "
              f"({len(recs)} records)")
    for line in bad:
        print("DIFFERS:", line)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
