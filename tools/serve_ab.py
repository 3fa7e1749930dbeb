#!/usr/bin/env python3
"""Greedy serving of the multimodal models in two checkouts, in turns, on one card.

    python3 tools/serve_ab.py --base DIR [--model NAME ...] [--repeats N]

DIR is another commit's tree (e.g. unpacked with ``git archive``); both
checkouts' ``repro_torch`` packages are imported into this one process as
`tools/kernel_ab.py` does.  Each model of `chip_smoke.MM_SERVE`
(phi-3-vision-4.2b, seamless-m4t-large-v2) runs at full width and depth in
bf16 as the `mm_models` phase's (b) serves it: the same requests and
`MM_NEW_TOKENS` greedy tokens each, through each checkout's `build_model`
with one set of seeded weights, after a warm-up generation in each, in turns
base, this, this, base of `--repeats` generations.  Prints the card
(nvidia-smi name and power limit) and one JSON line: per model, each turn's
median decode step and prefill ms and tokens/s (host clock, synchronised,
as the phase measures them), this checkout's mean median step over the
base's, and whether every generation's tokens equal the base's first; where
one does not, the first step where they differ, the row, and the base's
logit margin (top-1 minus top-2) there.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))


def first_difference(ref_toks, ref_rows, toks):
    """None where `toks` [B, T] equal `ref_toks`; else the first step that
    differs, its first differing row, and the reference's logit margin
    (top-1 minus top-2) at that row and step."""
    diff = ref_toks != toks
    if not bool(diff.any()):
        return None
    step = int(diff.any(0).nonzero()[0])
    row = int(diff[:, step].nonzero()[0])
    top = ref_rows[step][row].topk(2).values
    return {"step": step, "row": row, "base_margin": float(top[0] - top[1])}


def main() -> int:
    from chip_smoke import MM_NEW_TOKENS, MM_SERVE
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="the other checkout's root")
    ap.add_argument("--model", action="append", choices=list(MM_SERVE),
                    help="a model to serve (default: both)")
    ap.add_argument("--repeats", type=int, default=2, help="generations a turn")
    args = ap.parse_args()
    import numpy as np
    import torch

    from chip_smoke import generate, mm_inputs
    from kernel_ab import Checkout
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = torch.cuda.synchronize
    trees = {"base": Checkout(Path(args.base)), "this": Checkout(ROOT)}
    res = {"card": card}
    for name in args.model or list(MM_SERVE):
        n, plen, src = MM_SERVE[name]
        models = {}
        for w, t in trees.items():
            cfg = dataclasses.replace(t.wrapper("repro_torch.configs", "get_arch")(name),
                                      dtype="bfloat16")
            models[w] = t.wrapper("repro_torch.models", "build_model")(cfg, device="cuda")
        trees["this"].use()
        params = models["this"].init(torch.Generator(device="cuda").manual_seed(0))
        # the requests of mm_serve: its warm-up's, then the timed ones
        rng = np.random.default_rng(8)
        warm = rng.integers(0, cfg.vocab_size, (n, 16))
        warm_extra = mm_inputs(cfg, n, rng, "cuda", src)
        prompts = rng.integers(0, cfg.vocab_size, (n, plen))
        extra = mm_inputs(cfg, n, rng, "cuda", src)
        for w, t in trees.items():
            t.use()
            generate(models[w], params, warm, 3, sync, extra=warm_extra)
            t.keep()
        turns, ref, differs = [], None, []
        for w in ("base", "this", "this", "base"):
            trees[w].use()
            pre_ms, dec_ms = [], []
            sync()
            t0 = time.perf_counter()
            for _ in range(args.repeats):
                toks, rows, _ = generate(models[w], params, prompts, MM_NEW_TOKENS, sync,
                                         pre_ms, dec_ms, extra=extra)
                if ref is None:
                    ref = (toks, rows)
                else:
                    d = first_difference(ref[0], ref[1], toks)
                    if d is not None:
                        differs.append({"which": w, **d})
            wall = time.perf_counter() - t0
            turns.append({"which": w, "median_decode_step_ms": statistics.median(dec_ms),
                          "median_prefill_ms": statistics.median(pre_ms),
                          "tokens_per_s": args.repeats * n * MM_NEW_TOKENS / wall})
        mean = {w: sum(t["median_decode_step_ms"] for t in turns if t["which"] == w) / 2
                for w in trees}
        res[name] = {"requests": n, "prompt_len": plen, "source_frames": src,
                     "max_new": MM_NEW_TOKENS, "repeats": args.repeats, "turns": turns,
                     "step_this_over_base": mean["this"] / mean["base"],
                     "tokens_identical": not differs, "differences": differs}
        del models, params, ref
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
