#!/usr/bin/env python3
"""Greedy serving in two checkouts, in turns, on one card.

    python3 tools/serve_ab.py --base DIR [--model NAME ...] [--repeats N]

DIR is another commit's tree (e.g. unpacked with ``git archive``); both
checkouts' ``repro_torch`` packages are imported into this one process as
`tools/kernel_ab.py` does, with one set of seeded weights a model, and every
run is warmed up in each checkout first.  Each model of
`chip_smoke.MM_SERVE` (phi-3-vision-4.2b, seamless-m4t-large-v2) runs at
full width and depth in bf16 as the `mm_models` phase's (b) serves it: the
same requests and `MM_NEW_TOKENS` greedy tokens each through each
checkout's `build_model`, in turns base, this, this, base of `--repeats`
generations.  Each model of `ENGINE_SERVE` runs through each checkout's
`ServingEngine` as its phase serves it: nemotron-4-340b at full width, 2
layers, bf16, on both paths (`wide_heads`: `run_continuous` on 8 prompts of
64-256 tokens, 16 new; `run()` on 4 prompts of 256 in microbatches of 2);
qwen3-moe-30b-a3b at full width, 8 layers, bf16, `run_continuous` on
serve's trace (`moe`), in the same turns.  Prints the card (nvidia-smi name
and power limit) and one JSON line: per model (and path), each turn's
median decode step (pass) ms, prefill ms and tokens/s (host clock,
synchronised, as the phases measure them), this checkout's mean median step
over the base's, and whether every run's tokens equal the base's first;
where one does not, the first step where they differ, the row (request),
and the base's logit margin (top-1 minus top-2) there, from an untimed run
of the base that keeps its logits.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

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


# name -> (layers, {path: (prompt lengths, new tokens, engine kwargs, run kwargs)})
ENGINE_SERVE = {
    "nemotron-4-340b": (2, {
        "run_continuous": ([int(n) for n in np.random.default_rng(9).integers(64, 257, 8)], 16,
                           {"paged": True, "kv_pool_blocks": 512}, {"max_active": 8}),
        "run": ([256] * 4, 16, {"microbatch": 2}, {})}),
    "qwen3-moe-30b-a3b": (8, {
        "run_continuous": ([int(n) for n in np.random.default_rng(2).integers(64, 513, 16)], 32,
                           {"paged": True, "kv_pool_blocks": 1024}, {"max_active": 8})}),
}


def first_token_difference(ref_toks: dict, margins: dict, toks: dict):
    """None where the per-request token lists `toks` equal `ref_toks`; else
    the first step where any request differs, that request, and the
    reference's logit margin there (`margins[(rid, step)]`)."""
    diffs = [(next(i for i, (a, b) in enumerate(zip(ref_toks[r], toks[r])) if a != b), r)
             for r in ref_toks if ref_toks[r] != toks[r]]
    if not diffs:
        return None
    step, rid = min(diffs)
    return {"step": step, "row": rid, "base_margin": margins.get((rid, step))}


def engine_run(tree, name, cfg, model, params, path, sync, margins=None, dec_ms=None,
               pre_ms=None):
    """One run of `path` of ENGINE_SERVE[name] through `tree`'s ServingEngine
    (2 stage workers): the tokens by request, and the wall seconds.  With
    `margins`, each emitted token's top-1 minus top-2 logit goes there by
    (request, step); `dec_ms` / `pre_ms` take each decode / prefill pass's
    synchronised host ms."""
    from chip_smoke import _requests, _timed
    tree.use()
    lens, new, ekw, rkw = ENGINE_SERVE[name][1][path]
    sampling = importlib.import_module("repro_torch.serving.sampling")
    last = {}

    def sampler(logits, step):
        if margins is not None:
            last["top"] = logits.float().topk(2, dim=-1).values
        return sampling.greedy(logits, step)

    eng = tree.wrapper("repro_torch.serving", "ServingEngine")(
        cfg, model, params, 2, sampler=sampler, device="cuda", **ekw)
    if margins is not None:
        emit = eng._emit

        def recording(requests, tok, i):
            top = last["top"].cpu()
            for b, r in enumerate(requests):
                margins[(r.rid, i)] = float(top[b, 0] - top[b, 1])
            return emit(requests, tok, i)
        eng._emit = recording
    cl = eng.cluster
    if dec_ms is not None:
        for attr in ("decode_batch", "decode_mb"):
            setattr(cl, attr, _timed(getattr(cl, attr), dec_ms, sync))
        for attr in ("prefill_chunkset_pass", "prefill_mb"):
            setattr(cl, attr, _timed(getattr(cl, attr), pre_ms, sync))
    reqs = _requests(lens, new, cfg.vocab_size, seed=3)
    run = eng.run_continuous if path == "run_continuous" else eng.run
    sync()
    t0 = time.perf_counter()
    rep = run(reqs, **rkw)
    sync()
    wall = time.perf_counter() - t0
    cl.streamer.drain()              # the last write-behinds land, the thread ends
    cl.streamer.close()
    tree.keep()
    return {int(r): list(map(int, v)) for r, v in rep.tokens.items()}, wall


def engine_turns(name: str, trees: dict, repeats: int, sync) -> dict:
    """ENGINE_SERVE[name] in both checkouts, each path in turns base, this,
    this, base of `repeats` runs, after a warm-up run of each checkout and an
    untimed run of the base that records its logit margins."""
    import torch
    layers, paths = ENGINE_SERVE[name]
    models = {}
    for w, t in trees.items():
        cfg = dataclasses.replace(t.wrapper("repro_torch.configs", "get_arch")(name),
                                  num_layers=layers, dtype="bfloat16")
        models[w] = t.wrapper("repro_torch.models", "build_model")(cfg, device="cuda")
    trees["this"].use()
    params = models["this"].init(torch.Generator(device="cuda").manual_seed(0))
    out = {"layers": layers}
    for path in paths:
        margins = {}
        ref, _ = engine_run(trees["base"], name, cfg, models["base"], params, path, sync,
                            margins=margins)
        engine_run(trees["this"], name, cfg, models["this"], params, path, sync)
        turns, differs = [], []
        for w in ("base", "this", "this", "base"):
            dec_ms, pre_ms, gen, wall = [], [], 0, 0.0
            for _ in range(repeats):
                toks, s = engine_run(trees[w], name, cfg, models[w], params, path, sync,
                                     dec_ms=dec_ms, pre_ms=pre_ms)
                gen += sum(len(v) for v in toks.values())
                wall += s
                d = first_token_difference(ref, margins, toks)
                if d is not None:
                    differs.append({"which": w, **d})
            turns.append({"which": w, "median_decode_step_ms": statistics.median(dec_ms),
                          "median_prefill_ms": statistics.median(pre_ms),
                          "tokens_per_s": gen / wall})
        mean = {w: sum(t["median_decode_step_ms"] for t in turns if t["which"] == w) / 2
                for w in trees}
        lens, new = paths[path][:2]
        out[path] = {"prompt_lens": lens, "max_new": new, "repeats": repeats, "turns": turns,
                     "step_this_over_base": mean["this"] / mean["base"],
                     "tokens_identical": not differs, "differences": differs}
    del models, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    from chip_smoke import MM_NEW_TOKENS, MM_SERVE
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="the other checkout's root")
    ap.add_argument("--model", action="append", choices=list(MM_SERVE) + list(ENGINE_SERVE),
                    help="a model to serve (default: all)")
    ap.add_argument("--repeats", type=int, default=2, help="generations a turn")
    args = ap.parse_args()
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
    for name in args.model or list(MM_SERVE) + list(ENGINE_SERVE):
        if name in ENGINE_SERVE:
            res[name] = engine_turns(name, trees, args.repeats, sync)
            continue
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
