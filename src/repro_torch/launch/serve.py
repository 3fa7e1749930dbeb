"""Serving driver: the full DéjàVu system on an in-process cluster
(counterpart of `repro.launch.serve`).

``python -m repro_torch.launch.serve --arch gpt2-1.5b --reduced --workers 4 \\
      --mode disaggregated --swapping --replication --fail-at 12:1``

Runs synthetic requests through the pipeline-parallel cluster with the
selected DéjàVu features and prints the report (tokens, transfers, recovery
events).  The planner picks the prompt/token split unless --dp-split is
given.  Runs on the card unless --device cpu; the weights come from a
torch.Generator seeded with --seed.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.core import costmodel as cm
from repro_torch.core.planner import plan
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--mode", choices=["colocated", "disaggregated"],
                    default="colocated")
    ap.add_argument("--dp-split", default=None, help="e.g. 2:2")
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--swapping", action="store_true")
    ap.add_argument("--replication", action="store_true")
    ap.add_argument("--compress-replicas", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--fail-at", default=None, help="step:worker, e.g. 12:1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), num_layers=max(8, args.workers))
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))

    dp_split = None
    if args.mode == "disaggregated":
        if args.dp_split:
            a, b = args.dp_split.split(":")
            dp_split = (int(a), int(b))
        else:
            wl = cm.WorkloadSpec(args.prompt_len, args.max_new, args.microbatch)
            p = plan(cfg, wl, args.workers)
            dp_split = ((p.d_prompt, p.d_token) if p.feasible
                        else (max(1, args.workers // 4),
                              args.workers - max(1, args.workers // 4)))
            print(f"planner split: Dp={dp_split[0]} Dt={dp_split[1]}")

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]

    eng = ServingEngine(cfg, model, params, args.workers, mode=args.mode,
                        dp_split=dp_split, microbatch=args.microbatch,
                        swapping=args.swapping, replication=args.replication,
                        compress_replicas=args.compress_replicas, device=dev)
    fail_at = None
    if args.fail_at:
        s, w = args.fail_at.split(":")
        fail_at = {int(s): int(w)}
    report = eng.run(reqs, fail_at=fail_at)
    print(f"steps={report.steps_executed} redone={report.steps_redone} "
          f"failures={report.failures} recoveries={report.recoveries}")
    print("transfers:", eng.transfer_summary())
    for rid in sorted(report.tokens)[:4]:
        print(f"req {rid}: {report.tokens[rid]}")
    for ev in eng.cluster.controller.events:
        print("event:", {k: v for k, v in ev.items() if k != 't'})


if __name__ == "__main__":
    main()
