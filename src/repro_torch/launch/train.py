"""Training driver: ``python -m repro_torch.launch.train --arch smollm-360m``
(counterpart of `repro.launch.train`).

Fault-tolerant by construction: checkpoints every --ckpt-every steps with
atomic manifests and auto-resumes from the latest valid step on restart
(kill it mid-run and re-launch to see).  Runs on the card unless --device
cpu; --reduced takes the config's smoke-test scale, and remat is on unless
--reduced.  One process on one device: the sharded multi-card launch waits
for the distributed slice (ROADMAP.md, queue A).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.training import (SyntheticDataPipeline, adamw_init, latest_step,
                                  make_train_step, restore_checkpoint, save_checkpoint)
from repro_torch.training.train import TrainConfig, batch_to


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=dev, remat=not args.reduced)
    data = SyntheticDataPipeline(cfg.vocab_size, args.seq, args.batch,
                                 seed=args.seed, family=cfg.family,
                                 d_model=cfg.d_model,
                                 num_patches=cfg.num_patches,
                                 src_len=min(cfg.max_source_len, args.seq))
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    opt = adamw_init(params)
    start = 0
    if latest_step(args.ckpt_dir) is not None:
        (state, start) = restore_checkpoint(args.ckpt_dir, {"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        print(f"resumed from step {start}")

    step_fn = make_train_step(model, TrainConfig(lr=args.lr, grad_accum=args.grad_accum))
    t0 = time.time()
    for step in range(start, args.steps):
        params, opt, metrics = step_fn(params, opt, batch_to(data.batch_at(step), dev))
        if (step + 1) % args.log_every == 0:
            print(f"step {step+1:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/args.log_every:.2f}s/step)")
            t0 = time.time()
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            path = save_checkpoint(args.ckpt_dir, step + 1, {"params": params, "opt": opt})
            print(f"checkpointed -> {path}")


if __name__ == "__main__":
    main()
