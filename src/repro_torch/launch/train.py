"""Training driver: ``python -m repro_torch.launch.train --arch smollm-360m``
(counterpart of `repro.launch.train`).

Fault-tolerant by construction: checkpoints every --ckpt-every steps with
atomic manifests and auto-resumes from the latest valid step on restart
(kill it mid-run and re-launch to see).  Runs on the card unless --device
cpu; --reduced takes the config's smoke-test scale, and remat is on unless
--reduced.

Started by ``torchrun`` (WORLD_SIZE set), or in a process group already
initialised, each rank trains one shard of the state on a mesh:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2

--mesh DxM is the ("data", "model") mesh (default: data = the world size,
model 1).  The parameters and AdamW moments live sharded by the rules
(`distributed.sharding`) and `distributed.train_step` splits the compute
over them, under the reference's rules of --variant (baseline, opt:
sequence parallelism, opt-zmlp: the MLP FSDP-only on the rank's tokens);
each rank takes its slice of the same global batch.  Checkpoints
hold full tensors, written by rank 0 in the one-process format, so a run
on one mesh resumes on another or in one process.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import gather_tree
from repro_torch.distributed.train_step import make_sharded_train_step, shard_train_state
from repro_torch.launch.mesh import MeshShape, make_mesh
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
    ap.add_argument("--mesh", default=None,
                    help="DxM data x model mesh of a sharded run (default: Wx1)")
    ap.add_argument("--variant", choices=["baseline", "opt", "opt-zmlp"], default="baseline",
                    help="the reference's sharding rules of a sharded run")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    sharded = dist.is_initialized() or "WORLD_SIZE" in os.environ
    dev = resolve_device(args.device)
    if sharded and not dist.is_initialized():          # torchrun's env:// rendezvous
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    rank = dist.get_rank() if sharded else 0
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
        if rank == 0:
            print(f"resumed from step {start}")

    tcfg = TrainConfig(lr=args.lr, grad_accum=args.grad_accum)
    if sharded:
        mesh = make_mesh(_mesh_shape(args.mesh, dist.get_world_size()), dev)
        params, opt = shard_train_state(params, opt, cfg, mesh, args.variant)
        step_fn = make_sharded_train_step(model, tcfg, mesh, args.variant)
    else:
        step_fn = make_train_step(model, tcfg)
    t0 = time.time()
    for step in range(start, args.steps):
        params, opt, metrics = step_fn(params, opt, batch_to(data.batch_at(step), dev))
        if (step + 1) % args.log_every == 0 and rank == 0:
            print(f"step {step+1:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/args.log_every:.2f}s/step)")
            t0 = time.time()
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            # a sharded run gathers on every rank; rank 0 writes full tensors
            tree = gather_tree({"params": params, "opt": opt}) if sharded else \
                {"params": params, "opt": opt}
            if rank == 0:
                path = save_checkpoint(args.ckpt_dir, step + 1, tree)
                print(f"checkpointed -> {path}")
            if sharded:
                dist.barrier()


def _mesh_shape(spec, world: int) -> MeshShape:
    """The ("data", "model") mesh of --mesh DxM; without one, world x 1."""
    if spec is None:
        return MeshShape(("data", "model"), (world, 1))
    d, m = (int(x) for x in spec.lower().split("x"))
    return MeshShape(("data", "model"), (d, m))


if __name__ == "__main__":
    main()
