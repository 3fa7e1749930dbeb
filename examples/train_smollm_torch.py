"""End-to-end fault-tolerant training on the SmolLM family with the
PyTorch/CUDA port (the counterpart of `examples/train_smollm.py`; reduced
scale, the same driver trains the full 360M config on the card).

Demonstrates: synthetic data pipeline (host-sharded, step-addressable),
AdamW + remat + grad accumulation, atomic checkpointing, and crash-resume:
the script checkpoints every 25 steps, then simulates a crash at step 60 and
resumes bit-identically.

The step runs eagerly, as `python -m repro_torch.launch.train` runs it
(there is no `jax.jit` here).  On the card attention trains through the
flash forward with its row LSE and `flash_attention_bwd`
(`src/repro_torch/kernels/csrc/flash_attention.cu`,
`flash_attention_bwd.cu`), both on their f32 bodies at this fp32 config.
The weights come from `model.init` with a seeded `torch.Generator`, so the
losses are the port's.

    PYTHONPATH=src python examples/train_smollm_torch.py               # on the card
    PYTHONPATH=src python examples/train_smollm_torch.py --device cpu
"""
import argparse
import dataclasses
import shutil
import sys
import tempfile

sys.path.insert(0, "src")

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.training import (SyntheticDataPipeline, adamw_init, latest_step,
                                  make_train_step, restore_checkpoint, save_checkpoint)
from repro_torch.training.optimizer import tree_map
from repro_torch.training.train import TrainConfig, batch_to


def config():
    return dataclasses.replace(get_arch("smollm-360m").reduced(),
                               num_layers=4, d_model=128, d_ff=512,
                               dtype="float32")


def run(cfg, model, params, device="cuda", ckpt_dir=None) -> dict:
    """`model` built with remat; `ckpt_dir` (default: a fresh temporary
    directory) is removed at the end."""
    data = SyntheticDataPipeline(cfg.vocab_size, seq_len=64, global_batch=8,
                                 seed=0)
    step_fn = make_train_step(model, TrainConfig(lr=1e-3, grad_accum=2))
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="dejavu-train-")
    log = []

    def train(until, params, opt, start):
        for step in range(start, until):
            batch = batch_to(data.batch_at(step), device)
            params, opt, m = step_fn(params, opt, batch)
            if (step + 1) % 20 == 0:
                log.append((step + 1, float(m["loss"])))
                print(f"  step {step+1:3d} loss={log[-1][1]:.4f}")
            if (step + 1) % 25 == 0:
                save_checkpoint(ckpt_dir, step + 1, {"params": params, "opt": opt})
        return params, opt, m

    try:
        opt = adamw_init(params)
        print("phase 1: train to step 60, checkpointing every 25")
        params, opt, m1 = train(60, params, opt, 0)
        loss_at_60 = float(m1["loss"])

        crash_step = latest_step(ckpt_dir)
        print("simulated crash!  restarting from the latest checkpoint "
              f"(step {crash_step})")
        fresh_params = tree_map(torch.zeros_like, params)
        fresh_opt = adamw_init(fresh_params)
        restored, start = restore_checkpoint(ckpt_dir,
                                             {"params": fresh_params, "opt": fresh_opt})
        print(f"phase 2: resume from step {start} and catch up")
        p2, o2, m2 = train(60, restored["params"], restored["opt"], start)
        loss_resumed = float(m2["loss"])

        print("phase 3: continue to step 120")
        _, _, m3 = train(120, p2, o2, 60)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"loss_at_60": loss_at_60, "checkpoint_step": crash_step, "resumed_from": start,
            "loss_after_resume": loss_resumed, "identical": loss_at_60 == loss_resumed,
            "loss_at_120": float(m3["loss"]), "log": log}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = config()
    model = build_model(cfg, device=device, remat=True)
    params = model.init(torch.Generator(device).manual_seed(0))
    res = run(cfg, model, params, device)
    print(f"loss before crash: {res['loss_at_60']:.6f}  after resume: "
          f"{res['loss_after_resume']:.6f}  identical: {res['identical']}")
    return res


if __name__ == "__main__":
    main()
