"""Microbatch swapping (paper §4.2.2) on the PyTorch/CUDA port: all in-flight
microbatches' KV caches live in host memory; only the active slots are
device-resident (the counterpart of `examples/microbatch_swapping.py`).  The
swap path packs each writeback with the CUDA `kv_pack` kernel
(`src/repro_torch/kernels/csrc/kv_pack.cu`), so each writeback is ONE
contiguous transfer instead of per-layer slices.

The memory line uses the port's machine: `MachineSpec` is an 8 x H100 node
(640 GB of HBM, `src/repro_torch/core/planner.py`), where the JAX example
prints its own hardware model's budget, so the two budgets differ.  The
real run has the JAX example's configuration and requests; the weights come
from `model.init` with a seeded `torch.Generator`, so its tokens are the
port's.

    PYTHONPATH=src python examples/microbatch_swapping_torch.py               # on the card
    PYTHONPATH=src python examples/microbatch_swapping_torch.py --device cpu
"""
import argparse
import dataclasses
import sys

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.core import costmodel as cm
from repro_torch.core.planner import MachineSpec
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine


def config():
    return dataclasses.replace(get_arch("gpt2-1.5b").reduced(), num_layers=8)


def run(cfg, model, params, device="cuda") -> dict:
    # memory accounting at paper scale: why swapping unlocks 2x batches
    full = get_arch("opt-66b")
    mach = MachineSpec()
    wl = cm.WorkloadSpec(1000, 220, 32)
    kv_all = full.decode_state_bytes(1220) * wl.microbatch      # one microbatch
    d = 4
    resident_all = d * kv_all / d                                # all-resident/stage
    resident_swap = 2 * kv_all / d                               # 2 slots/stage

    # real run: swapping produces identical tokens; hostlink bytes move
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (4, 10)).astype(np.int32)

    def reqs():
        return [Request(rid=i, prompt=prompts[i].copy(), max_new=6)
                for i in range(4)]

    base = ServingEngine(cfg, model, params, 4, microbatch=2, device=device).run(reqs())
    eng = ServingEngine(cfg, model, params, 4, microbatch=2, swapping=True, device=device)
    rep = eng.run(reqs())
    return {"resident_all_bytes": resident_all, "resident_swap_bytes": resident_swap,
            "machine_mem_bytes": mach.mem_bytes,
            "tokens_identical": rep.tokens == base.tokens,
            "transfer_summary": eng.transfer_summary()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = config()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device).manual_seed(0))
    res = run(cfg, model, params, device)
    print(f"OPT-66B b=32: per-stage KV all-resident={res['resident_all_bytes']/1e9:.1f}GB, "
          f"with swapping={res['resident_swap_bytes']/1e9:.1f}GB "
          f"(machine budget {res['machine_mem_bytes']/1e9:.0f}GB)")
    print("tokens identical with swapping:", res["tokens_identical"])
    print("host-link (PCIe-role) bytes:", res["transfer_summary"]["hostlink"])
    return res


if __name__ == "__main__":
    main()
