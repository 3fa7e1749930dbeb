"""Fault tolerance (paper §4.2.3) on the PyTorch/CUDA port: token-level ring
replication + 4-step recovery (the counterpart of
`examples/fault_tolerance.py`).  A stage is killed mid-generation; the
controller detects the missing heartbeat, restores the lost KV from the ring
successor's replica, and generation resumes from the last replicated token,
regenerating tokens bit-identical to a failure-free run.

Same configuration, requests, kill and migration as the JAX example.  The
weights come from `model.init` with a seeded `torch.Generator`, so the
tokens are the port's.  On the card the passes run `flash_attention` and
`decode_attention`, and each replicated window is packed by `kv_pack`
(`src/repro_torch/kernels/csrc/kv_pack.cu`) before it streams to the ring
successor.

    PYTHONPATH=src python examples/fault_tolerance_torch.py               # on the card
    PYTHONPATH=src python examples/fault_tolerance_torch.py --device cpu
"""
import argparse
import dataclasses
import sys

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine


def config():
    return dataclasses.replace(get_arch("gpt2-1.5b").reduced(), num_layers=8)


def run(cfg, model, params, device="cuda") -> dict:
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (4, 10)).astype(np.int32)

    def reqs():
        return [Request(rid=i, prompt=prompts[i].copy(), max_new=8)
                for i in range(4)]

    ref = ServingEngine(cfg, model, params, 4, microbatch=2, device=device).run(reqs())

    eng = ServingEngine(cfg, model, params, 4, microbatch=2, replication=True,
                        device=device)
    rep = eng.run(reqs(), fail_at={13: 2})     # kill worker 2 at step 13

    # straggler mitigation reuses the same machinery (beyond-paper)
    eng2 = ServingEngine(cfg, model, params, 4, microbatch=2, replication=True,
                         device=device)
    rep2 = eng2.run(reqs(), migrate_at={9: 1})
    return {"failures": rep.failures, "recoveries": rep.recoveries,
            "steps_redone": rep.steps_redone,
            "tokens_identical": rep.tokens == ref.tokens,
            "events": [{k: v for k, v in ev.items() if k != "t"}
                       for ev in eng.cluster.controller.events],
            "migration_tokens_identical": rep2.tokens == ref.tokens,
            "transfer_summary": eng.transfer_summary(),
            "migration_transfer_summary": eng2.transfer_summary()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = config()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device).manual_seed(0))
    res = run(cfg, model, params, device)
    print(f"failures={res['failures']} recoveries={res['recoveries']} "
          f"steps_redone={res['steps_redone']}")
    print("tokens identical to failure-free run:", res["tokens_identical"])
    for ev in res["events"]:
        print("controller event:", ev)
    print("straggler migration keeps tokens identical:",
          res["migration_tokens_identical"])
    return res


if __name__ == "__main__":
    main()
