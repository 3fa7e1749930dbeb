"""Quickstart on the PyTorch/CUDA port: serve a small model with batched
requests through the DéjàVu pipeline-parallel cluster (the counterpart of
`examples/quickstart.py`).

Same configuration, requests and engine calls as the JAX example.  The
weights come from `model.init` with a seeded `torch.Generator`, so the
tokens printed are the port's, not the JAX example's.  On the card the
prompts go through `flash_attention` (causal prefill) and each step through
`decode_attention`, the hand-written kernels under
`src/repro_torch/kernels/csrc/`.

    PYTHONPATH=src python examples/quickstart_torch.py               # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
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
    # GPT2-family reduced config (the paper's Fig.-4 model family), 8 layers
    return dataclasses.replace(get_arch("gpt2-1.5b").reduced(), num_layers=8)


def run(cfg, model, params, device="cuda") -> dict:
    rng = np.random.default_rng(0)
    requests = [
        Request(rid=i,
                prompt=rng.integers(0, cfg.vocab_size, 12).astype(np.int32),
                max_new=8)
        for i in range(6)
    ]
    # 4 pipeline stages, colocated (the paper's baseline deployment)
    engine = ServingEngine(cfg, model, params, n_workers=4, microbatch=2, device=device)
    report = engine.run(requests)
    return {"steps_executed": report.steps_executed,
            "tokens": {rid: list(report.tokens[rid]) for rid in sorted(report.tokens)},
            "max_new": {r.rid: r.max_new for r in requests},
            "transfer_summary": engine.transfer_summary()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = config()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device).manual_seed(0))
    res = run(cfg, model, params, device)
    print(f"executed {res['steps_executed']} pipeline steps")
    for rid, toks in res["tokens"].items():
        print(f"request {rid}: generated {toks}")
    print("transfer bytes by transport:", res["transfer_summary"])
    return res


if __name__ == "__main__":
    main()
