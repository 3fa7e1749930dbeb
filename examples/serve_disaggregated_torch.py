"""Prompt/token disaggregation (paper §4.2.1) on the PyTorch/CUDA port: the
planner splits D machines into a prompt pipeline and a token pipeline; the
prompt KV cache streams P->T through DéjàVuLib, and generated tokens match
the colocated baseline bit-for-bit (the counterpart of
`examples/serve_disaggregated.py`).

The planner line comes from the port's H100 cost model (`DEFAULT_HW`,
`MachineSpec`: 8 x H100 a machine), where the JAX example's comes from its
own hardware model, so the split and the times differ.  The real run has
the JAX example's configuration and requests; the weights come from
`model.init` with a seeded `torch.Generator`, so its tokens are the port's.
On the card each prompt's KV is packed by `kv_pack` before it streams to the
token pipeline and unpacked there by `kv_unpack`
(`src/repro_torch/kernels/csrc/kv_pack.cu`).

    PYTHONPATH=src python examples/serve_disaggregated_torch.py               # on the card
    PYTHONPATH=src python examples/serve_disaggregated_torch.py --device cpu
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
from repro_torch.core.planner import plan
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine


def config():
    return dataclasses.replace(get_arch("gpt2-1.5b").reduced(), num_layers=8)


def run(cfg, model, params, device="cuda") -> dict:
    # the planner on the FULL-SCALE model shows the Eq.-5 split logic
    full = get_arch("opt-66b")
    wl = cm.WorkloadSpec(prompt_len=1000, new_tokens=220, microbatch=16)
    p = plan(full, wl, d=8)

    def reqs():
        rng_ = np.random.default_rng(1)
        return [Request(rid=i, prompt=rng_.integers(0, cfg.vocab_size, 12)
                        .astype(np.int32), max_new=6) for i in range(4)]

    base = ServingEngine(cfg, model, params, 4, mode="colocated", microbatch=2,
                         device=device)
    rb = base.run(reqs())
    dis = ServingEngine(cfg, model, params, 4, mode="disaggregated",
                        dp_split=(1, 3), microbatch=2, device=device)
    rd = dis.run(reqs())
    return {"plan": {"d_prompt": p.d_prompt, "d_token": p.d_token,
                     "m_overhead": p.m_overhead, "inv_tp_colocated": p.inv_tp_colocated,
                     "inv_tp_disagg": p.inv_tp_disagg, "speedup": p.speedup},
            "tokens_identical": rd.tokens == rb.tokens,
            "tokens": {rid: list(rd.tokens[rid]) for rid in sorted(rd.tokens)},
            "colocated_transfer_summary": base.transfer_summary(),
            "transfer_summary": dis.transfer_summary()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = config()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device).manual_seed(0))
    res = run(cfg, model, params, device)
    p = res["plan"]
    print(f"planner (OPT-66B, D=8): Dp={p['d_prompt']} Dt={p['d_token']} "
          f"m={p['m_overhead']:.3f} I_c={p['inv_tp_colocated']:.2f}s "
          f"I_dis={p['inv_tp_disagg']:.2f}s speedup={p['speedup']:.2f}x")
    print("tokens identical to colocated:", res["tokens_identical"])
    print("P->T prompt-KV bytes over network:", res["transfer_summary"]["net"])
    return res


if __name__ == "__main__":
    main()
