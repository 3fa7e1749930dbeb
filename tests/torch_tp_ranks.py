"""The ranks of `test_torch_tensor_parallel.py`: four spawned gloo processes
that run the port's split-compute train step and sharded serving on small
meshes and write what they saw for the parent, which holds the references.

This module imports the port and nothing of JAX, so a spawned rank starts
in a few seconds.
"""
import dataclasses
import os

import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding
from repro_torch.distributed.serve_step import make_sharded_decode_step, make_sharded_prefill
from repro_torch.distributed.train_step import make_sharded_train_step, shard_train_state
from repro_torch.launch.mesh import MeshShape, make_mesh
from repro_torch.models import build_model
from repro_torch.training import TrainConfig, adamw_init

from torch_ranks import WORLD, _init, forced_fsdp

LR = 1e-3
STEPS = 2
NEW_TOKENS = 8
MESHES = {"2x2": MeshShape(("data", "model"), (2, 2)),
          "1x4": MeshShape(("data", "model"), (1, 4))}
# reduced configs (fp32): name -> (arch, overrides).  "6:2" and "5:5" split
# their heads unevenly over 4 ranks (1 or 2 a rank, none padded); "6:2" also
# leaves its ff (126) and vocabulary (250) replicated over `model`, which a
# rank then slices locally
CONFIGS = {"internlm2": ("internlm2-1.8b", {}),
           "qwen3-moe": ("qwen3-moe-30b-a3b", {}),
           "phi-3-vision": ("phi-3-vision-4.2b", {}),
           "internlm2-6:2": ("internlm2-1.8b", {"num_heads": 6, "num_kv_heads": 2,
                                                "d_ff": 126, "vocab_size": 250}),
           "smollm-5:5": ("smollm-360m", {"num_heads": 5, "num_kv_heads": 5})}
# (config, mesh, FSDP forced on, grad_accum); at grad_accum 4 a microbatch
# of the 4-row batch is one row, which the 2 data ranks cannot split: each
# holds it whole
TRAIN_CASES = (("internlm2", "2x2", False, 1), ("internlm2", "2x2", True, 2),
               ("qwen3-moe", "2x2", True, 1), ("qwen3-moe", "2x2", False, 4),
               ("phi-3-vision", "2x2", False, 2), ("internlm2-6:2", "1x4", False, 1),
               ("smollm-5:5", "1x4", True, 2))
# (config, mesh): sharded prefill, then NEW_TOKENS greedy decode steps
SERVE_CASES = (("internlm2", "2x2"), ("qwen3-moe", "2x2"), ("phi-3-vision", "2x2"),
               ("internlm2-6:2", "1x4"), ("smollm-5:5", "1x4"), ("qwen3-moe", "1x4"))


def case_name(case) -> str:
    return "-".join(str(x) for x in case)


def config(name: str):
    arch, kw = CONFIGS[name]
    return dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **kw)


def tp_ranks(rank, out, params_np, train_batches, prompts):
    """Every TRAIN_CASES case for STEPS steps from `params_np[config]` (loss,
    norm, collective bytes per step; the parameters gathered at the end),
    then every SERVE_CASES case: prefill `prompts[config]` into a cache of
    its length plus NEW_TOKENS, and decode greedily (this rank's rows'
    tokens and logits, and its state slice after prefill and at the end)."""
    _init(rank, WORLD, out)
    res = {"coords": {}}
    try:
        meshes = {k: make_mesh(v, "cpu") for k, v in MESHES.items()}
        for k, m in meshes.items():
            res["coords"][k] = sharding.mesh_coords(m)
        for case in TRAIN_CASES:
            name, mesh_name, fsdp, accum = case
            cfg, mesh = config(name), meshes[mesh_name]
            model = build_model(cfg, device="cpu")

            def run():
                params = params_from_jax(cfg, params_np[name], device="cpu")
                p, o = shard_train_state(params, adamw_init(params), cfg, mesh)
                step = make_sharded_train_step(model, TrainConfig(lr=LR, grad_accum=accum),
                                               mesh)
                got = {"loss": [], "grad_norm": [], "bytes": []}
                for b in train_batches[name]:
                    p, o, m = step(p, o, {k: torch.from_numpy(v) for k, v in b.items()})
                    got["loss"].append(m["loss"].item())
                    got["grad_norm"].append(m["grad_norm"].item())
                    got["bytes"].append(m["collective_bytes"])
                got["params"] = sharding.gather_tree(p)
                return got
            res[case_name(case)] = forced_fsdp(run) if fsdp else run()
        for case in SERVE_CASES:
            name, mesh_name = case
            cfg, mesh = config(name), meshes[mesh_name]
            model = build_model(cfg, device="cpu")
            params = params_from_jax(cfg, params_np[name], device="cpu")
            p, _ = shard_train_state(params, adamw_init(params), cfg, mesh)
            prefill, decode = make_sharded_prefill(model, mesh), make_sharded_decode_step(
                model, mesh)
            batch = {k: torch.from_numpy(v) for k, v in prompts[name].items()}
            s = batch["tokens"].shape[1] + (cfg.num_patches if cfg.family == "vlm" else 0)
            logits, state, pos = prefill(p, batch, s + NEW_TOKENS)
            got = {"logits": [logits], "tokens": [], "state0": tree_clone(state),
                   "prefill_bytes": dict(prefill.comm.bytes), "decode_bytes": []}
            for _ in range(NEW_TOKENS):
                tok = logits.argmax(-1)
                got["tokens"].append(tok)
                logits, state = decode(p, state, tok, pos, prefill.state_specs)
                got["logits"].append(logits)
                got["decode_bytes"].append(dict(decode.comm.bytes))
                pos += 1
            got["state"] = state
            res[case_name(case)] = got
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def tree_clone(tree):
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    return tree.clone()
