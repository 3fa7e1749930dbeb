"""The ranks of `test_torch_opt_rules.py`: four spawned gloo processes that
run the port's split train steps and sharded serving under the reference's
`opt` variants on small meshes, and write what they saw for the parent,
which holds the references.  A share each, the ranks also run the
unsharded train steps and count the dry run's collectives of the train
cases (`ShapeCollectives` over fake tensors), while the parent runs the
JAX package's steps.

This module imports the port and nothing of JAX, so a spawned rank starts
in a few seconds.
"""
import dataclasses
import os

import numpy as np
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding
from repro_torch.distributed.serve_step import make_sharded_decode_step, make_sharded_prefill
from repro_torch.distributed.train_step import (make_sharded_train_step, rank_batch, rank_step,
                                                shard_params, shard_train_state)
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import MeshShape, make_mesh
from repro_torch.launch.specs import ShapeCollectives, cell_rules, fake_mode
from repro_torch.models import build_model
from repro_torch.training import TrainConfig, adamw_init, make_train_step

from torch_ranks import WORLD, _init, forced_fsdp
from torch_tp_family_ranks import fake_local
from torch_tp_ranks import tree_clone

LR = 1e-3
STEPS = 2
NEW_TOKENS = 8
MESHES = {"2x2": MeshShape(("data", "model"), (2, 2)),
          "1x4": MeshShape(("data", "model"), (1, 4))}
# reduced fp32 configs: name -> (arch, overrides).  "ssm-rows" has a
# vocabulary that 2 does not divide, so under opt-rowssm its tied
# embedding's d_model columns lie over `model` (the path of ROADMAP C.4);
# "ssm-rows-d48" has 6 SSM heads, whose decode state 4 ranks keep whole,
# and a vocabulary 4 does not divide
CONFIGS = {"dense": ("smollm-360m", {}),
           "ssm": ("mamba2-780m", {}),
           "hybrid": ("hymba-1.5b", {}),
           "encdec": ("seamless-m4t-large-v2", {}),
           "moe": ("qwen3-moe-30b-a3b", {}),
           "vlm": ("phi-3-vision-4.2b", {}),
           "ssm-rows": ("mamba2-780m", {"vocab_size": 251}),
           "ssm-rows-d48": ("mamba2-780m", {"d_model": 48, "vocab_size": 250})}
# (config, variant, tokens, FSDP forced on) on 2 x 2: hybrid streams hold 4
# meta tokens, vlm streams 8 patches; 15 tokens do not divide over
# `model`, so that step keeps the residual stream whole (and opt-zmlp's MLP
# whole on every rank)
TRAIN_CASES = (("dense", "opt", 16, False), ("dense", "opt-zmlp", 16, False),
               ("ssm", "opt", 16, False), ("ssm", "opt-zmlp", 16, False),
               ("hybrid", "opt", 16, False), ("hybrid", "opt-zmlp", 16, True),
               ("encdec", "opt", 16, False), ("encdec", "opt-zmlp", 16, True),
               ("moe", "opt", 16, False), ("vlm", "opt", 16, False),
               ("dense", "opt-zmlp", 15, False))
# (config, mesh, variant, prompt rows, prompt tokens): sharded prefill under
# the variant's prefill placements, then NEW_TOKENS greedy decode steps
# under its decode placements (opt-rowssm for the ssm configs)
SERVE_CASES = (("ssm-rows", "2x2", "opt", 2, 8), ("ssm-rows-d48", "1x4", "opt", 2, 8),
               ("dense", "2x2", "opt-zmlp", 2, 8), ("hybrid", "2x2", "opt", 2, 20))
# the dry run's mamba2-780m decode cells under opt (ROADMAP C.4), one a rank:
# (shape, two pods)
DRYRUN_CELLS = (("decode_32k", False), ("long_500k", False), ("decode_32k", True),
                ("long_500k", True))
SRC_FRAMES = 10
B = 4


def case_name(case) -> str:
    return "-".join(str(x) for x in case)


def config(name: str):
    arch, kw = CONFIGS[name]
    return dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **kw)


def max_len(cfg, tokens: int) -> int:
    return tokens + cfg.num_meta_tokens + NEW_TOKENS


def train_batches(name: str, s: int):
    """STEPS batches of config `name` of `s` tokens whose loss masks differ
    between the two data shards."""
    cfg = config(name)
    rng = np.random.default_rng(11 + list(CONFIGS).index(name) + s)
    out = []
    for _ in range(STEPS):
        mask = np.ones((B, s), np.float32)
        mask[: B // 2] = (rng.random((B // 2, s)) < 0.4).astype(np.float32)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32),
                 "targets": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32),
                 "loss_mask": mask}
        if cfg.family == "encdec":
            batch["src_embeds"] = rng.standard_normal((B, SRC_FRAMES, cfg.d_model)
                                                      ).astype(np.float32)
        if cfg.family == "vlm":
            batch["patch_embeds"] = rng.standard_normal((B, cfg.num_patches, cfg.d_model)
                                                        ).astype(np.float32)
        out.append(batch)
    return out


def prompt(case):
    name, _, _, b, s = case
    cfg = config(name)
    rng = np.random.default_rng(5 + SERVE_CASES.index(case))
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _fake(batch):
    return {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in batch.items()}


def fake_train_bytes(case) -> dict:
    """What the dry run counts for the last `model` rank's train step of
    `case` (`rank_step` over `ShapeCollectives` on fake shards, the
    moments under the baseline rules, remat's recompute included)."""
    name, variant, s, _ = case
    cfg, mesh = config(name), MESHES["2x2"]
    model = build_model(cfg, device="cpu", remat=True)
    comm = ShapeCollectives(mesh)
    with fake_mode():
        params = model.init(torch.Generator())
        specs = sharding.param_shardings(params, cfg, mesh, variant)
        m_specs = sharding.param_shardings(params, cfg, mesh)
        local, opt = fake_local(params, specs, mesh), adamw_init(fake_local(params, m_specs,
                                                                             mesh))
        b, split = rank_batch(_fake(train_batches(name, s)[0]), cfg, mesh, comm.coords, 1)
        rank_step(model, TrainConfig(lr=LR), local, specs, opt, b, split, comm,
                  variant=variant, m_specs=m_specs)
    return dict(comm.bytes)


def unsharded_steps(params_np, name: str, s: int) -> dict:
    """The port's `make_train_step` on the whole batches: losses, norms and
    the final parameters."""
    cfg = config(name)
    params = params_from_jax(cfg, params_np, device="cpu")
    step = make_train_step(build_model(cfg, device="cpu"), TrainConfig(lr=LR))
    opt = adamw_init(params)
    run = {"loss": [], "grad_norm": []}
    for b in train_batches(name, s):
        params, opt, met = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
        run["loss"].append(float(met["loss"]))
        run["grad_norm"].append(float(met["grad_norm"]))
    run["params"] = params
    return run


def opt_ranks(rank, out):
    """This rank's cell of DRYRUN_CELLS, its share of the fake counts and
    the unsharded steps of TRAIN_CASES; then every TRAIN_CASES case for STEPS steps (loss, norm,
    collective bytes; the parameters gathered at the end) and every
    SERVE_CASES case (this rank's tokens and logits, its decode bytes and
    the state's specs), from the weights the parent saved."""
    _init(rank, WORLD, out)
    res = {"coords": {}, "fake": {}, "unsharded": {}}
    try:
        shape, multi = DRYRUN_CELLS[rank]
        res["dryrun"] = {(shape, multi): run_cell("mamba2-780m", shape, multi, variant="opt")}
        params_np = torch.load(os.path.join(out, "params.pt"), weights_only=False)
        for case in TRAIN_CASES[rank::WORLD]:
            res["fake"][case] = forced_fsdp(lambda: fake_train_bytes(case)) if case[3] \
                else fake_train_bytes(case)
            res["unsharded"][case] = unsharded_steps(params_np[case[0]], case[0], case[2])
        meshes = {k: make_mesh(v, "cpu") for k, v in MESHES.items()}
        for k, m in meshes.items():
            res["coords"][k] = sharding.mesh_coords(m)
        for case in TRAIN_CASES:
            name, variant, s, fsdp = case
            cfg, mesh = config(name), meshes["2x2"]
            model = build_model(cfg, device="cpu", remat=True)

            def run():
                params = params_from_jax(cfg, params_np[name], device="cpu")
                p, o = shard_train_state(params, adamw_init(params), cfg, mesh, variant)
                step = make_sharded_train_step(model, TrainConfig(lr=LR), mesh, variant)
                got = {"loss": [], "grad_norm": [], "bytes": []}
                for b in train_batches(name, s):
                    p, o, m = step(p, o, {k: torch.from_numpy(v) for k, v in b.items()})
                    got["loss"].append(m["loss"].item())
                    got["grad_norm"].append(m["grad_norm"].item())
                    got["bytes"].append(m["collective_bytes"])
                got["params"] = sharding.gather_tree(p)
                return got
            res[case_name(case)] = forced_fsdp(run) if fsdp else run()
        for case in SERVE_CASES:
            name, mesh_name, variant = case[:3]
            cfg, mesh = config(name), meshes[mesh_name]
            model = build_model(cfg, device="cpu")
            params = params_from_jax(cfg, params_np[name], device="cpu")
            pp = shard_params(params, cfg, mesh, variant, "prefill")
            pd = shard_params(params, cfg, mesh, variant, "decode")
            prefill = make_sharded_prefill(model, mesh, variant)
            decode = make_sharded_decode_step(model, mesh, variant)
            batch = {k: torch.from_numpy(v) for k, v in prompt(case).items()}
            logits, state, pos = prefill(pp, batch, max_len(cfg, case[4]))
            specs = prefill.state_specs
            got = {"logits": [logits], "tokens": [], "specs": specs,
                   "prefill_bytes": dict(prefill.comm.bytes), "decode_bytes": [],
                   "decode_param_specs": sharding.param_shardings(
                       params, cfg, MESHES[mesh_name], cell_rules(
                           cfg, "decode", variant, MESHES[mesh_name])[1])}
            for _ in range(NEW_TOKENS):
                tok = logits.argmax(-1)
                got["tokens"].append(tok)
                logits, state = decode(pd, state, tok, pos, specs)
                got["logits"].append(logits)
                got["decode_bytes"].append(dict(decode.comm.bytes))
                pos += 1
            got["state"] = tree_clone(state)
            res[case_name(case)] = got
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
