"""The ranks of `test_torch_tensor_parallel_families.py`: four spawned gloo
processes that run the port's split-compute train step and sharded serving
for the ssm, hybrid and encdec families on small meshes, and write what
they saw for the parent, which holds the references.  A share each, the
ranks also run the unsharded steps and count the dry run's collectives of
the train cases (`ShapeCollectives` over fake tensors), while the parent
runs the JAX package's steps.

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
from repro_torch.distributed.serve_step import (make_sharded_decode_step, make_sharded_prefill,
                                                rank_decode, rank_prefill)
from repro_torch.distributed.train_step import (make_sharded_train_step, rank_batch, rank_step,
                                                shard_train_state)
from repro_torch.launch.mesh import MeshShape, make_mesh
from repro_torch.launch.specs import ShapeCollectives, fake_mode
from repro_torch.models import build_model
from repro_torch.training import TrainConfig, adamw_init, make_train_step
from repro_torch.training.optimizer import tree_map

from torch_ranks import WORLD, _init, forced_fsdp
from torch_tp_ranks import tree_clone

LR = 1e-3
STEPS = 2
NEW_TOKENS = 8
MESHES = {"2x2": MeshShape(("data", "model"), (2, 2)),
          "1x4": MeshShape(("data", "model"), (1, 4))}
# reduced configs (fp32): name -> (arch, overrides).  Reduced mamba2 and
# hymba have 8 SSM heads (4 or 2 a rank); at d_model 48 they have 6, which
# split 1 or 2 a rank over 4 ranks in training and prefill, and whose decode
# state the rules keep whole (decoded whole on every rank).  "hymba-6:2"
# also splits its attention heads unevenly and leaves its ff (126) and
# vocabulary (250) replicated over `model`
CONFIGS = {"mamba2": ("mamba2-780m", {}),
           "hymba": ("hymba-1.5b", {}),
           "seamless": ("seamless-m4t-large-v2", {}),
           "mamba2-d48": ("mamba2-780m", {"d_model": 48}),
           "hymba-6:2": ("hymba-1.5b", {"d_model": 48, "num_heads": 6, "num_kv_heads": 2,
                                        "d_ff": 126, "vocab_size": 250})}
# (config, mesh, FSDP forced on, grad_accum)
TRAIN_CASES = (("mamba2", "2x2", False, 1), ("hymba", "2x2", True, 1),
               ("seamless", "2x2", False, 1), ("seamless", "2x2", True, 2),
               ("mamba2-d48", "1x4", True, 1), ("hymba-6:2", "1x4", False, 1),
               ("seamless", "1x4", False, 1))
# one case per family that the parent also holds to the JAX package's step
JAX_CASES = (("mamba2", "2x2", False, 1), ("hymba", "2x2", True, 1),
             ("seamless", "2x2", False, 1))
# (config, mesh, prompt rows, prompt tokens): sharded prefill, then
# NEW_TOKENS greedy decode steps.  Hymba's prompts wrap its window ring
# (4 meta + 20 tokens past 4 + 16 slots); on 1 x 4 its full cache (23 + 8
# slots) divides no axis and stays whole; one row on 2 x 2 puts the caches'
# sequence over `data` (long_500k's placement); seamless's 10 source frames
# split over 2 ranks of `model`, not 4
SERVE_CASES = (("mamba2", "2x2", 2, 8), ("hymba", "2x2", 2, 20), ("seamless", "2x2", 2, 8),
               ("mamba2-d48", "1x4", 2, 8), ("hymba-6:2", "1x4", 2, 19),
               ("seamless", "1x4", 2, 8), ("hymba", "2x2", 1, 20), ("mamba2", "2x2", 1, 8))
SRC_FRAMES = 10


def case_name(case) -> str:
    return "-".join(str(x) for x in case)


def config(name: str):
    arch, kw = CONFIGS[name]
    return dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **kw)


def max_len(cfg, tokens: int) -> int:
    """The decode state's slots for a prompt of `tokens` and NEW_TOKENS."""
    return tokens + cfg.num_meta_tokens + NEW_TOKENS


def train_batches(name: str, b: int = 4, s: int = 16):
    """STEPS batches of config `name` whose loss masks differ between the two
    data shards (rows 0-1 keep about a third of their positions, rows 2-3
    all)."""
    cfg = config(name)
    rng = np.random.default_rng(3 + list(CONFIGS).index(name))
    out = []
    for _ in range(STEPS):
        mask = np.ones((b, s), np.float32)
        mask[: b // 2] = (rng.random((b // 2, s)) < 0.35).astype(np.float32)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                 "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                 "loss_mask": mask}
        if cfg.family == "encdec":
            batch["src_embeds"] = rng.standard_normal((b, SRC_FRAMES, cfg.d_model)
                                                      ).astype(np.float32)
        out.append(batch)
    return out


def prompt(case):
    """The prompt of SERVE_CASES' `case`."""
    name, _, b, s = case
    cfg = config(name)
    rng = np.random.default_rng(7 + SERVE_CASES.index(case))
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["src_embeds"] = rng.standard_normal((b, SRC_FRAMES, cfg.d_model)).astype(np.float32)
    return out


def fake_local(tree, specs, mesh):
    """Fake tensors of one device's shard shapes under `specs`."""
    return tree_map(lambda t, s: torch.empty(sharding.local_shape(t.shape, s, mesh),
                                             dtype=t.dtype), tree, specs)


def _fake(batch):
    return {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in batch.items()}


def fake_train_bytes(cfg, mesh, batch, accum: int, model=None) -> dict:
    """What the dry run counts for one rank's split train step: `rank_step`
    over `ShapeCollectives` (the last rank of `model`) on fake shards and a
    fake batch share."""
    model = model or build_model(cfg, device="cpu")
    comm = ShapeCollectives(mesh)
    with fake_mode():
        params = model.init(torch.Generator())
        specs = sharding.param_shardings(params, cfg, mesh)
        local = fake_local(params, specs, mesh)
        b, split = rank_batch(_fake(batch), cfg, mesh, comm.coords, accum)
        rank_step(model, TrainConfig(lr=LR, grad_accum=accum), local, specs,
                  adamw_init(local), b, split, comm)
    return dict(comm.bytes)


def fake_serve_bytes(case) -> dict:
    """What the dry run counts for one rank's prefill and decode step of
    SERVE_CASES' `case` (`rank_prefill`, `rank_decode` over
    `ShapeCollectives`), and the state's specs."""
    name, mesh_name, rows, tokens = case
    cfg, mesh = config(name), MESHES[mesh_name]
    model = build_model(cfg, device="cpu")
    comm = ShapeCollectives(mesh)
    with fake_mode():
        params = model.init(torch.Generator())
        specs = sharding.param_shardings(params, cfg, mesh)
        local = fake_local(params, specs, mesh)
        batch = _fake(prompt(case))
        mine = fake_local(batch, sharding.batch_shardings(batch, cfg, mesh), mesh)
        _, state, pos, st_specs = rank_prefill(model, local, specs, mine,
                                               max_len(cfg, tokens), comm, rows)
        out = {"prefill": dict(comm.bytes), "specs": st_specs}
        comm.reset()
        rank_decode(model, local, specs, state, st_specs, mine["tokens"][:, 0].long(), pos,
                    comm)
    return {**out, "decode": dict(comm.bytes)}


def unsharded_steps(params_np, name: str, accum: int) -> dict:
    """The port's `make_train_step` on the whole batches of config `name`
    from `params_np`: losses, norms and the final parameters."""
    cfg = config(name)
    params = params_from_jax(cfg, params_np, device="cpu")
    step = make_train_step(build_model(cfg, device="cpu"), TrainConfig(lr=LR, grad_accum=accum))
    opt = adamw_init(params)
    run = {"loss": [], "grad_norm": []}
    for b in train_batches(name):
        params, opt, met = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
        run["loss"].append(float(met["loss"]))
        run["grad_norm"].append(float(met["grad_norm"]))
    run["params"] = params
    return run


def _fake_counts(rank: int) -> dict:
    """This rank's share of the dry run's counts of the train cases (the
    parent counts the serve cases, `fake_serve_bytes`)."""
    out = {}
    for case in TRAIN_CASES[rank::WORLD]:
        name, mesh_name, fsdp, accum = case
        cfg = config(name)

        def count():
            return fake_train_bytes(cfg, MESHES[mesh_name], train_batches(name)[0], accum)
        out[case] = forced_fsdp(count) if fsdp else count()
    return out


def family_ranks(rank, out):
    """This rank's share of the dry run's counts (`_fake_counts`) and of the
    unsharded steps (`unsharded_steps`); then, from the weights the parent
    saved in out/params.pt, every TRAIN_CASES case for STEPS
    steps (loss, norm, collective bytes per step; the parameters gathered
    at the end), then every SERVE_CASES case: prefill the case's `prompt`
    into a state of `max_len` slots and decode greedily (this rank's rows'
    tokens and logits, its state slice after prefill and at the end, the
    state's specs and the collective bytes)."""
    _init(rank, WORLD, out)
    res = {"coords": {}}
    try:
        res["fake"] = _fake_counts(rank)
        params_np = torch.load(os.path.join(out, "params.pt"), weights_only=False)
        res["unsharded"] = {case: unsharded_steps(params_np[case[0]], case[0], case[3])
                            for case in TRAIN_CASES[rank::WORLD]}
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
                for b in train_batches(name):
                    p, o, m = step(p, o, {k: torch.from_numpy(v) for k, v in b.items()})
                    got["loss"].append(m["loss"].item())
                    got["grad_norm"].append(m["grad_norm"].item())
                    got["bytes"].append(m["collective_bytes"])
                got["params"] = sharding.gather_tree(p)
                return got
            res[case_name(case)] = forced_fsdp(run) if fsdp else run()
        for case in SERVE_CASES:
            name, mesh_name = case[:2]
            cfg, mesh = config(name), meshes[mesh_name]
            model = build_model(cfg, device="cpu")
            params = params_from_jax(cfg, params_np[name], device="cpu")
            p, _ = shard_train_state(params, adamw_init(params), cfg, mesh)
            prefill, decode = make_sharded_prefill(model, mesh), make_sharded_decode_step(
                model, mesh)
            batch = {k: torch.from_numpy(v) for k, v in prompt(case).items()}
            logits, state, pos = prefill(p, batch, max_len(cfg, case[3]))
            specs = prefill.state_specs
            got = {"logits": [logits], "tokens": [], "state0": tree_clone(state),
                   "specs": specs, "prefill_bytes": dict(prefill.comm.bytes),
                   "decode_bytes": []}
            for _ in range(NEW_TOKENS):
                tok = logits.argmax(-1)
                got["tokens"].append(tok)
                logits, state = decode(p, state, tok, pos, specs)
                got["logits"].append(logits)
                got["decode_bytes"].append(dict(decode.comm.bytes))
                pos += 1
            got["state"] = state
            res[case_name(case)] = got
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
