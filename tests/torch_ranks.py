"""The ranks of the port's multi-process CPU tests (`test_torch_distributed.py`,
`test_torch_sharding.py`): spawned processes that meet over gloo through a
file store under the test's temporary directory, run the port, and write
their results there for the parent, which holds the reference.

This module imports the port and nothing of JAX, so a spawned rank starts
in a few seconds; the test files import both.
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding
from repro_torch.distributed.train_step import make_sharded_train_step, shard_train_state
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import MeshShape, make_local_mesh, make_mesh
from repro_torch.models import build_model
from repro_torch.training import TrainConfig, adamw_init, make_train_step, save_checkpoint
from repro_torch.training.optimizer import compressed_allreduce, tree_map

LR = 1e-3
WORLD = 4
# (name, mesh, FSDP forced on, grad_accum): the rules on a 2 x 2 mesh
# (columns over `model`), there with two microbatches a step, and on a
# 2 x 2 x 1 pod mesh with the d_model rows FSDP-sharded over ("pod",
# "data") as a model past the threshold would have them
STEP_MESHES = (("2x2", MeshShape(("data", "model"), (2, 2)), False, 1),
               ("2x2-accum2", MeshShape(("data", "model"), (2, 2)), False, 2),
               ("2x2x1", MeshShape(("pod", "data", "model"), (2, 2, 1)), True, 1))
# a world of one: (arch, grad_accum)
ONE_RANK = (("internlm2-1.8b", 1), ("qwen3-moe-30b-a3b", 1), ("smollm-360m", 2))
# hand-picked specs of an [8, 12] tensor on a 2 x 2 and a 2 x 2 x 1 pod mesh
PLACEMENT_MESHES = (MeshShape(("data", "model"), (2, 2)),
                    MeshShape(("pod", "data", "model"), (2, 2, 1)))
HAND_SPECS = ({"a": (None, None), "b": ("data", None), "c": (None, "model"),
               "d": ("data", "model"), "e": ("model", "data")},
              {"a": (("pod", "data"), None), "b": ("pod", "data"), "c": ("data", "pod"),
               "d": (None, ("pod", "data"))})


def internlm2_cfg():
    """The reduced fp32 internlm2-1.8b of `tests/test_sharding.py`."""
    return dataclasses.replace(get_arch("internlm2-1.8b").reduced(), dtype="float32")


def spawn(fn, world: int, args: tuple, timeout: float = 240.0, meanwhile=None):
    """Run fn(rank, *args) in `world` spawned processes; a rank's exception
    fails the test, and so does a run past `timeout` seconds.  `meanwhile`,
    if given, runs in this process while the ranks do; its result is
    returned."""
    ctx = torch.multiprocessing.start_processes(fn, args=args, nprocs=world, join=False,
                                                start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        out = meanwhile() if meanwhile is not None else None
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks still running after {timeout} s")
    return out


def _init(rank: int, world: int, out: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out, 'store')}",
                            rank=rank, world_size=world)


def forced_fsdp(fn):
    """fn() with the rules' FSDP switched on whatever the model's size."""
    real = sharding.fsdp_enabled
    sharding.fsdp_enabled = lambda cfg: True
    try:
        return fn()
    finally:
        sharding.fsdp_enabled = real


def four_ranks(rank, out, xs, params_np, batches):
    """(a) `compressed_allreduce` of row `rank` of `xs`, its gathered payload
    and scales recorded as sent; (b) `len(batches)` sharded steps of the
    reduced internlm2 from `params_np` on each of STEP_MESHES (mesh and
    grad_accum), with (d) a
    checkpoint of the 2 x 2 run after step 1 (rank 0 writes it under
    out/ckpt); then launch.train's sharded path, 2 steps on a 2 x 2 mesh,
    checkpointed under out/train_ckpt."""
    import torch.distributed as dist
    _init(rank, WORLD, out)
    res = {}
    try:
        gathered = []
        real = dist.all_gather_single

        def recording(output, inp, group=None, async_op=False):
            r = real(output, inp, group=group, async_op=async_op)
            gathered.append(output.clone())
            return r
        dist.all_gather_single = recording
        try:
            res["car"] = {"sum": compressed_allreduce(torch.from_numpy(xs[rank])),
                          "q": gathered[0], "scale": gathered[1]}
        finally:
            dist.all_gather_single = real

        cfg = internlm2_cfg()
        model = build_model(cfg, device="cpu")
        for name, shape, fsdp, accum in STEP_MESHES:
            def run():
                mesh = make_mesh(shape, "cpu")
                params = params_from_jax(cfg, params_np, device="cpu")
                p, o = shard_train_state(params, adamw_init(params), cfg, mesh)
                step = make_sharded_train_step(model, TrainConfig(lr=LR, grad_accum=accum),
                                               mesh)
                got = {"loss": [], "grad_norm": [], "bytes": []}
                for i, b in enumerate(batches):
                    p, o, m = step(p, o, {k: torch.from_numpy(v) for k, v in b.items()})
                    got["loss"].append(m["loss"].item())
                    got["grad_norm"].append(m["grad_norm"].item())
                    got["bytes"].append(m["collective_bytes"])
                    if i == 0 and name == "2x2":
                        state = sharding.gather_tree({"params": p, "opt": o})
                        if rank == 0:
                            save_checkpoint(os.path.join(out, "ckpt"), 1, state)
                            # a replicated leaf's gather is its local shard,
                            # which the next step's moments update in place
                            res["saved"] = {"params": tree_map(torch.clone, state["params"]),
                                            "opt": type(state["opt"])(
                                                state["opt"].step.clone(),
                                                tree_map(torch.clone, state["opt"].m),
                                                tree_map(torch.clone, state["opt"].v))}
                        dist.barrier()
                got["params"] = sharding.gather_tree(p)
                got["local_shapes"] = {k: tuple(v.to_local().shape)
                                       for k, v in p["layers"]["attn"].items()}
                return got
            res[name] = forced_fsdp(run) if fsdp else run()

        port_train.main(["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu",
                         "--batch", "4", "--seq", "16", "--steps", "2", "--ckpt-every", "2",
                         "--log-every", "1", "--mesh", "2x2",
                         "--ckpt-dir", os.path.join(out, "train_ckpt")])
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def one_rank(rank, out):
    """A world of one (`make_local_mesh("cpu")`, its own file store): three
    steps of each ONE_RANK config, sharded and unsharded from one init in
    turns; and `make_mesh` refusing a mesh of another size."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    res = {}
    mesh = make_local_mesh("cpu")
    try:
        try:
            make_mesh(MeshShape(("data", "model"), (2, 2)), "cpu")
            res["refused"] = None
        except ValueError as e:
            res["refused"] = str(e)
        for name, accum in ONE_RANK:
            cfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32")
            model = build_model(cfg, device="cpu")
            params = model.init(torch.Generator().manual_seed(0))
            tcfg = TrainConfig(lr=LR, grad_accum=accum)
            plain, sharded = (make_train_step(model, tcfg),
                              make_sharded_train_step(model, tcfg, mesh))
            pa, oa = params, adamw_init(params)
            pb, ob = shard_train_state(params, adamw_init(params), cfg, mesh)
            rng = np.random.default_rng(1)
            runs = {"plain": [], "sharded": []}
            for _ in range(3):
                b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))),
                     "targets": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))),
                     "loss_mask": torch.from_numpy((rng.random((4, 16)) < 0.7)
                                                   .astype(np.float32))}
                pa, oa, ma = plain(pa, oa, b)
                pb, ob, mb = sharded(pb, ob, b)
                runs["plain"].append((ma["loss"], ma["grad_norm"]))
                runs["sharded"].append((mb["loss"], mb["grad_norm"]))
            state = sharding.gather_tree({"params": pb, "m": ob.m, "v": ob.v})
            res[name] = {"runs": runs, "plain": {"params": pa, "m": oa.m, "v": oa.v},
                         "sharded": state, "steps": (int(oa.step), int(ob.step))}
        torch.save(res, os.path.join(out, "one.pt"))
    finally:
        dist.destroy_process_group()


def placement_ranks(rank, out):
    """On each of PLACEMENT_MESHES, for HAND_SPECS on an [8, 12] tensor and
    the rules' specs (FSDP forced) of a reduced internlm2: what
    `distribute_tensor` holds on this rank beside `local_shape`,
    `local_slice`, `shard_tree`, `spec_of` and `gather_tree`."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    _init(rank, WORLD, out)
    try:
        cfg = internlm2_cfg()
        params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        res = []
        for shape, hand in zip(PLACEMENT_MESHES, HAND_SPECS):
            mesh = make_mesh(shape, "cpu")
            coords = sharding.mesh_coords(mesh)
            t = torch.arange(96, dtype=torch.float32).reshape(8, 12)
            tree = {**{k: t for k in hand}, "params": params}
            specs = {**hand, "params": forced_fsdp(
                lambda: sharding.param_shardings(params, cfg, shape))}
            shards = _flat(sharding.shard_tree(tree, specs, mesh))
            whole = _flat(sharding.gather_tree(sharding.shard_tree(tree, specs, mesh)))
            full_leaves = _flat(tree)
            for path, spec in _flat(specs).items():
                full = full_leaves[path]
                ref = distribute_tensor(full, mesh, sharding.placements(spec, mesh)).to_local()
                mine = sharding.local_slice(full, spec, shape, coords)
                res.append({"mesh": shape.name, "path": path, "spec": spec,
                            "local_shape": tuple(ref.shape),
                            "rules_shape": sharding.local_shape(full.shape, spec, shape),
                            "slice_equal": torch.equal(mine, ref),
                            "shard_equal": torch.equal(shards[path].to_local(), ref),
                            "spec_back": sharding.spec_of(shards[path].placements,
                                                          mesh.mesh_dim_names, full.ndim),
                            "gathered_equal": torch.equal(whole[path], full)})
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _flat(tree, prefix=""):
    """{path: leaf} over dicts (a spec tuple is a leaf)."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _flat(sub, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}
