"""A train step whose parameters and AdamW moments live sharded over a torch
DeviceMesh by the rules of `sharding` (the port's counterpart of the
reference's ``jax.jit(train_step, in_shardings=...)``,
`repro.launch.specs.make_cell`).

Each step, on every rank:

1. gathers the parameters whole from their shards (an all-gather per
   sharded mesh axis of each leaf, minor axis first);
2. runs the port's ordinary `loss_and_grads` (the model's `loss` through
   its kernels) on the rank's share of the batch (`rank_batch`): its
   slice, as `batch_shardings` splits a microbatch over the data axes, of
   each of the `grad_accum` microbatches that the unsharded step cuts
   (whole where a microbatch does not divide);
3. weights each microbatch's loss and gradients by the rank's share of
   that microbatch's global loss-mask count and sums them over the data
   axes, flattened into one group (one all-reduce a tensor): each global
   microbatch's masked mean, where a mean of per-rank means would differ
   whenever the shards' masks differ.  Ranks that differ only in their
   `model` coordinate computed the same gradients and are not summed;
4. cuts each gradient to the rank's shard and takes the global norm with
   each element counted once (a shard's squares count on the rank at
   coordinate 0 of every axis that does not split it);
5. applies `adamw_update` to the local shards, the moments in place.

On one rank every collective is a copy and every weight is 1, so the step
is bit for bit `make_train_step`'s.

Limits: at compute time the full parameters and gradients are resident on
every rank; each gradient is all-reduced whole and then cut to the shard
(a reduce-scatter would move the same operand and keep only the shard),
and the ranks of the `model` axis store less but compute the same thing;
per-layer gathering and tensor-parallel compute are queued (ROADMAP).
The moe family's capacity and load-balancing loss are taken over each
rank's tokens, as data-parallel moe training does, not over the global
microbatch; a loss mask whose sum on a rank lies strictly between 0 and 1
is weighted by that sum where the unsharded mean clamps it to 1.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import (_axes, _names, batch_shardings, local_slice,
                                              mesh_coords, param_shardings, shard_tree,
                                              spec_of)
from repro_torch.launch.mesh import MeshShape
from repro_torch.training.optimizer import (AdamWState, adamw_update, all_gather_fn,
                                            tree_leaves, tree_map)
from repro_torch.training.train import TrainConfig, loss_and_grads

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


class Collectives:
    """The step's collectives over the process groups of a DeviceMesh's axes,
    each counted by its per-device operand bytes (the convention of the
    reference's dry run: an all-gather's operand is the rank's input, an
    all-reduce's the whole tensor).  The transport is `_gather` and
    `_reduce`; the dry run's `launch.specs.ShapeCollectives` replaces only
    those, so a fake step counts what a real one does."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.mesh = MeshShape.of(device_mesh)
        self.coords = mesh_coords(device_mesh)
        self.groups = {}
        self.reset()

    def reset(self) -> None:
        self.bytes = dict.fromkeys(COLLECTIVES, 0)

    def all_gather(self, t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """`t` concatenated along `dim` over the ranks of mesh axis `axis`."""
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((self.mesh.shape[axis] * src.shape[0],) + tuple(src.shape[1:]))
        self._gather(out, src, axis)
        self.bytes["all-gather"] += src.numel() * src.element_size()
        return out.movedim(0, dim).contiguous()   # the layout the unsharded step has

    def all_reduce(self, t: torch.Tensor, axes: Optional[Tuple[str, ...]] = None
                   ) -> torch.Tensor:
        """`t` summed in place, in one collective, over the ranks that differ
        from this one only on the mesh axes `axes` (None: every rank)."""
        self._reduce(t, axes)
        self.bytes["all-reduce"] += t.numel() * t.element_size()
        return t

    def _gather(self, out: torch.Tensor, src: torch.Tensor, axis: str) -> None:
        all_gather_fn()(out, src, group=self.device_mesh.get_group(axis))

    def _reduce(self, t: torch.Tensor, axes) -> None:
        import torch.distributed as dist
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._group(axes))

    def _group(self, axes):
        """The process group over `axes`: one axis's group of the mesh, or for
        several axes one group of each set of ranks that differ only on them,
        made at first use (every rank reaches it at the same point)."""
        if axes is None:
            return None
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self.groups:
            import torch.distributed as dist
            names = list(self.device_mesh.mesh_dim_names)
            rest = [i for i, a in enumerate(names) if a not in axes]
            ranks = self.device_mesh.mesh.permute(rest + [names.index(a) for a in axes])
            self.groups[axes], _ = dist.new_subgroups_by_enumeration(
                ranks.reshape(-1, math.prod(self.mesh.shape[a] for a in axes)).tolist())
        return self.groups[axes]


def gather_leaf(t: torch.Tensor, spec, comm, keep: Sequence[int] = ()) -> torch.Tensor:
    """A shard gathered whole along every dim its spec splits (but those in
    `keep`): one all-gather per mesh axis, the minor axis first."""
    for dim, entry in enumerate(spec):
        if entry is None or dim in keep:
            continue
        for axis in reversed(_names(entry)):
            t = comm.all_gather(t, dim, axis)
    return t


def _owns(spec, comm) -> float:
    """1.0 on the one rank of each group of copies of a shard that counts
    it in the global norm: coordinate 0 on every axis that does not split
    the leaf."""
    split = {a for e in spec if e is not None for a in _names(e)}
    return float(all(c == 0 for a, c in comm.coords.items() if a not in split))


def rank_step(model, tcfg: TrainConfig, params, p_specs, opt: AdamWState, batch, comm):
    """One train step as one rank runs it, on local tensors: `params` and
    `opt`'s moments are this rank's shards under `p_specs`, `batch` its
    share of the global batch (`rank_batch`).  `comm` carries the mesh,
    this rank's coordinates and the collectives.  Returns (new parameter
    shards, the state, {"loss", "grad_norm"}), the loss and norm the
    global ones."""
    dp, _ = _axes(comm.mesh)
    full = tree_map(lambda t, s: gather_leaf(t, s, comm), params, p_specs)
    count = batch["loss_mask"].float().reshape(tcfg.grad_accum, -1).sum(1)
    total = comm.all_reduce(count.clone(), dp)
    loss, grads = loss_and_grads(model, tcfg, full, batch,
                                 weights=count / torch.clamp(total, min=1.0))
    del full
    specs = tree_leaves(p_specs)
    comm.all_reduce(loss, dp)
    for g in tree_leaves(grads):
        comm.all_reduce(g, dp)
    g_local = tree_map(lambda g, s: local_slice(g, s, comm.mesh, comm.coords), grads, p_specs)
    sq = torch.stack([torch.sum(torch.square(g.float())) for g in tree_leaves(g_local)])
    sq = sq * torch.tensor([_owns(s, comm) for s in specs], device=sq.device)
    comm.all_reduce(sq)
    gnorm = torch.sqrt(torch.sum(sq))
    new, opt, om = adamw_update(g_local, opt, params, lr=tcfg.lr, b1=tcfg.b1, b2=tcfg.b2,
                                weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm,
                                grad_norm=gnorm)
    return new, opt, {"loss": loss, **om}


def rank_batch(batch, cfg, mesh: MeshShape, coords, grad_accum: int):
    """This rank's share of the global `batch`: its slice, under
    `batch_shardings` of one microbatch, of each of the `grad_accum`
    microbatches that `loss_and_grads` cuts, stacked in their order (with
    one microbatch, the rank's slice of the batch)."""
    micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])
             for k, v in batch.items()}
    specs = batch_shardings({k: v[0] for k, v in micro.items()}, cfg, mesh)
    return {k: local_slice(v, (None,) + tuple(specs[k]), mesh, coords)
            .reshape(-1, *v.shape[2:]) for k, v in micro.items()}


def shard_train_state(params, opt: AdamWState, cfg, device_mesh):
    """Full parameters and AdamW state (the same on every rank) as DTensors
    under the rules' placements (baseline); the moments take the
    parameters' placements, the step count stays a plain replicated
    tensor."""
    specs = param_shardings(params, cfg, MeshShape.of(device_mesh))
    return (shard_tree(params, specs, device_mesh),
            AdamWState(opt.step, shard_tree(opt.m, specs, device_mesh),
                       shard_tree(opt.v, specs, device_mesh)))


def make_sharded_train_step(model, tcfg: TrainConfig, device_mesh):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) over DTensor parameters and moments (`shard_train_state`) and
    the global batch, the same on every rank (each takes its own slice).
    metrics: "loss" and "grad_norm" (global, on every rank) and
    "collective_bytes", this step's per-device operand bytes by kind.
    Every rank of the mesh calls it."""
    from torch.distributed.tensor import DTensor

    mesh = MeshShape.of(device_mesh)
    names = tuple(device_mesh.mesh_dim_names)
    comm = Collectives(device_mesh)

    def train_step(params, opt_state: AdamWState, batch):
        with torch.no_grad():
            local = tree_map(lambda t: t.to_local(), params)
            m = tree_map(lambda t: t.to_local(), opt_state.m)
            v = tree_map(lambda t: t.to_local(), opt_state.v)
        p_specs = tree_map(lambda t: spec_of(t.placements, names, t.ndim), params)
        comm.reset()
        mine = rank_batch(batch, model.cfg, mesh, comm.coords, tcfg.grad_accum)
        new, opt, metrics = rank_step(model, tcfg, local, p_specs,
                                      AdamWState(opt_state.step, m, v), mine, comm)
        new_params = tree_map(
            lambda n, t: DTensor.from_local(n, device_mesh, t.placements, run_check=False,
                                            shape=t.shape, stride=t.stride()), new, params)
        return (new_params, AdamWState(opt.step, opt_state.m, opt_state.v),
                {**metrics, "collective_bytes": dict(comm.bytes)})

    return train_step
