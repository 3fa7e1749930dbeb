"""A train step whose parameters and AdamW moments live sharded over a torch
DeviceMesh by the rules of `sharding` (the port's counterpart of the
reference's ``jax.jit(train_step, in_shardings=...)``,
`repro.launch.specs.make_cell`).

Each step, on every rank, over the rank's share of the batch
(`rank_batch`: its slice, as `batch_shardings` splits a microbatch over the
data axes, of each of the `grad_accum` microbatches that the unsharded
step cuts; whole where a microbatch does not divide):

1. weights each microbatch's loss by the rank's share of that
   microbatch's global loss-mask count, before the backward: summed over
   the data axes that gives each global microbatch's masked mean, where a
   mean of per-rank means would differ whenever the shards' masks differ;
2. splits the compute (`tensor_parallel.Split`, the model's ``tp``): each
   layer gathers its FSDP rows over the data axes where it runs (inside
   its activation checkpoint) and computes the rank's heads, ff columns,
   experts, SSM heads and vocabulary; the gradients of FSDP-sharded leaves
   come out of the backward reduce-scattered over the data axes, those of
   `model`-split leaves are the rank's own, and the rest are summed over
   the data axes (one all-reduce a tensor).  The moe family keeps each
   global microbatch's capacity and load-balancing loss;
3. takes the global norm with each element counted once (a shard's
   squares count on the rank at coordinate 0 of every axis that does not
   split it);
4. applies `adamw_update` to the local shards, the moments in place.  The
   moments lie under the baseline rules whatever the variant, as the
   reference places them: where a moment is split over more axes than its
   parameter (opt-zmlp's MLP, FSDP-only weights beside moments split over
   `model`), the update takes the moment's block of the gradient and of
   the parameter, and the new parameter's blocks are all-gathered back.

`variant` names the reference's rules ("baseline", "opt", "opt-zmlp";
`launch.specs.cell_rules`): under opt the residual stream runs cut over
`model` (sequence parallelism), opt-zmlp's MLP runs on the rank's tokens,
and attention off the card runs blocked (`tensor_parallel.Split`).

On one rank every collective is a copy, every selection the whole leaf
and every weight 1, so the step is bit for bit `make_train_step`'s (under
opt off the card, where blocked attention replaces the plain one, within
f32 rounding).

Limit: a loss mask whose sum on a rank lies strictly between 0 and 1 is
weighted by that sum where the unsharded mean clamps it to 1.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.distributed.sharding import (_axes, _names, batch_shardings, local_slice,
                                              mesh_coords, param_shardings, shard_index,
                                              shard_tree, spec_of)
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
    all-reduce's and a reduce-scatter's the whole tensor, an all-to-all's
    what the rank sends).  The transport is `_gather`, `_reduce`,
    `_reduce_scatter` and `_all_to_all`; the dry run's
    `launch.specs.ShapeCollectives` replaces only those, so a fake step
    counts what a real one does.  `axes` is one mesh axis or a tuple of
    them (the flattened data axes), None every rank.  Over a group of one
    rank a collective is the identity: it moves nothing and copies
    nothing, and counts its bytes all the same."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.mesh = MeshShape.of(device_mesh)
        self.coords = mesh_coords(device_mesh)
        self.groups = {}
        self.reset()

    def reset(self) -> None:
        self.bytes = dict.fromkeys(COLLECTIVES, 0)

    def size(self, axes) -> int:
        """The ranks of `axes` (None: every rank)."""
        if axes is None:
            return self.mesh.size
        return math.prod(self.mesh.shape[a] for a in _names(axes))

    def all_gather(self, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """`t` concatenated along `dim` over the ranks of `axes`, major to
        minor."""
        self.bytes["all-gather"] += t.numel() * t.element_size()
        if self.size(axes) == 1:
            return t
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((self.size(axes) * src.shape[0],) + tuple(src.shape[1:]))
        self._gather(out, src, _names(axes))
        return out.movedim(0, dim).contiguous()   # the layout the unsharded step has

    def all_reduce(self, t: torch.Tensor, axes=None, op: str = "sum") -> torch.Tensor:
        """`t` reduced in place (op "sum" or "max"), in one collective, over
        the ranks that differ from this one only on `axes`."""
        self.bytes["all-reduce"] += t.numel() * t.element_size()
        if self.size(axes) > 1:
            self._reduce(t, None if axes is None else _names(axes), op)
        return t

    def all_reduced(self, t: torch.Tensor, axes=None, op: str = "sum") -> torch.Tensor:
        """`all_reduce` into a new tensor, `t` left as it is (`t` itself
        over a group of one rank)."""
        if self.size(axes) == 1:
            self.bytes["all-reduce"] += t.numel() * t.element_size()
            return t
        return self.all_reduce(t.contiguous().clone(), axes, op)

    def reduce_scatter(self, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """This rank's block along `dim` of `t` summed over the ranks of
        `axes` (the backward of `all_gather`)."""
        self.bytes["reduce-scatter"] += t.numel() * t.element_size()
        if self.size(axes) == 1:
            return t
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // self.size(axes),) + tuple(src.shape[1:]))
        self._reduce_scatter(out, src, _names(axes))
        return out.movedim(0, dim).contiguous()

    def all_to_all(self, sends: Sequence[torch.Tensor], recv_shapes, axes) -> list:
        """sends[i] to the i-th rank of `axes`; returns what each rank sent
        this one, of shapes `recv_shapes` (one dtype throughout)."""
        self.bytes["all-to-all"] += sum(t.numel() * t.element_size() for t in sends)
        if self.size(axes) == 1:
            return [sends[0].reshape(tuple(recv_shapes[0]))]
        src = torch.cat([t.reshape(-1) for t in sends])
        sizes = [math.prod(s) for s in recv_shapes]
        out = src.new_empty((sum(sizes),))
        self._all_to_all(out, src, sizes, [t.numel() for t in sends], _names(axes))
        return [c.view(tuple(s)) for c, s in zip(out.split(sizes), recv_shapes)]

    def _gather(self, out: torch.Tensor, src: torch.Tensor, axes) -> None:
        all_gather_fn()(out, src, group=self._group(axes))

    def _reduce(self, t: torch.Tensor, axes, op: str) -> None:
        import torch.distributed as dist
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self._group(axes))

    def _reduce_scatter(self, out: torch.Tensor, src: torch.Tensor, axes) -> None:
        import torch.distributed as dist
        dist.reduce_scatter_tensor(out, src, group=self._group(axes))

    def _all_to_all(self, out, src, out_sizes, in_sizes, axes) -> None:
        import torch.distributed as dist
        dist.all_to_all_single(out, src, output_split_sizes=out_sizes,
                               input_split_sizes=in_sizes, group=self._group(axes))

    def _group(self, axes):
        """The process group over `axes`: one axis's group of the mesh, or for
        several axes one group of each set of ranks that differ only on them,
        ranked major to minor, made at first use (every rank reaches it at
        the same point)."""
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


def _owns(spec, comm) -> float:
    """1.0 on the one rank of each group of copies of a shard that counts
    it in the global norm: coordinate 0 on every axis that does not split
    the leaf."""
    split = {a for e in spec if e is not None for a in _names(e)}
    return float(all(c == 0 for a, c in comm.coords.items() if a not in split))


class _OnMesh:
    """A model whose `loss` runs this rank's share of the split compute."""

    def __init__(self, model, tp):
        self.model, self.tp = model, tp

    def loss(self, params, batch):
        return self.model.loss(params, batch, tp=self.tp)


def _moment_dims(p_spec, m_spec):
    """[(tensor dim, axes)] that a moment's spec splits beyond its
    parameter's (the moment's axes of a dim extend the parameter's)."""
    out = []
    for d, (pe, me) in enumerate(zip(p_spec, m_spec)):
        pa, ma = (_names(e) if e is not None else () for e in (pe, me))
        if pa != ma:
            if ma[:len(pa)] != pa:
                raise ValueError(f"a moment under {m_spec} beside its parameter under {p_spec}")
            out.append((d, ma[len(pa):]))
    return out


def _to_moment(t, dims, comm):
    """The block of a parameter shard (or its gradient) that this rank's
    moment covers."""
    for d, axes in dims:
        i, n = shard_index(axes, comm.mesh, comm.coords)
        w = t.shape[d] // n
        t = t.narrow(d, i * w, w)
    return t


def _from_moment(t, dims, comm):
    """A moment's block of a new parameter all-gathered to the parameter's
    shard, minor axis first."""
    for d, axes in reversed(dims):
        for a in reversed(axes):
            t = comm.all_gather(t, d, a)
    return t


def rank_step(model, tcfg: TrainConfig, params, p_specs, opt: AdamWState, batch,
              batch_split: bool, comm, variant: str = "baseline", m_specs=None):
    """One train step as one rank runs it, on local tensors: `params` and
    `opt`'s moments are this rank's shards under `p_specs` and `m_specs`
    (default `p_specs`), `batch` and `batch_split` its share of the global
    batch and whether the microbatches were split, as `rank_batch` returns
    them.  `comm` carries the mesh, this rank's coordinates and the
    collectives; `variant` the rules (`Split`).  Returns (new parameter
    shards, the state, {"loss", "grad_norm"}), the loss and norm the global
    ones."""
    from repro_torch.distributed.tensor_parallel import Split
    dp, _ = _axes(comm.mesh)
    count = batch["loss_mask"].float().reshape(tcfg.grad_accum, -1).sum(1)
    total = comm.all_reduced(count, dp)
    weights = count / torch.clamp(total, min=1.0)
    specs = tree_leaves(p_specs)
    tp = Split(model.cfg, comm, p_specs, batch_split, variant=variant)
    loss, g_local = loss_and_grads(_OnMesh(model, tp), tcfg, params, batch, weights=weights)
    comm.all_reduce(loss, dp)
    # FSDP rows came out of the backward reduce-scattered over the data
    # axes; the rest is summed over them here
    for g, s in zip(tree_leaves(g_local), specs):
        if not any(a in dp for e in s if e is not None for a in _names(e)):
            comm.all_reduce(g, dp)
    sq = torch.stack([torch.sum(torch.square(g.float())) for g in tree_leaves(g_local)])
    sq = sq * torch.tensor([_owns(s, comm) for s in specs], device=sq.device)
    comm.all_reduce(sq)
    gnorm = torch.sqrt(torch.sum(sq))
    dims = tree_map(_moment_dims, p_specs, p_specs if m_specs is None else m_specs)
    new, opt, om = adamw_update(tree_map(lambda g, d: _to_moment(g, d, comm), g_local, dims),
                                opt, tree_map(lambda p, d: _to_moment(p, d, comm), params, dims),
                                lr=tcfg.lr, b1=tcfg.b1, b2=tcfg.b2,
                                weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm,
                                grad_norm=gnorm)
    return tree_map(lambda p, d: _from_moment(p, d, comm), new, dims), opt, {"loss": loss, **om}


def splits_rows(batch_specs) -> bool:
    """Whether `batch_shardings`' specs of a microbatch split its rows over
    the data axes (they do not where the rows do not divide: every data
    rank then holds the microbatch whole)."""
    return batch_specs["tokens"][0] is not None


def rank_batch(batch, cfg, mesh: MeshShape, coords, grad_accum: int):
    """This rank's share of the global `batch`: its slice, under
    `batch_shardings` of one microbatch, of each of the `grad_accum`
    microbatches that `loss_and_grads` cuts, stacked in their order (with
    one microbatch, the rank's slice of the batch); and whether the
    microbatches were split (`splits_rows`)."""
    micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])
             for k, v in batch.items()}
    specs = batch_shardings({k: v[0] for k, v in micro.items()}, cfg, mesh)
    return ({k: local_slice(v, (None,) + tuple(specs[k]), mesh, coords)
             .reshape(-1, *v.shape[2:]) for k, v in micro.items()}, splits_rows(specs))


def shard_params(params, cfg, device_mesh, variant: str = "baseline", kind: str = "train"):
    """Full parameters (the same on every rank) as DTensors under the
    placements a `kind` step ("train", "prefill", "decode") of `variant`
    computes with (`launch.specs.cell_rules`' parameter variant: a pure
    SSM's opt decode takes opt-rowssm)."""
    from repro_torch.launch.specs import cell_rules
    mesh = MeshShape.of(device_mesh)
    pvariant = cell_rules(cfg, kind, variant, mesh)[1]
    return shard_tree(params, param_shardings(params, cfg, mesh, pvariant), device_mesh)


def shard_train_state(params, opt: AdamWState, cfg, device_mesh, variant: str = "baseline"):
    """Full parameters and AdamW state (the same on every rank) as DTensors:
    the parameters under `variant`'s placements (`shard_params`), the
    moments under the baseline rules whatever the variant, as the
    reference places them; the step count stays a plain replicated
    tensor."""
    specs = param_shardings(params, cfg, MeshShape.of(device_mesh))
    return (shard_params(params, cfg, device_mesh, variant),
            AdamWState(opt.step, shard_tree(opt.m, specs, device_mesh),
                       shard_tree(opt.v, specs, device_mesh)))


def make_sharded_train_step(model, tcfg: TrainConfig, device_mesh, variant: str = "baseline"):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) under `variant`'s rules over DTensor parameters and moments
    (`shard_train_state` with the same variant) and the global batch, the
    same on every rank (each takes its own slice).
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
        m_specs = tree_map(lambda t: spec_of(t.placements, names, t.ndim), opt_state.m)
        comm.reset()
        mine, split = rank_batch(batch, model.cfg, mesh, comm.coords, tcfg.grad_accum)
        new, opt, metrics = rank_step(model, tcfg, local, p_specs,
                                      AdamWState(opt_state.step, m, v), mine, split, comm,
                                      variant, m_specs)
        new_params = tree_map(
            lambda n, t: DTensor.from_local(n, device_mesh, t.placements, run_check=False,
                                            shape=t.shape, stride=t.stride()), new, params)
        return (new_params, AdamWState(opt.step, opt_state.m, opt_state.v),
                {**metrics, "collective_bytes": dict(comm.bytes)})

    return train_step
