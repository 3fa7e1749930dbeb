"""Sharded prefill and decode for the dense, moe and vlm families: the
serving counterpart of `train_step`, over the rules' placements (the
parameters by `param_shardings`, the decode state by `state_shardings`:
its batch over the data axes, its sequence over `model`).

A rank computes its share of every layer (`tensor_parallel.Split`):

- prefill runs flash over the rank's heads for the whole prompt, then one
  all-to-all over `model` hands each rank the K/V of its sequence slice;
- decode makes q and the new K/V for the rank's heads and all-gathers them
  over `model` (B x H x D), the rank holding slot `pos` writes the new K/V,
  each rank runs `decode_attention` with its LSE over its slice and the
  partials are combined over `model`;
- the logits are all-gathered over the vocabulary for sampling.

Nothing gathers the parameters whole or the decode state.  On a world of
one the steps are the unsharded `prefill` and `decode_step` bit for bit.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed.sharding import (_axes, batch_shardings, local_slice,
                                              spec_of, state_shardings)
from repro_torch.distributed.tensor_parallel import MODEL, Split
from repro_torch.distributed.train_step import Collectives
from repro_torch.kvcache.cache import decode_state_shapes
from repro_torch.launch.mesh import MeshShape
from repro_torch.training.optimizer import tree_leaves, tree_map


def check_state_specs(st_specs, mesh: MeshShape) -> None:
    """The decode state must lie as the rules place it for a batch that
    divides over the data axes: [L, B, S, H, D] with B over them and S over
    `model`."""
    dp, _ = _axes(mesh)
    want = (None, dp[0] if len(dp) == 1 else dp, MODEL, None, None)
    for s in tree_leaves(st_specs):
        if tuple(s) != want:
            raise ValueError(f"split decode takes a state placed {want}, not {s} "
                             "(a batch that divides over the data axes, a cache length "
                             "that divides over `model`)")


def rank_prefill(model, params, p_specs, batch, max_len: int, comm):
    """Prefill as one rank runs it: `params` this rank's shards under
    `p_specs`, `batch` its rows.  Returns (last-token logits [B,V], this
    rank's slice of the decode state, the next position)."""
    # serving keeps no microbatch: moe dispatches without capacity
    return model.prefill(params, batch, max_len=max_len,
                         tp=Split(model.cfg, comm, p_specs, False))


def rank_decode(model, params, p_specs, state, token, pos: int, comm):
    """One decode step as one rank runs it on its shards, its slice of the
    state (updated in place) and its rows' tokens: (logits [B,V], state)."""
    return model.decode_step(params, state, token, pos,
                             tp=Split(model.cfg, comm, p_specs, False))


def _local_params(params, names):
    """DTensor parameters -> (local shards, their specs)."""
    with torch.no_grad():
        local = tree_map(lambda t: t.to_local(), params)
    return local, tree_map(lambda t: spec_of(t.placements, names, t.ndim), params)


def _rows(tree, cfg, mesh: MeshShape, coords):
    """This rank's rows of a global batch (or token vector)."""
    specs = batch_shardings(tree, cfg, mesh)
    return tree_map(lambda t, s: local_slice(t, s, mesh, coords), tree, specs)


def make_sharded_prefill(model, device_mesh):
    """Returns prefill(params, batch, max_len) -> (logits [B_rank,V], state,
    next position) over DTensor parameters (`train_step.shard_train_state`'s
    placements) and the global batch, the same on every rank: each takes
    its rows, and gets its rows' logits and its slice of the decode state
    (local tensors under `state_shardings`).  `prefill.comm` counts the
    collectives of the last call.  Every rank of the mesh calls it."""
    mesh, names = MeshShape.of(device_mesh), tuple(device_mesh.mesh_dim_names)
    comm = Collectives(device_mesh)

    def prefill(params, batch: Dict, max_len: int):
        comm.reset()
        b = batch["tokens"].shape[0]
        check_state_specs(state_shardings(decode_state_shapes(model.cfg, b, max_len),
                                          model.cfg, mesh, b), mesh)
        local, p_specs = _local_params(params, names)
        rows = _rows(batch, model.cfg, mesh, comm.coords)
        return rank_prefill(model, local, p_specs, rows, max_len, comm)

    prefill.comm = comm
    return prefill


def make_sharded_decode_step(model, device_mesh):
    """Returns decode_step(params, state, token, pos) -> (logits [B_rank,V],
    state): `state` this rank's slice (`make_sharded_prefill`'s), updated
    in place, `token` the global [B] tokens (each rank takes its rows).
    `decode_step.comm` counts the collectives of the last call."""
    mesh, names = MeshShape.of(device_mesh), tuple(device_mesh.mesh_dim_names)
    comm = Collectives(device_mesh)

    def decode_step(params, state, token, pos: int):
        comm.reset()
        local, p_specs = _local_params(params, names)
        return rank_decode(model, local, p_specs, state,
                           _rows(token, model.cfg, mesh, comm.coords), pos, comm)

    decode_step.comm = comm
    return decode_step
