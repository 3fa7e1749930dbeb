"""Sharded prefill and decode for every model family: the serving
counterpart of `train_step`, over the rules' placements (the parameters by
`param_shardings`, the decode state by `state_shardings`: its batch over
the data axes where it divides, a cache's sequence over `model`, over the
data axes for batch 1, or whole where its length divides neither, the SSD
heads over `model` where they divide, the conv state whole).

A rank computes its share of every layer (`tensor_parallel.Split`):

- prefill runs the rank's heads (attention, cross-attention, SSM) for the
  whole prompt, then hands each rank its slice of every cache (one
  all-to-all over `model`, or an all-gather of the heads), and
  all-gathers the SSD final states once where the rules keep them whole;
- decode makes q and the new K/V for the rank's heads and all-gathers them
  over `model` (B x H x D), the rank holding the write slot writes the new
  K/V, each rank runs `decode_attention` (cross-attention:
  `flash_attention`) with its LSE over its slice and the partials are
  combined over the axes that split the sequence; the SSM runs on the
  rank's heads of the state, or whole where the state is whole;
- the logits are all-gathered over the vocabulary for sampling.

Nothing gathers the parameters whole or a cache.  Every step takes the
reference's `variant` ("baseline", "opt", "opt-zmlp"; `launch.specs.
cell_rules`): under opt, prefill attends blocked off the card and, with
opt-zmlp, runs the MLP on the rank's slice of the sequence; a pure SSM's
decode computes with opt-rowssm's row-split weights (`shard_params` with
kind "decode" places them).  On a world of one the steps are the unsharded
`prefill` and `decode_step` bit for bit (off the card, blocked attention
agrees within f32 rounding).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed.sharding import (_axes, batch_shardings, local_slice,
                                              spec_of)
from repro_torch.distributed.tensor_parallel import MODEL, Split
from repro_torch.distributed.train_step import Collectives
from repro_torch.launch.mesh import MeshShape
from repro_torch.training.optimizer import tree_map


def check_state_specs(st_specs: Dict, mesh: MeshShape) -> None:
    """The decode state must lie as the rules can place it: a cache
    [L,B,S,H,D] with B over the data axes or whole and S over `model`, over
    the data axes (B whole) or whole; the SSD state [L,B,nh,hd,N] with its
    heads over `model` or whole; the conv state and the ring's slot
    positions whole but for the batch."""
    dp, _ = _axes(mesh)
    dpe = dp[0] if len(dp) == 1 else dp
    for key, sub in st_specs.items():
        for s in (sub.values() if isinstance(sub, dict) else (sub,)):
            s = tuple(s)
            if key.startswith(("kv", "cross")):
                ok = (len(s) == 5 and s[0] is None and s[3:] == (None, None)
                      and (s[1], s[2]) in ((dpe, MODEL), (dpe, None), (None, dpe),
                                           (None, None)))
            elif key == "ssd":
                ok = (len(s) == 5 and s[0] is None and s[1] in (dpe, None)
                      and s[2] in (MODEL, None) and s[3:] == (None, None))
            elif key == "conv":
                ok = len(s) == 4 and s[0] is None and s[1] in (dpe, None) and s[2:] == (None,
                                                                                           None)
            else:
                ok = key == "swa_pos" and s == (None,)
            if not ok:
                raise ValueError(f"split decode takes no state entry {key!r} placed {s}")


def rank_prefill(model, params, p_specs, batch, max_len: int, comm, global_batch: int,
                 variant: str = "baseline"):
    """Prefill as one rank runs it: `params` this rank's shards under
    `p_specs`, `batch` its rows of a global batch of `global_batch` rows.
    Returns (last-token logits [B,V], this rank's slice of the decode state,
    the next position, the state's specs)."""
    # serving keeps no microbatch: moe dispatches without capacity
    tp = Split(model.cfg, comm, p_specs, False, batch=global_batch, variant=variant)
    logits, state, pos = model.prefill(params, batch, max_len=max_len, tp=tp)
    st_specs = tp.state_specs(state)
    check_state_specs(st_specs, comm.mesh)
    return logits, state, pos, st_specs


def rank_decode(model, params, p_specs, state, st_specs, token, pos: int, comm,
                variant: str = "baseline"):
    """One decode step as one rank runs it on its shards, its slice of the
    state (placed by `st_specs`, updated in place) and its rows' tokens:
    (logits [B,V], state)."""
    check_state_specs(st_specs, comm.mesh)
    return model.decode_step(params, state, token, pos,
                             tp=Split(model.cfg, comm, p_specs, False, state_specs=st_specs,
                                      variant=variant))


def _local_params(params, names):
    """DTensor parameters -> (local shards, their specs)."""
    with torch.no_grad():
        local = tree_map(lambda t: t.to_local(), params)
    return local, tree_map(lambda t: spec_of(t.placements, names, t.ndim), params)


def _rows(tree, cfg, mesh: MeshShape, coords):
    """This rank's rows of a global batch (or token vector)."""
    specs = batch_shardings(tree, cfg, mesh)
    return tree_map(lambda t, s: local_slice(t, s, mesh, coords), tree, specs)


def make_sharded_prefill(model, device_mesh, variant: str = "baseline"):
    """Returns prefill(params, batch, max_len) -> (logits [B_rank,V], state,
    next position) under `variant`'s rules over DTensor parameters
    (`train_step.shard_params(..., variant, "prefill")`'s placements) and
    the global batch, the same on every rank: each takes
    its rows, and gets its rows' logits and its slice of the decode state
    (local tensors under `state_shardings`).  `prefill.comm` counts the
    collectives of the last call, `prefill.state_specs` is its state's
    spec tree (for the decode step).  Every rank of the mesh calls it."""
    mesh, names = MeshShape.of(device_mesh), tuple(device_mesh.mesh_dim_names)
    comm = Collectives(device_mesh)

    def prefill(params, batch: Dict, max_len: int):
        comm.reset()
        local, p_specs = _local_params(params, names)
        rows = _rows(batch, model.cfg, mesh, comm.coords)
        logits, state, pos, prefill.state_specs = rank_prefill(
            model, local, p_specs, rows, max_len, comm, batch["tokens"].shape[0], variant)
        return logits, state, pos

    prefill.comm = comm
    return prefill


def make_sharded_decode_step(model, device_mesh, variant: str = "baseline"):
    """Returns decode_step(params, state, token, pos, state_specs) ->
    (logits [B_rank,V], state) under `variant`'s rules, over DTensor
    parameters placed as `train_step.shard_params(..., variant, "decode")`
    places them: `state` this rank's slice
    (`make_sharded_prefill`'s), updated in place, `state_specs` its spec
    tree (the prefill's `state_specs`), `token` the global [B] tokens (each
    rank takes its rows).  `decode_step.comm` counts the collectives of the
    last call."""
    mesh, names = MeshShape.of(device_mesh), tuple(device_mesh.mesh_dim_names)
    comm = Collectives(device_mesh)

    def decode_step(params, state, token, pos: int, state_specs: Dict):
        comm.reset()
        local, p_specs = _local_params(params, names)
        return rank_decode(model, local, p_specs, state, state_specs,
                           _rows(token, model.cfg, mesh, comm.coords), pos, comm, variant)

    decode_step.comm = comm
    return decode_step
