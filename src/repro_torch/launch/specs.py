"""Fake-tensor inputs and one rank's step of each (arch × shape) cell, for
the dry run (counterpart of `repro.launch.specs`).

Every input is a fake tensor (``FakeTensorMode``): a shape and a dtype,
nothing allocated, so a 340-billion-parameter model's inputs cost no
memory.  They are built on the CPU device: `resolve_device` and the
kernels' routing stay as they are, and a fake CPU tensor goes to each
kernel's plain version, which computes nothing on fake tensors.

`make_cell` gives the cell's step as one rank of the port runs it on a
mesh: the train step is `distributed.train_step.rank_step`, prefill and
serve_step are `distributed.serve_step`'s split `rank_prefill` and
`rank_decode` over the rank's shards, its rows and its slice of the decode
state, for every family, under the rules of a `variant` (`cell_rules`). The reference also lowers
per-layer corrections (`_layer_corrections`) because XLA's cost analysis
counts a ``scan`` body once whatever its trip count; a torch run executes
every layer, so the port needs none.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import (activation_rules, batch_shardings, local_shape,
                                              param_shardings, state_shardings)
from repro_torch.distributed.serve_step import rank_decode, rank_prefill
from repro_torch.distributed.train_step import Collectives, rank_step, splits_rows
from repro_torch.kvcache.cache import decode_state_shapes
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import build_model
from repro_torch.training.optimizer import AdamWState, tree_map
from repro_torch.training.train import TrainConfig


def fake_mode():
    """A fake-tensor mode for one cell (tensors of two modes do not mix).
    Real tensors that a model holds (its constants) may enter its ops."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype)


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mode=None) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    with mode or fake_mode():
        if cfg.family == "vlm":
            s_text = s - cfg.num_patches
            out = {"tokens": _sds((b, s_text), torch.int32),
                   "patch_embeds": _sds((b, cfg.num_patches, cfg.d_model), torch.float32)}
            tgt = s_text
        elif cfg.family == "encdec":
            ssrc = min(cfg.max_source_len, s)
            out = {"tokens": _sds((b, s), torch.int32),
                   "src_embeds": _sds((b, ssrc, cfg.d_model), torch.float32)}
            tgt = s
        elif cfg.family == "hybrid":
            s_text = s - cfg.num_meta_tokens       # meta tokens fill the context
            out = {"tokens": _sds((b, s_text), torch.int32)}
            tgt = s_text
        else:
            out = {"tokens": _sds((b, s), torch.int32)}
            tgt = s
        if shape.kind == "train":
            out["targets"] = _sds((b, tgt), torch.int32)
            out["loss_mask"] = _sds((b, tgt), torch.float32)
    return out


def state_specs(cfg: ArchConfig, shape: ShapeConfig, mode=None):
    shapes = decode_state_shapes(cfg, shape.global_batch, shape.seq_len)

    def mk(t):
        if isinstance(t, dict):
            return {k: mk(v) for k, v in t.items()}
        return _sds(*t)
    with mode or fake_mode():
        return mk(shapes)


def params_specs(cfg: ArchConfig, model, mode=None) -> Dict:
    with mode or fake_mode():
        return model.init(torch.Generator())


def input_specs(arch: ArchConfig, shape: ShapeConfig, model=None, mode=None) -> Dict:
    """All model inputs for this cell as fake tensors (the reference's
    assignment API), in one fake mode (`mode`, or a new one)."""
    model = model or build_model(arch, device="cpu")
    mode = mode or fake_mode()
    out = {"params": params_specs(arch, model, mode)}
    if shape.kind == "train":
        out["batch"] = batch_specs(arch, shape, mode)
        with mode:
            zeros = tree_map(lambda p: _sds(p.shape, torch.float32), out["params"])
            out["opt_state"] = AdamWState(_sds((), torch.int32), zeros,
                                          tree_map(lambda p: _sds(p.shape, torch.float32),
                                                   out["params"]))
    elif shape.kind == "prefill":
        out["batch"] = batch_specs(arch, shape, mode)
    else:  # decode
        out["state"] = state_specs(arch, shape, mode)
        with mode:
            out["token"] = _sds((shape.global_batch,), torch.int32)
            out["pos"] = _sds((), torch.int32)
    return out


# ---------------------------------------------------------------------------
# one rank's step per cell
# ---------------------------------------------------------------------------

class ShapeCollectives(Collectives):
    """`train_step.Collectives` on fake tensors, counting the same bytes with
    no transport: a gather's output keeps its fresh fake tensor, a
    reduction leaves its tensor as it is.  One rank: coordinate 0 of the
    data axes (every rank holds shards of the same shapes) and the last of
    `model`, which computes the largest share of an uneven split
    (ceil(H/n) heads; `tensor_parallel.balanced`)."""

    def __init__(self, mesh: MeshShape):
        self.mesh = mesh
        self.coords = {a: mesh.shape[a] - 1 if a == "model" else 0 for a in mesh.axis_names}
        self.reset()

    def _gather(self, out, src, axes) -> None:
        pass

    def _reduce(self, t, axes, op) -> None:
        pass

    def _reduce_scatter(self, out, src, axes) -> None:
        pass

    def _all_to_all(self, out, src, out_sizes, in_sizes, axes) -> None:
        pass


@dataclasses.dataclass
class Cell:
    name: str              # train_step | prefill | serve_step
    fn: Callable           # one rank's step
    args: tuple            # its fake inputs: the rank's shards and batch slice
    inputs: Dict           # `input_specs`: the cell's global fake inputs
    specs: Dict            # the rules' spec of every leaf of `inputs`
    mode: object           # the fake mode of `args` and `inputs`; run `fn` in it
    comm: ShapeCollectives  # what `fn`'s collectives moved, counted as it runs


def cell_rules(cfg: ArchConfig, kind: str, variant: str,
               mesh) -> Tuple[Optional[Dict], str]:
    """(activation rules, parameter variant) of a cell of shape kind `kind`
    ("train", "prefill", "decode") under `variant` on `mesh`: the
    reference's `activation_rules` with its make_cell's adjustments
    (`repro.launch.specs.make_cell`):

    - moe: ``seq`` and ``experts`` None (the sort-based dispatch reads every
      token), so the moe family keeps the baseline form;
    - decode: ``heads`` and ``kv_heads`` None (the cache stays
      sequence-sharded);
    - pure-SSM decode: the parameters take opt-rowssm, ``d_inner`` and
      ``ssm_heads`` None;
    - hybrid decode: no rules, baseline parameters.

    The split steps (`distributed.tensor_parallel.Split`) read the rules
    as the reference's ``logical_constraint`` does: a dim that the mesh axis
    does not divide stays unconstrained.  So sequence parallelism reaches
    the train cells whose (meta- or patch-extended) sequence `model`
    divides, and opt-zmlp's token split the prefill cells whose prompt it
    divides: on the production meshes every train and prefill cell (streams
    of 4,096 and 32,768 tokens, seamless's 4,096 source frames, over 16)."""
    rules = activation_rules(mesh, variant, kind)
    pvariant = variant
    if rules is not None and cfg.is_moe:
        rules = {**rules, "seq": None, "experts": None}
    if variant.startswith("opt") and kind == "decode":
        if rules is not None:
            rules = {**rules, "heads": None, "kv_heads": None}
        if cfg.family == "ssm":
            pvariant = "opt-rowssm"
            if rules is not None:
                rules = {**rules, "d_inner": None, "ssm_heads": None}
        elif cfg.family == "hybrid":
            rules, pvariant = None, "baseline"
    return rules, pvariant


def _local(tree, specs, mesh: MeshShape):
    """Fake tensors of one device's shard shapes."""
    return tree_map(lambda t, s: _sds(local_shape(t.shape, s, mesh), t.dtype), tree, specs)


def cell_specs(cfg: ArchConfig, shape: ShapeConfig, inputs: Dict, mesh: MeshShape,
               variant: str = "baseline") -> Dict:
    """The rules' spec of every leaf of `input_specs`' tree on `mesh`.  The
    parameters take `cell_rules`' parameter variant and the AdamW moments
    the baseline rules whatever the variant, as the reference places them
    (under opt-zmlp the MLP's moments are split over `model`, its weights
    not)."""
    pvariant = cell_rules(cfg, shape.kind, variant, mesh)[1]
    specs: Dict = {"params": param_shardings(inputs["params"], cfg, mesh, pvariant)}
    if shape.kind == "train":
        specs["opt_state"] = param_shardings(inputs["opt_state"], cfg, mesh)
    if shape.kind in ("train", "prefill"):
        specs["batch"] = batch_shardings(inputs["batch"], cfg, mesh)
    else:
        specs.update(state=state_shardings(inputs["state"], cfg, mesh, shape.global_batch),
                     token=batch_shardings(inputs["token"], cfg, mesh), pos=())
    return specs


def make_cell(cfg: ArchConfig, shape: ShapeConfig, mesh: MeshShape,
              variant: str = "baseline") -> Cell:
    """The step of one (arch × shape) cell as one rank of a `mesh` runs it
    under `variant`'s rules, with fake inputs (`cell_specs` places them)."""
    model = build_model(cfg, device="cpu", remat=shape.kind == "train")
    mode = fake_mode()
    inputs = input_specs(cfg, shape, model, mode)
    specs = cell_specs(cfg, shape, inputs, mesh, variant)
    p_specs = specs["params"]
    comm = ShapeCollectives(mesh)
    with mode:
        params = _local(inputs["params"], p_specs, mesh)
        if shape.kind == "train":
            opt, o_specs = inputs["opt_state"], specs["opt_state"]
            args = (params, AdamWState(_sds((), torch.int32), _local(opt.m, o_specs.m, mesh),
                                       _local(opt.v, o_specs.v, mesh)),
                    _local(inputs["batch"], specs["batch"], mesh))
            split = splits_rows(specs["batch"])      # one microbatch, as `rank_batch`'s

            def fn(p, o, b):
                return rank_step(model, TrainConfig(), p, p_specs, o, b, split, comm,
                                 variant=variant, m_specs=o_specs.m)
            return Cell("train_step", fn, args, inputs, specs, mode, comm)

        if shape.kind == "prefill":
            def fn(p, b):
                return rank_prefill(model, p, p_specs, b, shape.seq_len, comm,
                                    shape.global_batch, variant=variant)[:3]
            args = (params, _local(inputs["batch"], specs["batch"], mesh))
            return Cell("prefill", fn, args, inputs, specs, mode, comm)

        st_specs = specs["state"]

        def fn(p, st, tok, pos):
            return rank_decode(model, p, p_specs, st, st_specs, tok, pos, comm,
                               variant=variant)
        # the port's decode step takes its position on the host: the last slot
        args = (params, _local(inputs["state"], st_specs, mesh),
                _local(inputs["token"], specs["token"], mesh), shape.seq_len - 1)
        return Cell("serve_step", fn, args, inputs, specs, mode, comm)
