"""Name-based sharding rules for the production mesh (the port's copy of
`repro.distributed.sharding`), and their placement on a torch DeviceMesh.

Mesh axes: ("data", "model") single-pod / ("pod", "data", "model") multi-pod.

  batch        → (pod, data)
  heads/ff/vocab/experts (weight columns) → model        (tensor / expert par.)
  d_model rows of big-arch weights        → (pod, data)  (FSDP / ZeRO-style)
  decode KV cache: batch → (pod, data), seq → model      (flash-decode style
      sequence sharding: avoids padding waste for kv_heads ∤ 16 and keeps
      per-chip KV under HBM limits at 32k contexts)
  long_500k (batch=1): full-attn KV seq → data, SSM heads → model

FSDP kicks in when bf16 params exceed `FSDP_THRESHOLD_BYTES` (the weights no
longer fit replicated per-chip next to activations).

A spec is a tuple with one entry per tensor dimension: None (replicated),
an axis name, or a tuple of axis names, major to minor; the entries of the
reference's ``PartitionSpec``, which writes a one-axis tuple as the bare
name.  The rules read a mesh's ``axis_names`` and ``shape`` only, so they
take a `repro_torch.launch.mesh.MeshShape` of any size.  What JAX gave the
reference for free is added here: `placements` (a spec as DTensor
``Shard``/``Replicate`` per mesh dimension), `local_shape`, `local_slice`,
`shard_tree` and `gather_tree`.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig

FSDP_THRESHOLD_BYTES = 4e9

Spec = Tuple


def fsdp_enabled(cfg: ArchConfig) -> bool:
    return cfg.param_count() * 2 > FSDP_THRESHOLD_BYTES


def _axes(mesh):
    names = mesh.axis_names
    dp = ("pod", "data") if "pod" in names else ("data",)
    return dp, "model"


def _names(axes) -> tuple:
    return axes if isinstance(axes, tuple) else (axes,)


def _size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in _names(axes))


def _divisible(dim: int, mesh, axes) -> bool:
    return dim % _size(mesh, axes) == 0


def _spec(*entries) -> Spec:
    """The entries as ``PartitionSpec`` keeps them: a one-axis tuple becomes
    the bare axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def param_spec(path: str, shape, cfg: ArchConfig, mesh,
               variant: str = "baseline") -> Spec:
    dp, mp = _axes(mesh)
    fsdp = dp if fsdp_enabled(cfg) else None
    leaf = path.split("/")[-1]
    container = path.split("/")[-2] if "/" in path else ""

    def dprow(dim):  # FSDP-shard a d_model-sized dim if divisible
        return fsdp if (fsdp and _divisible(dim, mesh, fsdp)) else None

    def mcol(dim):
        return mp if _divisible(dim, mesh, mp) else None

    if leaf in ("embed",):
        if variant == "opt-rowssm" and mcol(shape[0]) is None \
                and dprow(shape[1]) is None and _divisible(shape[1], mesh, mp):
            # vocab not divisible by TP width: shard d_model instead so the
            # (tied) head matmul partial-sums with a tiny psum
            return _spec(None, mp)
        return _spec(mcol(shape[0]), dprow(shape[1]))
    if leaf == "lm_head":
        if variant == "opt-rowssm" and mcol(shape[1]) is None \
                and dprow(shape[0]) is None and _divisible(shape[0], mesh, mp):
            return _spec(mp, None)
        return _spec(dprow(shape[0]), mcol(shape[1]))
    if leaf in ("pos_table", "src_pos", "meta", "patch_proj"):
        return _spec(*([None] * len(shape)))
    if container == "attn" or container == "cross":
        if leaf in ("wq", "wk", "wv"):
            return _spec(None, dprow(shape[1]), mcol(shape[2]))
        if leaf == "wo":
            return _spec(None, mcol(shape[1]), dprow(shape[2]))
    if container == "mlp":
        if variant == "opt-zmlp":
            # ZeRO-style MLP: weights FSDP-only (gathered per layer); tokens
            # seq-sharded over `model` -> no ff-contraction all-reduce
            if leaf in ("w_gate", "w_up"):
                return _spec(None, dprow(shape[1]), None)
            if leaf == "w_down":
                return _spec(None, None, dprow(shape[2]))
        if leaf in ("w_gate", "w_up"):
            return _spec(None, dprow(shape[1]), mcol(shape[2]))
        if leaf == "w_down":
            return _spec(None, mcol(shape[1]), dprow(shape[2]))
    if container == "moe":
        if leaf == "router":
            return _spec(None, None, None)
        if leaf in ("w_gate", "w_up"):
            return _spec(None, mcol(shape[1]), dprow(shape[2]), None)   # experts → model
        if leaf == "w_down":
            return _spec(None, mcol(shape[1]), None, dprow(shape[3]))
    if container == "ssm":
        if variant == "opt-rowssm" and leaf in ("w_in", "w_out"):
            # batch=1 decode is weight-traffic-bound: shard weight ROWS over
            # `model` (1/16 weight reads/chip, tiny psum of the output) —
            # row sharding doesn't conflict with the z/x/B/C column slices
            return _spec(None, mcol(shape[1]), None)
        if leaf in ("w_in", "w_out"):
            return _spec(None, dprow(shape[1]), None)
        return _spec(*([None] * len(shape)))
    # norms, scalars, fuse scales, conv weights: replicated
    return _spec(*([None] * len(shape)))


def _tree_with_paths(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _tree_with_paths(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if hasattr(tree, "_asdict"):
        return type(tree)(**{k: _tree_with_paths(v, fn, f"{prefix}{k}/")
                             for k, v in tree._asdict().items()})
    return fn(prefix[:-1], tree)


def param_shardings(params_shapes, cfg: ArchConfig, mesh, variant: str = "baseline"):
    """Spec tree for a params (or optimizer state: m/, v/) tree of tensors
    (fake ones will do: only their shapes are read)."""
    def mk(path, leaf):
        # strip the leading container for optimizer trees (m/, v/)
        p = path
        for pre in ("m/", "v/"):
            if p.startswith(pre):
                p = p[len(pre):]
        if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            return ()
        return param_spec(p, tuple(leaf.shape), cfg, mesh, variant)
    return _tree_with_paths(params_shapes, mk)


def batch_shardings(batch_shapes, cfg: ArchConfig, mesh):
    dp, _ = _axes(mesh)

    def mk(path, leaf):
        if len(leaf.shape) == 0:
            return ()
        spec = [None] * len(leaf.shape)
        if leaf.shape[0] % _size(mesh, dp) == 0:
            spec[0] = dp
        return _spec(*spec)
    return _tree_with_paths(batch_shapes, mk)


def state_shardings(state_shapes, cfg: ArchConfig, mesh, batch: int) -> Dict:
    """Decode-state sharding: batch → dp when divisible; else (batch=1 long
    context) shard the seq/window axis over data and heads over model.  A
    leaf is a tensor or `decode_state_shapes`' (shape, dtype) pair."""
    dp, mp = _axes(mesh)
    dp_n = _size(mesh, dp)
    mp_n = mesh.shape[mp]

    def mk(path, leaf):
        shape = tuple(leaf[0] if isinstance(leaf, tuple) else leaf.shape)
        spec = [None] * len(shape)
        if path == "swa_pos" or len(shape) <= 1:
            return _spec(*spec)
        if path.startswith(("kv", "cross")):
            # [L, B, S, H, D]
            if batch % dp_n == 0 and batch >= dp_n:
                spec[1] = dp
                if shape[2] % mp_n == 0:
                    spec[2] = mp                      # seq → model
            else:
                if shape[2] % dp_n == 0:
                    spec[2] = dp                      # long-context: seq → data
            return _spec(*spec)
        if path == "ssd":
            # [L, B, nh, hd, N]
            if batch % dp_n == 0 and batch >= dp_n:
                spec[1] = dp
            if shape[2] % mp_n == 0:
                spec[2] = mp
            return _spec(*spec)
        if path == "conv":
            # [L, B, K-1, conv_dim] — conv_dim stays UNSHARDED: the state is
            # tiny and its x/B/C part boundaries don't align with 1/16 shards
            # (sharding it forces involuntary full remats on every slice)
            if batch % dp_n == 0 and batch >= dp_n:
                spec[1] = dp
            return _spec(*spec)
        return _spec(*spec)
    return _tree_with_paths(state_shapes, mk)


def activation_rules(mesh, variant: str = "baseline",
                     kind: str = "train") -> Optional[Dict[str, object]]:
    """Logical-axis rules of the reference's activations, as data.

    The reference installs them into its models' ``logical_constraint``
    calls.  The port reads them, with the reference's per-cell
    adjustments (`launch.specs.cell_rules`), in its split steps
    (`distributed.tensor_parallel.Split`): ``seq`` for sequence
    parallelism, ``ff`` and ``mlp_seq`` for opt-zmlp; the rest name what
    its split compute does under every variant.

    baseline: None — no activation constraints; GSPMD propagates from the
              weight/IO shardings alone (the paper-faithful starting point).
    opt:      explicit tensor-parallel activations — heads/kv_heads/ff/
              experts/vocab → model (GSPMD pads non-divisible head counts),
              d_inner/ssm groups → model (Mamba inner parallelism), and
              seq → model on the residual stream for train (Megatron-style
              sequence parallelism: saved activations shrink 16×).
    """
    if variant == "baseline":
        return None
    dp, mp = _axes(mesh)
    rules = {"batch": dp, "heads": mp, "kv_heads": mp, "ff": mp,
             "vocab": mp, "experts": mp, "d_inner": mp, "ssm_gn": None,
             "ssm_heads": mp, "seq": mp if kind == "train" else None,
             "__sizes__": {a: int(mesh.shape[a]) for a in mesh.axis_names}}
    if variant == "opt-zmlp":
        rules["ff"] = None
        rules["mlp_seq"] = mp
    return rules


# ---------------------------------------------------------------------------
# specs on a torch DeviceMesh
# ---------------------------------------------------------------------------

def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a `shape` tensor under `spec`."""
    if len(spec) not in (0, len(shape)):
        raise ValueError(f"spec {spec} for a {len(shape)}-d shape {tuple(shape)}")
    out = []
    for i, dim in enumerate(shape):
        n = _size(mesh, spec[i]) if spec and spec[i] is not None else 1
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} ({dim}) does not split {n} ways "
                             f"({spec[i]})")
        out.append(dim // n)
    return tuple(out)


def shard_index(entry, mesh, coords: Dict[str, int]) -> Tuple[int, int]:
    """(which shard, how many) a device at mesh coordinates `coords` holds
    along a tensor dim whose spec entry is `entry`; a tuple of axes counts
    major to minor, as in JAX."""
    idx, n = 0, 1
    for a in (_names(entry) if entry is not None else ()):
        idx = idx * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return idx, n


def local_slice(t, spec: Spec, mesh, coords: Dict[str, int], keep=()):
    """The view of the full tensor `t` that the device at `coords` holds
    under `spec`; tensor dims in `keep` are left whole."""
    for dim, entry in enumerate(spec):
        if entry is None or dim in keep:
            continue
        i, n = shard_index(entry, mesh, coords)
        step = t.shape[dim] // n
        t = t.narrow(dim, i * step, step)
    return t


def placements(spec: Spec, device_mesh) -> tuple:
    """`spec` as DTensor placements, one per mesh dimension: ``Shard(d)`` on
    each mesh dim that splits tensor dim d, ``Replicate()`` elsewhere.  A
    tuple of axes on one tensor dim must follow the mesh's order, which is
    how DTensor nests two shardings of one dim (major to minor)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in _names(entry)]
        if idx != sorted(idx):
            raise ValueError(f"axes {entry} of dim {dim} are not in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} shards two dims in {spec}")
            out[i] = Shard(dim)
    return tuple(out)


def spec_of(placements_, mesh_dim_names, ndim: int) -> Spec:
    """The spec that `placements` (DTensor, one per mesh dim) stand for."""
    from torch.distributed.tensor import Replicate, Shard
    axes = [[] for _ in range(ndim)]
    for name, p in zip(mesh_dim_names, placements_):
        if isinstance(p, Shard):
            axes[p.dim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} is neither Shard nor Replicate")
    return _spec(*(tuple(a) if a else None for a in axes))


def mesh_coords(device_mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of `device_mesh`."""
    return dict(zip(device_mesh.mesh_dim_names, device_mesh.get_coordinate()))


def shard_tree(tree, specs, device_mesh):
    """Each full tensor of `tree` (the same on every rank) as a DTensor
    holding this rank's shard under its spec in `specs` (a tree of the same
    structure): a copy of the shard, cut locally, with no communication."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import MeshShape
    mesh, coords = MeshShape.of(device_mesh), mesh_coords(device_mesh)

    def one(t, spec):
        local = local_slice(t, spec, mesh, coords).clone(memory_format=torch.contiguous_format)
        return DTensor.from_local(local, device_mesh, placements(spec, device_mesh),
                                  run_check=False, shape=t.shape, stride=t.stride())
    return _zip_map(one, tree, specs)


def gather_tree(tree):
    """Every DTensor leaf of `tree` gathered whole onto every rank (a
    collective: every rank calls it); other leaves as they are.  A leaf
    replicated on every axis comes back as its local tensor, not a copy."""
    from torch.distributed.tensor import DTensor

    def one(t):
        return t.full_tensor() if isinstance(t, DTensor) else t
    return _zip_map(one, tree)


def _zip_map(fn, tree, *rest):
    """fn over the leaves of dicts and NamedTuples of one structure (a
    spec, a tuple, is a leaf of the spec tree)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if hasattr(tree, "_asdict"):
        return type(tree)(*(_zip_map(fn, v, *(getattr(r, k) for r in rest))
                            for k, v in tree._asdict().items()))
    return fn(tree, *rest)
