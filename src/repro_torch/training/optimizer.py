"""AdamW and global-norm clipping on dicts of tensors (counterpart of
`repro.training.optimizer`).

Optimizer moments are f32 whatever the parameter dtype; the update is
computed in f32 and cast back, as the reference does, leaf by leaf with
the same roundings.  Unlike the reference, the moments are updated in
place: they are 8 bytes a parameter, and a second copy of them would not
fit beside a 3-billion-parameter model on one 80 GB card.  The parameters
come back as new tensors.  `compressed_allreduce` is the reference's int8
gradient all-reduce (an all-gather of int8 payloads and per-tensor scales,
then a local dequant-sum) over a `torch.distributed` process group.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32 scalar
    m: dict
    v: dict


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """The leaves of nested dicts in sorted-key order, as `jax.tree.leaves`."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def adamw_init(params) -> AdamWState:
    first = tree_leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=first.device),
                      m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params),
                      v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params))


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def adamw_update(grads, state: AdamWState, params, *, lr: float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 clip_norm: float = 1.0, grad_norm: Optional[torch.Tensor] = None):
    """-> (new params, the state, {"grad_norm"}).  Gradients are clipped to
    `clip_norm` by their global norm first: `grad_norm` where given (the
    norm of the whole gradient when `grads` are one rank's shards of it),
    else `global_norm(grads)`.  The state's moments are updated in place
    (the state passed in is consumed); the parameters passed in are left as
    they were."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        # the reference's m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2 and
        # p - lr (mhat / (sqrt(vhat) + eps) + wd p), one rounding an op as
        # there, with each temporary freed as soon as it is used
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
        del g
        step_dir = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
        pf = p.float()
        step_dir.add_(weight_decay * pf)
        return (pf - lr * step_dir).to(p.dtype)

    new_params: Dict = tree_map(upd, params, grads, state.m, state.v)
    return new_params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm}


def quantize_int8(x: torch.Tensor):
    """Symmetric int8 with one per-tensor scale: (q int8, scale f32)."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def all_gather_fn():
    """torch.distributed's all-gather into one tensor, (output, input,
    group=): `all_gather_single` where this torch has it (it deprecates
    the other), else `all_gather_into_tensor`.  Looked up at each call."""
    import torch.distributed as dist
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def compressed_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over the ranks of `group` (default: every rank), sent as
    int8: each rank quantizes its f32 copy with one per-tensor scale
    (`quantize_int8`), the int8 payloads and the scales are all-gathered,
    and every rank dequantizes and sums them locally in f32, in rank order.
    Moves a quarter of an f32 all-reduce's bytes at the cost of one
    quantization error per rank (the reference's, under shard_map).  A
    collective: every rank of `group` calls it, with tensors of one shape."""
    import torch.distributed as dist
    gather = all_gather_fn()
    q, scale = quantize_int8(x.float())
    n = dist.get_world_size(group)
    qs = q.new_empty((n * q.numel(),))                      # n payloads, int8
    ss = scale.new_empty((n,))                              # [n] f32
    gather(qs, q.reshape(-1), group=group)
    gather(ss, scale.reshape(1), group=group)
    qs = qs.view((n,) + tuple(q.shape))
    out = qs[0].float() * ss[0]
    for i in range(1, n):
        out += qs[i].float() * ss[i]
    return out
