"""Mixture-of-Experts FFN with sort-based, capacity-bounded token dispatch
(counterpart of `repro.models.moe`).

The reference leaves this to XLA, so plain PyTorch ops do it here, step for
step: router logits in f32 (the router stays f32 in a bf16 model), softmax,
top-k with the gates renormalised, a stable sort of the [T*k] (token, slot)
entries by expert, each entry's position in its expert from `searchsorted`,
a scatter into an [E*C + 1, d] buffer whose last row takes the entries past
an expert's capacity C, the expert FFN batched over [E, C, d], then a gather
back and a gate-weighted sum over the k slots in the model's dtype.

Training dispatches with capacity dropping and adds the load-balancing
loss.  Serving dispatches with ``drop=False``: capacity T, lossless, so a token's
output does not depend on how many tokens share its pass.  The batched FFN
then runs E/k times the FLOPs the routed tokens need (16 for qwen3-moe's 128
experts, top 8); a grouped GEMM over the routed entries would not.

On a mesh (``tp``, a `distributed.tensor_parallel.Split`) the experts are
split over `model` as the rules place them: the tokens are the same on
every rank of `model`, so each rank routes them all as above, runs its
own experts over the entries routed to them (the others go to the spill
row) and the combine is summed over `model`.  Where the rank's tokens are
its slice of a microbatch split over the data axes, training keeps the
microbatch's semantics: the capacity is the whole microbatch's, an entry's
place in its expert counts the entries of the data ranks before this one,
and the load-balancing loss takes the microbatch's means
(`Split.data_tokens`, `data_offsets`, `data_sum`).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import activation_fn, dense_init


def moe_init(generator, cfg, dtype, device):
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": dense_init(generator, (d, e), torch.float32, device, scale=0.02),
        "w_gate": dense_init(generator, (e, d, ff), dtype, device),
        "w_up": dense_init(generator, (e, d, ff), dtype, device),
        "w_down": dense_init(generator, (e, ff, d), dtype, device),
    }


def capacity(num_tokens: int, cfg) -> int:
    c = int(-(-num_tokens * cfg.experts_per_token * cfg.moe_capacity_factor // cfg.num_experts))
    return max(c, 1)


def moe_apply(x: torch.Tensor, p, cfg, return_aux: bool = False, drop: bool = True,
              tp=None):
    """x [T, d] flattened tokens -> [T, d] (and, with `return_aux`, the
    Switch-style load-balancing loss E * sum_e f_e p_e, f32).  ``drop=False``
    dispatches with capacity T: a token's k experts are distinct, so no
    expert receives more than T entries and none is dropped.  Training
    drops: every entry past an expert's capacity lands in the spill row,
    which nothing reads, so its token gets no output and no gradient from
    that slot.  Under `tp`, p's experts are the rank's (`tp.experts`)."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    over_data = tp is not None and drop and tp.data_split
    t_all = tp.data_tokens(t) if over_data else t        # the microbatch's tokens
    c = capacity(t_all, cfg) if drop else t
    cb = c                                               # rows a buffer of one expert holds
    act = activation_fn(cfg.activation)

    probs = torch.softmax(x.float() @ p["router"], dim=-1)          # [T, E]
    # descending, as jax.lax.top_k: the slot order fixes the sum's order
    gate, eidx = torch.topk(probs, k, dim=-1, sorted=True)          # [T, k]
    gate = gate / gate.sum(dim=-1, keepdim=True)
    e0, e1 = (0, e) if tp is None else tp.experts
    if tp is not None:                  # into the rank's share: gradients summed over it
        x, gate = tp.copy(x), tp.copy(gate)

    # group the (token, slot) entries by expert
    fe = eidx.reshape(-1)                                            # [T*k]
    order = torch.argsort(fe, stable=True)
    se = fe[order]
    ar = torch.arange(t * k, device=x.device)
    pos_in_e = ar - torch.searchsorted(se, se, side="left")
    # bincount's output shape depends on the data; this count has a static one
    counts = torch.zeros(e, dtype=torch.int64, device=x.device).scatter_add_(
        0, fe, torch.ones_like(fe))
    keep = pos_in_e < c
    if over_data:                        # the entries of the data ranks before this one
        first = tp.data_offsets(counts)
        keep = pos_in_e + first[se] < c
        # the most entries one of this rank's experts keeps
        cb = tp.expert_rows(torch.clamp(c - first, min=0).minimum(counts)[e0:e1], c)
    if tp is not None:
        keep = keep & (se >= e0) & (se < e1)
    el = e1 - e0
    slot = torch.where(keep, (se - e0) * cb + pos_in_e, el * cb)   # spill row at El*Cb

    buf = x.new_zeros((el * cb + 1, d))
    # each entry's token row, gathered from x repeated over its k slots by
    # the permutation `order`: no index repeats, so the backward sums a
    # token's k rows in the expand's fixed order, not by atomics as the
    # backward of a gather by `order // k` would on CUDA
    xk = x[:, None].expand(t, k, d).reshape(t * k, d)
    buf.index_put_((slot,), xk.index_select(0, order))
    h = buf[:el * cb].view(el, cb, d)

    # the expert FFN, batched over the experts
    y = act(torch.bmm(h, p["w_gate"])) * torch.bmm(h, p["w_up"])
    y = torch.bmm(y, p["w_down"])

    # combine back to the tokens; the spill row gives 0
    yflat = torch.cat([y.reshape(el * cb, d), y.new_zeros((1, d))])
    out_sorted = yflat.index_select(0, slot)                         # [T*k, d]
    inv = torch.empty_like(order)
    inv[order] = ar
    out_entries = out_sorted.index_select(0, inv).view(t, k, d)
    out = torch.sum(out_entries * gate[..., None].to(out_entries.dtype), dim=1)
    if tp is not None:
        out = tp.reduce(out)
    if not return_aux:
        return out
    if over_data:
        me = tp.data_sum(probs.sum(dim=0)) / t_all                   # mean router prob
        counts = tp.data_sum(counts)
    else:
        me = probs.mean(dim=0)
    ce = counts.float() / (t_all * k)                                # share of entries
    return out, e * torch.sum(me * ce)
