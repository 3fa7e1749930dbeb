"""Training step factory (counterpart of `repro.training.train`): loss and
gradient, optional microbatched accumulation, the AdamW update, metrics.

The parameters are a nested dict of tensors, as the models take them; the
step is functional like the reference's: it returns new parameters and a
new optimizer state.  Remat is a model flag (`build_model(..., remat=True)`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.training.optimizer import AdamWState, adamw_update, tree_leaves, tree_map


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_accum: int = 1        # microbatches per step, run one after another


def batch_to(batch, device) -> dict:
    """A batch of numpy arrays (`SyntheticDataPipeline.batch_at`) as tensors
    on `device`."""
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def loss_and_grads(model, tcfg: TrainConfig, params, batch, weights=None):
    """(loss, gradient tree) of `model.loss` on `batch`.  With grad_accum >
    1, the leading batch dim is split into microbatches whose losses and
    gradients are averaged, the gradients summed in f32 as the reference's
    scan does.  `weights` ([grad_accum] f32; default none) scale each
    microbatch's loss and gradients before they are averaged: a sharded
    step's share of each global microbatch's mask count."""

    def value_and_grad(batch, i):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = model.loss(live, batch)
            grads = torch.autograd.grad(loss, tree_leaves(live))
        loss = loss.detach()
        if weights is not None:
            loss = loss * weights[i]
            for g in grads:
                g.mul_(weights[i])
        return loss, _unflatten(live, iter(grads))

    n = tcfg.grad_accum
    if n == 1:
        return value_and_grad(batch, 0)
    micro = [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
              for k, v in batch.items()} for i in range(n)]
    loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    for i, mb in enumerate(micro):
        l, g = value_and_grad(mb, i)
        loss = loss + l / n
        grads = tree_map(lambda a, b_: a + b_ / n, grads, g)
    return loss, grads


def make_train_step(model, tcfg: TrainConfig = TrainConfig()):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): `loss_and_grads`, then the AdamW update."""

    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = loss_and_grads(model, tcfg, params, batch)
        params, opt_state, om = adamw_update(
            grads, opt_state, params, lr=tcfg.lr, b1=tcfg.b1, b2=tcfg.b2,
            weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm)
        return params, opt_state, {"loss": loss.float(), **om}

    return train_step


def _unflatten(tree, it):
    """`tree`'s structure filled from `it`, in `tree_leaves`' order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)
