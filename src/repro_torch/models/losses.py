"""Loss functions (counterpart of `repro.models.losses`)."""
from __future__ import annotations

import torch


def causal_lm_loss(logits: torch.Tensor, targets: torch.Tensor,
                   loss_mask: torch.Tensor) -> torch.Tensor:
    """logits [B,S,V] (bf16 ok); targets [B,S] int; loss_mask [B,S] ->
    the mask-weighted mean cross-entropy, f32 scalar.

    CE = logsumexp(logits) - logits[target]: the f32 copy of the logits is
    the one the logsumexp needs; the target logit is gathered from the
    logits in their own dtype and only then cast."""
    lse = torch.logsumexp(logits.float(), dim=-1)                          # [B,S]
    tgt = logits.gather(-1, targets[..., None].long())[..., 0].float()
    mask = loss_mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    return ((lse - tgt) * mask).sum() / denom
