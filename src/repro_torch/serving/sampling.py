"""Token sampling.  Greedy is the cross-package contract: `torch.argmax`
returns the first maximum, like `jnp.argmax`, so equal logits pick equal
tokens in both packages."""
from __future__ import annotations

import numpy as np
import torch


def greedy(logits: torch.Tensor, _step: int = 0) -> np.ndarray:
    return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()


class TopKSampler:
    """Seeded top-k / temperature sampling.  The draw depends only on
    (seed, step) and the logits, so a step regenerated after a recovery
    samples the token it sampled before.  The stream is torch's, not
    `jax.random`'s: the tokens differ from the JAX package's sampler."""

    def __init__(self, k: int = 40, temperature: float = 1.0, seed: int = 0):
        self.k = k
        self.temperature = temperature
        self.seed = seed

    def __call__(self, logits: torch.Tensor, step: int = 0) -> np.ndarray:
        gen = torch.Generator(device=logits.device)
        gen.manual_seed((self.seed * 1_000_003 + step) % (2 ** 63))
        vals, idx = torch.topk(logits.float() / self.temperature, self.k, dim=-1)
        # Gumbel-max: argmax(vals + Gumbel noise) draws from softmax(vals)
        u = torch.rand(vals.shape, generator=gen, device=vals.device)
        choice = torch.argmax(vals - torch.log(-torch.log(u.clamp_min(1e-20))), dim=-1)
        return torch.gather(idx, -1, choice[:, None])[:, 0].to(torch.int32).cpu().numpy()
