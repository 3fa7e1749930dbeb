"""Token sampling.  Greedy is the cross-package contract: `torch.argmax`
returns the first maximum, like `jnp.argmax`, so equal logits pick equal
tokens in both packages."""
from __future__ import annotations

import numpy as np
import torch


def greedy(logits: torch.Tensor, _step: int = 0) -> np.ndarray:
    return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
