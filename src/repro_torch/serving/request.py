"""Request lifecycle (the port's copy of `repro.serving.request.Request`)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new: int
    eos_id: Optional[int] = None
    arrival: float = 0.0
    tokens: List[int] = field(default_factory=list)
    done: bool = False

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])
