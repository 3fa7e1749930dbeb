"""Request and microbatch lifecycle (the port's copy of
`repro.serving.request`)."""
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


@dataclass
class Microbatch:
    mb: int
    requests: List[Request]
    next_step: int = 0            # 0 = needs prefill; i >= 1 = next decode step
    n_new: int = 0                # synchronous token budget (max over requests)
    done: bool = False

    @property
    def prompt_len(self) -> int:
        return self.requests[0].prompt_len

    def batch_prompts(self) -> np.ndarray:
        return np.stack([r.prompt for r in self.requests]).astype(np.int32)


def form_microbatches(requests: List[Request], size: int) -> List[Microbatch]:
    """Group fixed-size, length-homogeneous microbatches.

    Prompts inside one microbatch must share a length (the paper's setting,
    a fixed prompt size per experiment), so a mixed-length trace is bucketed
    by prompt length first (arrival order kept within a bucket; each
    bucket's tail microbatch may be smaller than `size`)."""
    order: List[int] = []
    buckets = {}
    for r in requests:
        if r.prompt_len not in buckets:
            order.append(r.prompt_len)
        buckets.setdefault(r.prompt_len, []).append(r)
    mbs = []
    for plen in order:
        bucket = buckets[plen]
        for i in range(0, len(bucket), size):
            group = bucket[i: i + size]
            mbs.append(Microbatch(mb=len(mbs), requests=group,
                                  n_new=max(r.max_new for r in group)))
    return mbs
