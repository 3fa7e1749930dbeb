"""The port's kernels: CUDA sources under ``csrc/``, their wrappers, their
plain PyTorch versions (`ref`) and the `ops` entry points the model calls.

`LAUNCHES` counts, per kernel, the launches its wrapper made on the card; a
wrapper adds one where it launches its kernel and nowhere else, so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

KERNELS = ("batched_decode_attention", "kv_pack_ragged", "kv_pack", "decode_attention",
           "flash_attention", "kv_unpack", "ssd_scan", "paged_decode_attention",
           "paged_prefill_attention")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
