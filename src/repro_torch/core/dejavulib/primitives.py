"""DéjàVuLib primitives (paper §4.1.2, Table 1) of the port (counterpart of
`repro.core.dejavulib.primitives`, for the dense decode state).

Layered as in the paper:

  stream_out / stream_in   top level: given source and destination pipeline
                           topologies (depths, microbatch sizes), plan which
                           chunks of the stacked decode state go to which
                           peer (split at the source, merged at the
                           destination) and move them;
  scatter                  middle: a token window of a stacked cache leaf
                           becomes one contiguous transfer, packed on the
                           device by the `kv_pack` kernel first (the paper's
                           "buffered copies");
  flush / fetch            bottom: one contiguous chunk over a transport.

Leaves are [L,B,S,H,D] tensors addressed by path (``kv/k``, ``kv/v``).

Landing differs from the reference in where it happens, not in the values.
The reference's `stream_in` assembles the local cache in host memory
(``dense[...] = arr`` into zeros) and the worker then moves it to the
device.  Here `stream_in` allocates the zero cache on the device and writes
each fetched chunk's token window with the `kv_unpack` kernel, the chunk
padded with zeros to a multiple of the token block.  A microbatch cache is
8-aligned, so the padded window fits, and the padding writes zeros over
zeros: the cache equals the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.dejavulib.buffers import HostMemoryStore
from repro_torch.core.dejavulib.transport import Transport
from repro_torch.kernels import ops as kops

TOKEN_AXIS = 2


@dataclass(frozen=True)
class PipelineTopo:
    """A pipeline's shape: `depth` stages over `num_layers`, `microbatch`."""
    depth: int
    num_layers: int
    microbatch: int

    def layer_range(self, stage: int) -> Tuple[int, int]:
        splits = np.array_split(np.arange(self.num_layers), self.depth)
        seg = splits[stage]
        return (int(seg[0]), int(seg[-1]) + 1) if len(seg) else (0, 0)


@dataclass(frozen=True)
class CacheChunk:
    """A rectangular region of one decode-state leaf."""
    leaf: str
    layers: Tuple[int, int]
    batch: Tuple[int, int]
    tokens: Optional[Tuple[int, int]] = None

    def key(self, mb: int | str) -> str:
        t = f"/t{self.tokens[0]}-{self.tokens[1]}" if self.tokens else ""
        return (f"mb{mb}/{self.leaf}/l{self.layers[0]}-{self.layers[1]}"
                f"/b{self.batch[0]}-{self.batch[1]}{t}")


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> Optional[Tuple[int, int]]:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else None


def plan_repartition(src: PipelineTopo, dst: PipelineTopo
                     ) -> List[Tuple[int, int, Tuple[int, int], Tuple[int, int]]]:
    """All (src_stage, dst_stage, layer_range, batch_range) intersections,
    for differing pipeline depths (layer split/merge) and differing
    microbatch sizes (batch split/merge)."""
    if src.num_layers != dst.num_layers:
        raise ValueError(f"{src.num_layers} layers cannot stream to {dst.num_layers}")
    plan = []
    nb = max(src.microbatch, dst.microbatch)
    src_b = [(i * src.microbatch, (i + 1) * src.microbatch)
             for i in range(max(1, nb // src.microbatch))]
    dst_b = [(j * dst.microbatch, (j + 1) * dst.microbatch)
             for j in range(max(1, nb // dst.microbatch))]
    for ss in range(src.depth):
        sl = src.layer_range(ss)
        for ds in range(dst.depth):
            lr = _overlap(sl, dst.layer_range(ds))
            if lr is None:
                continue
            for sb in src_b:
                for db in dst_b:
                    br = _overlap(sb, db)
                    if br is not None:
                        plan.append((ss, ds, lr, br))
    return plan


# ---------------------------------------------------------------------------
# flush / fetch: one contiguous chunk
# ---------------------------------------------------------------------------

def flush(t: torch.Tensor, store: HostMemoryStore, key: str, transport: Transport) -> int:
    """Copy one chunk into a (possibly remote) host store; returns bytes."""
    out = transport.transfer(t)
    store.put(key, out)
    return out.numel() * out.element_size()


def fetch(store: HostMemoryStore, key: str, transport: Transport, *,
          device="cpu") -> torch.Tensor:
    """A copy of one stored chunk on `device`."""
    return transport.transfer(store.get(key), device=device)


# ---------------------------------------------------------------------------
# scatter: a token window -> one contiguous transfer
# ---------------------------------------------------------------------------

def _pack_window(leaf: torch.Tensor, t0: int, t1: int, token_block: int) -> torch.Tensor:
    """Tokens [t0, t1) of a stacked leaf [l,b,S,H,D] (a view of a larger
    one will do): the window, widened to the token block, packed by kv_pack
    on the leaf's device, then cut back to [t0, t1)."""
    t0a = (t0 // token_block) * token_block
    w = min(-(-(t1 - t0a) // token_block) * token_block, leaf.shape[TOKEN_AXIS] - t0a)
    buf = kops.kv_pack_auto(leaf, t0a, w, token_block=token_block)
    return buf[:, :, t0 - t0a:t1 - t0a]


def scatter(cache_leaf: torch.Tensor, leaf_name: str, token_range: Tuple[int, int],
            store: HostMemoryStore, transport: Transport, *, mb: int | str = 0,
            token_block: int = 8) -> Dict[str, int]:
    """Stream the token window `token_range` of a stacked leaf [L,B,S,H,D]
    as one transfer of one kv_pack-ed buffer.  Returns {key: bytes}."""
    t0, t1 = token_range
    chunk = CacheChunk(leaf_name, (0, cache_leaf.shape[0]), (0, cache_leaf.shape[1]),
                       (t0, t1))
    key = chunk.key(mb)
    return {key: flush(_pack_window(cache_leaf, t0, t1, token_block), store, key,
                       transport)}


# ---------------------------------------------------------------------------
# stream_out / stream_in: repartition between pipeline topologies
# ---------------------------------------------------------------------------

def _leaf_items(state: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    items = []
    for k, v in state.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            items.extend(_leaf_items(v, path + "/"))
        else:
            items.append((path, v))
    return items


def stream_out(state: Dict, src_stage: int, src_topo: PipelineTopo,
               dst_topo: PipelineTopo, dst_stores: Dict[int, HostMemoryStore],
               transport: Transport, *, mb: int | str = 0,
               token_range: Optional[Tuple[int, int]] = None,
               token_block: int = 8) -> int:
    """Send this stage's slice of the decode state to the destination
    pipeline's stores, split and merged by layers and batch; each chunk's
    token window is packed on the device (`scatter`'s buffered copy) before
    it crosses.  Returns bytes."""
    plan = plan_repartition(src_topo, dst_topo)
    my_lo = src_topo.layer_range(src_stage)[0]
    total = 0
    for leaf, arr in _leaf_items(state):
        if arr.dim() != 5:
            raise ValueError(f"leaf {leaf} is not a stacked [L,B,S,H,D] cache")
        tok = token_range or (0, arr.shape[TOKEN_AXIS])
        for ss, ds, lr, br in plan:
            lo, hi = lr[0] - my_lo, lr[1] - my_lo
            if ss != src_stage or lo < 0 or hi > arr.shape[0]:
                continue
            buf = _pack_window(arr[lo:hi, br[0]:br[1]], *tok, token_block)
            total += flush(buf, dst_stores[ds], CacheChunk(leaf, lr, br, tok).key(mb),
                           transport)
    return total


def _land(view: torch.Tensor, chunk: torch.Tensor, t0: int, token_block: int) -> None:
    """Write a fetched chunk [l,b,w,H,D] into `view` at token t0 through
    kv_unpack, padded with zeros to a multiple of the token block."""
    pad = -chunk.shape[TOKEN_AXIS] % token_block
    if pad:
        chunk = F.pad(chunk, (0, 0, 0, 0, 0, pad))
    kops.kv_unpack_auto(view, chunk, t0, token_block=token_block)


def stream_in(store: HostMemoryStore, dst_stage: int, dst_topo: PipelineTopo,
              src_topo: PipelineTopo, state_shapes: Dict, transport: Transport, *,
              mb: int | str = 0, token_range: Optional[Tuple[int, int]] = None,
              device="cuda", token_block: int = 8) -> Dict:
    """Rebuild this stage's local decode state on `device` from streamed
    chunks.  `state_shapes`: nested dict of (shape, dtype) of the stage's
    own state (its layer axis is the stage's layer count)."""
    plan = plan_repartition(src_topo, dst_topo)
    my_lo = dst_topo.layer_range(dst_stage)[0]

    def build(shapes, prefix=""):
        out = {}
        for k, v in shapes.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                out[k] = build(v, path + "/")
                continue
            shape, dtype = v
            tok = token_range or (0, shape[TOKEN_AXIS])
            dense = torch.zeros(shape, dtype=dtype, device=device)
            for _, ds, lr, br in plan:
                if ds != dst_stage:
                    continue
                arr = fetch(store, CacheChunk(path, lr, br, tok).key(mb), transport,
                            device=device)
                _land(dense[lr[0] - my_lo:lr[1] - my_lo, br[0]:br[1]], arr, tok[0],
                      token_block)
            out[k] = dense
        return out

    return build(state_shapes)
