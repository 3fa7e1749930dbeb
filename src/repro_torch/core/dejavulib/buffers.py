"""Host-side buffer stores for KV-cache streaming (the port's copies of the
reference's `HostMemoryStore` and `SSDStore`, holding CPU tensors instead of
numpy arrays).

`HostMemoryStore` is a node's host memory: the swap and replication target
and tier 1 of the KV hierarchy (`repro_torch.kvcache.tiers`).  `SSDStore`
persists to disk (tier 2) with atomic, fsync'd writes, so a crashed writer
never leaves a torn block.

Capacity is enforced on every `put`: the store either raises
(``on_full="raise"``, the default) or evicts least-recently-used entries
(``on_full="evict_lru"``), handing each victim to an optional ``spill_cb``.
The store keeps a running count of its bytes, so a `put` costs the same
however many entries it holds (a replica store holds thousands of blocks).
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dejavulib import faults


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class HostMemoryStore:
    """Named CPU tensor store with capacity accounting (pinned host RAM)."""

    def __init__(self, name: str = "host", capacity_bytes: Optional[int] = None,
                 on_full: str = "raise",
                 spill_cb: Optional[Callable[[str, torch.Tensor], None]] = None):
        if on_full not in ("raise", "evict_lru"):
            raise ValueError(f"on_full must be 'raise' or 'evict_lru', not {on_full!r}")
        self.name = name
        self.capacity_bytes = capacity_bytes
        self.on_full = on_full
        self.spill_cb = spill_cb
        self._data: "OrderedDict[str, torch.Tensor]" = OrderedDict()
        self._used = 0                         # bytes of every entry
        self._lock = threading.Lock()

    def put(self, key: str, array: torch.Tensor) -> List[Tuple[str, torch.Tensor]]:
        """Store `array` (moved to the CPU) under `key`.  Returns the
        (key, tensor) entries evicted to make room."""
        arr = array.to("cpu")
        evicted: List[Tuple[str, torch.Tensor]] = []
        with self._lock:
            old = self._data.get(key)
            new_bytes = self._used - (0 if old is None else _nbytes(old)) + _nbytes(arr)
            if self.capacity_bytes is not None and new_bytes > self.capacity_bytes:
                if self.on_full == "raise":
                    raise MemoryError(f"store {self.name!r}: {new_bytes} > capacity "
                                      f"{self.capacity_bytes}")
                while new_bytes > self.capacity_bytes:
                    victim_key = next((k for k in self._data if k != key), None)
                    if victim_key is None:
                        break
                    victim = self._data.pop(victim_key)
                    evicted.append((victim_key, victim))
                    new_bytes -= _nbytes(victim)
                    self._used -= _nbytes(victim)
                if new_bytes > self.capacity_bytes:
                    raise MemoryError(f"store {self.name!r}: single array of "
                                      f"{_nbytes(arr)} bytes exceeds capacity "
                                      f"{self.capacity_bytes}")
            self._data[key] = arr
            self._data.move_to_end(key)
            self._used = new_bytes
        if self.spill_cb is not None:
            for k, a in evicted:
                self.spill_cb(k, a)
        return evicted

    def get(self, key: str) -> torch.Tensor:
        with self._lock:
            arr = self._data[key]
            self._data.move_to_end(key)        # LRU touch
            return arr

    def pop(self, key: str) -> torch.Tensor:
        with self._lock:
            arr = self._data.pop(key)
            self._used -= _nbytes(arr)
            return arr

    def delete(self, key: str) -> None:
        with self._lock:
            arr = self._data.pop(key, None)
            if arr is not None:
                self._used -= _nbytes(arr)

    def keys(self):
        with self._lock:
            return list(self._data)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._used = 0


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes as a numpy array of its shape: bfloat16, which
    numpy lacks, as its 2-byte integer view."""
    t = t.detach().to("cpu").contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


class SSDStore:
    """Disk-backed store (one ``.npy`` file per key, published by atomic
    rename).  Survives process death: the tier-2 spill of the KV hierarchy,
    which failure recovery restores from.

    Writes are crash-safe: the bytes land in a temp file that is flushed and
    fsync'd before ``os.replace`` publishes it, so a reader never sees a torn
    block; a writer's crash leaves at worst an orphaned ``*.tmp.*`` file,
    which `keys()` ignores.  A bfloat16 tensor is stored as its int16 view,
    and `get` takes the dtype to view it back as; any other dtype is stored
    as numpy stores it (an fp32 file has the reference store's size)."""

    def __init__(self, root: str, name: str = "ssd"):
        self.name = name
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "__") + ".npy")

    def put(self, key: str, array: torch.Tensor) -> None:
        path = self._path(key)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        arr = _as_numpy(array)
        with self._lock:
            try:
                with open(tmp, "wb") as f:   # np.save(str) would append .npy
                    np.save(f, arr)
                    f.flush()
                    os.fsync(f.fileno())     # durable before the rename publishes
                # the crash window: the bytes are durable in the temp file but
                # not published; a fault here must leave a reader the old
                # block (or none), never a torn one
                faults.fire("ssd.put", tag=key)
                os.replace(tmp, path)        # atomic
            except BaseException:
                try:
                    os.remove(tmp)           # never leak a partial temp file
                except FileNotFoundError:
                    pass
                raise

    def get(self, key: str, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The stored tensor, viewed as `dtype` where one is given (a stored
        int16 view as bfloat16)."""
        t = torch.from_numpy(np.load(self._path(key)))
        if dtype is not None and t.dtype != dtype:
            if t.element_size() != torch.empty((), dtype=dtype).element_size():
                raise TypeError(f"store {self.name!r}: {key!r} holds {t.dtype}, "
                                f"not a view of {dtype}")
            t = t.view(dtype)
        return t

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def __contains__(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def size(self, key: str) -> int:
        """On-disk bytes of one entry (0 if absent)."""
        try:
            return os.path.getsize(self._path(key))
        except FileNotFoundError:
            return 0

    def keys(self):
        return [f[:-4].replace("__", "/") for f in os.listdir(self.root) if f.endswith(".npy")]

    def used_bytes(self) -> int:
        return sum(os.path.getsize(os.path.join(self.root, f))
                   for f in os.listdir(self.root) if f.endswith(".npy"))

    def clear(self) -> None:
        for f in list(os.listdir(self.root)):
            if f.endswith(".npy"):
                os.remove(os.path.join(self.root, f))
