"""Host-side buffer store for KV-cache swapping (the port's copy of the
reference's `HostMemoryStore`, holding CPU tensors instead of numpy arrays).

Capacity is enforced on every `put`: the store either raises
(``on_full="raise"``, the default) or evicts least-recently-used entries
(``on_full="evict_lru"``), handing each victim to an optional ``spill_cb``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import torch


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
        self._lock = threading.Lock()

    def put(self, key: str, array: torch.Tensor) -> List[Tuple[str, torch.Tensor]]:
        """Store `array` (moved to the CPU) under `key`.  Returns the
        (key, tensor) entries evicted to make room."""
        arr = array.to("cpu")
        evicted: List[Tuple[str, torch.Tensor]] = []
        with self._lock:
            old = self._data.get(key)
            new_bytes = (self._used_bytes_locked() - (0 if old is None else _nbytes(old))
                         + _nbytes(arr))
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
                if new_bytes > self.capacity_bytes:
                    raise MemoryError(f"store {self.name!r}: single array of "
                                      f"{_nbytes(arr)} bytes exceeds capacity "
                                      f"{self.capacity_bytes}")
            self._data[key] = arr
            self._data.move_to_end(key)
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
            return self._data.pop(key)

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def keys(self):
        with self._lock:
            return list(self._data)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def used_bytes(self) -> int:
        with self._lock:
            return self._used_bytes_locked()

    def _used_bytes_locked(self) -> int:
        return sum(_nbytes(a) for a in self._data.values())

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
