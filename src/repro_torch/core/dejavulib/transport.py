"""Transports of the port: real copies that count their bytes (the port's
counterpart of `repro.core.dejavulib.transport`).

A transfer copies a tensor to its destination device: a device tensor to
pinned host memory, a host tensor to the device, or host to host.  Each
transport counts the bytes it moved, which `ServingEngine.transfer_summary`
reads by kind.  The reference's modeled time (`HardwareModel`) is not here:
it comes with the H100 cost model (ROADMAP A.7).
"""
from __future__ import annotations

import threading

import torch


class Transport:
    kind = "base"

    def __init__(self):
        self._bytes = 0
        self._lock = threading.Lock()

    def transfer(self, t: torch.Tensor, device="cpu") -> torch.Tensor:
        """A copy of `t` on `device`; a host copy of a device tensor lands in
        pinned memory.  Synchronous: the copy is complete on return."""
        dst = torch.device(device)
        if dst.type == "cpu":
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            out.copy_(t)
        else:
            out = t.to(dst, copy=True)
        with self._lock:
            self._bytes += out.numel() * out.element_size()
        return out

    def bytes_total(self) -> int:
        with self._lock:
            return self._bytes


class LocalTransport(Transport):
    """Same-host copy."""
    kind = "local"


class HostLinkTransport(Transport):
    """Device memory <-> host memory over PCIe (the swap path)."""
    kind = "hostlink"


class NetworkTransport(Transport):
    """Between the prompt and token pipelines (the paper's inter-machine
    stream of the prompt's KV)."""
    kind = "net"
