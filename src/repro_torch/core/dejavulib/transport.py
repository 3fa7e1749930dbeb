"""Transports of the port: real copies that count their bytes (the port's
counterpart of `repro.core.dejavulib.transport`).

A transfer copies a tensor to its destination device: a device tensor to
pinned host memory, a host tensor to the device, or host to host.  Each
transport counts the bytes it moved, which `ServingEngine.transfer_summary`
reads by kind, and its attempts and retransmits.  A transfer fires the
``transport.transfer.<kind>`` injection point (`faults`): a ``drop`` loses
the first copy, a ``corrupt`` flips a byte of it, which the integrity check
finds; either way the transfer sends again, so the caller always gets exact
bytes.  The reference's modeled time (`HardwareModel`) is not here: it
comes with the H100 cost model (ROADMAP A.7).
"""
from __future__ import annotations

import threading

import torch

from repro_torch.core.dejavulib import faults


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _bytes_view(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


class Transport:
    kind = "base"

    def __init__(self):
        self._bytes = 0
        self.transfers = 0
        self.attempts = 0
        self.retransmits = 0
        self._lock = threading.Lock()
        self._stage: torch.Tensor = None     # pinned staging buffer (pin=False)
        self._stage_lock = threading.Lock()

    def _copy(self, t: torch.Tensor, dst: torch.device, pin: bool) -> torch.Tensor:
        if dst.type != "cpu":
            return t.to(dst, copy=True)
        if not (t.is_cuda and not pin):
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin and t.is_cuda)
            out.copy_(t)
            return out
        # device to pageable memory through a pinned staging buffer that is
        # kept and reused: a direct copy into pageable memory runs at a
        # fraction of the link's rate
        out = torch.empty(t.shape, dtype=t.dtype)
        n = _nbytes(t)
        with self._stage_lock:
            if self._stage is None or self._stage.numel() < n:
                self._stage = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            stage = self._stage[:n].view(t.dtype).view(t.shape)
            stage.copy_(t)
            out.copy_(stage)
        return out

    def transfer(self, t: torch.Tensor, device="cpu", *, tag: str = "",
                 pin: bool = True) -> torch.Tensor:
        """A copy of `t` on `device`.  A host copy of a device tensor lands
        in pinned memory, or, with ``pin=False``, in pageable memory (for a
        copy that is kept: every pinned allocation that is not freed again
        costs a page-locking call).  Synchronous: the copy is complete on
        return."""
        dst = torch.device(device)
        out = self._copy(t, dst, pin)
        attempts = 1
        # the fault point, and the byte-wise integrity check standing in for
        # a checksum, run only with an injector installed: otherwise a
        # transfer is one copy
        if faults.current() is not None:
            spec = faults.fire(f"transport.transfer.{self.kind}", tag=tag)
            if spec is not None and spec.kind in ("drop", "corrupt"):
                out, attempts = self._realize_loss(spec, t, out, dst, pin)
        with self._lock:
            self._bytes += _nbytes(out)
            self.transfers += 1
            self.attempts += attempts
            self.retransmits += attempts - 1
        return out

    def _realize_loss(self, spec, src: torch.Tensor, out: torch.Tensor, dst, pin: bool):
        """Apply a drop or corrupt fault, detect it and send again."""
        if spec.kind == "drop":
            out = None                           # the receiver saw nothing
        elif out.numel():
            _bytes_view(out)[0] ^= 0xFF          # a bit flip in flight
        if out is None or not torch.equal(_bytes_view(out),
                                          _bytes_view(src.to(out.device))):
            return self._copy(src, dst, pin), 2
        return out, 1

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
    """Between machines: the prompt KV streamed from the prompt pipeline to
    the token pipeline, and each stage's KV replicated to its ring
    successor's host memory."""
    kind = "net"
