"""Transports of the port: real copies that count their bytes and charge
modeled time (the port's counterpart of `repro.core.dejavulib.transport`).

A transfer copies a tensor to its destination device: a device tensor to
pinned host memory, a host tensor to the device, or host to host.  Each
transport counts the bytes it moved, which `ServingEngine.transfer_summary`
reads by kind, its attempts and retransmits, and the modeled seconds it
charged (`HardwareModel`: latency plus bytes over bandwidth, once per
attempt), which `modeled_total` reads.  With a
telemetry registry or a tracer installed it also records the
``transport.*`` counters (labelled ``kind=``) and an ``xfer`` event.  A
transfer fires the ``transport.transfer.<kind>`` injection point
(`faults`): a ``drop`` loses the first copy, a ``corrupt`` flips a byte of
it, which the integrity check finds; either way the transfer sends again,
so the caller always gets exact bytes.  A ``delay`` adds its seconds to the
modeled time.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

from repro_torch.core import telemetry, tracing
from repro_torch.core.dejavulib import faults


@dataclass(frozen=True)
class HardwareModel:
    """The deployment the modeled time stands for.  The defaults describe an
    HGX H100 node: 8 × H100 SXM5 80GB at 700 W.  Rates are bytes or
    operations per second, one direction."""
    # H100 SXM5 datasheet: 989 TFLOP/s dense bf16 tensor-core rate per GPU
    peak_flops: float = 989e12
    # same datasheet: 3.35 TB/s HBM3 per GPU
    hbm_bw: float = 3.35e12
    # GPU to GPU (the reference's ICI): NVLink 4, 900 GB/s per GPU in the
    # datasheet, both directions of its 18 links together; 450 GB/s each way
    ici_bw: float = 450e9
    # device <-> host: PCIe Gen5 x16, 128 GB/s in the datasheet, both
    # directions together; 64 GB/s each way
    host_link_bw: float = 64e9
    # between nodes (the reference's DCN): one ConnectX-7 NDR InfiniBand
    # port per GPU, 400 Gb/s = 50 GB/s each way
    dcn_stream_bw: float = 50e9
    # the host, an assumption (no datasheet figure): one thread's memcpy in
    # host DRAM; chip_smoke.py measures it beside this figure
    host_mem_bw: float = 20e9
    # the host, an assumption: one PCIe Gen4 x4 NVMe drive's sequential rate
    ssd_bw: float = 6e9
    # assumptions: the fixed cost of one copy (a copy's launch and DMA
    # setup) and of one network message (an RDMA message's round trip)
    transfer_latency: float = 5e-6
    net_latency: float = 5e-6
    # GPUs per HGX H100 node
    chips_per_host: int = 8


DEFAULT_HW = HardwareModel()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _bytes_view(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


class Transport:
    """Base transport: copies tensors, counts bytes, charges modeled time."""

    kind = "base"

    def __init__(self, hw: HardwareModel = DEFAULT_HW):
        self.bandwidth, self.latency = self._link(hw)
        self._bytes = 0
        self._model_s = 0.0
        self.transfers = 0
        self.attempts = 0
        self.retransmits = 0
        self._lock = threading.Lock()
        self._stage: torch.Tensor = None     # pinned staging buffer (pin=False)
        self._stage_lock = threading.Lock()

    @staticmethod
    def _link(hw: HardwareModel):
        """(bandwidth, latency) of this kind of link in `hw`."""
        return hw.host_mem_bw, hw.transfer_latency

    def model_time(self, nbytes: int, n_messages: int = 1) -> float:
        return self.latency * n_messages + nbytes / self.bandwidth

    def _copy(self, t: torch.Tensor, dst: torch.device, pin: bool,
              non_blocking: bool = False) -> torch.Tensor:
        if dst.type != "cpu":
            return t.to(dst, copy=True, non_blocking=non_blocking)
        if not (t.is_cuda and not pin):
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin and t.is_cuda)
            out.copy_(t, non_blocking=non_blocking)
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
                 pin: bool = True, non_blocking: bool = False) -> torch.Tensor:
        """A copy of `t` on `device`.  A host copy of a device tensor lands
        in pinned memory, or, with ``pin=False``, in pageable memory (for a
        copy that is kept: every pinned allocation that is not freed again
        costs a page-locking call).  Synchronous: the copy is complete on
        return, unless ``non_blocking``: then a copy between pinned host
        memory and the device is only queued on the current CUDA stream, and
        the caller synchronises that stream before the host reads or frees
        its side."""
        dst = torch.device(device)
        out = self._copy(t, dst, pin, non_blocking)
        attempts, spec = 1, None
        # the fault point, and the byte-wise integrity check standing in for
        # a checksum, run only with an injector installed: otherwise a
        # transfer is one copy
        if faults.current() is not None:
            spec = faults.fire(f"transport.transfer.{self.kind}", tag=tag)
            if spec is not None and spec.kind in ("drop", "corrupt"):
                if non_blocking and (t.is_cuda or out.is_cuda):
                    torch.cuda.current_stream().synchronize()   # the copy has landed
                out, attempts = self._realize_loss(spec, t, out, dst, pin)
        nbytes = _nbytes(out)
        model = self.model_time(nbytes) * attempts
        if spec is not None and spec.kind == "delay":
            model += spec.delay_s                # an injected straggler
        with self._lock:
            self._bytes += nbytes
            self._model_s += model
            self.transfers += 1
            self.attempts += attempts
            self.retransmits += attempts - 1
        telemetry.count("transport.transfers", 1, kind=self.kind)
        telemetry.count("transport.bytes", nbytes, kind=self.kind)
        telemetry.count_time("transport.model_ns", model, kind=self.kind)
        if attempts > 1:
            telemetry.count("transport.retransmits", 1, kind=self.kind)
        if tracing.active():
            # runs on the serving and on the streamer thread; the tracer puts
            # each on its thread's track with the modeled duration
            tracing.event("xfer", kind=self.kind, bytes=nbytes, attempts=attempts, tag=tag,
                          dur_ns=int(round(model * 1e9)))
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

    def modeled_total(self) -> float:
        """Modeled seconds of every transfer so far, retransmits included."""
        with self._lock:
            return self._model_s

    def reset_log(self) -> None:
        """Start the counts afresh: bytes, modeled seconds, transfers,
        attempts and retransmits (the reference clears the log of records
        its totals sum; the port keeps the sums alone)."""
        with self._lock:
            self._bytes, self._model_s = 0, 0.0
            self.transfers = self.attempts = self.retransmits = 0


class LocalTransport(Transport):
    """Same-host copy."""
    kind = "local"


class HostLinkTransport(Transport):
    """Device memory <-> host memory over PCIe (the swap path)."""
    kind = "hostlink"

    @staticmethod
    def _link(hw: HardwareModel):
        return hw.host_link_bw, hw.transfer_latency


class ICITransport(Transport):
    """Card to card inside one host (the role of the reference's
    intra-pod ICI link for prompt-to-token transfers; NVLink here)."""
    kind = "ici"

    @staticmethod
    def _link(hw: HardwareModel):
        return hw.ici_bw, hw.transfer_latency


class NetworkTransport(Transport):
    """Between machines: the prompt KV streamed from the prompt pipeline to
    the token pipeline, and each stage's KV replicated to its ring
    successor's host memory."""
    kind = "net"

    @staticmethod
    def _link(hw: HardwareModel):
        return hw.dcn_stream_bw, hw.net_latency


class SSDTransport(Transport):
    """Host memory <-> local NVMe (the tier-2 spill and promotion of the KV
    hierarchy)."""
    kind = "ssd"

    @staticmethod
    def _link(hw: HardwareModel):
        return hw.ssd_bw, hw.transfer_latency
