from repro_torch.core.dejavulib import faults
from repro_torch.core.dejavulib.buffers import HostMemoryStore
from repro_torch.core.dejavulib.faults import (FaultInjected, FaultInjector, FaultPlan,
                                               FaultSpec, FiredFault, StreamTaskError,
                                               assert_no_leaks)
from repro_torch.core.dejavulib.primitives import (CacheChunk, PipelineTopo, fetch, flush,
                                                   plan_repartition, scatter, stream_in,
                                                   stream_in_blocks, stream_out,
                                                   stream_out_blocks)
from repro_torch.core.dejavulib.streamer import StreamEngine
from repro_torch.core.dejavulib.transport import (DEFAULT_HW, HardwareModel,
                                                  HostLinkTransport, LocalTransport,
                                                  NetworkTransport, Transport)

__all__ = ["DEFAULT_HW", "HardwareModel", "HostMemoryStore", "CacheChunk", "PipelineTopo",
           "fetch", "flush", "plan_repartition", "scatter", "stream_in", "stream_out",
           "stream_in_blocks", "stream_out_blocks", "HostLinkTransport", "LocalTransport",
           "NetworkTransport", "Transport", "StreamEngine", "faults", "FaultInjected",
           "FaultInjector", "FaultPlan", "FaultSpec", "FiredFault", "StreamTaskError",
           "assert_no_leaks"]
