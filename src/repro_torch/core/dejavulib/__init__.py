from repro_torch.core.dejavulib.buffers import HostMemoryStore
from repro_torch.core.dejavulib.primitives import (CacheChunk, PipelineTopo, fetch, flush,
                                                   plan_repartition, scatter, stream_in,
                                                   stream_out)
from repro_torch.core.dejavulib.transport import (HostLinkTransport, LocalTransport,
                                                  NetworkTransport, Transport)

__all__ = ["HostMemoryStore", "CacheChunk", "PipelineTopo", "fetch", "flush",
           "plan_repartition", "scatter", "stream_in", "stream_out", "HostLinkTransport",
           "LocalTransport", "NetworkTransport", "Transport"]
