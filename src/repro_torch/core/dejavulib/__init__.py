from repro_torch.core.dejavulib.buffers import HostMemoryStore

__all__ = ["HostMemoryStore"]
