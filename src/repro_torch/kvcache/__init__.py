from repro_torch.kvcache.paged import BlockPool, PagedKVCache, PoolExhausted, blocks_for

__all__ = ["BlockPool", "PagedKVCache", "PoolExhausted", "blocks_for"]
