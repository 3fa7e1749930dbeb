from repro_torch.kvcache.paged import BlockPool, PagedKVCache, PoolExhausted, blocks_for
from repro_torch.kvcache.tiers import KVTierManager, TierConfig

__all__ = ["BlockPool", "PagedKVCache", "PoolExhausted", "blocks_for", "KVTierManager",
           "TierConfig"]
