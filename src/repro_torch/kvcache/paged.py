"""Paged KV cache: the block pool (control plane) and the device pages
(data plane) of one pipeline stage.

`BlockPool` is a copy of the reference's pure-Python allocator
(`repro.kvcache.paged`): ref-counted fixed-size blocks, per-sequence block
tables, prefix sharing by hash chain, copy-on-write and defragmentation.
`PagedKVCache` keeps the pages as device tensors ``[N, Lstage, bs, Hkv, D]``;
gathering a batch of sequences to the dense stage-cache layout is one device
gather through their block tables.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch


class PoolExhausted(MemoryError):
    """No free block to satisfy an alloc/append — callers preempt or queue."""


@dataclass
class Block:
    bid: int
    ref: int = 0
    # content hash (prefix chain) — only set for FULL immutable prompt blocks
    hash: Optional[int] = None


def blocks_for(num_tokens: int, block_size: int) -> int:
    """Blocks needed to hold `num_tokens` token slots."""
    return -(-max(num_tokens, 0) // block_size)


class BlockPool:
    """Ref-counted fixed-size block allocator with per-sequence block tables.

    Invariants (property-tested in tests/test_paged_kv.py):
      * a block id is on the free list XOR referenced by >= 1 table;
      * sum of table multiplicities of a block == its ref count;
      * after all sequences are freed, every block is free again.
    """

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.blocks = [Block(i) for i in range(num_blocks)]
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))  # pop() -> lowest id
        self.tables: Dict[int, List[int]] = {}       # seq -> block ids (logical order)
        self.seq_lens: Dict[int, int] = {}           # seq -> live token count
        self._hash_index: Dict[int, int] = {}        # prefix hash -> bid
        self.peak_used_blocks = 0

    # --- accounting ----------------------------------------------------
    def num_free(self) -> int:
        return len(self._free)

    def num_used(self) -> int:
        return self.num_blocks - len(self._free)

    def can_allocate(self, num_tokens: int) -> bool:
        return blocks_for(num_tokens, self.block_size) <= self.num_free()

    def _track_peak(self) -> None:
        self.peak_used_blocks = max(self.peak_used_blocks, self.num_used())

    # --- alloc / append / free -----------------------------------------
    def append_needs_block(self, seq: int) -> bool:
        """Would `append(seq, 1)` consume a free block?  (New block at a
        block boundary, or copy-on-write off a shared tail block.)"""
        cur = self.seq_lens[seq]
        table = self.tables[seq]
        if cur % self.block_size == 0 or not table:
            return True
        return self.blocks[table[-1]].ref > 1

    def _take_block(self) -> int:
        if not self._free:
            raise PoolExhausted("block pool exhausted")
        bid = self._free.pop()
        blk = self.blocks[bid]
        assert blk.ref == 0
        blk.ref = 1
        blk.hash = None
        return bid

    def _drop_ref(self, bid: int) -> None:
        blk = self.blocks[bid]
        blk.ref -= 1
        assert blk.ref >= 0
        if blk.ref == 0:
            if blk.hash is not None:
                self._hash_index.pop(blk.hash, None)
            blk.hash = None
            self._free.append(bid)

    @staticmethod
    def chain_hashes(token_ids: Sequence[int], block_size: int) -> List[int]:
        """Prefix hash chain over the FULL blocks of a token sequence."""
        hashes, prev = [], 0
        n_full = len(token_ids) // block_size
        for j in range(n_full):
            chunk = tuple(int(t) for t in token_ids[j * block_size:(j + 1) * block_size])
            prev = hash((prev, chunk))
            hashes.append(prev)
        return hashes

    def allocate(self, seq: int, num_tokens: int,
                 token_ids: Optional[Sequence[int]] = None,
                 hashes: Optional[Sequence[int]] = None,
                 publish: bool = True) -> Tuple[List[int], List[int]]:
        """Allocate a table for `seq` holding `num_tokens` live tokens.

        With `token_ids` (the prompt) — or a precomputed prefix-hash chain
        `hashes` (recovery/restore, where the prompt is no longer at hand) —
        full blocks whose prefix hash matches a live block are SHARED (ref++)
        instead of newly allocated.  Returns ``(table, fresh)`` where `fresh`
        lists the logical block indices the caller must actually write
        (shared ones already hold the data).

        ``publish=False`` still SHARES matching live blocks but does not
        publish the fresh blocks' hashes: chunked prefill writes pages over
        several passes, so it publishes each block via `publish_hashes` only
        once the pages actually hold the data — a concurrent allocate/adopt
        must never share unwritten pages.
        """
        assert seq not in self.tables, f"seq {seq} already allocated"
        n = blocks_for(num_tokens, self.block_size)
        if hashes is None:
            hashes = (self.chain_hashes(token_ids, self.block_size)
                      if token_ids is not None else [])
        else:
            hashes = list(hashes)
        # pre-flight so a mid-allocation PoolExhausted can't leak blocks
        need = sum(1 for j in range(n)
                   if not (j < len(hashes) and hashes[j] in self._hash_index))
        if need > self.num_free():
            raise PoolExhausted(
                f"need {need} blocks for seq {seq}, {self.num_free()} free")
        table: List[int] = []
        fresh: List[int] = []
        for j in range(n):
            h = hashes[j] if j < len(hashes) else None
            if h is not None and h in self._hash_index:
                bid = self._hash_index[h]
                self.blocks[bid].ref += 1
                table.append(bid)
                continue
            bid = self._take_block()
            if h is not None and publish:
                self.blocks[bid].hash = h
                self._hash_index[h] = bid
            table.append(bid)
            fresh.append(j)
        self.tables[seq] = table
        self.seq_lens[seq] = num_tokens
        self._track_peak()
        return table, fresh

    def publish_hashes(self, seq: int, hashes: Sequence[int]) -> int:
        """Publish prefix-chain hashes for the LEADING blocks of `seq` (one
        hash per logical block, starting at block 0).  Chunked prefill calls
        this as each block's pages complete, pairing with
        ``allocate(..., publish=False)``.  Blocks already hashed (shared) and
        hashes already in the index are skipped.  Returns #published."""
        table = self.tables[seq]
        n = 0
        for j, h in enumerate(hashes):
            if j >= len(table):
                break
            blk = self.blocks[table[j]]
            if blk.hash is None and h not in self._hash_index:
                blk.hash = h
                self._hash_index[h] = table[j]
                n += 1
        return n

    def has_hash(self, h: int) -> bool:
        """Is a live block holding this prefix-chain hash resident (tier 0)?"""
        return h in self._hash_index

    def adopt_prefix(self, seq: int, hashes: Sequence[int],
                     num_tokens: int) -> Tuple[List[int], List[Tuple[int, int]]]:
        """Build `seq`'s table from an already-materialised prefix chain
        (cross-request reuse: the bytes come from a co-resident shared block
        or are promoted out of a lower tier by `KVTierManager`).

        Each hash either refs the live block holding it or takes a fresh
        block and publishes the hash.  Returns ``(table, fills)`` where
        `fills` lists ``(hash, bid)`` pairs whose pages the caller must
        install.  Raises PoolExhausted BEFORE any mutation."""
        assert seq not in self.tables, f"seq {seq} already allocated"
        assert num_tokens <= len(hashes) * self.block_size
        need = sum(1 for h in hashes if h not in self._hash_index)
        if need > self.num_free():
            raise PoolExhausted(
                f"need {need} blocks to adopt prefix for seq {seq}, "
                f"{self.num_free()} free")
        table: List[int] = []
        fills: List[Tuple[int, int]] = []
        for h in hashes:
            bid = self._hash_index.get(h)
            if bid is None:
                bid = self._take_block()
                self.blocks[bid].hash = h
                self._hash_index[h] = bid
                fills.append((h, bid))
            else:
                self.blocks[bid].ref += 1
            table.append(bid)
        self.tables[seq] = table
        self.seq_lens[seq] = num_tokens
        self._track_peak()
        return table, fills

    def append(self, seq: int, n: int = 1) -> List[Tuple[int, int]]:
        """Grow `seq` by `n` token slots.  Returns copy-on-write directives
        ``[(old_bid, new_bid), ...]`` — the caller must copy page contents of
        `old_bid` into `new_bid` (a shared last block diverges on write)."""
        table = self.tables[seq]
        cur = self.seq_lens[seq]
        # pre-flight (atomicity): new blocks at boundary crossings + at most
        # one copy-on-write when the first slot lands inside a shared block
        need = blocks_for(cur + n, self.block_size) - len(table)
        if table and cur % self.block_size != 0 and \
                self.blocks[table[-1]].ref > 1:
            need += 1
        if need > self.num_free():
            raise PoolExhausted(
                f"need {need} blocks to append to seq {seq}, "
                f"{self.num_free()} free")
        cow: List[Tuple[int, int]] = []
        for _ in range(n):
            if cur % self.block_size == 0 or not table:
                table.append(self._take_block())
            else:
                last = self.blocks[table[-1]]
                if last.ref > 1:                       # diverging from a shared block
                    new_bid = self._take_block()
                    cow.append((table[-1], new_bid))
                    self._drop_ref(table[-1])
                    table[-1] = new_bid
                elif last.hash is not None:
                    # uniquely owned but published for sharing: unpublish, the
                    # block is about to be mutated past the hashed prefix
                    self._hash_index.pop(last.hash, None)
                    last.hash = None
            cur += 1
        self.seq_lens[seq] = cur
        self._track_peak()
        return cow

    def truncate(self, seq: int, num_tokens: int) -> List[int]:
        """Roll `seq` back to `num_tokens` live tokens (failure-recovery
        rollback), freeing now-empty tail blocks.  Returns freed bids."""
        table = self.tables[seq]
        keep = blocks_for(max(num_tokens, 1), self.block_size)
        freed = []
        while len(table) > keep:
            bid = table.pop()
            self._drop_ref(bid)
            freed.append(bid)
        self.seq_lens[seq] = num_tokens
        return freed

    def free_seq(self, seq: int) -> None:
        for bid in self.tables.pop(seq):
            self._drop_ref(bid)
        del self.seq_lens[seq]

    def block_span(self, seq: int) -> Iterator[Tuple[int, int, int, int]]:
        """Yield ``(logical_idx, bid, t0, t1)`` for every live block of `seq`
        (t0/t1 = global token range covered; t1 clipped to the live length)."""
        n = self.seq_lens[seq]
        for j, bid in enumerate(self.tables[seq]):
            t0 = j * self.block_size
            t1 = min(t0 + self.block_size, n)
            if t1 <= t0:
                return
            yield j, bid, t0, t1

    # --- defragmentation ------------------------------------------------
    def defrag(self) -> Dict[int, int]:
        """Compact live blocks onto the lowest ids (so a pool shrink / a
        contiguous DMA window is possible).  Returns {old_bid: new_bid};
        the data plane must apply the same moves to its pages."""
        live = sorted({bid for t in self.tables.values() for bid in t})
        moves: Dict[int, int] = {}
        target = 0
        for bid in live:
            if bid != target:
                moves[bid] = target
                src, dst = self.blocks[bid], self.blocks[target]
                dst.ref, dst.hash = src.ref, src.hash
                src.ref, src.hash = 0, None
                if dst.hash is not None:
                    self._hash_index[dst.hash] = target
            target += 1
        if moves:
            for table in self.tables.values():
                for i, bid in enumerate(table):
                    table[i] = moves.get(bid, bid)
            self._free = list(range(self.num_blocks - 1, target - 1, -1))
        return moves


@dataclass
class PagedKVCache:
    """Data plane for one pipeline stage: pages ``[N, Lstage, bs, Hkv, Dh]``
    as device tensors, plus the gather (blocks -> dense stage cache) and
    scatter (dense window -> blocks) between them and the stage functions."""
    pool: BlockPool
    layers: int
    num_kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")
    k: torch.Tensor = field(init=False)
    v: torch.Tensor = field(init=False)

    def __post_init__(self):
        shape = (self.pool.num_blocks, self.layers, self.pool.block_size,
                 self.num_kv_heads, self.head_dim)
        self.k = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=self.dtype, device=self.device)

    @property
    def block_bytes(self) -> int:
        return 2 * self.layers * self.pool.block_size * self.num_kv_heads \
            * self.head_dim * self.k.element_size()

    def used_bytes(self) -> int:
        return self.pool.num_used() * self.block_bytes

    # --- dense <-> paged ------------------------------------------------
    def write_window(self, seq: int, kv: Dict[str, torch.Tensor], t0: int) -> List[int]:
        """Scatter a dense window ``[Lstage, W, H, D]`` (tokens t0..t0+W) of
        `seq` into its pages, clipped to the sequence's live tokens: one
        indexed copy per leaf.  Returns the bids touched (the streaming
        delta), in block order."""
        bs = self.pool.block_size
        table = self.pool.tables[seq]
        w = next(iter(kv.values())).shape[1]
        lo, hi = max(t0, 0), min(t0 + w, self.pool.seq_lens[seq], len(table) * bs)
        if lo >= hi:
            return []
        toks = range(lo, hi)
        bids = torch.tensor([table[t // bs] for t in toks], device=self.device)
        offs = torch.tensor([t % bs for t in toks], device=self.device)
        for leaf, win in kv.items():
            pages = self.k if leaf == "k" else self.v
            pages[bids, :, offs] = win[:, lo - t0:hi - t0].transpose(0, 1).to(pages.dtype)
        return [table[j] for j in range(lo // bs, (hi - 1) // bs + 1)]

    # --- reading the pages in place --------------------------------------
    def block_tables(self, seqs: Sequence[int]) -> torch.Tensor:
        """The block tables of `seqs` as one int32 [B, nb] device tensor, nb
        the longest table, shorter rows padded with page 0 (the paged kernels
        never read an entry past a sequence's length): one host-to-device
        copy."""
        tables = [self.pool.tables[s] for s in seqs]
        nb = max(len(t) for t in tables)
        return torch.tensor([t + [0] * (nb - len(t)) for t in tables], dtype=torch.int32,
                            device=self.device)

    def write_indices(self, seqs: Sequence[int], starts: Sequence[int],
                      lens: Sequence[int], width: int) -> torch.Tensor:
        """Where a pass's new K/V rows go: int64 [3, n] holding, for each
        token t in [starts[i], starts[i] + lens[i]) of sequence seqs[i] in
        that order, its page, its slot in the page, and its row
        i * width + t - starts[i] among the pass's [B * width] rows (padding
        rows past lens[i] are never written): one host-to-device copy."""
        bs = self.pool.block_size
        pages, slots, rows = [], [], []
        for i, (seq, t0, n) in enumerate(zip(seqs, starts, lens)):
            table = self.pool.tables[seq]
            for t in range(t0, t0 + n):
                pages.append(table[t // bs])
                slots.append(t % bs)
                rows.append(i * width + t - t0)
        return torch.tensor([pages, slots, rows], dtype=torch.int64, device=self.device)

    def gather_dense(self, seqs, pad_to: int) -> Dict[str, torch.Tensor]:
        """Assemble the live tokens of `seqs` (one id or a list) into a dense
        ``[Lstage, B, pad_to, H, D]`` cache, the layout the stage functions
        take: one gather through the block tables per leaf, slots past each
        sequence's live length zeroed."""
        seqs = [seqs] if isinstance(seqs, int) else list(seqs)
        bs = self.pool.block_size
        nb = max(blocks_for(pad_to, bs), 1)
        tables = [self.pool.tables[s][:nb] for s in seqs]
        tab = torch.tensor([t + [0] * (nb - len(t)) for t in tables], device=self.device)
        live = torch.tensor([self.pool.seq_lens[s] for s in seqs], device=self.device)
        dead = torch.arange(pad_to, device=self.device)[None, :] >= live[:, None]
        out = {}
        for leaf, pages in (("k", self.k), ("v", self.v)):
            dense = pages.permute(1, 0, 2, 3, 4)[:, tab]          # [L,B,nb,bs,H,D]
            dense = dense.reshape(self.layers, len(seqs), nb * bs, self.num_kv_heads,
                                  self.head_dim)[:, :, :pad_to].contiguous()
            out[leaf] = dense.masked_fill_(dead[None, :, :, None, None], 0)
        return out

    def copy_block(self, src_bid: int, dst_bid: int) -> None:
        """Apply a copy-on-write or defrag move to the pages."""
        self.k[dst_bid] = self.k[src_bid]
        self.v[dst_bid] = self.v[src_bid]

    def apply_cow(self, cow: Sequence[Tuple[int, int]]) -> None:
        for old, new in cow:
            self.copy_block(old, new)

    def apply_defrag(self, moves: Dict[int, int]) -> None:
        """Apply `BlockPool.defrag`'s {old: new} moves to the pages, lowest
        destination first (each lies below its source, so no move
        overwrites a block still to be moved)."""
        for old, new in sorted(moves.items(), key=lambda kv: kv[1]):
            self.copy_block(old, new)

    def block_arrays(self, bid: int, width: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
        """One block's pages (optionally only the first `width` token
        slots), copied: the unit that swap-out moves to host memory."""
        w = self.pool.block_size if width is None else width
        return {"k": self.k[bid, :, :w].clone(), "v": self.v[bid, :, :w].clone()}

    def install_block(self, bid: int, arrays: Dict[str, torch.Tensor]) -> None:
        for leaf, arr in arrays.items():
            pages = self.k if leaf == "k" else self.v
            pages[bid, :, :arr.shape[1]].copy_(arr)
