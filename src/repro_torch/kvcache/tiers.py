"""The KV hierarchy of the port: HBM block pool -> host memory -> SSD (the
counterpart of `repro.kvcache.tiers`).

`KVTierManager` puts one stage's paged pool (tier 0, the device pages)
behind one block-granular API with a `HostMemoryStore` (tier 1, pinned host
memory on a card) and an `SSDStore` (tier 2, local disk):

  demotion   a cold block moves down as a write-behind task on the shared
             `StreamEngine`: the block is packed on the device, on the
             compute stream, and copied to the host on the streamer's side
             stream behind an event, so the copy overlaps the next passes;
  promotion  a needed block moves up on demand, straight into the pages'
             device; the rest of its chain is charged as prefetched behind
             the first fetch, so only the head is an exposed stall;
  prefix     full prompt blocks are indexed by their prefix-chain hash
             (`BlockPool.chain_hashes`) when their sequence retires, so a new
             request whose prompt shares the prefix takes those blocks from
             whatever tier holds them instead of prefilling them again.

Two kinds of entry live in the hierarchy:

  ``pfx/<hash>``            immutable full prompt blocks, keyed by content:
                            prefill can make them again, so they may be
                            dropped under tier-2 pressure (LRU);
  ``tswap/seq<i>/blk<j>``   a preempted or swapped sequence's live blocks:
                            possibly the only copy, so they spill to SSD but
                            are never dropped (over-commit is counted).

A block's bytes are packed as one ``[2, Lstage, w, Hkv, Dh]`` tensor (K
stacked on V), so every store holds one object per block and a spill never
tears a block across tiers.  All bookkeeping (index, LRU order, eviction
planning) happens on the caller's thread; only the data movement runs on the
streamer, and every read path drains the streamer and waits for its side
stream first, so a read sees every completed write.  Capacities are counted
in blocks; the host store's byte capacity is only a backstop that raises.

Tier 2 survives a worker's death (it is disk): `reattach()` rebuilds the
index from the self-describing keys, and failure recovery restores from the
lowest tier that holds a sequence (`DejaVuCluster._recover_worker_paged`).

Every counter of `stats()` is mirrored into the telemetry registry as
``tier.<name>`` (an event count) or ``tier.<name>_ns`` (modeled seconds as
integer ns); with a tracer installed, demotion, promotion and adoption
record ``tier.demote``, ``tier.promote`` and ``tier.adopt``.  The
``tier.demote`` and ``tier.promote`` injection points fire on the caller's
thread, ``ssd.put`` inside each disk write (`faults`).
"""
from __future__ import annotations

import tempfile
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core import telemetry, tracing
from repro_torch.core.dejavulib import faults
from repro_torch.core.dejavulib.buffers import HostMemoryStore, SSDStore
from repro_torch.core.dejavulib.faults import WorkerDead
from repro_torch.core.dejavulib.streamer import StreamEngine
from repro_torch.core.dejavulib.transport import (DEFAULT_HW, HardwareModel,
                                                  HostLinkTransport, SSDTransport)
from repro_torch.kvcache.paged import BlockPool, PagedKVCache

TIER_HBM, TIER_HOST, TIER_SSD = 0, 1, 2


@dataclass(frozen=True)
class TierConfig:
    """Per-stage capacities of the off-device tiers, in KV blocks."""
    host_capacity_blocks: Optional[int] = None   # None = unbounded
    ssd_capacity_blocks: Optional[int] = None    # None = unbounded
    ssd_root: Optional[str] = None               # None = a private temp dir


@dataclass
class _Entry:
    key: str            # store key (the same string in every tier)
    kind: str           # "pfx" | "swap"
    tier: int           # the fastest off-device tier holding the bytes
    on_ssd: bool        # a (possibly additional) copy exists on disk
    nbytes: int
    seq: int = -1       # swap entries only
    j: int = -1         # swap entries only


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class KVTierManager:
    """Block-granular movement between one stage's device pool and its host
    and SSD tiers.  One per `StageWorker` (each stage caches its own layer
    slice of every block, keyed by the same prefix hash)."""

    def __init__(self, pool: BlockPool, pages: PagedKVCache, streamer: StreamEngine,
                 hw: HardwareModel = DEFAULT_HW, cfg: TierConfig = TierConfig(),
                 name: str = "tier"):
        self.pool = pool
        self.pages = pages
        self.streamer = streamer
        self.cfg = cfg
        self.name = name
        self.device = pages.k.device
        self.dtype = pages.k.dtype
        cap = (None if cfg.host_capacity_blocks is None
               else cfg.host_capacity_blocks * pages.block_bytes)
        # the manager plans placement in whole blocks, so a raise here means
        # its accounting is wrong: fail loud
        self.host = HostMemoryStore(f"{name}-tier1", capacity_bytes=cap)
        root = cfg.ssd_root or tempfile.mkdtemp(prefix=f"dejavu-{name}-ssd-")
        self.ssd = SSDStore(root, name=f"{name}-tier2")
        self.hostlink = HostLinkTransport(hw)
        self.ssdlink = SSDTransport(hw)
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()   # LRU order
        self._stats: Dict[str, float] = {}
        self._pending: List[object] = []    # in-flight streamer tasks
        self._pinned: set = set()           # keys a read in progress protects

    # ------------------------------------------------------------------
    # bookkeeping (caller thread only)
    # ------------------------------------------------------------------
    def _bump(self, key: str, v: float = 1) -> None:
        self._stats[key] = self._stats.get(key, 0) + v
        # time-valued keys accumulate integer ns, event keys integer counts
        if key.endswith("_s"):
            telemetry.count_time(f"tier.{key[:-2]}_ns", v)
        else:
            telemetry.count(f"tier.{key}", int(v))

    def _fault_point(self, point: str, tag: str) -> None:
        """Fire a tier injection point; a `delay` charges straggler time to
        the tier's modeled timeline (raising kinds propagate)."""
        spec = faults.fire(point, tag=tag)
        if spec is not None and spec.kind == "delay":
            self._bump("fault_delay_model_s", spec.delay_s)

    def _submit(self, fn, model_seconds: float = 0.0, tag: str = "") -> None:
        self._pending.append(self.streamer.submit(fn, model_seconds=model_seconds, tag=tag))
        if len(self._pending) > 64:     # bound the list (and the tensors its
            self._reap()                # closures hold) between reads

    def _reap(self) -> None:
        """Drop completed tasks, raising the first error any of them hit: a
        failed demotion must not strand an entry whose bytes never landed."""
        live, err = [], None
        for task in self._pending:
            if not task.done.is_set():
                live.append(task)
            elif task.error is not None and err is None:
                err = task
        self._pending = live
        if err is not None:
            raise RuntimeError(f"tier write-behind {err.tag!r} failed") from err.error

    def _sync(self) -> None:
        """The barrier before any read: wait for the write-behinds in
        flight and their copies on the side stream, and raise their
        errors."""
        try:
            self.streamer.drain()
        except faults.StreamTaskError:
            # our own write-behind failed: _reap raises it with the tier's
            # context (which key, which task)
            self._reap()
            raise      # not ours (a replication send): as it is
        self._reap()
        self.streamer.sync_copies()

    def _touch(self, key: str) -> None:
        self._entries.move_to_end(key)

    def _host_blocks(self) -> int:
        return sum(1 for e in self._entries.values() if e.tier == TIER_HOST)

    def _ssd_blocks(self) -> int:
        return sum(1 for e in self._entries.values() if e.on_ssd)

    @staticmethod
    def _pack(arrays: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.stack([arrays["k"], arrays["v"]])

    @staticmethod
    def _unpack(arr: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"k": arr[0], "v": arr[1]}

    def _pinned_copy(self, t: torch.Tensor) -> torch.Tensor:
        """`t` in pinned memory where the pages live on a card (the host
        tier's copies go up without staging)."""
        return t.pin_memory() if self.device.type == "cuda" else t

    # ------------------------------------------------------------------
    # placement planning and write-behind data movement
    # ------------------------------------------------------------------
    def _make_host_room(self, entry: _Entry) -> bool:
        """Spill LRU host entries to SSD until `entry` fits in tier 1.
        False when no room can be made (capacity 0, or every resident entry
        is pinned by a read in progress)."""
        cap = self.cfg.host_capacity_blocks
        if cap is not None and cap <= 0:
            return False
        need = 0 if entry.tier == TIER_HOST else 1
        while cap is not None and self._host_blocks() + need > cap:
            victim = next((e for e in self._entries.values()
                           if e.tier == TIER_HOST and e is not entry
                           and e.key not in self._pinned), None)
            if victim is None:
                return False
            self._spill_to_ssd(victim)
        return True

    def _admit_host(self, entry: _Entry, packed: torch.Tensor) -> None:
        """Place `entry`'s bytes in tier 1, or straight in tier 2 when no
        host room can be made; the copy is a write-behind."""
        self._fault_point("tier.demote", entry.key)
        if tracing.active():
            tracing.event("tier.demote", key=entry.key, blocks=1, dst="host")
        if not self._make_host_room(entry):
            self._admit_ssd(entry, packed)
            return
        entry.tier = TIER_HOST
        key, link = entry.key, self.hostlink
        ev = self.streamer.hand_off([packed])

        def _put():
            if ev is not None:
                ev.wait()                # the side stream waits for the pack
            # to pinned memory, queued on the side stream: readers wait for
            # it through `_sync` (and a spill through `sync_copies`)
            self.host.put(key, link.transfer(packed, tag=key, non_blocking=True))

        t = link.model_time(_nbytes(packed))
        self._bump("write_behind_model_s", t)
        self._submit(_put, model_seconds=t, tag=f"tier-demote-{key}")

    def _admit_ssd(self, entry: _Entry, packed: torch.Tensor) -> None:
        self._make_ssd_room(exclude=entry)
        entry.tier, entry.on_ssd = TIER_SSD, True
        key, link = entry.key, self.ssdlink
        ev = self.streamer.hand_off([packed])

        def _put():
            if ev is not None:
                ev.wait()
            self.ssd.put(key, link.transfer(packed, tag=key))

        t = link.model_time(_nbytes(packed))
        self._bump("write_behind_model_s", t)
        self._submit(_put, model_seconds=t, tag=f"tier-demote2-{key}")

    def _spill_to_ssd(self, entry: _Entry) -> None:
        """Demote one host-resident entry to tier 2 (write-behind)."""
        key = entry.key
        self._fault_point("tier.demote", f"spill-{key}")
        if tracing.active():
            tracing.event("tier.demote", key=key, blocks=1, dst="ssd")
        self._bump("spills")
        if entry.on_ssd:                    # the disk already holds a copy
            entry.tier = TIER_SSD
            self._submit(lambda: self.host.delete(key), tag=f"tier-drop1-{key}")
            return
        self._make_ssd_room(exclude=entry)
        entry.tier, entry.on_ssd = TIER_SSD, True
        link = self.ssdlink

        def _spill():
            # idempotent (a transient SSD-write fault runs the closure
            # again): the host copy stays until the disk write is durable
            self.streamer.sync_copies()     # its copy to the host has landed
            arr = self.host.get(key)        # FIFO: the host put already ran
            self.ssd.put(key, link.transfer(arr, tag=key))
            self.host.delete(key)

        t = link.model_time(entry.nbytes)
        self._bump("write_behind_model_s", t)
        self._submit(_spill, model_seconds=t, tag=f"tier-spill-{key}")

    def _make_ssd_room(self, exclude: Optional[_Entry] = None) -> None:
        cap = self.cfg.ssd_capacity_blocks
        while cap is not None and self._ssd_blocks() >= cap:
            # only prefix blocks may go (prefill can make them again; a swap
            # block may be the only copy of live state).  The newest goes
            # first: chains are demoted head first, so evicting from the MRU
            # end gives up chain tails, where dropping a head would strand
            # its whole chain (adoption needs a leading run)
            victim = next((e for e in reversed(self._entries.values())
                           if e.on_ssd and e.kind == "pfx" and e is not exclude
                           and e.key not in self._pinned), None)
            if victim is None:
                self._bump("ssd_overcommit")
                return
            if victim.tier == TIER_HOST:
                # the host still serves it: retiring the disk copy frees the
                # SSD slot without evicting a hot block from every tier
                victim.on_ssd = False
                self._submit(lambda k=victim.key: self.ssd.delete(k),
                             tag=f"tier-unpersist-{victim.key}")
                self._bump("ssd_copy_retired")
            else:
                self._drop(victim)

    def _drop(self, entry: _Entry, evicted: bool = True) -> None:
        self._entries.pop(entry.key, None)
        key, on_host, on_ssd = entry.key, entry.tier == TIER_HOST, entry.on_ssd
        if evicted:
            self._bump("dropped")

        def _rm():
            if on_host:
                self.host.delete(key)
            if on_ssd:
                self.ssd.delete(key)

        self._submit(_rm, tag=f"tier-evict-{key}")

    def _read(self, entry: _Entry) -> torch.Tensor:
        """Synchronous up-tier read of one entry (the caller synced first):
        its bytes on the pages' device, the copy queued on the caller's
        stream.  Refreshes the LRU order and the tier state."""
        key = entry.key
        self._fault_point("tier.promote", key)
        if tracing.active():
            tracing.event("tier.promote", key=key,
                          src="host" if entry.tier == TIER_HOST else "ssd")
        if entry.tier == TIER_HOST:
            try:
                host = self.host.get(key)
            except KeyError as e:
                # the worker died mid-read and its host tier was wiped: the
                # recoverable error class
                raise WorkerDead(f"tier {self.name!r}: host entry {key!r} lost mid-read") from e
            arr = self.hostlink.transfer(host, device=self.device, tag=key,
                                         non_blocking=True)
            self._bump("host_hits")
            self._touch(key)
            return arr
        # a promotion earlier in this chain may have queued a spill whose
        # disk write has not landed yet: wait for the queue
        self._sync()
        try:
            host = self.ssdlink.transfer(self.ssd.get(key, dtype=self.dtype), tag=key)
        except FileNotFoundError as e:
            raise WorkerDead(f"tier {self.name!r}: SSD entry {key!r} lost mid-read") from e
        arr = self.hostlink.transfer(host, device=self.device, tag=key,
                                     non_blocking=True)       # SSD -> host -> HBM
        self._bump("ssd_hits")
        entry.nbytes = _nbytes(arr)
        self._promote_to_host(entry, host)
        self._touch(key)
        return arr

    def _model_fetch_time(self, entry: _Entry) -> float:
        t = self.hostlink.model_time(entry.nbytes)
        if entry.tier == TIER_SSD:
            t += self.ssdlink.model_time(entry.nbytes)
        return t

    def _promote_to_host(self, entry: _Entry, host: torch.Tensor) -> None:
        """A tier-2 hit earns the block a tier-1 slot (the SSD copy stays:
        free persistence for the next failure).  It stays SSD-only when no
        host room can be made."""
        if not self._make_host_room(entry):
            return
        entry.tier = TIER_HOST
        key = entry.key
        self._submit(lambda: self.host.put(key, self._pinned_copy(host)),
                     tag=f"tier-promote-{key}")

    # ------------------------------------------------------------------
    # prefix cache (cross-request reuse)
    # ------------------------------------------------------------------
    @staticmethod
    def prefix_key(h: int) -> str:
        return f"pfx/{h}"

    def has_prefix(self, h: int) -> bool:
        return self.prefix_key(h) in self._entries

    def prefix_chain_len(self, hashes: Sequence[int]) -> int:
        """Longest leading run of `hashes` the hierarchy holds."""
        n = 0
        for h in hashes:
            if not self.has_prefix(h):
                break
            n += 1
        return n

    def cache_prefix_block(self, h: int, arrays: Dict[str, torch.Tensor]) -> bool:
        """Write-behind demotion of one full prompt block keyed by its chain
        hash (when its sequence retires).  Dedups by content."""
        key = self.prefix_key(h)
        if key in self._entries:
            self._touch(key)
            return False
        packed = self._pack(arrays)
        entry = _Entry(key, "pfx", -1, False, _nbytes(packed))   # tier set by admit
        self._entries[key] = entry
        self._bump("demotions")
        self._admit_host(entry, packed)
        return True

    def fetch_prefix_chain(self, hashes: Sequence[int]) -> Dict[int, Dict[str, torch.Tensor]]:
        """Promote a chain of prefix blocks for installation into the pool,
        on the pages' device.  The first block's fetch is an exposed stall;
        the rest of the chain is charged as prefetched behind it (modeled
        accounting)."""
        if not hashes:
            return {}
        if tracing.active():
            # the chain's identity: head hash and length
            tracing.event("tier.adopt", chain=f"{hashes[0]:x}", blocks=len(hashes))
        self._sync()
        keys = [self.prefix_key(h) for h in hashes]
        self._pinned.update(keys)        # mid-chain evictions must skip these
        try:
            out: Dict[int, Dict[str, torch.Tensor]] = {}
            for i, h in enumerate(hashes):
                entry = self._entries[self.prefix_key(h)]
                t = self._model_fetch_time(entry)
                self._bump("stall_model_s" if i == 0 else "prefetch_model_s", t)
                out[h] = self._unpack(self._read(entry))
                self._bump("prefix_promotions")
            return out
        finally:
            self._pinned.difference_update(keys)

    # ------------------------------------------------------------------
    # swap path (preemption and restore through the hierarchy)
    # ------------------------------------------------------------------
    @staticmethod
    def swap_key(seq: int, j: int) -> str:
        return f"tswap/seq{seq}/blk{j}"

    def _swap_entries(self, seq: int) -> List[_Entry]:
        return sorted((e for e in self._entries.values() if e.kind == "swap" and e.seq == seq),
                      key=lambda e: e.j)

    def swap_out_blocks(self, seq: int, blocks: Dict[int, Dict[str, torch.Tensor]]) -> None:
        """Offload the given (dirty) blocks of `seq` down-tier, write-behind.
        Offloading a block again refreshes whatever copies the tiers hold."""
        for j, arrays in sorted(blocks.items()):
            key = self.swap_key(seq, j)
            packed = self._pack(arrays)
            entry = self._entries.get(key)
            if entry is None:
                entry = _Entry(key, "swap", -1, False, _nbytes(packed), seq=seq, j=j)
                self._entries[key] = entry
            else:
                self._touch(key)
                if entry.on_ssd:            # a stale disk copy: retire it
                    self._submit(lambda k2=key: self.ssd.delete(k2), tag=f"tier-stale-{key}")
                    entry.on_ssd = False
            entry.nbytes = _nbytes(packed)
            self._bump("swap_out_blocks")
            self._admit_host(entry, packed)

    def swap_in_blocks(self, seq: int) -> Dict[int, Dict[str, torch.Tensor]]:
        """Every held block of `seq`, on the pages' device, for installation:
        the fastest tier holding each block serves it; blocks past the first
        are charged as prefetched.  Entries stay (a clean block need not be
        written again on the next offload)."""
        self._sync()
        entries = self._swap_entries(seq)
        keys = [e.key for e in entries]
        self._pinned.update(keys)
        try:
            out: Dict[int, Dict[str, torch.Tensor]] = {}
            for i, entry in enumerate(entries):
                t = self._model_fetch_time(entry)
                self._bump("stall_model_s" if i == 0 else "prefetch_model_s", t)
                out[entry.j] = self._unpack(self._read(entry))
                self._bump("swap_in_blocks")
            return out
        finally:
            self._pinned.difference_update(keys)

    def restore_swap_from_ssd(self, seq: int, keep: int
                              ) -> Optional[Dict[int, Dict[str, torch.Tensor]]]:
        """Failure recovery: `seq`'s first `keep` blocks from the persistent
        tier, or None if the disk does not hold the whole chain (the caller
        then takes the replication ring's)."""
        self._sync()
        present = {e.j: e for e in self._swap_entries(seq) if e.on_ssd}
        if any(j not in present for j in range(keep)):
            return None
        keys = [present[j].key for j in range(keep)]
        self._pinned.update(keys)
        try:
            out: Dict[int, Dict[str, torch.Tensor]] = {}
            for i in range(keep):
                entry = present[i]
                self._bump("stall_model_s" if i == 0 else "prefetch_model_s",
                           self._model_fetch_time(entry))
                out[i] = self._unpack(self._read(entry))
            self._bump("ssd_restores")
            return out
        finally:
            self._pinned.difference_update(keys)

    def drop_seq(self, seq: int) -> None:
        """Retire a finished sequence's swap entries from every tier."""
        for entry in self._swap_entries(seq):
            self._drop(entry, evicted=False)

    # ------------------------------------------------------------------
    # failure and recovery
    # ------------------------------------------------------------------
    def on_host_failure(self) -> None:
        """The worker died: tier 1 (its memory) dies with it, tier 2 is disk
        and survives.  An entry whose only copy was in host memory is lost.
        An ``on_ssd`` claim is trusted only if the bytes reached the disk: a
        spill whose write died with the worker leaves no entry pointing at
        nothing."""
        self.host.clear()
        self._pending.clear()            # the write-behinds in flight died too
        for key, entry in list(self._entries.items()):
            if entry.on_ssd and key in self.ssd:
                entry.tier = TIER_SSD
            else:
                del self._entries[key]
                self._bump("lost_with_host")

    def reattach(self) -> int:
        """Rebuild the index from the self-describing SSD keys (a fresh
        worker pointed at a dead one's disk).  Returns the entries
        recovered."""
        n = 0
        for key in self.ssd.keys():
            if key in self._entries:
                continue
            nbytes = self.ssd.size(key)    # restores are charged at their true cost
            if key.startswith("pfx/"):
                self._entries[key] = _Entry(key, "pfx", TIER_SSD, True, nbytes)
            elif key.startswith("tswap/seq"):
                seq_s, blk_s = key[len("tswap/seq"):].split("/blk")
                self._entries[key] = _Entry(key, "swap", TIER_SSD, True, nbytes,
                                            seq=int(seq_s), j=int(blk_s))
            else:
                continue
            n += 1
        self._bump("reattached", n)
        return n

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        out = dict(self._stats)
        out["host_blocks"] = self._host_blocks()
        out["ssd_blocks"] = self._ssd_blocks()
        out["prefix_entries"] = sum(1 for e in self._entries.values() if e.kind == "pfx")
        return out
