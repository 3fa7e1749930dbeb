"""Pipeline-stage workers of the port (counterpart of `repro.core.worker`).

A `StageWorker` owns a contiguous layer slice of the model, its dense
microbatch KV slots (the run() path), its block pool and device pages (the
paged path), a host store (the swap target and the landing zone of the
prompt KV streamed from the prompt pipeline) and a replica store holding
its ring predecessor's KV copies (paper §4.2.3: worker x streams to worker
(x+1) % N).  Every byte between the device and the host moves through the
`CacheManager`'s transports.

Failure semantics (paper): killing a worker loses its device KV, its host
store and the replica it hosts; a dead worker's stage ops raise
`WorkerDead`.  The KV tiers of the reference are a later slice.

Each stage op counts ``worker.stage_calls{wid}`` and, with a tracer
installed, records a ``stage.<op>`` event on the worker's own track (the
reference's op names, on both routes of the fused passes); a kill counts
``worker.kills`` and records ``worker.kill``.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device, torch_dtype
from repro_torch.core import telemetry, tracing
from repro_torch.core.dejavulib import (HostLinkTransport, HostMemoryStore, LocalTransport,
                                        NetworkTransport, StreamEngine)
from repro_torch.core.dejavulib.transport import DEFAULT_HW, HardwareModel
from repro_torch.kernels import ops as kops
from repro_torch.kvcache.cache import init_decode_state
from repro_torch.kvcache.paged import BlockPool, PagedKVCache, PoolExhausted, blocks_for


class WorkerDead(RuntimeError):
    """A stage op reached a dead worker: the one error the serving engine
    recovers from.  Any other error, a failed kernel launch included,
    propagates."""


class CacheManager:
    """Per-worker KV movement: microbatch swapping (paper §4.2.2) over the
    host link, the paged path's block-granular swap, and ring replication
    over the network into the successor's replica store (§4.2.3).  The
    transports count their bytes and charge modeled time (`hw`); each
    replication task carries the modeled time of its bytes to the streamer.

    Replication runs on the cluster's `StreamEngine`: the window or block is
    produced on the compute stream, handed to the streamer's side stream
    behind an event, copied to host memory there, and acknowledged to the
    controller only once the copy has landed.  Replicas live in pageable
    host memory: the dense replica of a microbatch leaf is allocated once,
    at the full cache shape, and updated in place; a replica block is kept
    as it arrives.

    `compress_replicas=True` (beyond the paper) quantises each replicated
    window or block to int8 with one scale before it crosses the network
    and dequantises it into the peer's replica store."""

    def __init__(self, wid: int, streamer: StreamEngine, hw: HardwareModel = DEFAULT_HW,
                 token_block: int = 8, compress_replicas: bool = False):
        self.wid = wid
        self.host = HostMemoryStore(f"w{wid}-host")
        self.replica = HostMemoryStore(f"w{wid}-replica")   # the predecessor's KV
        self.hostlink = HostLinkTransport(hw)
        self.net = NetworkTransport(hw)
        self.local = LocalTransport(hw)
        self.streamer = streamer
        self.token_block = token_block
        self.compress_replicas = compress_replicas

    # --- swapping (microbatch granularity) -----------------------------
    def swap_out(self, mb: int, kv: Dict[str, torch.Tensor],
                 token_range: Optional[Tuple[int, int]] = None) -> None:
        """Offload a microbatch's stage KV to pinned host memory.  With
        `token_range`, only the newly written window moves: packed on the
        device by kv_pack, copied, and written into the host copy in place."""
        for leaf, arr in kv.items():
            key = f"swap/mb{mb}/{leaf}"
            if token_range is None:
                self.host.put(key, self.hostlink.transfer(arr, tag=key))
                continue
            t0, t1 = token_range
            tb = self.token_block
            t0a = (t0 // tb) * tb
            w = min(-(-(t1 - t0a) // tb) * tb, arr.shape[2] - t0a)
            packed = self.hostlink.transfer(kops.kv_pack_auto(arr, t0a, w, token_block=tb),
                                            tag=key)
            self.host.get(key)[:, :, t0a:t0a + w] = packed

    def swap_in(self, mb: int, device) -> Dict[str, torch.Tensor]:
        out = {}
        for leaf in ("k", "v"):
            key = f"swap/mb{mb}/{leaf}"
            out[leaf] = self.hostlink.transfer(self.host.get(key), device=device, tag=key)
        return out

    def host_has(self, mb: int) -> bool:
        return f"swap/mb{mb}/k" in self.host

    def swap_out_blocks(self, seq: int,
                        blocks: Dict[int, Dict[str, torch.Tensor]]) -> int:
        """Offload the given (dirty) blocks of `seq` to host memory."""
        nbytes = 0
        for j, arrays in blocks.items():
            for leaf, arr in arrays.items():
                key = f"pagedswap/seq{seq}/blk{j}/{leaf}"
                self.host.put(key, self.hostlink.transfer(arr, tag=key))
                nbytes += arr.numel() * arr.element_size()
        return nbytes

    def swap_in_blocks(self, seq: int, device) -> Dict[int, Dict[str, torch.Tensor]]:
        prefix = f"pagedswap/seq{seq}/blk"
        out: Dict[int, Dict[str, torch.Tensor]] = {}
        for key in self.host.keys():
            if key.startswith(prefix):
                j, leaf = key[len(prefix):].split("/")
                out.setdefault(int(j), {})[leaf] = self.hostlink.transfer(
                    self.host.get(key), device=device, tag=key)
        return out

    def drop_seq_swap(self, seq: int) -> None:
        for key in [k for k in self.host.keys() if k.startswith(f"pagedswap/seq{seq}/")]:
            self.host.delete(key)

    # --- replication (ring, paper §4.2.3) ---------------------------------
    def _hand_off(self, tensors: List[torch.Tensor]):
        """Make device tensors made on the compute stream safe for the
        streamer's side stream: an event recorded after them, which the
        task waits on, and each tensor marked as used by the side stream,
        so its memory is not reused before the copy has run."""
        side = self.streamer.stream
        if side is None or not tensors[0].is_cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        for t in tensors:
            t.record_stream(side)
        return ev

    def _model_seconds(self, tensors) -> float:
        """The modeled network time of replicating `tensors` (half the bytes
        with int8 replicas)."""
        raw = sum(t.numel() * t.element_size() for t in tensors)
        return self.net.model_time(raw // 2 if self.compress_replicas else raw)

    def _send(self, buf: torch.Tensor, key: str) -> torch.Tensor:
        """One replica copy over the network into the peer's pageable host
        memory, as the peer stores it."""
        if not self.compress_replicas:
            return self.net.transfer(buf, tag=key, pin=False)
        scale = max(float(buf.abs().max()), 1e-8) / 127.0
        q = torch.clamp(torch.round(buf.float() / scale), -127, 127).to(torch.int8)
        return (self.net.transfer(q, tag=key + "/int8", pin=False).float() * scale
                ).to(buf.dtype)

    def replicate_to(self, peer: "CacheManager", mb: int, kv: Dict[str, torch.Tensor],
                     token_range: Tuple[int, int], step: int, ack_cb) -> None:
        """Stream the KV window [t0, t1) of a microbatch to the ring
        successor's replica store: packed on the device by kv_pack (token
        block aligned), then sent on the streamer."""
        t0, t1 = token_range
        tb = self.token_block
        t0a = (t0 // tb) * tb
        packed = {}
        for leaf, arr in kv.items():
            w = min(-(-(t1 - t0a) // tb) * tb, arr.shape[2] - t0a)
            packed[leaf] = (kops.kv_pack_auto(arr, t0a, w, token_block=tb), arr.shape,
                            arr.dtype)
        ev = self._hand_off([b for b, _, _ in packed.values()])

        def send():
            if ev is not None:
                ev.wait()                    # the side stream waits for the pack
            for leaf, (buf, shape, dtype) in packed.items():
                key = f"w{self.wid}/mb{mb}/{leaf}"
                recv = self._send(buf, key)
                if key not in peer.replica:
                    peer.replica.put(key, torch.zeros(shape, dtype=dtype))
                peer.replica.get(key)[:, :, t0a:t0a + recv.shape[2]] = recv
            ack_cb(self.wid, mb, step)       # only once the copies have landed

        self.streamer.submit(send, model_seconds=self._model_seconds(
                                 [b for b, _, _ in packed.values()]),
                             tag=f"rep-w{self.wid}-mb{mb}-s{step}")

    def replicate_block_to(self, peer: "CacheManager", seq: int, j: int,
                           arrays: Dict[str, torch.Tensor], step: int, ack_cb) -> None:
        """Stream one live KV block of a sequence to the ring successor's
        replica store (a decode step sends only the block it touched)."""
        ev = self._hand_off(list(arrays.values()))

        def send():
            if ev is not None:
                ev.wait()
            for leaf, arr in arrays.items():
                key = f"w{self.wid}/seq{seq}/blk{j}/{leaf}"
                peer.replica.put(key, self._send(arr, key))
            ack_cb(self.wid, seq, step)

        self.streamer.submit(send, model_seconds=self._model_seconds(arrays.values()),
                             tag=f"rep-w{self.wid}-seq{seq}-blk{j}-s{step}")

    def replica_blocks(self, wid: int, seq: int) -> Dict[int, Dict[str, torch.Tensor]]:
        """Every replica block this store holds for (failed worker, seq)."""
        prefix = f"w{wid}/seq{seq}/blk"
        out: Dict[int, Dict[str, torch.Tensor]] = {}
        for key in self.replica.keys():
            if key.startswith(prefix):
                j, leaf = key[len(prefix):].split("/")
                out.setdefault(int(j), {})[leaf] = self.replica.get(key)
        return out


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class StageWorker:
    """One pipeline stage.  Stage 0 takes token ids, later stages the
    previous stage's activations; the last stage returns logits."""

    def __init__(self, wid: int, model, full_params, lo: int, hi: int, *,
                 first: bool, last: bool, hw: HardwareModel = DEFAULT_HW, device="cuda",
                 streamer: Optional[StreamEngine] = None, compress_replicas: bool = False):
        self.wid = wid
        self.model = model
        self.device = resolve_device(device)
        self.lo, self.hi = lo, hi
        self.first, self.last = first, last
        self.alive = True
        self.last_heartbeat = time.monotonic()
        # views of the full params where those already lie on the device
        self.sp = _to_device(model.slice_params(full_params, lo, hi, first=first,
                                                last=last), self.device)
        self.hw = hw
        self.cache = CacheManager(wid, streamer or StreamEngine(f"w{wid}", self.device), hw,
                                  compress_replicas=compress_replicas)
        self.kv: Dict[int, Dict[str, torch.Tensor]] = {}   # microbatch -> stage KV
        self.pool: BlockPool = None
        self.pages: PagedKVCache = None
        self.paged_dirty: Dict[int, set] = {}       # seq -> dirty logical blocks
        self.paged_swapped: Dict[int, int] = {}     # seq -> offloaded length

    def heartbeat(self) -> bool:
        if self.alive:
            self.last_heartbeat = time.monotonic()
        return self.alive

    def kill(self) -> None:
        """Machine failure: the device KV, the host store and the hosted
        replica all die."""
        telemetry.count("worker.kills", 1, wid=self.wid)
        tracing.event("worker.kill", wid=self.wid)
        self.alive = False
        self.kv.clear()
        self.cache.host.clear()
        self.cache.replica.clear()

    def _check(self, op: Optional[str] = None, **ids: int) -> None:
        if not self.alive:
            raise WorkerDead(f"worker {self.wid} is dead")
        # every stage op passes through here
        telemetry.count("worker.stage_calls", 1, wid=self.wid)
        if op is not None and tracing.active():
            # one track per worker: instants at the modeled clock of the
            # enclosing pass span
            tracing.event(f"stage.{op}", track=f"w{self.wid}", **ids)

    def _stage(self, fn, x_or_tokens, *args, tok_kw: str):
        if self.first:
            return fn(self.sp, None, *args, first=True, last=self.last,
                      **{tok_kw: x_or_tokens})
        return fn(self.sp, x_or_tokens, *args, first=False, last=self.last)

    # ------------------------------------------------------------------
    # dense microbatch slots (the run() path)
    # ------------------------------------------------------------------
    def prefill(self, mb: int, x_or_tokens, max_len: int):
        """Whole-prompt prefill of a microbatch; its K/V lands at the head of
        a zero cache of `max_len` slots, [Lstage,B,max_len,H,D]."""
        self._check("prefill", mb=mb)
        x, ks, vs = self._stage(self.model.stage_prefill, x_or_tokens, tok_kw="tokens")
        slot = init_decode_state(self.model.cfg, ks.shape[1], max_len, device=self.device,
                                 layers=self.hi - self.lo)["kv"]
        slot["k"][:, :, :ks.shape[2]] = ks
        slot["v"][:, :, :vs.shape[2]] = vs
        self.kv[mb] = slot
        return x

    def decode(self, mb: int, x_or_token, pos: int):
        """One decode step of a microbatch at the shared position `pos`."""
        self._check("decode", mb=mb)
        slot = self.kv[mb]
        x, _, _ = self._stage(self.model.stage_decode, x_or_token, slot["k"], slot["v"],
                              pos, tok_kw="token")
        return x

    def offload(self, mb: int, token_range=None) -> None:
        if mb in self.kv:
            self.cache.swap_out(mb, self.kv.pop(mb), token_range)

    def restore(self, mb: int) -> None:
        if mb not in self.kv and self.cache.host_has(mb):
            self.kv[mb] = self.cache.swap_in(mb, self.device)

    def resident(self) -> int:
        return len(self.kv)

    def install_kv(self, mb: int, arrays: Dict[str, torch.Tensor]) -> None:
        self.kv[mb] = {k: v.to(self.device) for k, v in arrays.items()}

    # ------------------------------------------------------------------
    # paged mode: per-sequence KV in ref-counted blocks
    # ------------------------------------------------------------------
    def enable_paging(self, num_blocks: int, block_size: int) -> None:
        cfg = self.model.cfg
        self.pool = BlockPool(num_blocks, block_size)
        self.pages = PagedKVCache(self.pool, layers=self.hi - self.lo,
                                  num_kv_heads=cfg.num_kv_heads,
                                  head_dim=cfg.resolved_head_dim,
                                  dtype=torch_dtype(cfg.dtype), device=self.device)

    def prefill_paged(self, seq: int, x_or_tokens, token_ids=None):
        """Whole-prompt prefill of one request (batch 1) into pool blocks;
        with `token_ids`, full prompt blocks whose prefix is live are
        shared.  Returns (x, fresh blocks)."""
        self._check("prefill_paged", rid=seq)
        x, ks, vs = self._stage(self.model.stage_prefill, x_or_tokens, tok_kw="tokens")
        _, fresh = self.pool.allocate(seq, ks.shape[2], token_ids=token_ids)
        # shared blocks already hold these values (same prefix, same
        # weights): one window write covers every block
        self.pages.write_window(seq, {"k": ks[:, 0], "v": vs[:, 0]}, 0)
        self.paged_dirty[seq] = {j for j, _, _, _ in self.pool.block_span(seq)}
        return x, len(fresh)

    def ensure_prefill_table(self, seq: int, plen: int, token_ids=None) -> None:
        """Size `seq`'s block table for the whole prompt before chunked
        prefill (fresh blocks stay unpublished until their pages are
        written, see `publish_prefix_hashes`).  Raises PoolExhausted before
        mutating."""
        self._check()
        if seq not in self.pool.tables:
            self.pool.allocate(seq, plen, token_ids=token_ids, publish=False)
            self.paged_dirty.setdefault(seq, set())
            return
        have = self.pool.seq_lens[seq]
        if plen > have:
            self.pages.apply_cow(self.pool.append(seq, plen - have))

    def publish_prefix_hashes(self, seq: int, hashes, upto_tokens: int) -> None:
        """Publish the prefix hashes of the prompt blocks whose pages the
        chunked-prefill cursor has fully written."""
        n = min(len(hashes), upto_tokens // self.pool.block_size)
        if n > 0:
            self.pool.publish_hashes(seq, hashes[:n])

    def prefill_chunk_paged(self, seq: int, x_or_tokens, pos0: int):
        """One chunk [pos0, pos0+C) of a paged prefill: gather the pages,
        run the chunk stage function, and write the chunk's K/V window back
        through kv_pack.  Requires `ensure_prefill_table` first."""
        self._check("prefill_chunk", rid=seq)
        c = int(x_or_tokens.shape[1])
        pad_to = len(self.pool.tables[seq]) * self.pool.block_size
        dense = self.pages.gather_dense(seq, pad_to)
        x, kc, vc = self._stage(self.model.stage_prefill_chunk, x_or_tokens,
                                dense["k"], dense["v"], pos0, tok_kw="tokens")
        self._write_chunk_window(seq, kc, vc, pos0, c, pad_to)
        return x

    def _write_chunk_window(self, seq: int, kc, vc, pos0: int, c: int,
                            pad_to: int) -> None:
        """Write one chunk's K/V window [pos0, pos0+c) back into `seq`'s
        pages through a token-block-aligned kv_pack (kc/vc [Lstage,1,S,H,D];
        the re-written head tokens of the aligned window hold identical
        values).  Shared by the per-sequence and fused chunk paths."""
        tb = self.cache.token_block
        t0a = (pos0 // tb) * tb
        w = min(-(-(pos0 + c - t0a) // tb) * tb, pad_to - t0a)
        # a pool whose block size does not divide the token block can clip
        # the window off-alignment: copy at a granularity that divides both
        tbw = tb if w % tb == 0 else math.gcd(w, tb)
        win = {"k": kops.kv_pack_auto(kc, t0a, w, token_block=tbw)[:, 0],
               "v": kops.kv_pack_auto(vc, t0a, w, token_block=tbw)[:, 0]}
        self.pages.write_window(seq, win, t0a)
        self._mark_chunk_dirty(seq, pos0, c)

    def _mark_chunk_dirty(self, seq: int, pos0: int, c: int) -> None:
        """The blocks a chunk [pos0, pos0+c) dirties: those its
        token-block-aligned write-back window touches."""
        bs = self.pool.block_size
        t0a = (pos0 // self.cache.token_block) * self.cache.token_block
        self.paged_dirty.setdefault(seq, set()).update(
            range(t0a // bs, -(-(pos0 + c) // bs)))

    def decode_paged(self, seq: int, x_or_token, pos: int):
        """One decode step of one sequence (the per-sequence path): append a
        slot (copy-on-write if the tail block is shared), gather, run the
        stage, write the new token's K/V back into its block."""
        self._check("decode_paged", rid=seq)
        self.pages.apply_cow(self.pool.append(seq))
        pad_to = len(self.pool.tables[seq]) * self.pool.block_size
        dense = self.pages.gather_dense(seq, pad_to)
        x, kc, vc = self._stage(self.model.stage_decode, x_or_token, dense["k"],
                                dense["v"], pos, tok_kw="token")
        self.pages.write_window(seq, {"k": kc[:, 0, pos:pos + 1],
                                      "v": vc[:, 0, pos:pos + 1]}, pos)
        self.paged_dirty.setdefault(seq, set()).add(pos // self.pool.block_size)
        return x

    def _gather_batch(self, seqs) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Gather every sequence's pages to a common pad -> (kc, vc, pad_to),
        kc/vc [Lstage, B, pad_to, H, D]: the fused-round stage-cache layout."""
        pad_to = max(len(self.pool.tables[s]) for s in seqs) * self.pool.block_size
        dense = self.pages.gather_dense(list(seqs), pad_to)
        return dense["k"], dense["v"], pad_to

    def reads_pages(self) -> bool:
        """Whether this stage's fused passes read the pool's pages in place
        (every layer plain causal, `DecoderLM.reads_pages`), else gather."""
        return self.model.reads_pages(self.sp)

    def decode_paged_batch(self, seqs, x_or_tokens, poses: Sequence[int]):
        """One fused pipeline pass: every sequence in `seqs` decodes one step
        at its own position.  A plain causal stage reads and writes its pages
        in place; otherwise the pages are gathered dense and the new-token
        K/V windows go back through one ragged buffered copy per leaf.  The
        cluster pre-flights pool capacity for the whole batch first."""
        self._check("decode_batch", n=len(seqs))
        for seq in seqs:
            self.pages.apply_cow(self.pool.append(seq))
        pos = torch.tensor(list(poses), dtype=torch.int32, device=self.device)
        if self.reads_pages():
            x = self._stage(self.model.stage_decode_paged, x_or_tokens, self.pages.k,
                            self.pages.v, self.pages.block_tables(seqs),
                            self.pages.write_indices(seqs, poses, [1] * len(seqs), 1), pos,
                            tok_kw="token")
        else:
            x = self._decode_gathered(seqs, x_or_tokens, poses, pos)
        for seq, p in zip(seqs, poses):
            self.paged_dirty.setdefault(seq, set()).add(p // self.pool.block_size)
        return x

    def _decode_gathered(self, seqs, x_or_tokens, poses: Sequence[int], pos):
        """The decode pass of a stage that gathers its pages: the dense
        stage cache, then the new-token K/V windows back through one ragged
        buffered copy per leaf."""
        kc, vc, pad_to = self._gather_batch(seqs)
        x, kc, vc = self._stage(self.model.stage_decode_batch, x_or_tokens, kc, vc,
                                pos, tok_kw="token")
        tb = self.cache.token_block
        t0s = [(p // tb) * tb for p in poses]
        if pad_to % tb == 0:
            # the aligned head tokens of each window re-write identical values
            wk = kops.kv_pack_ragged_auto(kc, t0s, tb, token_block=tb)
            wv = kops.kv_pack_ragged_auto(vc, t0s, tb, token_block=tb)
            wins = [({"k": wk[:, i], "v": wv[:, i]}, t0s[i]) for i in range(len(seqs))]
        else:                            # unaligned pool blocks: plain slices
            wins = [({"k": kc[:, i, p:p + 1], "v": vc[:, i, p:p + 1]}, p)
                    for i, p in enumerate(poses)]
        for seq, (win, t0) in zip(seqs, wins):
            self.pages.write_window(seq, win, t0)
        return x

    def prefill_chunk_paged_batch(self, seqs, x_or_tokens, pos0s: List[int],
                                  q_lens: List[int]):
        """One fused chunk-set pass: one prefill chunk of each sequence, each
        attending over its own resident prefix plus itself.  A plain causal
        stage reads and writes its pages in place; otherwise the pages are
        gathered dense and each window goes back into its own pages.
        Requires `ensure_prefill_table` first."""
        self._check("chunkset", n=len(seqs))
        pos = torch.tensor(pos0s, dtype=torch.int32, device=self.device)
        ql = torch.tensor(q_lens, dtype=torch.int32, device=self.device)
        if self.reads_pages():
            c = int(x_or_tokens.shape[1])
            x = self._stage(self.model.stage_prefill_chunk_paged, x_or_tokens, self.pages.k,
                            self.pages.v, self.pages.block_tables(seqs),
                            self.pages.write_indices(seqs, pos0s, q_lens, c), pos, ql,
                            tok_kw="tokens")
            for seq, p0, n in zip(seqs, pos0s, q_lens):
                self._mark_chunk_dirty(seq, p0, n)
            return x
        kc, vc, pad_to = self._gather_batch(seqs)
        x, kc, vc = self._stage(self.model.stage_prefill_chunk_batch, x_or_tokens,
                                kc, vc, pos, ql, tok_kw="tokens")
        for i, seq in enumerate(seqs):
            self._write_chunk_window(seq, kc[:, i:i + 1], vc[:, i:i + 1],
                                     pos0s[i], q_lens[i], pad_to)
        return x

    # ------------------------------------------------------------------
    def touched_block(self, seq: int, pos: int):
        """(logical_idx, arrays) of the block holding token `pos`."""
        j = pos // self.pool.block_size
        _, bid, t0, t1 = next(sp for sp in self.pool.block_span(seq) if sp[0] == j)
        return j, self.pages.block_arrays(bid, width=t1 - t0)

    def live_blocks(self, seq: int) -> Dict[int, Dict[str, torch.Tensor]]:
        return {j: self.pages.block_arrays(bid, width=t1 - t0)
                for j, bid, t0, t1 in self.pool.block_span(seq)}

    def install_blocks(self, seq: int, length: int,
                       blocks: Dict[int, Dict[str, torch.Tensor]],
                       hashes=None) -> None:
        """(Re)build a sequence's pool entry from blocks (swap-in); with
        `hashes`, full prompt blocks already live in the pool are shared."""
        if seq in self.pool.tables:
            self.pool.free_seq(seq)
        table, fresh = self.pool.allocate(seq, length, hashes=hashes)
        fresh_set = set(fresh)
        for j, bid in enumerate(table):
            if j in blocks and j in fresh_set:
                self.pages.install_block(bid, blocks[j])
        # shared blocks hold live data too: they must survive an offload
        self.paged_dirty[seq] = set(blocks) | (set(range(len(table))) - fresh_set)

    def paged_offload(self, seq: int) -> None:
        """Swap a sequence out: only dirty blocks cross to host memory, then
        its pool blocks are freed."""
        if seq not in self.pool.tables:
            return
        dirty = self.paged_dirty.get(seq, set())
        self.cache.swap_out_blocks(seq, {j: a for j, a in self.live_blocks(seq).items()
                                         if j in dirty})
        self.paged_swapped[seq] = self.pool.seq_lens[seq]
        self.pool.free_seq(seq)
        self.paged_dirty[seq] = set()

    def paged_restore(self, seq: int) -> None:
        if seq in self.pool.tables or seq not in self.paged_swapped:
            return
        length = self.paged_swapped[seq]
        need = blocks_for(length, self.pool.block_size)
        # capacity check before any state mutation, so a failed restore is
        # retryable
        if self.pool.num_free() < need:
            raise PoolExhausted(f"worker {self.wid}: cannot restore seq {seq} "
                                f"({need} blocks needed, {self.pool.num_free()} free)")
        del self.paged_swapped[seq]
        blocks = self.cache.swap_in_blocks(seq, self.device)
        self.install_blocks(seq, length, {j: a for j, a in blocks.items() if j < need})
        self.paged_dirty[seq] = set()

    def free_paged_seq(self, seq: int) -> None:
        """Retire a sequence: its blocks return to the pool."""
        if self.pool is not None and seq in self.pool.tables:
            self.pool.free_seq(seq)
        self.paged_swapped.pop(seq, None)
        self.paged_dirty.pop(seq, None)
        self.cache.drop_seq_swap(seq)
