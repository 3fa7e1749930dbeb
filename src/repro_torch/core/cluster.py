"""In-process DéjàVu cluster of the port (counterpart of `repro.core.cluster`).

Two serving paths share the stage workers:

- the microbatch path of `ServingEngine.run`: `prefill_mb` / `decode_mb`
  over dense per-microbatch caches, with prompt/token disaggregation (the
  prompt pipeline streams each microbatch's prompt KV to the token pipeline,
  paper §4.2.1) and microbatch swapping (every microbatch's KV lives in host
  memory between its steps, paper §4.2.2);
- the paged path of `run_continuous`: whole-prompt or chunked prefill into
  the block pool, fused decode and chunk-set passes, the per-sequence path,
  and preemption by block-granular swap to host memory.

On both paths ring replication copies each stage's KV, after every pass, to
its ring successor's host memory (`replication=True`), and a failed worker
is rebuilt by the paper's 4-step recovery (§4.2.3): the successor returns
the failed worker's replica, the predecessor re-replicates its own KV to
the new worker, the controller finds the last replicated step, and every
stage rolls back to it.  The same machinery migrates a straggler, and
`repartition` re-splits the token pipeline through DéjàVuLib's streams.

Every pass runs inside a ``pass`` span of the telemetry registry and the
tracer (kinds ``mb_prefill``, ``mb_decode``, ``prefill_<mode>``,
``perseq_decode``, ``fused_decode``, ``chunkset``) and advances the modeled
clock by the cost model's time for it (`costmodel`, with `hw`, one stage
on an 8-GPU node), at the reference's call sites with its arguments; a
kill marks the clock for the engine's ``cluster.recovery_s``.

Tiers, swapping and disaggregation on the paged path are later slices and
raise NotImplementedError where asked for.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import not_ported, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import costmodel as cm
from repro_torch.core import telemetry, tracing
from repro_torch.core.controller import Controller
from repro_torch.core.dejavulib import (NetworkTransport, PipelineTopo, StreamEngine, faults,
                                        stream_in, stream_in_blocks, stream_out,
                                        stream_out_blocks)
from repro_torch.core.dejavulib.transport import DEFAULT_HW, HardwareModel
from repro_torch.core.worker import StageWorker
from repro_torch.kvcache.cache import decode_state_shapes, state_bytes
from repro_torch.kvcache.paged import BlockPool, PoolExhausted, blocks_for


# the chips one pipeline stage's modeled pass runs on: an 8-GPU node
# (`planner.MachineSpec`)
_STAGE_CHIPS = 8


def _stage_ranges(num_layers: int, depth: int) -> List[Tuple[int, int]]:
    if depth > num_layers:
        raise ValueError(f"pipeline depth {depth} > {num_layers} layers")
    splits = np.array_split(np.arange(num_layers), depth)
    return [(int(s[0]), int(s[-1]) + 1) for s in splits]


def fused_supported(cfg: ArchConfig) -> bool:
    """Whether the batched fused-round path is exact for this config: every
    dense/moe attention variant; not the families with per-sequence state
    outside the KV cache (ssm/hybrid/encdec) or vlm patch slots."""
    return cfg.family in ("dense", "moe") and not cfg.num_patches


class DejaVuCluster:
    def __init__(self, cfg: ArchConfig, model, params, n_workers: int, *,
                 mode: str = "colocated", dp_split=None, swapping: bool = False,
                 replication: bool = False, compress_replicas: bool = False,
                 paged: bool = False, kv_block_size: Optional[int] = None,
                 kv_pool_blocks: Optional[int] = None, tiered: bool = False,
                 host_cache_blocks: Optional[int] = None,
                 ssd_cache_blocks: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 fused_rounds: Optional[bool] = None, hw: HardwareModel = DEFAULT_HW,
                 device="cuda"):
        if mode not in ("colocated", "disaggregated"):
            raise ValueError(f"mode must be 'colocated' or 'disaggregated', not {mode!r}")
        if mode == "disaggregated" and (dp_split is None or sum(dp_split) != n_workers):
            raise ValueError(f"disaggregated mode needs dp_split summing to {n_workers}, "
                             f"got {dp_split}")
        # the stage API (slice_params, stage_prefill, ...) exists for the dense
        # family only; MambaLM and HybridLM serve through prefill/decode_step
        not_ported(**{f"family={cfg.family} in the cluster (A.12)": cfg.family != "dense",
                      "tiered (A.10)": tiered, "host_cache_blocks (A.10)": host_cache_blocks,
                      "ssd_cache_blocks (A.10)": ssd_cache_blocks,
                      "swapping with paged=True (A.9)": swapping and paged,
                      "mode=disaggregated with paged=True (A.9)":
                          paged and mode != "colocated"})
        self.cfg = cfg
        self.model = model
        self.params = params             # full weights (the checkpoint store)
        self.device = resolve_device(device)
        self.mode = mode
        self.swapping = swapping
        self.replication = replication
        self.compress_replicas = compress_replicas
        self.hw = hw
        self.paged = paged
        self.kv_block_size = kv_block_size or cfg.kv_block_size
        self.kv_pool_blocks = kv_pool_blocks or cfg.kv_pool_blocks or 512
        self.prefill_chunk_tokens = (cfg.prefill_chunk_tokens
                                     if prefill_chunk_tokens is None
                                     else prefill_chunk_tokens)
        self.fused_rounds = cfg.fused_rounds if fused_rounds is None else fused_rounds
        self.streamer = StreamEngine("cluster", device=self.device)
        self.controller = Controller()
        self.net = NetworkTransport(hw)
        if mode == "colocated":
            self.prompt_group = self.token_group = self._build_group(n_workers, wid0=0)
        else:
            dp, dt = dp_split
            self.prompt_group = self._build_group(dp, wid0=0)
            self.token_group = self._build_group(dt, wid0=dp)
        for w in self.workers():
            self.controller.register(w)
        if paged:
            for w in self.token_group:
                w.enable_paging(self.kv_pool_blocks, self.kv_block_size)
        # microbatch (run() path) bookkeeping: KV length, prompt length,
        # cache length, batch
        self.mb_pos: Dict[int, int] = {}
        self.mb_prompt_len: Dict[int, int] = {}
        self.mb_max_len: Dict[int, int] = {}
        self.mb_batch: Dict[int, int] = {}
        # paged (per-sequence) bookkeeping
        self.seq_len: Dict[int, int] = {}       # live tokens per sequence
        self.seq_prompt_len: Dict[int, int] = {}
        self.seq_hashes: Dict[int, List[int]] = {}
        self.kv_bytes_peak = 0
        self._pending_prefill: Dict[int, dict] = {}
        # pipeline passes run, by kind; "one_token" counts the passes whose
        # attention ran with one query per sequence (every decode pass, and
        # any prefill pass whose longest chunk is a single token)
        self.pass_counts: Counter = Counter()
        # one entry per delivered failure: the wall clock of the kill and of
        # each recovery step, in ms (`_recover_worker`); the engine adds the
        # first token emitted after the recovery
        self.recovery_log: List[dict] = []
        # wall seconds spent in replication rounds, the drain barrier included
        self.replication_s = 0.0
        # modeled prefill seconds this round (the engine resets it)
        self.round_prefill_model_s = 0.0
        # the modeled clock at each delivered kill; the engine closes each
        # into a `cluster.recovery_s` observation at the first token emitted
        # after the recovery (the paper's fail -> first restored token)
        self._recovery_marks: List[float] = []

    # ------------------------------------------------------------------
    def workers(self) -> List[StageWorker]:
        """Every stage worker once (the groups are one list when colocated)."""
        return list(dict.fromkeys(self.prompt_group + self.token_group))

    def live_kv_bytes(self) -> int:
        """Device-resident decode-state bytes now: dense slots and pages."""
        total = 0
        for w in self.workers():
            if w.pages is not None:
                total += w.pages.used_bytes()
            total += sum(state_bytes(slot) for slot in w.kv.values())
        return total

    def _track_kv_peak(self) -> None:
        self.kv_bytes_peak = max(self.kv_bytes_peak, self.live_kv_bytes())

    def _tokens(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks, np.int32), device=self.device)

    def _count_pass(self, kind: str, c: int) -> None:
        self.pass_counts[kind] += 1
        if c == 1:
            self.pass_counts["one_token"] += 1

    def _worker(self, wid: int, lo: int, hi: int, first: bool, last: bool) -> StageWorker:
        return StageWorker(wid, self.model, self.params, lo, hi, first=first, last=last,
                           hw=self.hw, device=self.device, streamer=self.streamer,
                           compress_replicas=self.compress_replicas)

    def _build_group(self, depth: int, wid0: int) -> List[StageWorker]:
        ranges = _stage_ranges(self.cfg.num_layers, depth)
        return [self._worker(wid0 + i, lo, hi, i == 0, i == len(ranges) - 1)
                for i, (lo, hi) in enumerate(ranges)]

    def _heartbeats(self) -> None:
        for w in self.workers():
            w.heartbeat()

    # ------------------------------------------------------------------
    # microbatch serving primitives (the run() path)
    # ------------------------------------------------------------------
    def prefill_mb(self, mb: int, tokens, max_new: int) -> torch.Tensor:
        """Prefill a microbatch (tokens [B,plen]) through the prompt
        pipeline; in disaggregated mode stream its prompt KV to the token
        pipeline; with swapping move it to host memory.  Returns logits."""
        tokens = self._tokens(tokens)
        b, plen = tokens.shape
        # cache length aligned to the kv_pack token block (8)
        max_len = -(-(plen + max_new) // 8) * 8
        self.mb_batch[mb] = b
        self.mb_pos[mb] = plen
        self.mb_prompt_len[mb] = plen
        self.mb_max_len[mb] = max_len
        with telemetry.span("pass", kind="mb_prefill"), \
                tracing.span("pass", kind="mb_prefill", mb=mb, batch=b):
            x = tokens
            for w in self.prompt_group:
                x = w.prefill(mb, x, max_len)
            self._count_pass("mb_prefill", plen)
            telemetry.advance(cm.stage_prompt_time(
                self.cfg, cm.WorkloadSpec(prompt_len=plen, new_tokens=1, microbatch=b),
                self.cfg.num_layers, _STAGE_CHIPS, self.hw))
        if self.mode == "disaggregated":
            self._stream_prompt_kv(mb, plen)
        if self.replication:
            self._replicate(mb, (0, plen), step=0)
        if self.swapping:
            for w in self.token_group:
                w.offload(mb)            # full first offload to host
        self._track_kv_peak()
        return x

    def _stream_prompt_kv(self, mb: int, plen: int) -> None:
        """Move the microbatch's prompt KV from the prompt stages to the
        token stages, split and merged by layer range: packed on the device,
        over the network transport into each token stage's host store, then
        landed on that stage's device (see `dejavulib.primitives`)."""
        bsz = self.mb_batch[mb]
        topo_p = PipelineTopo(len(self.prompt_group), self.cfg.num_layers, bsz)
        topo_t = PipelineTopo(len(self.token_group), self.cfg.num_layers, bsz)
        dst_stores = {i: w.cache.host for i, w in enumerate(self.token_group)}
        for si, w in enumerate(self.prompt_group):
            stream_out({"kv": w.kv.pop(mb)}, si, topo_p, topo_t, dst_stores, self.net,
                       mb=mb, token_range=(0, plen))
        for di, w in enumerate(self.token_group):
            lo, hi = topo_t.layer_range(di)
            shapes = decode_state_shapes(self.cfg, bsz, self.mb_max_len[mb], layers=hi - lo)
            local = stream_in(w.cache.host, di, topo_t, topo_p, shapes, self.net, mb=mb,
                              token_range=(0, plen), device=w.device)
            w.install_kv(mb, local["kv"])
            for key in [k for k in w.cache.host.keys() if k.startswith(f"mb{mb}/")]:
                w.cache.host.delete(key)

    def decode_mb(self, mb: int, token, step: int) -> torch.Tensor:
        """One decode step of a microbatch (token [B]) through the token
        pipeline; `step` is 1-based (step i consumes token i-1).  With
        swapping the KV comes in from host memory and the new token's window
        goes back out.  Returns logits [B,V]."""
        pos = self.mb_pos[mb]
        with telemetry.span("pass", kind="mb_decode"), \
                tracing.span("pass", kind="mb_decode", mb=mb, step=step):
            if self.swapping:
                for w in self.token_group:
                    w.restore(mb)
            x = self._tokens(token)
            for w in self.token_group:
                x = w.decode(mb, x, pos)
            self._count_pass("mb_decode", 1)
            telemetry.advance(cm.stage_token_time(
                self.cfg, cm.WorkloadSpec(prompt_len=max(pos, 1), new_tokens=1,
                                          microbatch=self.mb_batch.get(mb, 1)),
                self.cfg.num_layers, _STAGE_CHIPS, pos + 1, self.hw))
        self.mb_pos[mb] = pos + 1
        if self.replication:
            self._replicate(mb, (pos, pos + 1), step=step)
        if self.swapping:
            for w in self.token_group:
                w.offload(mb, token_range=(pos, pos + 1))
        self._heartbeats()
        self._track_kv_peak()
        return x

    def _replicate(self, mb: int, token_range: Tuple[int, int], step: int) -> None:
        """Ring-replicate a microbatch's KV window: each token stage sends
        it to its successor's replica store (from its host copy when
        swapped out), then the streamer is drained (the barrier)."""
        t = time.perf_counter()
        group = self.token_group
        n = len(group)
        for i, w in enumerate(group):
            if mb not in w.kv and not self.swapping:
                continue
            kv = w.kv.get(mb)
            if kv is None:               # swapped out: from the host copy
                kv = {leaf: w.cache.host.get(f"swap/mb{mb}/{leaf}").to(w.device)
                      for leaf in ("k", "v")}
            w.cache.replicate_to(group[(i + 1) % n].cache, mb, kv, token_range, step,
                                 self.controller.ack_replication)
        self.streamer.drain()
        self.replication_s += time.perf_counter() - t

    # ------------------------------------------------------------------
    @property
    def fused_ok(self) -> bool:
        return self.fused_rounds and self.paged and fused_supported(self.cfg)

    def can_admit(self, prompt_len: int, n_active: int, token_ids=None) -> bool:
        """Admission control: every pool must fit the prompt plus one
        headroom block per already-running sequence."""
        need = blocks_for(prompt_len + 1, self.kv_block_size) + n_active
        return all(w.pool.num_free() >= need for w in self.token_group)

    def prefill_seq_begin(self, rid: int, prompt: np.ndarray, max_new: int) -> None:
        """Stage a prefill for `prefill_seq_step` to advance pass by pass:
        in chunks of `prefill_chunk_tokens` prompt tokens ("chunk" mode) when
        the prompt is longer than a chunk or fused rounds are on (so every
        in-flight prefill packs into the round's chunk-set pass), else the
        whole prompt in one pass ("batch" mode, through `flash_attention`).
        `prefill_chunk_tokens=0` always runs the whole prompt."""
        plen = int(prompt.shape[0])
        self.seq_len[rid] = plen
        self.seq_prompt_len[rid] = plen
        token_ids = [int(t) for t in prompt]
        self.seq_hashes[rid] = BlockPool.chain_hashes(token_ids, self.kv_block_size)
        for w in self.prompt_group:      # re-prefill after rollback-to-0
            if rid in w.pool.tables:
                w.free_paged_seq(rid)
        ck = self.prefill_chunk_tokens
        mode = "chunk" if ck > 0 and (plen > ck or self.fused_ok) else "batch"
        if mode == "chunk":
            for w in self.prompt_group:
                w.ensure_prefill_table(rid, plen, token_ids=token_ids)
        self._pending_prefill[rid] = {"prompt": np.asarray(prompt, np.int32),
                                      "plen": plen, "pos": 0, "x": None, "mode": mode}

    def prefill_seq_step(self, rid: int) -> Optional[torch.Tensor]:
        """Run one pipeline pass of a staged prefill: the whole prompt
        ("batch" mode) or one chunk attending over the pool-resident prefix.
        Returns the prefill logits once the prompt is done, else None."""
        st = self._pending_prefill[rid]
        plen, pos = st["plen"], st["pos"]
        with telemetry.span("pass", kind=f"prefill_{st['mode']}"), \
                tracing.span("pass", rid=rid, kind=f"prefill_{st['mode']}", pos=pos,
                             plen=plen):
            if st["mode"] == "batch":
                x = self._tokens(st["prompt"])[None]
                token_ids = [int(t) for t in st["prompt"]]
                for w in self.prompt_group:
                    x, _ = w.prefill_paged(rid, x, token_ids=token_ids)
                c = plen
                self._count_pass("prefill_batch", c)
            else:
                c = min(self.prefill_chunk_tokens, plen - pos)
                x = self._tokens(st["prompt"][pos:pos + c])[None]
                for w in self.prompt_group:
                    x = w.prefill_chunk_paged(rid, x, pos)
                self._count_pass("prefill_chunk", c)
            st["x"] = x
            self._after_prefill_pass(rid, st, c)
        if st["pos"] < plen:
            return None
        return self._finish_prefill(rid)

    def _after_prefill_pass(self, rid: int, st: dict, n_q: int) -> None:
        """Advance the cursor, in chunk mode publish the prefix hashes of the
        blocks whose pages the cursor just completed (a whole-prompt pass
        publishes them as it allocates), and charge the modeled pass time."""
        st["pos"] += n_q
        if st["mode"] == "chunk":
            for w in self.prompt_group:
                w.publish_prefix_hashes(rid, self.seq_hashes[rid], st["pos"])
        t = cm.chunked_prefill_pass_time(self.cfg, n_q, st["pos"], self.cfg.num_layers,
                                         _STAGE_CHIPS, self.hw)
        self.round_prefill_model_s += t
        telemetry.advance(t)

    def _finish_prefill(self, rid: int) -> torch.Tensor:
        st = self._pending_prefill.pop(rid)
        if self.replication:
            self._replicate_paged(rid, step=0)
        self._track_kv_peak()
        return st["x"]

    def abort_prefill(self, rid: int) -> None:
        """Drop an in-flight prefill (a worker died mid-chunk and took the
        partial tables with it); the engine begins it again."""
        self._pending_prefill.pop(rid, None)
        for w in self.prompt_group:
            if rid in w.pool.tables:
                w.free_paged_seq(rid)

    def prefill_pending(self, rid: int) -> bool:
        return rid in self._pending_prefill

    def prefill_mode(self, rid: int) -> Optional[str]:
        """'chunk' or 'batch' for a staged prefill, else None: the engine
        packs only chunk-mode prefills into a fused pass."""
        st = self._pending_prefill.get(rid)
        return None if st is None else st["mode"]

    def decode_seq(self, rid: int, token, step: int) -> torch.Tensor:
        """One decode step for one sequence.  Raises PoolExhausted before
        mutating any pool, so the engine can preempt a victim and retry."""
        pos = self.seq_len[rid]
        with telemetry.span("pass", kind="perseq_decode"), \
                tracing.span("pass", rid=rid, seq=step, kind="perseq_decode"):
            for w in self.token_group:
                if w.pool.append_needs_block(rid) and w.pool.num_free() == 0:
                    raise PoolExhausted(f"worker {w.wid} pool full (seq {rid})")
            x = self._tokens(token)
            for w in self.token_group:
                x = w.decode_paged(rid, x, pos)
            self.seq_len[rid] = pos + 1
            self._count_pass("perseq_decode", 1)
            telemetry.advance(cm.stage_token_time(
                self.cfg, cm.WorkloadSpec(prompt_len=max(pos, 1), new_tokens=1, microbatch=1),
                self.cfg.num_layers, _STAGE_CHIPS, pos + 1, self.hw))
        if self.replication:
            self._replicate_paged(rid, step=step, pos=pos)
        self._heartbeats()
        self._track_kv_peak()
        return x

    def decode_batch(self, rids: List[int], tokens, steps: List[int]) -> torch.Tensor:
        """One pipeline pass that decodes every sequence in `rids` one step.
        Capacity is pre-flighted across the whole batch, so PoolExhausted
        raises before any pool mutates.  Returns logits [B,V]."""
        poses = [self.seq_len[rid] for rid in rids]
        with telemetry.span("pass", kind="fused_decode"), \
                tracing.span("pass", kind="fused_decode", rids=list(rids)):
            for w in self.token_group:
                need = sum(1 for rid in rids if w.pool.append_needs_block(rid))
                if need > w.pool.num_free():
                    raise PoolExhausted(
                        f"worker {w.wid} pool cannot absorb a fused round of "
                        f"{len(rids)} appends ({need} needed, {w.pool.num_free()} free)")
            x = self._tokens(tokens)
            for w in self.token_group:
                x = w.decode_paged_batch(rids, x, poses)
            for rid, pos in zip(rids, poses):
                self.seq_len[rid] = pos + 1
            self._count_pass("fused_decode", 1)
            # the mean context of the batch, as the reference rounds it
            ctx = max(1, (sum(poses) + len(poses)) // max(len(poses), 1))
            telemetry.advance(cm.decode_round_time(self.cfg, len(rids), ctx,
                                                   self.cfg.num_layers, _STAGE_CHIPS, self.hw,
                                                   fused=True))
        if self.replication:
            for rid, step, pos in zip(rids, steps, poses):
                self._replicate_paged(rid, step=step, pos=pos)
        self._heartbeats()
        self._track_kv_peak()
        return x

    def prefill_chunkset_pass(self, rids: List[int]
                              ) -> Dict[int, Optional[torch.Tensor]]:
        """Advance the staged prefills of all `rids` by one chunk each in ONE
        pipeline pass.  Ragged chunks are padded to the longest and masked
        inside the pass.  Returns {rid: prefill logits | None}."""
        with telemetry.span("pass", kind="chunkset"), \
                tracing.span("pass", kind="chunkset", rids=list(rids)):
            return self._prefill_chunkset_pass(rids)

    def _prefill_chunkset_pass(self, rids: List[int]) -> Dict[int, Optional[torch.Tensor]]:
        sts = [self._pending_prefill[r] for r in rids]
        ck = self.prefill_chunk_tokens
        cs = [min(ck, st["plen"] - st["pos"]) for st in sts]
        cmax = max(cs)
        toks = np.zeros((len(rids), cmax), np.int32)
        for i, st in enumerate(sts):
            toks[i, :cs[i]] = st["prompt"][st["pos"]:st["pos"] + cs[i]]
        pos0s = [st["pos"] for st in sts]
        x = self._tokens(toks)
        for w in self.prompt_group:
            x = w.prefill_chunk_paged_batch(rids, x, pos0s, cs)
        self._count_pass("chunkset", cmax)
        out: Dict[int, Optional[torch.Tensor]] = {}
        for i, (rid, st) in enumerate(zip(rids, sts)):
            self._after_prefill_pass(rid, st, cs[i])
            if st["pos"] < st["plen"]:
                out[rid] = None
            else:
                st["x"] = x[i:i + 1]
                out[rid] = self._finish_prefill(rid)
        return out

    def _replicate_paged(self, rid: int, step: int, pos: Optional[int] = None) -> None:
        """Ring-replicate at block granularity: a prefill sends every live
        block, a decode step only the block it touched; then the streamer
        is drained (the barrier)."""
        t = time.perf_counter()
        group = self.token_group
        n = len(group)
        for i, w in enumerate(group):
            if rid not in w.pool.tables:
                continue
            peer = group[(i + 1) % n].cache
            blocks = w.live_blocks(rid) if pos is None else dict([w.touched_block(rid, pos)])
            for j, arrays in blocks.items():
                w.cache.replicate_block_to(peer, rid, j, arrays, step,
                                           self.controller.ack_replication)
        self.streamer.drain()
        self.replication_s += time.perf_counter() - t

    def preempt_seq(self, rid: int) -> None:
        """Swap a running sequence out (block-granular) to free pool space;
        `resume_seq` brings it back."""
        for w in self.token_group:
            w.paged_offload(rid)

    def resident_blocks(self, rid: int) -> int:
        """Device-resident blocks a preemption of `rid` would free."""
        return sum(len(w.pool.tables.get(rid, ())) for w in self.token_group)

    def can_resume(self, rid: int, n_active: int) -> bool:
        need = blocks_for(self.seq_len[rid] + 1, self.kv_block_size) + n_active
        return all(w.pool.num_free() >= need for w in self.token_group)

    def resume_seq(self, rid: int) -> None:
        for w in self.token_group:
            w.paged_restore(rid)

    def free_seq(self, rid: int) -> None:
        """Retire a finished sequence: its blocks return to the pool and its
        replica blocks are dropped."""
        for w in self.workers():
            w.free_paged_seq(rid)
            for key in [k for k in w.cache.replica.keys() if f"/seq{rid}/" in k]:
                w.cache.replica.delete(key)
        self.seq_len.pop(rid, None)
        self.seq_prompt_len.pop(rid, None)
        self.seq_hashes.pop(rid, None)
        self._pending_prefill.pop(rid, None)

    # ------------------------------------------------------------------
    # failure handling (paper §4.2.3) and straggler migration
    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _lap(self, rec: dict, key: str, t: float) -> float:
        """Record the wall ms since `t` under `key`; returns the clock now."""
        self._sync()
        now = time.perf_counter()
        rec[key] = (now - t) * 1e3
        return now

    def inject_failure(self, wid: int) -> None:
        # an observation point only: a recorded trace and `fault_trace` show
        # every delivered kill, whatever path asked for it
        faults.fire("cluster.fail", tag=f"w{wid}")
        tracing.event("cluster.kill", wid=wid)
        t = telemetry.current()
        if t is not None:
            self._recovery_marks.append(t.clock_s)
            t.count("cluster.failures", 1)
        for w in self.workers():
            if w.wid == wid:
                self._sync()
                self.recovery_log.append({"wid": wid, "t_fail": time.perf_counter()})
                w.kill()
                self.controller.log_event("failure", wid=wid)
                return
        raise KeyError(wid)

    def detect_and_recover(self, active: List[int]) -> Dict[int, int]:
        """Controller-driven recovery of every dead worker.  Returns {mb or
        rid: step to resume from} (empty if no worker failed)."""
        resume: Dict[int, int] = {}
        for wid in self.controller.check_failures():
            with tracing.span("recovery", wid=wid):
                resume.update(self._recover_worker(wid, active))
        return resume

    def take_recovery_marks(self) -> List[float]:
        """Drain the clock marks of the kills delivered since the last call
        (see `inject_failure`)."""
        marks, self._recovery_marks = self._recovery_marks, []
        return marks

    def _replace(self, group: List[StageWorker], idx: int) -> StageWorker:
        """A fresh worker in place of `group[idx]`: its weights are views of
        the full params (already on the device), its KV empty."""
        old = group[idx]
        neww = self._worker(old.wid, old.lo, old.hi, old.first, old.last)
        group[idx] = neww
        self.controller.workers = [neww if w.wid == old.wid else w
                                   for w in self.controller.workers]
        return neww

    def _recover_worker(self, wid: int, active: List[int]) -> Dict[int, int]:
        rec = next((r for r in reversed(self.recovery_log) if r["wid"] == wid), None)
        if rec is None:
            rec = {"wid": wid, "t_fail": time.perf_counter()}
            self.recovery_log.append(rec)
        t = self._lap(rec, "detect_ms", rec["t_fail"])
        if self.mode == "disaggregated" and any(w.wid == wid for w in self.prompt_group):
            # prompt workers hold no state across microbatches: rebuild in place
            self._replace(self.prompt_group,
                          next(i for i, w in enumerate(self.prompt_group) if w.wid == wid))
            self._lap(rec, "rebuild_ms", t)
            self.controller.log_event("recovery", wid=wid, resume={})
            return {}
        group = self.token_group
        idx = next(i for i, w in enumerate(group) if w.wid == wid)
        n = len(group)
        neww = self._replace(group, idx)
        if self.paged:
            neww.enable_paging(self.kv_pool_blocks, self.kv_block_size)
        t = self._lap(rec, "rebuild_ms", t)
        succ, pred = group[(idx + 1) % n], group[(idx - 1) % n]
        if self.paged:
            return self._recover_worker_paged(wid, neww, succ, pred, active, rec, t)
        # step 1: the successor returns the failed worker's replica
        for mb in active:
            arrays = {leaf: succ.cache.replica.get(f"w{wid}/mb{mb}/{leaf}")
                      for leaf in ("k", "v") if f"w{wid}/mb{mb}/{leaf}" in succ.cache.replica}
            if arrays:                   # a copy: the replica stays the successor's
                neww.install_kv(mb, {k: a.to(neww.device, copy=True)
                                     for k, a in arrays.items()})
                if self.swapping:        # rebuild the host copy too
                    neww.cache.swap_out(mb, neww.kv[mb])
        t = self._lap(rec, "replica_ms", t)
        # step 2: the predecessor re-replicates its own KV to the new worker
        for mb in active:
            kv = pred.kv.get(mb)
            if kv is None and pred.cache.host_has(mb):
                kv = {leaf: pred.cache.host.get(f"swap/mb{mb}/{leaf}").to(pred.device)
                      for leaf in ("k", "v")}
            if kv is not None:
                pred.cache.replicate_to(neww.cache, mb, kv, (0, self.mb_pos[mb]),
                                        self.controller.replicated_step(pred.wid, mb),
                                        self.controller.ack_replication)
        self.streamer.drain()
        t = self._lap(rec, "rereplicate_ms", t)
        # steps 3 and 4: the resume point per microbatch, and the rollback;
        # step i writes at prompt_len + i - 1
        resume = self.controller.resume_point(wid, active)
        for mb, r in resume.items():
            self.mb_pos[mb] = self.mb_prompt_len[mb] + max(r - 1, 0)
        self._lap(rec, "rollback_ms", t)
        self.controller.log_event("recovery", wid=wid, resume=dict(resume))
        return resume

    def _recover_worker_paged(self, wid: int, neww: StageWorker, succ: StageWorker,
                              pred: StageWorker, active: List[int], rec: dict,
                              t: float) -> Dict[int, int]:
        """Paged 4-step recovery: only live blocks move.  Each sequence is
        restored from the successor's replica blocks, the predecessor
        re-streams its own blocks, and every sequence rolls back to its last
        fully replicated step."""
        bs = self.kv_block_size
        # step 1: restore each sequence from the successor's replica blocks
        for rid in active:
            rep = self.controller.replicated_step(wid, rid)
            if rep < 0:
                continue                 # nothing replicated: the engine re-prefills
            avail = self.seq_prompt_len[rid] + rep
            keep = blocks_for(avail, bs)
            blocks = {j: a for j, a in succ.cache.replica_blocks(wid, rid).items() if j < keep}
            # full prompt blocks shared with co-resident sequences are shared
            # again, so a pool that fit its load by sharing still fits it
            neww.install_blocks(rid, avail, blocks,
                                hashes=self.seq_hashes.get(rid, [])[:avail // bs])
            # a preempted sequence goes back to host memory on the new worker
            # too: recovery leaves residency as it found it
            if rid in pred.paged_swapped:
                neww.paged_offload(rid)
        t = self._lap(rec, "replica_ms", t)
        # step 2: the predecessor re-replicates its own live blocks; a
        # preempted sequence comes back for the send and goes out again
        for rid in active:
            was_swapped = rid in pred.paged_swapped
            pred.paged_restore(rid)
            if rid not in pred.pool.tables:
                continue
            step = self.controller.replicated_step(pred.wid, rid)
            for j, arrays in pred.live_blocks(rid).items():
                pred.cache.replicate_block_to(neww.cache, rid, j, arrays, step,
                                              self.controller.ack_replication)
            if was_swapped:
                pred.paged_offload(rid)
        self.streamer.drain()
        t = self._lap(rec, "rereplicate_ms", t)
        # steps 3 and 4: the resume point per sequence; every pool rolls back
        resume = self.controller.resume_point(wid, active)
        for rid, r in resume.items():
            new_len = self.seq_prompt_len[rid] + max(r - 1, 0) if r > 0 else 0
            self.seq_len[rid] = new_len
            for w in self.token_group:
                if rid in w.pool.tables:
                    if new_len > 0:
                        w.pool.truncate(rid, new_len)
                    else:
                        w.free_paged_seq(rid)
                if rid in w.paged_swapped:
                    w.paged_swapped[rid] = min(w.paged_swapped[rid], new_len)
        self._lap(rec, "rollback_ms", t)
        self.controller.log_event("recovery", wid=wid, resume=dict(resume))
        return resume

    def migrate_worker(self, wid: int, active: List[int]) -> Dict[int, int]:
        """Straggler mitigation: move a slow stage to a fresh worker through
        the replication ring (beyond the paper, the same machinery)."""
        self.controller.log_event("migrate", wid=wid)
        self.inject_failure(wid)
        return self.detect_and_recover(active)

    # ------------------------------------------------------------------
    # elastic repartitioning (beyond the paper)
    # ------------------------------------------------------------------
    def repartition(self, new_depth: int, active: List[int]) -> None:
        """Re-split the token pipeline into `new_depth` stages, moving all
        live KV through DéjàVuLib's stream_out / stream_in (dense) or
        stream_out_blocks / stream_in_blocks (paged)."""
        old_group = self.token_group
        bsz = max(self.mb_batch.values()) if self.mb_batch else 1
        topo_old = PipelineTopo(len(old_group), self.cfg.num_layers, bsz)
        topo_new = PipelineTopo(new_depth, self.cfg.num_layers, bsz)
        ranges = _stage_ranges(self.cfg.num_layers, new_depth)
        wid0 = max(w.wid for w in self.workers()) + 1
        new_group = [self._worker(wid0 + i, lo, hi, i == 0, i == len(ranges) - 1)
                     for i, (lo, hi) in enumerate(ranges)]
        dst_stores = {i: w.cache.host for i, w in enumerate(new_group)}
        if self.paged:
            for w in new_group:
                w.enable_paging(self.kv_pool_blocks, self.kv_block_size)
            for rid in active:
                for si, w in enumerate(old_group):
                    stream_out_blocks(w.live_blocks(rid), si, topo_old, topo_new, dst_stores,
                                      self.net, seq=rid)
                for di, w in enumerate(new_group):
                    blocks = stream_in_blocks(w.cache.host, di, topo_new, topo_old, self.net,
                                              seq=rid, device=w.device)
                    w.install_blocks(rid, self.seq_len[rid], blocks)
        else:
            for mb in active:
                cur = self.mb_pos[mb]
                for si, w in enumerate(old_group):
                    if self.swapping:
                        w.restore(mb)
                    stream_out({"kv": w.kv[mb]}, si, topo_old, topo_new, dst_stores,
                               self.net, mb=mb, token_range=(0, cur))
                for di, w in enumerate(new_group):
                    lo, hi = topo_new.layer_range(di)
                    shapes = decode_state_shapes(self.cfg, self.mb_batch[mb],
                                                 self.mb_max_len[mb], layers=hi - lo)
                    local = stream_in(w.cache.host, di, topo_new, topo_old, shapes, self.net,
                                      mb=mb, token_range=(0, cur), device=w.device)
                    w.install_kv(mb, local["kv"])
                    for key in [k for k in w.cache.host.keys() if k.startswith(f"mb{mb}/")]:
                        w.cache.host.delete(key)
        self.token_group = new_group
        if self.mode == "colocated":
            self.prompt_group = new_group
        for w in new_group:
            self.controller.register(w)
        self.controller.log_event("repartition", depth=new_depth)
