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

Replication and recovery, tiers, swapping and disaggregation on the paged
path, and the modeled clock are later slices and raise NotImplementedError
where asked for.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import not_ported, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.dejavulib import NetworkTransport, PipelineTopo, stream_in, stream_out
from repro_torch.core.worker import StageWorker
from repro_torch.kvcache.cache import decode_state_shapes, state_bytes
from repro_torch.kvcache.paged import BlockPool, PoolExhausted, blocks_for


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
                 fused_rounds: Optional[bool] = None, device="cuda"):
        if mode not in ("colocated", "disaggregated"):
            raise ValueError(f"mode must be 'colocated' or 'disaggregated', not {mode!r}")
        if mode == "disaggregated" and (dp_split is None or sum(dp_split) != n_workers):
            raise ValueError(f"disaggregated mode needs dp_split summing to {n_workers}, "
                             f"got {dp_split}")
        # the stage API (slice_params, stage_prefill, ...) exists for the dense
        # family only; MambaLM and HybridLM serve through prefill/decode_step
        not_ported(**{f"family={cfg.family} in the cluster": cfg.family != "dense",
                      "replication": replication, "compress_replicas": compress_replicas,
                      "tiered": tiered, "host_cache_blocks": host_cache_blocks,
                      "ssd_cache_blocks": ssd_cache_blocks,
                      "swapping with paged=True": swapping and paged,
                      "mode=disaggregated with paged=True": paged and mode != "colocated"})
        self.cfg = cfg
        self.model = model
        self.params = params
        self.device = resolve_device(device)
        self.mode = mode
        self.swapping = swapping
        self.paged = paged
        self.kv_block_size = kv_block_size or cfg.kv_block_size
        self.kv_pool_blocks = kv_pool_blocks or cfg.kv_pool_blocks or 512
        self.prefill_chunk_tokens = (cfg.prefill_chunk_tokens
                                     if prefill_chunk_tokens is None
                                     else prefill_chunk_tokens)
        self.fused_rounds = cfg.fused_rounds if fused_rounds is None else fused_rounds
        self.net = NetworkTransport()
        if mode == "colocated":
            self.prompt_group = self.token_group = self._build_group(n_workers, wid0=0)
        else:
            dp, dt = dp_split
            self.prompt_group = self._build_group(dp, wid0=0)
            self.token_group = self._build_group(dt, wid0=dp)
        if paged:
            for w in self.token_group:
                w.enable_paging(self.kv_pool_blocks, self.kv_block_size)
        # microbatch (run() path) bookkeeping: KV length, cache length, batch
        self.mb_pos: Dict[int, int] = {}
        self.mb_max_len: Dict[int, int] = {}
        self.mb_batch: Dict[int, int] = {}
        # paged (per-sequence) bookkeeping
        self.seq_len: Dict[int, int] = {}       # live tokens per sequence
        self.seq_hashes: Dict[int, List[int]] = {}
        self.kv_bytes_peak = 0
        self._pending_prefill: Dict[int, dict] = {}
        # pipeline passes run, by kind; "one_token" counts the passes whose
        # attention ran with one query per sequence (every decode pass, and
        # any prefill pass whose longest chunk is a single token)
        self.pass_counts: Counter = Counter()

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

    def _build_group(self, depth: int, wid0: int) -> List[StageWorker]:
        ranges = _stage_ranges(self.cfg.num_layers, depth)
        return [StageWorker(wid0 + i, self.model, self.params, lo, hi, first=(i == 0),
                            last=(i == len(ranges) - 1), device=self.device)
                for i, (lo, hi) in enumerate(ranges)]

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
        self.mb_max_len[mb] = max_len
        x = tokens
        for w in self.prompt_group:
            x = w.prefill(mb, x, max_len)
        self._count_pass("mb_prefill", plen)
        if self.mode == "disaggregated":
            self._stream_prompt_kv(mb, plen)
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
        if self.swapping:
            for w in self.token_group:
                w.restore(mb)
        x = self._tokens(token)
        for w in self.token_group:
            x = w.decode(mb, x, pos)
        self._count_pass("mb_decode", 1)
        self.mb_pos[mb] = pos + 1
        if self.swapping:
            for w in self.token_group:
                w.offload(mb, token_range=(pos, pos + 1))
        self._track_kv_peak()
        return x

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
        """Advance the cursor and, in chunk mode, publish the prefix hashes
        of the blocks whose pages the cursor just completed (a whole-prompt
        pass publishes them as it allocates)."""
        st["pos"] += n_q
        if st["mode"] == "chunk":
            for w in self.prompt_group:
                w.publish_prefix_hashes(rid, self.seq_hashes[rid], st["pos"])

    def _finish_prefill(self, rid: int) -> torch.Tensor:
        st = self._pending_prefill.pop(rid)
        self._track_kv_peak()
        return st["x"]

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
        for w in self.token_group:
            if w.pool.append_needs_block(rid) and w.pool.num_free() == 0:
                raise PoolExhausted(f"worker {w.wid} pool full (seq {rid})")
        x = self._tokens(token)
        for w in self.token_group:
            x = w.decode_paged(rid, x, pos)
        self.seq_len[rid] = pos + 1
        self._count_pass("perseq_decode", 1)
        self._track_kv_peak()
        return x

    def decode_batch(self, rids: List[int], tokens, steps: List[int]) -> torch.Tensor:
        """One pipeline pass that decodes every sequence in `rids` one step.
        Capacity is pre-flighted across the whole batch, so PoolExhausted
        raises before any pool mutates.  Returns logits [B,V]."""
        poses = [self.seq_len[rid] for rid in rids]
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
        self._track_kv_peak()
        return x

    def prefill_chunkset_pass(self, rids: List[int]
                              ) -> Dict[int, Optional[torch.Tensor]]:
        """Advance the staged prefills of all `rids` by one chunk each in ONE
        pipeline pass.  Ragged chunks are padded to the longest and masked
        inside the pass.  Returns {rid: prefill logits | None}."""
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
        """Retire a finished sequence: its blocks return to the pool."""
        for w in self.token_group:
            w.free_paged_seq(rid)
        self.seq_len.pop(rid, None)
        self.seq_hashes.pop(rid, None)
        self._pending_prefill.pop(rid, None)
