"""ServingEngine of the port (counterpart of `repro.serving.engine`).

Two schedulers share the cluster and the sampler:

`run`: microbatch round-robin (FasterTransformer semantics, the paper's
setting).  In-flight microbatch slots, one per pipeline stage, advance one
step per round; a slot frees only when its whole microbatch drains, and each
microbatch holds a padded prompt+max_new cache for its lifetime.  Empty
slots are the pipeline bubbles of the paper's Fig. 4.  Colocated or
disaggregated, with or without swapping.

`run_continuous` (``paged=True``): continuous batching over the paged KV
pool.  Requests are admitted into the running batch as blocks free up,
finished sequences retire and release their blocks at once, and a full pool
preempts the youngest sequence (block-granular swap to host memory).  With
fused rounds on (the default) a round runs one batched decode pass plus one
chunk-set pass for the prefills in flight; ``fused_rounds=False`` runs one
pass per sequence, the path the fused one is tested against.

With greedy sampling every path gives the same tokens.  Not in this slice
(NotImplementedError where asked for): fault injection and recovery,
migration and repartition, telemetry and tracing with the modeled clock,
and sampling other than a given callable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch import not_ported
from repro_torch.configs.base import ArchConfig
from repro_torch.core.cluster import DejaVuCluster
from repro_torch.kvcache.paged import PoolExhausted
from repro_torch.serving.request import Microbatch, Request, form_microbatches
from repro_torch.serving.sampling import greedy
from repro_torch.serving.scheduler import RoundScheduler, StepPlan


@dataclass
class EngineReport:
    tokens: Dict[int, List[int]]            # rid -> generated tokens
    steps_executed: int = 0
    preemptions: int = 0
    peak_kv_bytes: int = 0
    # one entry per round: live batch size that round
    batch_trace: List[int] = field(default_factory=list)
    # one entry per round: pipeline passes executed that round
    pass_trace: List[int] = field(default_factory=list)
    # pipeline passes by kind over the run (see DejaVuCluster.pass_counts)
    pass_counts: Dict[str, int] = field(default_factory=dict)


class ServingEngine:
    def __init__(self, cfg: ArchConfig, model, params, n_workers: int, *,
                 mode: str = "colocated", dp_split: Optional[tuple] = None,
                 microbatch: int = 2, swapping: bool = False, replication: bool = False,
                 compress_replicas: bool = False, paged: bool = False,
                 kv_block_size: Optional[int] = None,
                 kv_pool_blocks: Optional[int] = None, tiered: bool = False,
                 host_cache_blocks: Optional[int] = None,
                 ssd_cache_blocks: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 fused_rounds: Optional[bool] = None,
                 sampler: Callable = greedy, device="cuda"):
        self.cfg = cfg
        self.microbatch = microbatch
        self.sampler = sampler
        self.cluster = DejaVuCluster(
            cfg, model, params, n_workers, mode=mode, dp_split=dp_split,
            swapping=swapping, replication=replication,
            compress_replicas=compress_replicas, paged=paged,
            kv_block_size=kv_block_size, kv_pool_blocks=kv_pool_blocks,
            tiered=tiered, host_cache_blocks=host_cache_blocks,
            ssd_cache_blocks=ssd_cache_blocks,
            prefill_chunk_tokens=prefill_chunk_tokens, fused_rounds=fused_rounds,
            device=device)

    def run(self, requests: List[Request], *,
            fail_at: Optional[Dict[int, int]] = None,
            migrate_at: Optional[Dict[int, int]] = None,
            repartition_at: Optional[Dict[int, int]] = None,
            fault_plan=None, fault_injector=None) -> EngineReport:
        """Microbatch round-robin: requests group into length-homogeneous
        microbatches of `microbatch`; each round, every occupied slot (one
        per token-pipeline stage) advances its microbatch one step, and a
        drained slot takes the next microbatch from the queue."""
        not_ported(fail_at=fail_at, migrate_at=migrate_at, repartition_at=repartition_at,
                   fault_plan=fault_plan, fault_injector=fault_injector)
        cl = self.cluster
        queue = form_microbatches(requests, self.microbatch)
        slots: List[Optional[Microbatch]] = [None] * len(cl.token_group)
        report = EngineReport(tokens={r.rid: r.tokens for r in requests})
        counts0 = dict(cl.pass_counts)
        while any(s is not None for s in slots) or queue:
            for q, mb in enumerate(slots):
                if mb is None and queue:
                    slots[q] = queue.pop(0)
            for q, mb in enumerate(slots):
                if mb is None:
                    continue
                self._advance(mb, report)
                if mb.done:
                    slots[q] = None
        report.peak_kv_bytes = cl.kv_bytes_peak
        report.pass_counts = {k: v - counts0.get(k, 0) for k, v in cl.pass_counts.items()}
        return report

    def _advance(self, mb: Microbatch, report: EngineReport) -> None:
        """One pipeline pass of a microbatch: its prefill (token 0), else
        decode step i (consuming token i-1).  A microbatch emits n_new
        tokens in all."""
        cl = self.cluster
        i = mb.next_step
        if i == 0:
            logits = cl.prefill_mb(mb.mb, mb.batch_prompts(), mb.n_new)
        else:
            last = np.asarray([r.tokens[i - 1] if len(r.tokens) >= i else 0
                               for r in mb.requests], np.int32)
            logits = cl.decode_mb(mb.mb, last, i)
        self._emit(mb.requests, self.sampler(logits, i), i)
        mb.next_step = i + 1
        report.steps_executed += 1
        if mb.next_step >= mb.n_new:
            mb.done = True

    def transfer_summary(self) -> Dict[str, int]:
        """Bytes moved so far, by transport kind (hostlink, net, local)."""
        out: Dict[str, int] = {}
        transports = [self.cluster.net]
        for w in self.cluster.workers():
            transports += [w.cache.net, w.cache.hostlink, w.cache.local]
        for t in transports:
            out[t.kind] = out.get(t.kind, 0) + t.bytes_total()
        return out

    def run_continuous(self, requests: List[Request], *, max_active: int = 4,
                       fail_at: Optional[Dict[int, int]] = None,
                       fault_plan=None, fault_injector=None) -> EngineReport:
        """Continuous-batching loop: per round, the scheduler resumes
        preempted and admits queued requests (each admission runs its first
        step at once), every live request advances one step, and finished
        requests retire.  Each request generates `max_new` tokens (or stops
        at eos)."""
        not_ported(fail_at=fail_at, fault_plan=fault_plan,
                   fault_injector=fault_injector)
        cl = self.cluster
        if not cl.paged:
            raise ValueError("run_continuous needs ServingEngine(..., paged=True)")
        sched = RoundScheduler(cl, requests, max_active=max_active)
        report = EngineReport(tokens={r.rid: r.tokens for r in requests})
        counts0 = dict(cl.pass_counts)
        fused = cl.fused_ok
        while sched.pending():
            self._round_passes = 0
            plan = sched.plan_round(lambda r: self._step_seq(r, sched.next_step, report))
            report.batch_trace.append(plan.n_active)
            if fused:
                self._execute_round_fused(plan, sched, report)
            else:
                self._execute_round(plan, sched, report)
            sched.retire()
            report.pass_trace.append(self._round_passes)
        report.peak_kv_bytes = cl.kv_bytes_peak
        report.pass_counts = {k: v - counts0.get(k, 0) for k, v in cl.pass_counts.items()}
        return report

    # ------------------------------------------------------------------
    # per-sequence path: one pipeline pass per request per round
    # ------------------------------------------------------------------
    def _execute_round(self, plan: StepPlan, sched: RoundScheduler,
                       report: EngineReport) -> None:
        for r in plan.work:
            if not sched.is_active(r.rid):
                continue        # dropped by a mid-round preemption
            if sched.next_step[r.rid] >= r.max_new or r.done:
                continue        # budget spent at admission (or eos'd)
            while True:
                try:
                    self._step_seq(r, sched.next_step, report)
                    break
                except PoolExhausted:
                    self._preempt_victim_or_raise(sched, report, exclude=(r.rid,))

    # ------------------------------------------------------------------
    # fused rounds: one batched decode pass per round (+ one chunk-set pass
    # while prefills are in flight)
    # ------------------------------------------------------------------
    def _execute_round_fused(self, plan: StepPlan, sched: RoundScheduler,
                             report: EngineReport) -> None:
        # snapshot the round's split before running anything: every request
        # advances one step per round, so a prompt whose prefill completes
        # this round decodes only from the next round on
        pf = [r for r in plan.work if sched.is_active(r.rid)
              and sched.next_step[r.rid] == 0 and not r.done]
        dec0 = [r for r in plan.work if sched.next_step[r.rid] >= 1]
        if pf:
            self._fused_prefill_pass(pf, sched, report)
        while True:
            dec = [r for r in dec0 if sched.is_active(r.rid) and not r.done
                   and 1 <= sched.next_step[r.rid] < r.max_new]
            if not dec:
                return
            try:
                self._fused_decode_pass(dec, sched, report)
                return
            except PoolExhausted:
                # the whole batch is "the current request": shrink the round
                # by preempting the youngest resident sequence and retry
                if len(dec) == 1:
                    self._preempt_victim_or_raise(sched, report, exclude=(dec[0].rid,))
                else:
                    self._preempt_victim_or_raise(sched, report)

    def _preempt_victim_or_raise(self, sched: RoundScheduler, report: EngineReport,
                                 exclude=()) -> None:
        """Handle a full pool mid-round: swap out the scheduler's chosen
        victim and let the caller retry, or re-raise the active
        PoolExhausted when nothing preemptible remains."""
        victim = sched.pick_victim(exclude=exclude)
        if victim is None:
            raise
        self.cluster.preempt_seq(victim.rid)
        sched.preempt(victim)
        report.preemptions += 1

    def _fused_prefill_pass(self, pf: List[Request], sched: RoundScheduler,
                            report: EngineReport) -> None:
        """Advance every in-flight prefill: chunk-mode prefills one chunk
        each in one pipeline pass, whole-prompt ones (chunking off) in a
        pass each."""
        cl = self.cluster
        for r in pf:
            while not cl.prefill_pending(r.rid):
                try:
                    cl.prefill_seq_begin(r.rid, r.prompt, r.max_new)
                except PoolExhausted:
                    self._preempt_victim_or_raise(sched, report)
        chunk = [r for r in pf if cl.prefill_mode(r.rid) == "chunk"]
        rest = [r for r in pf if cl.prefill_mode(r.rid) != "chunk"]
        if chunk:
            out = cl.prefill_chunkset_pass([r.rid for r in chunk])
            self._round_passes += 1
            report.steps_executed += len(chunk)
            for r in chunk:
                self._finish_prefill_step(r, out[r.rid], sched)
        for r in rest:
            while True:
                try:
                    logits = cl.prefill_seq_step(r.rid)
                    break
                except PoolExhausted:
                    self._preempt_victim_or_raise(sched, report)
            self._round_passes += 1
            report.steps_executed += 1
            self._finish_prefill_step(r, logits, sched)

    def _finish_prefill_step(self, r: Request, logits, sched: RoundScheduler) -> None:
        if logits is None:
            return              # prefill still in flight
        self._emit([r], self.sampler(logits, 0), 0)
        sched.next_step[r.rid] = 1

    def _fused_decode_pass(self, dec: List[Request], sched: RoundScheduler,
                           report: EngineReport) -> None:
        steps = [sched.next_step[r.rid] for r in dec]
        last = np.asarray([r.tokens[s - 1] for r, s in zip(dec, steps)], np.int32)
        logits = self.cluster.decode_batch([r.rid for r in dec], last, steps)
        self._round_passes += 1
        for i, (r, s) in enumerate(zip(dec, steps)):
            self._emit([r], self.sampler(logits[i:i + 1], s), s)
            sched.next_step[r.rid] = s + 1
            report.steps_executed += 1

    def _step_seq(self, r: Request, next_step: Dict[int, int],
                  report: EngineReport) -> None:
        """One pipeline pass for one request: a prefill chunk while
        next_step is 0 (it stays 0 until the final chunk returns the
        prefill logits), else one decode step."""
        cl = self.cluster
        i = next_step[r.rid]
        self._round_passes += 1
        if i == 0:
            if not cl.prefill_pending(r.rid):
                cl.prefill_seq_begin(r.rid, r.prompt, r.max_new)
            logits = cl.prefill_seq_step(r.rid)
            report.steps_executed += 1
            if logits is None:
                return                   # prefill still in flight
        else:
            logits = cl.decode_seq(r.rid, np.asarray([r.tokens[i - 1]], np.int32), i)
            report.steps_executed += 1
        self._emit([r], self.sampler(logits, i), i)
        next_step[r.rid] = i + 1

    @staticmethod
    def _emit(requests: List[Request], tok: np.ndarray, i: int) -> None:
        """Token i of each request from the sampled row of the same index."""
        for b, r in enumerate(requests):
            if len(r.tokens) == i:
                r.tokens.append(int(tok[b]))
            else:
                r.tokens[i] = int(tok[b])
            if r.eos_id is not None and int(tok[b]) == r.eos_id:
                r.done = True
