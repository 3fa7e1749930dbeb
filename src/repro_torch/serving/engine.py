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
pass per sequence, the path the fused one is tested against.  It serves
colocated or disaggregated (the prompt pipeline streams each prompt's blocks
to the token pipeline), with or without swapping.  ``tiered=True`` backs
every stage's pool with host memory and SSD (`repro_torch.kvcache.tiers`,
capacities ``host_cache_blocks`` and ``ssd_cache_blocks``): preemption swaps
through the tiers, retired prompt blocks enter a prefix cache, and a prompt
that shares a cached prefix adopts it instead of prefilling it
(`EngineReport.prefill_tokens_saved`, `tier_stats`).

With greedy sampling every path gives the same tokens.

Failure injection, detection and 4-step recovery run between steps in both
loops (``replication=True``): ``fail_at={step: wid}``, or a `FaultPlan` /
`FaultInjector` of `dejavulib.faults`.  Recovered work rolls back to its
last replicated step and regenerates the same tokens.  Only `WorkerDead`
starts a recovery; any other error propagates.  `run` also takes
``migrate_at`` (straggler migration) and ``repartition_at`` (elastic
re-split of the token pipeline).

Telemetry and tracing: each run records into the process-wide registry
(`core.telemetry`), an ambient one if installed (it is reused and left
installed, so runs aggregate into it), else a fresh one for the run.
Rounds and passes are spans on the modeled clock, which the cluster
advances by the cost model's time for each pass (`hw`, by default the
H100's datasheet figures); at each emitted token the
engine observes ``engine.ttft_s``, ``engine.inter_token_s`` and, at the
first token after a kill, ``cluster.recovery_s``.  A tracer installed
around the run (`core.tracing`) records the same events per request.
`EngineReport.telemetry` holds the registry's snapshot
(``repro.telemetry/v1``) and `prefill_stall_trace` the modeled prefill
seconds of each round that decoded.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core import telemetry, tracing
from repro_torch.core.cluster import DejaVuCluster
from repro_torch.core.dejavulib import faults
from repro_torch.core.dejavulib.transport import DEFAULT_HW, HardwareModel
from repro_torch.core.worker import WorkerDead
from repro_torch.kvcache.paged import PoolExhausted
from repro_torch.serving.request import Microbatch, Request, form_microbatches
from repro_torch.serving.sampling import greedy
from repro_torch.serving.scheduler import RoundScheduler, StepPlan


@dataclass
class EngineReport:
    tokens: Dict[int, List[int]]            # rid -> generated tokens
    steps_executed: int = 0
    steps_redone: int = 0
    failures: int = 0
    recoveries: int = 0
    preemptions: int = 0
    peak_kv_bytes: int = 0
    # one entry per round: live batch size that round
    batch_trace: List[int] = field(default_factory=list)
    # one entry per round: pipeline passes executed that round
    pass_trace: List[int] = field(default_factory=list)
    # pipeline passes by kind over the run (see DejaVuCluster.pass_counts)
    pass_counts: Dict[str, int] = field(default_factory=dict)
    # one dict per fault the run's FaultInjector realised (point, n, kind,
    # tag, wid)
    fault_trace: List[dict] = field(default_factory=list)
    # one dict per failure delivered in the run: the wall ms of each
    # recovery step (DejaVuCluster.recovery_log) and, under
    # "first_token_ms", from the kill to the first token emitted after it
    recovery_log: List[dict] = field(default_factory=list)
    # one entry per continuous-batching round that ran a decode step: the
    # modeled prefill seconds co-scheduled in that round (the stall a long
    # prompt inflicts on the decodes; chunking bounds it to one chunk pass)
    prefill_stall_trace: List[float] = field(default_factory=list)
    # cross-request prefix reuse through the KV tiers (tiered=True): prompt
    # tokens prefilled or adopted, those served from cache, and the summed
    # tier counters (DejaVuCluster.tier_stats)
    prefill_tokens_total: int = 0
    prefill_tokens_saved: int = 0
    tier_stats: Dict[str, float] = field(default_factory=dict)
    # the telemetry snapshot (schema `repro.telemetry/v1`): counters,
    # gauges, the SLO histograms (TTFT, inter-token gap, queue wait,
    # recovery time) and span aggregates on the modeled clock; cumulative
    # across runs when an ambient registry is installed
    telemetry: Dict[str, object] = field(default_factory=dict)


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
                 fused_rounds: Optional[bool] = None, hw: HardwareModel = DEFAULT_HW,
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
            prefill_chunk_tokens=prefill_chunk_tokens, fused_rounds=fused_rounds, hw=hw,
            device=device)
        self._log0 = 0
        self._open_recoveries: List[dict] = []
        # rid -> the modeled clock at its last emitted token (inter-token gap)
        self._emit_clock: Dict[int, float] = {}
        self._round_passes = 0
        self._round_decodes = 0

    # ------------------------------------------------------------------
    # telemetry (shared by both serving loops)
    # ------------------------------------------------------------------
    @staticmethod
    def _install_telemetry() -> Tuple[telemetry.Telemetry, bool]:
        """The ambient registry if one is installed (it aggregates across
        runs), else a fresh one for this run.  Returns (registry, created)."""
        t = telemetry.current()
        if t is not None:
            return t, False
        t = telemetry.Telemetry()
        telemetry.install(t)
        return t, True

    @staticmethod
    def _teardown_telemetry(t: telemetry.Telemetry, created: bool,
                            report: EngineReport) -> None:
        report.telemetry = t.snapshot()
        if created:
            telemetry.uninstall()

    def _tele_emit(self, requests: List[Request], i: int) -> None:
        """The per-token SLO observations at emit time, on the modeled clock:
        time to first token (arrival to token 0), the inter-token gap, and,
        at the first token after a kill, the recovery time."""
        t = telemetry.current()
        if t is None:
            return
        now = t.clock_s
        trc = tracing.active()
        for r in requests:
            if i == 0:
                ttft = max(now - r.arrival, 0.0)
                t.observe("engine.ttft_s", ttft)
                if trc:
                    tracing.event("emit.first_token", rid=r.rid, ttft_ns=int(round(ttft * 1e9)))
            else:
                prev = self._emit_clock.get(r.rid)
                if prev is not None:
                    t.observe("engine.inter_token_s", max(now - prev, 0.0))
            self._emit_clock[r.rid] = now
        for mark in self.cluster.take_recovery_marks():
            rec = max(now - mark, 0.0)
            t.observe("cluster.recovery_s", rec)
            if trc:
                # kill -> the first token after the restore, on the modeled clock
                tracing.event("recovery.first_token", recovery_ns=int(round(rec * 1e9)))

    # ------------------------------------------------------------------
    # fault injection (shared by both serving loops)
    # ------------------------------------------------------------------
    def _install_faults(self, fail_at, fault_plan, fault_injector, report: EngineReport
                        ) -> Tuple[Optional[faults.FaultInjector], object]:
        """Bind this run's FaultInjector and install it as the process-wide
        active injector.  ``fail_at={gstep: wid}`` becomes ``engine.step``
        worker_death specs (that point fires once per scheduled step, so
        occurrence == gstep).  Returns (injector, the injector it replaced)
        for `_teardown_faults`."""
        if fault_injector is None and not fail_at and fault_plan is None:
            return None, None
        inj = fault_injector if fault_injector is not None \
            else faults.FaultInjector(fault_plan)
        for g, w in sorted((fail_at or {}).items()):
            inj.plan.add(faults.FaultSpec("engine.step", nth=g, kind="worker_death", wid=w))

        def kill(wid):
            self.cluster.inject_failure(wid)
            report.failures += 1

        inj.worker_killer = kill
        prev = faults.current()
        faults.install(inj)
        return inj, prev

    @staticmethod
    def _teardown_faults(inj, prev, report: EngineReport) -> None:
        if inj is None:
            return
        if prev is None:
            faults.uninstall()
        else:
            faults.install(prev)
        report.fault_trace = [asdict(f) for f in inj.fired]

    def _start(self, requests: List[Request], fail_at, fault_plan, fault_injector):
        report = EngineReport(tokens={r.rid: r.tokens for r in requests})
        inj, prev = self._install_faults(fail_at, fault_plan, fault_injector, report)
        self._log0 = len(self.cluster.recovery_log)     # this run's first failure
        self._emit_clock = {}
        tele = self._install_telemetry()
        return report, (inj, prev, dict(self.cluster.pass_counts), tele)

    def _finish(self, report: EngineReport, ctx, bubble_frac: float) -> None:
        """Tear down what `_start` installed: `ctx` is its second result.
        `bubble_frac` goes to the ``engine.bubble_frac`` gauge."""
        cl = self.cluster
        inj, prev, counts0, (tele, tele_created) = ctx
        tele.gauge("engine.bubble_frac", bubble_frac)
        self._teardown_faults(inj, prev, report)
        self._teardown_telemetry(tele, tele_created, report)
        report.peak_kv_bytes = cl.kv_bytes_peak
        report.pass_counts = {k: v - counts0.get(k, 0) for k, v in cl.pass_counts.items()}
        report.recovery_log = [{k: v for k, v in r.items() if k != "t_fail"}
                               for r in cl.recovery_log[self._log0:]]
        self._open_recoveries = []

    def _recovered(self, report: EngineReport) -> None:
        """Count one recovery and open its clock: the next emitted token
        closes it (`_emit`)."""
        report.recoveries += 1
        self._open_recoveries = [r for r in self.cluster.recovery_log[self._log0:]
                                 if "detect_ms" in r and "first_token_ms" not in r]

    # ------------------------------------------------------------------
    def run(self, requests: List[Request], *,
            fail_at: Optional[Dict[int, int]] = None,
            migrate_at: Optional[Dict[int, int]] = None,
            repartition_at: Optional[Dict[int, int]] = None,
            fault_plan: Optional[faults.FaultPlan] = None,
            fault_injector: Optional[faults.FaultInjector] = None) -> EngineReport:
        """Microbatch round-robin: requests group into length-homogeneous
        microbatches of `microbatch`; each round, every occupied slot (one
        per token-pipeline stage) advances its microbatch one step, and a
        drained slot takes the next microbatch from the queue.

        fail_at / migrate_at: {global step: wid}; repartition_at: {global
        step: new depth}.  A step that reaches a dead worker triggers
        detect-and-recover, then runs again."""
        migrate_at = dict(migrate_at or {})
        repartition_at = dict(repartition_at or {})
        cl = self.cluster
        queue = form_microbatches(requests, self.microbatch)
        slots: List[Optional[Microbatch]] = [None] * len(cl.token_group)
        report, ctx = self._start(requests, fail_at, fault_plan, fault_injector)
        gstep = 0
        slot_rounds = slot_busy = 0      # microbatch-slot occupancy: the bubbles

        def active_ids() -> List[int]:
            return [s.mb for s in slots if s is not None]

        try:
            while any(s is not None for s in slots) or queue:
                for q, mb in enumerate(slots):
                    if mb is None and queue:
                        slots[q] = queue.pop(0)
                slot_rounds += len(slots)
                slot_busy += sum(s is not None for s in slots)
                with telemetry.span("round"), tracing.span("round"):
                    for q, mb in enumerate(slots):
                        if mb is None:
                            continue
                        gstep += 1
                        # scheduled control events
                        faults.fire("engine.step", tag=f"mb{mb.mb}")
                        if gstep in migrate_at:
                            res = cl.migrate_worker(migrate_at.pop(gstep), active_ids())
                            self._recovered(report)
                            self._apply_resume(res, slots, report)
                        if gstep in repartition_at:
                            cl.repartition(repartition_at.pop(gstep), active_ids())
                        try:
                            self._advance(mb, report)
                        except WorkerDead:
                            # a dead worker hit mid-pipeline: detect, recover
                            # and run the step again
                            self._apply_resume(cl.detect_and_recover(active_ids()), slots,
                                               report)
                            self._recovered(report)
                            self._advance(mb, report)
                        if mb.done:
                            slots[q] = None
        finally:
            # empty microbatch slots are the pipeline bubbles of the paper's
            # setting (a slot drains at the pace of its slowest member)
            self._finish(report, ctx, 1.0 - slot_busy / slot_rounds if slot_rounds else 0.0)
        return report

    def _apply_resume(self, resume: Dict[int, int], slots: List[Optional[Microbatch]],
                      report: EngineReport) -> None:
        for s in slots:
            if s is not None and s.mb in resume:
                r = resume[s.mb]
                report.steps_redone += max(0, s.next_step - r)
                s.next_step = min(s.next_step, max(r, 0))
                for req in s.requests:   # drop the tokens past the resume point
                    del req.tokens[s.next_step:]

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
        """Bytes moved so far, by transport kind (hostlink, net, local, and
        ssd with the tiers)."""
        out: Dict[str, int] = {}
        transports = [self.cluster.net]
        for w in self.cluster.workers():
            transports += [w.cache.net, w.cache.hostlink, w.cache.local]
            if w.tier is not None:
                transports += [w.tier.hostlink, w.tier.ssdlink]
        for t in transports:
            out[t.kind] = out.get(t.kind, 0) + t.bytes_total()
        return out

    def run_continuous(self, requests: List[Request], *, max_active: int = 4,
                       fail_at: Optional[Dict[int, int]] = None,
                       fault_plan: Optional[faults.FaultPlan] = None,
                       fault_injector: Optional[faults.FaultInjector] = None
                       ) -> EngineReport:
        """Continuous-batching loop: per round, the scheduler resumes
        preempted and admits queued requests (each admission runs its first
        step at once), every live request advances one step, and finished
        requests retire.  Each request generates `max_new` tokens (or stops
        at eos).  `fail_at` counts per-request steps as `run` counts global
        steps."""
        cl = self.cluster
        if not cl.paged:
            raise ValueError("run_continuous needs ServingEngine(..., paged=True)")
        sched = RoundScheduler(cl, requests, max_active=max_active)
        report, ctx = self._start(requests, fail_at, fault_plan, fault_injector)
        clock0 = telemetry.clock()
        fused = cl.fused_ok
        try:
            while sched.pending():
                cl.round_prefill_model_s = 0.0
                self._round_passes = 0
                self._round_decodes = 0
                with telemetry.span("round"), tracing.span("round"):
                    plan = sched.plan_round(lambda r: self._advance_seq(r, sched, report))
                    report.batch_trace.append(plan.n_active)
                    if tracing.active():
                        tracing.event("sched.plan", round=plan.round_idx,
                                      n_active=plan.n_active, rids=[r.rid for r in plan.work])
                    if fused:
                        self._execute_round_fused(plan, sched, report)
                    else:
                        self._execute_round(plan, sched, report)
                    sched.retire()
                if self._round_decodes:
                    report.prefill_stall_trace.append(cl.round_prefill_model_s)
                report.pass_trace.append(self._round_passes)
        finally:
            # the bubble fraction: the share of the run's modeled time that
            # decodes spent stalled behind co-scheduled prefill passes
            busy = telemetry.clock() - clock0
            stall = sum(report.prefill_stall_trace)
            self._finish(report, ctx, stall / busy if busy > 0.0 else 0.0)
        report.prefill_tokens_total = cl.prefill_tokens_total
        report.prefill_tokens_saved = cl.prefill_tokens_saved
        if cl.tiered:
            report.tier_stats = cl.tier_stats()
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
                    self._advance_seq(r, sched, report)
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
        pass each.  After a worker death is recovered, the prefills it
        rolled back begin again next round, and the round goes on to its
        decode pass."""
        cl = self.cluster
        for r in pf:            # one logical step per packed prefill, so the
            # engine.step occurrences land as on the per-sequence path
            faults.fire("engine.step", tag=f"prefill-r{r.rid}")
        try:
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
        except WorkerDead:
            self._recover_fused(sched, report)

    def _finish_prefill_step(self, r: Request, logits, sched: RoundScheduler) -> None:
        if logits is None:
            return              # prefill still in flight
        self._emit([r], self.sampler(logits, 0), 0)
        sched.next_step[r.rid] = 1

    def _fused_decode_pass(self, dec: List[Request], sched: RoundScheduler,
                           report: EngineReport) -> None:
        """One batched decode pass.  A worker death inside it is recovered
        and the pass runs again at once over the sequences still due a step
        (as `run` and the per-sequence path re-execute theirs), so a failure
        that rolls nothing back leaves the schedule, and every later batch's
        shapes, as they were."""
        for r in dec:
            faults.fire("engine.step", tag=f"decode-r{r.rid}")
        while True:
            steps = [sched.next_step[r.rid] for r in dec]
            last = np.asarray([r.tokens[s - 1] for r, s in zip(dec, steps)], np.int32)
            try:
                logits = self.cluster.decode_batch([r.rid for r in dec], last, steps)
                break
            except WorkerDead:
                self._recover_fused(sched, report)
                dec = [r for r in dec if sched.is_active(r.rid) and not r.done
                       and 1 <= sched.next_step[r.rid] < r.max_new]
                if not dec:
                    return
        self._round_passes += 1
        for i, (r, s) in enumerate(zip(dec, steps)):
            self._emit([r], self.sampler(logits[i:i + 1], s), s)
            sched.next_step[r.rid] = s + 1
            self._round_decodes += 1
            report.steps_executed += 1

    def _recover_fused(self, sched: RoundScheduler, report: EngineReport) -> None:
        """Detect and recover after a worker died inside a fused pass: every
        covered sequence rolls back to its last replicated step (one still
        in prefill starts again), as on the per-sequence path."""
        cl = self.cluster
        covered = sched.covered()
        resume = cl.detect_and_recover([a.rid for a in covered if not a.done])
        self._recovered(report)
        self._apply_resume_seqs(resume, covered, sched.next_step, report)
        for rr in covered:
            if sched.next_step.get(rr.rid, 1) == 0:
                cl.abort_prefill(rr.rid)

    def _advance_seq(self, r: Request, sched: RoundScheduler, report: EngineReport) -> None:
        """One per-request step (prefill while next_step is 0, else decode)
        with detect-and-recover: preempted sequences join the recovery set,
        since their swap copies on the failed worker die with it."""
        cl = self.cluster
        next_step = sched.next_step
        faults.fire("engine.step", tag=f"r{r.rid}")
        covered = sched.covered()
        live = [a.rid for a in covered if not a.done]
        if r.rid not in live:
            live.append(r.rid)
        try:
            self._step_seq(r, next_step, report)
        except WorkerDead:
            resume = cl.detect_and_recover(live)
            self._recovered(report)
            self._apply_resume_seqs(resume, covered + [r], next_step, report)
            # a worker death takes mid-prefill partial tables with it (their
            # sequences have no replicated step to restore from): begin those
            # prefills again on the recovered cluster
            for rr in covered + [r]:
                if next_step.get(rr.rid, 1) == 0:
                    cl.abort_prefill(rr.rid)
            self._step_seq(r, next_step, report)

    @staticmethod
    def _apply_resume_seqs(resume: Dict[int, int], requests: List[Request],
                           next_step: Dict[int, int], report: EngineReport) -> None:
        seen = set()
        for r in requests:
            if r.rid in seen or r.rid not in resume:
                continue
            seen.add(r.rid)
            rr = max(resume[r.rid], 0)
            report.steps_redone += max(0, next_step[r.rid] - rr)
            next_step[r.rid] = min(next_step[r.rid], rr)
            del r.tokens[next_step[r.rid]:]

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
            self._round_decodes += 1
            report.steps_executed += 1
        self._emit([r], self.sampler(logits, i), i)
        next_step[r.rid] = i + 1

    def _emit(self, requests: List[Request], tok: np.ndarray, i: int) -> None:
        """Token i of each request from the sampled row of the same index;
        the first token after a recovery closes its wall clock and the
        modeled one (`_tele_emit`)."""
        for b, r in enumerate(requests):
            if len(r.tokens) == i:
                r.tokens.append(int(tok[b]))
            else:                      # regeneration after a rollback
                r.tokens[i] = int(tok[b])
            if r.eos_id is not None and int(tok[b]) == r.eos_id:
                r.done = True
        if self._open_recoveries:
            now = time.perf_counter()
            for rec in self._open_recoveries:
                rec["first_token_ms"] = (now - rec["t_fail"]) * 1e3
            self._open_recoveries = []
        self._tele_emit(requests, i)
