"""The port's KV tiers (`repro_torch.kvcache.tiers`, the SSD store and
transport) against the JAX package's, held by `run_continuous`.

Unit level: `SSDStore` and `KVTierManager` of both packages on the same
numpy blocks: prefix chains and swapped sequences round-trip through host
and SSD with every capacity, `reattach` rebuilds the index from the disk,
the LRU spill and the MRU prefix eviction pick the same victims, and every
counter of `stats()` is equal.  A crash at ``ssd.put`` leaves the old block
or none, never a torn one; a bfloat16 block comes back from the disk bit
for bit; an fp32 block's file is the JAX store's, byte for byte (`reattach`
prices a restore by its size).

Engine level: the cases of `tests/test_tiered_kv.py:248-392` and
`tests/test_fused_rounds.py:132`, on reduced gpt2-1.5b (fp32, 2 layers,
4:2 GQA, blocks of 8) with weights bridged from the JAX params, through both
engines with a `Telemetry` and a `Tracer` installed: greedy tokens,
`tier_stats` (summed and per stage), `prefill_tokens_saved` and `_total`,
`transfer_summary` and `pool_stats` equal, and on fault-free runs the
registry's and the tracer's JSON equal byte for byte.  SSD roots go under
the test's `tmp_path`.
"""
import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread is faster, and steady on a shared host
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.registry import PAPER_ARCHS  # noqa: E402
from repro.core import telemetry as jax_telemetry  # noqa: E402
from repro.core import tracing as jax_tracing  # noqa: E402
from repro.core.dejavulib import SSDStore as JaxSSDStore  # noqa: E402
from repro.core.dejavulib import StreamEngine as JaxStreamEngine  # noqa: E402
from repro.core.dejavulib import faults as jax_faults  # noqa: E402
from repro.core.dejavulib.transport import HardwareModel as JaxHardwareModel  # noqa: E402
from repro.kvcache import paged as jax_paged  # noqa: E402
from repro.kvcache import tiers as jax_tiers  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import telemetry, tracing  # noqa: E402
from repro_torch.core.dejavulib import SSDStore, StreamEngine, faults  # noqa: E402
from repro_torch.core.dejavulib.transport import HardwareModel  # noqa: E402
from repro_torch.kvcache import BlockPool, KVTierManager, PagedKVCache, TierConfig  # noqa: E402
from repro_torch.kvcache.tiers import TIER_SSD  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402


# the reference's hardware model, so the modeled seconds are comparable
HW = HardwareModel(**dataclasses.asdict(JaxHardwareModel()))


@pytest.fixture(autouse=True)
def _ssd_roots_in_tmp(tmp_path, monkeypatch):
    """Every private SSD root (both packages' `tempfile.mkdtemp`) lies
    under the test's own directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


# ---------------------------------------------------------------------------
# unit level: the tier manager and the SSD store against the reference's
# ---------------------------------------------------------------------------

def _mgrs(tmp_path, host_cap=None, ssd_cap=None, name="t"):
    """(the reference's manager, the port's) over the same pool shape, each
    on a disk of its own."""
    out = []
    for pkg in ("jax", "port"):
        cfg = dict(host_capacity_blocks=host_cap, ssd_capacity_blocks=ssd_cap,
                   ssd_root=str(tmp_path / f"{pkg}-{name}"))
        if pkg == "jax":
            pool = jax_paged.BlockPool(8, 4)
            pages = jax_paged.PagedKVCache(pool, layers=2, num_kv_heads=2, head_dim=4,
                                           dtype="float32")
            out.append(jax_tiers.KVTierManager(pool, pages, JaxStreamEngine(f"jax-{name}"),
                                               cfg=jax_tiers.TierConfig(**cfg), name=name))
        else:
            pool = BlockPool(8, 4)
            pages = PagedKVCache(pool, layers=2, num_kv_heads=2, head_dim=4)
            out.append(KVTierManager(pool, pages, StreamEngine(f"port-{name}"), hw=HW,
                                     cfg=TierConfig(**cfg), name=name))
    return out


def _block(rng, w=4):
    return {"k": rng.standard_normal((2, w, 2, 4)).astype(np.float32),
            "v": rng.standard_normal((2, w, 2, 4)).astype(np.float32)}


def _t(block):
    return {k: torch.from_numpy(v.copy()) for k, v in block.items()}


def _equal(got, want):
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(np.asarray(got[leaf]), want[leaf])


def _same_state(jm, tm):
    assert tm.stats() == jm.stats()
    assert sorted(tm._entries) == sorted(jm._entries)
    assert [(e.kind, e.tier, e.on_ssd, e.nbytes) for e in tm._entries.values()] == \
        [(e.kind, e.tier, e.on_ssd, e.nbytes) for e in jm._entries.values()]
    tm._sync()
    jm._sync()
    assert sorted(tm.host.keys()) == sorted(jm.host.keys())
    assert sorted(tm.ssd.keys()) == sorted(jm.ssd.keys())


# name -> (host capacity, SSD capacity): tier 1 only, spills to SSD, SSD
# only, and both tiers too small (MRU prefix eviction drops chain tails)
PREFIX_CAPS = {"host": (None, None), "spill": (2, None), "ssd_only": (0, None),
               "tight": (1, 2)}


@pytest.mark.parametrize("case", list(PREFIX_CAPS))
def test_prefix_chain_round_trips_as_jax_does(tmp_path, case):
    jm, tm = _mgrs(tmp_path, *PREFIX_CAPS[case])
    rng = np.random.default_rng(1)
    blocks = {h: _block(rng) for h in range(6)}
    for h, b in blocks.items():
        assert tm.cache_prefix_block(h, _t(b)) == jm.cache_prefix_block(h, b)
    assert tm.cache_prefix_block(0, _t(blocks[0])) is False       # dedup by content
    jm.cache_prefix_block(0, blocks[0])
    _same_state(jm, tm)
    n = tm.prefix_chain_len(list(blocks))
    assert n == jm.prefix_chain_len(list(blocks)) and n >= 1
    got, want = tm.fetch_prefix_chain(list(blocks)[:n]), jm.fetch_prefix_chain(list(blocks)[:n])
    for h in list(blocks)[:n]:
        _equal(got[h], blocks[h])
        _equal(want[h], blocks[h])
    _same_state(jm, tm)
    # a promotion earned the chain's tail a host slot: fetched again, the
    # host serves it where it has room
    tail = list(blocks)[max(n - 2, 0):n]
    tm.fetch_prefix_chain(tail)
    jm.fetch_prefix_chain(tail)
    _same_state(jm, tm)
    if case == "spill":
        assert tm.stats()["spills"] >= 4 and tm.stats()["ssd_hits"] >= 4
    if case == "tight":
        assert tm.stats()["dropped"] > 0


@pytest.mark.parametrize("host_cap", [None, 1, 0])
def test_swap_round_trips_every_tier_pair_as_jax_does(tmp_path, host_cap):
    """A preempted sequence's blocks come back exact from host memory, from
    SSD after a spill, and after a dirty block is offloaded again."""
    jm, tm = _mgrs(tmp_path, host_cap)
    rng = np.random.default_rng(3)
    blocks = {j: _block(rng, w=4 if j < 3 else 2) for j in range(4)}   # a partial tail
    tm.swap_out_blocks(5, {j: _t(b) for j, b in blocks.items()})
    jm.swap_out_blocks(5, blocks)
    got = tm.swap_in_blocks(5)
    assert set(got) == set(jm.swap_in_blocks(5)) == set(blocks)
    for j in blocks:
        _equal(got[j], blocks[j])
    again = {2: _block(rng)}
    tm.swap_out_blocks(5, {2: _t(again[2])})
    jm.swap_out_blocks(5, again)
    got = tm.swap_in_blocks(5)
    jm.swap_in_blocks(5)
    _equal(got[2], again[2])
    _equal(got[1], blocks[1])
    _same_state(jm, tm)
    tm.drop_seq(5)
    jm.drop_seq(5)
    assert tm.swap_in_blocks(5) == {} and jm.swap_in_blocks(5) == {}
    _same_state(jm, tm)


def test_reattach_rebuilds_the_index_as_jax_does(tmp_path):
    """The host tier dies with its worker, the disk survives: a new manager
    on the same root finds the prefix blocks and the spilled swap chain,
    each priced at its file's size, which is the reference's."""
    jm, tm = _mgrs(tmp_path, host_cap=0, name="re")
    rng = np.random.default_rng(4)
    pfx, swp = _block(rng), {0: _block(rng), 1: _block(rng)}
    for m, conv in ((jm, dict), (tm, _t)):
        m.cache_prefix_block(11, conv(pfx))
        m.swap_out_blocks(3, {j: conv(b) for j, b in swp.items()})
        m.streamer.drain()
        m.on_host_failure()
    fj, ft = _mgrs(tmp_path, host_cap=0, name="re")
    assert ft.reattach() == fj.reattach() == 3
    for key in ft.ssd.keys():
        assert ft.ssd.size(key) == fj.ssd.size(key) > 0
    assert [e.nbytes for e in ft._entries.values()] == [e.nbytes for e in fj._entries.values()]
    assert ft.has_prefix(11)
    _equal(ft.fetch_prefix_chain([11])[11], pfx)
    fj.fetch_prefix_chain([11])
    got = ft.restore_swap_from_ssd(3, keep=2)
    assert fj.restore_swap_from_ssd(3, keep=2) is not None
    for j in swp:
        _equal(got[j], swp[j])
    assert ft.restore_swap_from_ssd(3, keep=3) is None       # the chain is short
    assert fj.restore_swap_from_ssd(3, keep=3) is None
    _same_state(fj, ft)


def test_on_host_failure_keeps_what_reached_the_disk(tmp_path):
    jm, tm = _mgrs(tmp_path, host_cap=1)
    rng = np.random.default_rng(6)
    blocks = {h: _block(rng) for h in range(3)}
    for h, b in blocks.items():
        tm.cache_prefix_block(h, _t(b))
        jm.cache_prefix_block(h, b)
    tm.streamer.drain()
    jm.streamer.drain()
    tm.on_host_failure()
    jm.on_host_failure()
    _same_state(jm, tm)
    assert tm.stats()["lost_with_host"] == 1 and all(e.tier == TIER_SSD
                                                     for e in tm._entries.values())


def test_write_behind_errors_surface_on_the_next_read(tmp_path):
    """A failed demotion (a full disk) raises at the next read, with the
    tier's context, instead of leaving an entry whose bytes never landed."""
    _, tm = _mgrs(tmp_path, host_cap=0, name="err")

    def full_disk(key, arr):
        raise OSError("disk full")

    # the disk is full before the demotion is queued: its write-behind may
    # run on the streamer's thread at once
    tm.ssd.put = full_disk
    tm.cache_prefix_block(1, _t(_block(np.random.default_rng(9))))
    with pytest.raises(RuntimeError, match="write-behind"):
        tm.fetch_prefix_chain([1])


def test_kill_after_a_failed_tier_task_returns_and_fails_the_host_tier():
    """ROADMAP C.3, as `src/repro/core/worker.py:283-291`: a write-behind
    that failed before the worker died dies with it.  `kill` returns, the
    host store and the tier's host tier are cleared, `on_host_failure` ran,
    and the error is not raised again at the next barrier."""
    _, _, _, tcfg, tm, tp = models()
    eng = ServingEngine(tcfg, tm, tp, 2, paged=True, hw=HW, device="cpu", **TIERS)
    w = _workers(eng.cluster)[0]
    ran = []
    on_host_failure = w.tier.on_host_failure
    w.tier.on_host_failure = lambda: (ran.append(True), on_host_failure())
    w.tier.cache_prefix_block(3, _t(_block(np.random.default_rng(4))))
    w.tier.streamer.drain()
    assert w.tier.stats()["host_blocks"] == 1
    w.tier.streamer.submit(_spill_fails, tag="tier.spill")
    w.kill()
    assert ran == [True] and not w.alive
    assert w.tier.stats()["host_blocks"] == 0 and not w.cache.host.keys()
    w.tier.streamer.drain()


def test_ssd_store_writes_the_jax_stores_files(tmp_path):
    """An fp32 block's file is the reference store's, byte for byte, so
    `size` (which `reattach` charges) agrees; keys and reads agree."""
    block = np.random.default_rng(5).standard_normal((2, 2, 8, 2, 4)).astype(np.float32)
    js, ts = JaxSSDStore(str(tmp_path / "j")), SSDStore(str(tmp_path / "t"))
    js.put("tswap/seq3/blk1", block)
    ts.put("tswap/seq3/blk1", torch.from_numpy(block.copy()))
    assert ts.keys() == js.keys() == ["tswap/seq3/blk1"]
    assert ts.size("tswap/seq3/blk1") == js.size("tswap/seq3/blk1") > block.nbytes
    with open(js._path("tswap/seq3/blk1"), "rb") as a, open(ts._path("tswap/seq3/blk1"), "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(ts.get("tswap/seq3/blk1").numpy(), js.get("tswap/seq3/blk1"))
    assert ts.used_bytes() == js.used_bytes()


@pytest.mark.parametrize("crash", ["fault_at_ssd_put", "torn_write"])
@pytest.mark.parametrize("had_old", [True, False])
def test_a_crash_in_an_ssd_put_leaves_the_old_block_or_none(tmp_path, monkeypatch, crash,
                                                            had_old):
    """A crash between the fsync and the rename (the ``ssd.put`` point) or
    in the middle of the write publishes nothing: a reader sees the old
    block, or none, never a torn one, and no temp file is left."""
    store = SSDStore(str(tmp_path))
    good = torch.arange(16, dtype=torch.float32)
    if had_old:
        store.put("blk", good)
    if crash == "fault_at_ssd_put":
        inj = faults.FaultInjector(faults.FaultPlan([faults.FaultSpec("ssd.put", nth=1,
                                                                      kind="error")]))
        faults.install(inj)
        try:
            with pytest.raises(faults.FaultInjected):
                store.put("blk", torch.zeros(16))
        finally:
            faults.uninstall()
        assert [f.point for f in inj.fired] == ["ssd.put"]
    else:
        def torn(f, arr):
            f.write(b"partial garbage")
            raise OSError("the writer crashed mid-write")
        monkeypatch.setattr(np, "save", torn)
        with pytest.raises(OSError):
            store.put("blk", torch.zeros(16))
        monkeypatch.undo()
    if had_old:
        assert torch.equal(store.get("blk"), good)
        assert store.keys() == ["blk"]
    else:
        assert "blk" not in store and store.keys() == []
    assert not [f for f in os.listdir(store.root) if ".tmp." in f]
    # an orphaned temp file of another crashed writer is not a key
    open(os.path.join(store.root, "zzz.npy.tmp.1.2"), "wb").close()
    assert store.keys() == (["blk"] if had_old else [])


def test_ssd_write_fault_is_retried_by_the_streamer(tmp_path):
    """``ssd_write`` at ``ssd.put`` is transient: the streamer runs the
    demotion again and the block lands whole."""
    _, tm = _mgrs(tmp_path, host_cap=0, name="retry")
    block = _block(np.random.default_rng(8))
    inj = faults.FaultInjector(faults.FaultPlan([faults.FaultSpec("ssd.put", nth=1,
                                                                  kind="ssd_write")]))
    faults.install(inj)
    try:
        tm.cache_prefix_block(4, _t(block))
        _equal(tm.fetch_prefix_chain([4])[4], block)
    finally:
        faults.uninstall()
    assert len(inj.fired) == 1 and tm.ssdlink.transfers == 2 + 1   # two puts, one read


def test_bf16_blocks_come_back_from_the_disk_bit_exact(tmp_path):
    """numpy has no bfloat16: a bf16 block goes to disk as its int16 view
    and comes back bit for bit through demotion, a dead host, `reattach`,
    promotion and a swap restore."""
    def mgr():
        pool = BlockPool(8, 4)
        pages = PagedKVCache(pool, layers=2, num_kv_heads=2, head_dim=4, dtype=torch.bfloat16)
        return KVTierManager(pool, pages, StreamEngine("bf16"),
                             cfg=TierConfig(host_capacity_blocks=0, ssd_root=str(tmp_path)))

    g = torch.Generator().manual_seed(2)

    def block():
        return {leaf: torch.randn(2, 4, 2, 4, generator=g).to(torch.bfloat16)
                for leaf in ("k", "v")}

    pfx, swp = block(), {0: block(), 1: block()}
    m = mgr()
    m.cache_prefix_block(7, pfx)
    m.swap_out_blocks(2, swp)
    m.streamer.drain()
    m.on_host_failure()
    assert SSDStore(str(tmp_path)).get("pfx/7").dtype == torch.int16      # as stored
    fresh = mgr()
    assert fresh.reattach() == 3
    got = fresh.fetch_prefix_chain([7])[7]
    restored = fresh.restore_swap_from_ssd(2, keep=2)
    for have, want in [(got, pfx)] + [(restored[j], swp[j]) for j in swp]:
        for leaf in ("k", "v"):
            assert have[leaf].dtype == torch.bfloat16
            assert torch.equal(have[leaf].view(torch.int16), want[leaf].view(torch.int16))


# ---------------------------------------------------------------------------
# engine level: run_continuous over the tiers, both engines
# ---------------------------------------------------------------------------

_MODELS: dict = {}


def models():
    """(jax cfg, model, params, port cfg, model, params), made once."""
    if not _MODELS:
        kw = dict(dtype="float32", num_layers=2)
        jcfg = dataclasses.replace(PAPER_ARCHS["gpt2-1.5b"].reduced(), **kw)
        tcfg = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), **kw)
        jm = build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS["m"] = (jcfg, jm, jp, tcfg, DecoderLM(tcfg, device="cpu"),
                        params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODELS["m"]


_RNG = np.random.default_rng(0)
_SYS = _RNG.integers(0, 256, (24,)).astype(np.int32)
# tests/test_tiered_kv.py:228-235: a 24-token system prompt and 8-token tails
SHARED = [np.concatenate([_SYS, _RNG.integers(0, 256, (8,)).astype(np.int32)])
          for _ in range(4)]
BOUNDARY = [np.random.default_rng(5).integers(0, 256, (16,)).astype(np.int32)] * 2
# tests/test_fused_rounds.py:140-142: a 16-token shared head, 6-token tails
_HEAD = np.random.default_rng(9).integers(0, 256, (16,)).astype(np.int32)
FUSED_SHARED = [np.concatenate([_HEAD, np.random.default_rng(10 + i).integers(
    0, 256, (6,)).astype(np.int32)]) for i in range(3)]

TIERS = dict(tiered=True, kv_pool_blocks=128, host_cache_blocks=16, ssd_cache_blocks=64)
# name -> (engine kwargs, prompts, max_new, max_active, fail_at), as
# tests/test_tiered_kv.py:248-392 and tests/test_fused_rounds.py:132
CASES = {
    "prefix_reuse_from_tiers": (TIERS, SHARED, 5, 1, None),
    "prefix_reuse_through_ssd_spill": (dict(TIERS, host_cache_blocks=1), SHARED, 5, 1, None),
    "tight_tier_caps": (dict(TIERS, host_cache_blocks=2, ssd_cache_blocks=2), SHARED, 5, 1,
                        None),
    "boundary_prompt_admission": (dict(tiered=True, kv_pool_blocks=4), BOUNDARY, 4, 2, None),
    "preempt_to_host_and_resume": (dict(TIERS, kv_pool_blocks=7, host_cache_blocks=2),
                                   SHARED, 10, 2, None),
    "failure_with_tiers": (dict(TIERS, replication=True, host_cache_blocks=8), SHARED, 5, 2,
                           {9: 1}),
    "failure_while_preempted": (dict(tiered=True, replication=True, kv_pool_blocks=7,
                                     host_cache_blocks=0), SHARED, 10, 2, {12: 1}),
    # a write-behind that failed on the streamer before the death dies with
    # the worker; the run recovers (ROADMAP C.3)
    "failure_after_a_failed_write_behind": (dict(TIERS, replication=True, host_cache_blocks=8),
                                            SHARED, 5, 2, {9: 1}),
    "fused_adoption_in_chunks_of_4": (dict(TIERS, prefill_chunk_tokens=4), FUSED_SHARED, 3,
                                      2, None),
    "perseq_adoption_in_chunks_of_4": (dict(TIERS, prefill_chunk_tokens=4,
                                            fused_rounds=False), FUSED_SHARED, 3, 2, None),
    # chunking off: an adopted prompt's suffix runs one token per pass
    "fused_adoption_token_by_token": (dict(TIERS, prefill_chunk_tokens=0), SHARED, 4, 1,
                                      None),
    "perseq_adoption_token_by_token": (dict(TIERS, prefill_chunk_tokens=0,
                                            fused_rounds=False), SHARED, 4, 1, None),
}


# the cases whose failure finds a failed task on the streamer
FAILED_TASK_CASES = {"failure_after_a_failed_write_behind"}


def _spill_fails():
    raise OSError("no space left on the device")


def _fail_a_task_before_each_death(cluster):
    """Submit a task that raises OSError to the cluster's streamer just
    before each `inject_failure`: the dying worker's `kill` drains it."""
    inject = cluster.inject_failure

    def inject_after_a_failed_task(wid):
        cluster.streamer.submit(_spill_fails, tag="tier.spill")
        inject(wid)
    cluster.inject_failure = inject_after_a_failed_task


def _run(port: bool, ekw, prompts, max_new, max_active, fail_at=None, specs=(),
         failed_task=False):
    """One run with a fresh registry and tracer installed around it, and a
    fault plan of `specs` (FaultSpec keyword dicts); with `failed_task`, a
    failed streamer task before each death: (engine, report, registry JSON,
    tracer JSON)."""
    jcfg, jm, jp, tcfg, tm, tp = models()
    tele, trc = (telemetry, tracing) if port else (jax_telemetry, jax_tracing)
    fmod = faults if port else jax_faults
    plan = fmod.FaultPlan([fmod.FaultSpec(**s) for s in specs]) if specs else None
    if port:
        eng = ServingEngine(tcfg, tm, tp, 2, paged=True, hw=HW, device="cpu", **ekw)
        reqs = [Request(rid=i, prompt=p.copy(), max_new=max_new) for i, p in enumerate(prompts)]
    else:
        eng = JaxEngine(jcfg, jm, jp, 2, paged=True, **ekw)
        reqs = [JaxRequest(rid=i, prompt=p.copy(), max_new=max_new)
                for i, p in enumerate(prompts)]
    if failed_task:
        _fail_a_task_before_each_death(eng.cluster)
    reg, tracer = tele.Telemetry(), trc.Tracer()
    prev_t, prev_r = tele.install(reg), trc.install(tracer)
    try:
        rep = eng.run_continuous(reqs, max_active=max_active, fail_at=fail_at, fault_plan=plan)
        # the last write-behinds may still be in flight: land them, so the
        # bytes and counters read below are the run's whole
        eng.cluster.streamer.drain()
    finally:
        trc.uninstall(prev_r)
        tele.uninstall(prev_t)
    return eng, rep, reg.to_json(), tracer.to_json()


def _workers(cluster):
    return list(dict.fromkeys(cluster.prompt_group + cluster.token_group))


def _held_to_jax(ekw, prompts, max_new, max_active, fail_at=None, specs=(), failed_task=False):
    je, jrep, jtele, jtrace = _run(False, ekw, prompts, max_new, max_active, fail_at, specs,
                                   failed_task)
    te, trep, ttele, ttrace = _run(True, ekw, prompts, max_new, max_active, fail_at, specs,
                                   failed_task)
    assert trep.tokens == jrep.tokens
    assert (trep.preemptions, trep.failures, trep.recoveries, trep.steps_redone) == \
        (jrep.preemptions, jrep.failures, jrep.recoveries, jrep.steps_redone)
    assert trep.tier_stats == jrep.tier_stats
    assert [w.tier.stats() for w in _workers(te.cluster)] == \
        [w.tier.stats() for w in _workers(je.cluster)]
    assert (trep.prefill_tokens_saved, trep.prefill_tokens_total) == \
        (jrep.prefill_tokens_saved, jrep.prefill_tokens_total)
    assert te.transfer_summary() == je.transfer_summary()
    tp, jp = te.cluster.pool_stats(), je.cluster.pool_stats()
    if fail_at:
        # the port's recovery holds a swapped sequence in host memory without
        # taking a pool block; the reference installs it, then swaps it out
        assert tp["peak_blocks"] <= jp["peak_blocks"]
        tp["peak_blocks"] = jp["peak_blocks"]
    assert tp == jp
    assert trep.fault_trace == jrep.fault_trace
    if not fail_at:
        assert ttele == jtele
        assert ttrace == jtrace
    faults.assert_no_leaks(te.cluster)
    return te, trep


@pytest.mark.parametrize("case", list(CASES))
def test_run_continuous_over_the_tiers_as_jax_does(case):
    ekw, prompts, max_new, max_active, fail_at = CASES[case]
    te, rep = _held_to_jax(ekw, prompts, max_new, max_active, fail_at,
                           failed_task=case in FAILED_TASK_CASES)
    st = rep.tier_stats
    assert all(len(t) == max_new for t in rep.tokens.values())
    # what each reference case is about happened here too
    if case.startswith("prefix_reuse") or "adoption" in case or case == "tight_tier_caps":
        assert rep.prefill_tokens_saved > 0 and st["prefix_promotions"] > 0
    if case == "prefix_reuse_from_tiers":
        assert rep.prefill_tokens_saved / rep.prefill_tokens_total >= 0.30
    if case == "prefix_reuse_through_ssd_spill":
        assert st["ssd_hits"] > 0 and st["spills"] > 0
    if case == "boundary_prompt_admission":
        assert rep.preemptions == 0
    if case.startswith("preempt") or case == "failure_while_preempted":
        assert rep.preemptions >= 1 and st["swap_in_blocks"] > 0
    if case == "preempt_to_host_and_resume":
        assert st["spills"] > 0
    if fail_at:
        assert rep.failures == 1 and rep.recoveries == 1
        assert te.cluster.recovery_log[0]["reattach_ms"] >= 0.0
    if "token_by_token" in case:
        assert te.cluster.prefill_passes and max(
            n for _, n in te.cluster.adoption_suffix_log) > 1


def test_tiered_runs_give_the_untiered_tokens():
    """The tiers change where the KV lives, not what it holds: the tiered
    cases above give the tokens of a run with a large pool and no tiers."""
    _, base, _, _ = _run(True, dict(kv_pool_blocks=128), SHARED, 10, 2)
    _, rep, _, _ = _run(True, CASES["preempt_to_host_and_resume"][0], SHARED, 10, 2)
    assert rep.tokens == base.tokens and rep.preemptions >= 1


def test_a_tiered_run_with_a_streamer_delay_records_what_jax_records():
    """tests/test_telemetry.py:161-196 and tests/test_tracing.py:143-169:
    fused, tiered, a delay at the second streamer task, and in the traced
    case a worker death at step 5 with replication."""
    specs = [dict(point="stream.task", nth=2, kind="delay", delay_s=1e-3)]
    prompts = list(np.random.default_rng(0).integers(0, 256, (3, 8)).astype(np.int32))
    ekw = dict(tiered=True, kv_pool_blocks=128, host_cache_blocks=16, ssd_cache_blocks=32)
    _, rep = _held_to_jax(ekw, prompts, 4, 2, specs=specs)
    tele = rep.telemetry
    assert tele["counters"]["faults.fired{kind=delay,point=stream.task}"] == 1
    assert any(k.startswith("tier.") for k in tele["counters"])
    _, jrep, _, jtrace = _run(False, dict(ekw, replication=True), prompts, 4, 2, {5: 1}, specs)
    _, trep, _, ttrace = _run(True, dict(ekw, replication=True), prompts, 4, 2, {5: 1}, specs)
    assert trep.tokens == jrep.tokens and trep.recoveries == jrep.recoveries == 1
    assert _event_names(ttrace) == _event_names(jtrace)


def _event_names(dump: str):
    """The names of the events on each track of a dumped trace."""
    return {track: sorted({e["name"] for e in t["events"]})
            for track, t in json.loads(dump)["tracks"].items()}
