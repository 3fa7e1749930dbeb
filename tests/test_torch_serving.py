"""The port's serving pieces below the engine, against the JAX package's.

The block pool is a copy of the reference's and must make the same
decisions; the device pages must hold what the reference's numpy pages hold
after the same writes, copies and gathers; a stage worker must leave the
same pages and logits after chunked prefill and fused decode passes.  The
entry points run on the card by default and raise without one unless the
caller asks for the CPU; what the port leaves out raises
NotImplementedError.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread is faster, and steady on a shared host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import PAPER_ARCHS  # noqa: E402
from repro.core.worker import StageWorker as JaxWorker  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.cluster import DejaVuCluster  # noqa: E402
from repro_torch.core.dejavulib import HostMemoryStore  # noqa: E402
from repro_torch.core.worker import StageWorker  # noqa: E402
from repro_torch.kvcache import paged  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

CFG = dataclasses.replace(PAPER_ARCHS["gpt2-1.5b"].reduced(), dtype="float32",
                          num_layers=2)
TCFG = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), dtype="float32",
                           num_layers=2)


# the worker test's variants: plain reads the pages in place; a stage with a
# windowed or ALiBi layer gathers them dense (tests/test_torch_model.py)
VARIANTS = {
    "plain": {},
    "window_meta": dict(sliding_window=6, num_meta_tokens=2, full_attn_layers=(0,)),
    "alibi": dict(pos_emb="alibi"),
}
_MODELS: dict = {}


def variant_models(name: str):
    """(jax model, jax params, port model, port params) of a variant, made
    once per module: the JAX weights from PRNGKey(0), bridged to the port."""
    if name not in _MODELS:
        jcfg = dataclasses.replace(CFG, **VARIANTS[name])
        tcfg = dataclasses.replace(TCFG, **VARIANTS[name])
        jm = build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _MODELS[name] = (jm, jp, DecoderLM(tcfg, device="cpu"),
                         params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODELS[name]


@pytest.fixture(scope="module")
def models():
    return variant_models("plain")


# ---------------------------------------------------------------------------
# block pool: the same decisions as the reference's
# ---------------------------------------------------------------------------

def _pool_state(pool):
    return (dict(pool.tables), dict(pool.seq_lens), list(pool._free),
            [(b.ref, b.hash) for b in pool.blocks], dict(pool._hash_index),
            pool.peak_used_blocks)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_pool_copy_decides_like_reference(seed):
    """A random run of allocate / append / publish / truncate / free /
    defrag, with shared prompt prefixes, leaves both pools identical after
    every operation (same tables, free list, refs, hashes, CoW moves)."""
    rng = np.random.default_rng(seed)
    ref, mine = jpaged.BlockPool(24, 4), paged.BlockPool(24, 4)
    base = [int(t) for t in rng.integers(0, 50, 12)]
    live = []
    for step in range(60):
        op = int(rng.integers(0, 6)) if live else int(rng.integers(0, 2))
        if op <= 1:        # a prompt sharing a prefix of `base`, published or not
            toks = base[:int(rng.integers(4, 12))] + [step] * int(rng.integers(0, 3))
            call = lambda p: p.allocate(step, len(toks), token_ids=toks,  # noqa: E731
                                        publish=bool(op))
        elif op == 2:
            seq, n = live[int(rng.integers(len(live)))], int(rng.integers(1, 6))
            call = lambda p: p.append(seq, n)  # noqa: E731
        elif op == 3:
            seq = live[int(rng.integers(len(live)))]
            call = lambda p: p.publish_hashes(seq, p.chain_hashes(base, 4))  # noqa: E731
        elif op == 4:
            seq = live.pop(int(rng.integers(len(live))))
            call = lambda p: p.free_seq(seq)  # noqa: E731
        else:
            call = lambda p: p.defrag()  # noqa: E731
        results = []
        for pool, exc in ((ref, jpaged.PoolExhausted), (mine, paged.PoolExhausted)):
            try:
                results.append(call(pool))
            except exc as e:
                results.append(type(e).__name__)
        assert results[0] == results[1], (step, op)
        assert _pool_state(ref) == _pool_state(mine), (step, op)
        if op <= 1 and results[0] != "PoolExhausted":
            live.append(step)


# ---------------------------------------------------------------------------
# device pages: the same contents as the reference's numpy pages
# ---------------------------------------------------------------------------

def test_paged_cache_matches_reference_pages():
    L, H, D, bs = 2, 3, 4, 8
    rng = np.random.default_rng(4)
    rp, tp = jpaged.BlockPool(16, bs), paged.BlockPool(16, bs)
    rc = jpaged.PagedKVCache(rp, L, H, D, dtype="float32")
    tc = paged.PagedKVCache(tp, L, H, D, dtype=torch.float32, device=torch.device("cpu"))
    prompt = [int(t) for t in rng.integers(0, 99, 19)]
    for pool in (rp, tp):
        pool.allocate(0, 19, token_ids=prompt)
        pool.allocate(1, 11)
        # 12 live tokens over seq 0's two full prompt blocks: both shared,
        # so the first append lands in a shared block and copies it
        pool.allocate(2, 12, token_ids=prompt[:16])
    for seq, t0, w in ((0, 0, 19), (1, 0, 11), (0, 16, 8), (1, 8, 3)):
        win = {leaf: rng.standard_normal((L, w, H, D)).astype(np.float32)
               for leaf in ("k", "v")}
        touched = rc.write_window(seq, win, t0)
        assert tc.write_window(seq, {k: torch.from_numpy(a) for k, a in win.items()},
                               t0) == touched
    cow_r, cow_t = rp.append(2, 3), tp.append(2, 3)      # seq 2 diverges: CoW
    assert cow_r == cow_t and cow_r
    rc.apply_cow(cow_r)
    tc.apply_cow(cow_t)
    np.testing.assert_array_equal(tc.k.numpy(), rc.k)
    np.testing.assert_array_equal(tc.v.numpy(), rc.v)
    # one gather for the batch == the reference's per-sequence gathers
    pad = 24
    dense = tc.gather_dense([0, 1, 2], pad)
    for i, seq in enumerate((0, 1, 2)):
        one = rc.gather_dense(seq, pad)
        for leaf in ("k", "v"):
            np.testing.assert_array_equal(dense[leaf][:, i].numpy(), one[leaf][:, 0])
    # block round trip: the swap unit
    arrs = tc.block_arrays(tp.tables[1][1], width=3)
    np.testing.assert_array_equal(arrs["k"].numpy(),
                                  rc.block_arrays(rp.tables[1][1], width=3)["k"])
    tc.install_block(5, arrs)
    np.testing.assert_array_equal(tc.k[5, :, :3].numpy(), arrs["k"].numpy())
    assert tc.used_bytes() == rc.used_bytes() and tc.block_bytes == rc.block_bytes


def test_host_store_capacity_and_lru():
    spilled = []
    st = HostMemoryStore("h", capacity_bytes=3 * 16, on_full="evict_lru",
                         spill_cb=lambda k, a: spilled.append(k))
    for i in range(3):
        st.put(f"b{i}", torch.zeros(4))
    st.get("b0")                                  # touch: b1 is now the oldest
    st.put("b3", torch.zeros(4))
    assert spilled == ["b1"] and st.keys() == ["b2", "b0", "b3"]
    assert st.used_bytes() == 48
    strict = HostMemoryStore("s", capacity_bytes=16)
    strict.put("a", torch.zeros(4))
    with pytest.raises(MemoryError):
        strict.put("b", torch.zeros(1))
    with pytest.raises(ValueError):
        HostMemoryStore("x", on_full="drop")


# ---------------------------------------------------------------------------
# a stage worker: the same pages and logits as the reference worker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_worker_passes_leave_reference_pages(variant):
    """One stage holding both layers: a packed chunk-set pass, a ragged one
    with a short chunk, a per-sequence chunk, two fused decode passes and a
    per-sequence decode.  Pages, dirty blocks and logits agree with the
    reference, whether the fused passes read the pages in place (plain) or
    gather them dense (a windowed or ALiBi layer in the stage)."""
    jm, jp, tm, tp = variant_models(variant)
    jw = JaxWorker(0, jm, jp, 0, 2, first=True, last=True)
    tw = StageWorker(0, tm, tp, 0, 2, first=True, last=True, device="cpu")
    assert tw.reads_pages() == (variant == "plain")
    rng = np.random.default_rng(8)
    p0 = rng.integers(0, CFG.vocab_size, 20).astype(np.int32)
    p1 = rng.integers(0, CFG.vocab_size, 13).astype(np.int32)
    outs = []
    for w, tens in ((jw, jnp.asarray), (tw, torch.from_numpy)):
        w.enable_paging(16, 8)
        w.ensure_prefill_table(0, 20, token_ids=[int(t) for t in p0])
        w.ensure_prefill_table(1, 13, token_ids=[int(t) for t in p1])
        o = [w.prefill_chunk_paged_batch([0, 1], tens(np.stack([p0[:8], p1[:8]])),
                                         [0, 0], [8, 8])]
        pad = np.zeros(8, np.int32)
        pad[:5] = p1[8:13]
        o.append(w.prefill_chunk_paged_batch([0, 1], tens(np.stack([p0[8:16], pad])),
                                             [8, 8], [8, 5]))
        o.append(w.prefill_chunk_paged(0, tens(p0[None, 16:20]), 16))
        o.append(w.decode_paged_batch([0, 1], tens(np.asarray([3, 4], np.int32)),
                                      [20, 13]))
        o.append(w.decode_paged_batch([0, 1], tens(np.asarray([5, 6], np.int32)),
                                      [21, 14]))
        o.append(w.decode_paged(1, tens(np.asarray([7], np.int32)), 15))
        outs.append(o)
    for j, t in zip(*outs):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-4)
    assert tw.pool.tables == jw.pool.tables and tw.paged_dirty == jw.paged_dirty
    np.testing.assert_allclose(tw.pages.k.numpy(), jw.pages.k, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tw.pages.v.numpy(), jw.pages.v, rtol=0, atol=1e-4)
    # swap out and back: the pages come back bit for bit
    before = {j: a["k"].clone() for j, a in tw.live_blocks(1).items()}
    tw.paged_offload(1)
    assert 1 not in tw.pool.tables
    tw.paged_restore(1)
    for j, a in tw.live_blocks(1).items():
        assert torch.equal(a["k"], before[j])


# ---------------------------------------------------------------------------
# entry points: on the card by default, the CPU only when asked for
# ---------------------------------------------------------------------------

ENTRY_POINTS = {
    "DecoderLM": lambda m, p: DecoderLM(TCFG),
    "StageWorker": lambda m, p: StageWorker(0, m, p, 0, 2, first=True, last=True),
    "DejaVuCluster": lambda m, p: DejaVuCluster(TCFG, m, p, 2, paged=True),
    "ServingEngine": lambda m, p: ServingEngine(TCFG, m, p, 2, paged=True),
    "params_from_jax": lambda m, p: params_from_jax(
        TCFG, jax.tree.map(np.asarray, build_model(CFG).init(jax.random.PRNGKey(0)))),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_asked_for_the_cpu(name, models, monkeypatch):
    _, _, tm, tp = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](tm, tp)


# the knobs the paged path once left out: swapping and disaggregation
# (A.9), the KV tiers and whole-prompt prefill under them (A.10).  All are
# served now (tests/test_torch_paged_modes.py, tests/test_torch_tiers.py);
# what the guard still leaves out is a family the cluster does not serve
LEFT_OUT = {
    "swapping": dict(swapping=True),
    "tiered": dict(tiered=True),
    "disaggregated": dict(mode="disaggregated", dp_split=(1, 1)),
    "whole_prompt_prefill": dict(prefill_chunk_tokens=0, tiered=True),
}


def _moe():
    """Reduced qwen3-moe at fp32, the port's model and its own seeded
    weights: the moe family builds a DecoderLM and a cluster."""
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").reduced(), dtype="float32")
    model = DecoderLM(cfg, device="cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("knob", list(LEFT_OUT))
def test_knobs_left_out_of_this_slice_raise(knob, models, tmp_path, monkeypatch):
    """Each knob now builds a paged engine, for the dense and the moe
    family; with the encdec family, which has no stage API here or in the
    reference, the cluster raises a ValueError that names the family
    alone."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))     # the SSD tiers' roots
    _, _, tm, tp = models
    kw = dict(paged=True, device="cpu")
    kw.update(LEFT_OUT[knob])
    cl = ServingEngine(TCFG, tm, tp, 2, **kw).cluster
    assert cl.paged and all(w.pool is not None for w in cl.workers())
    assert all((w.tier is not None) == bool(kw.get("tiered")) for w in cl.workers())
    mcl = DejaVuCluster(*_moe(), 2, **kw)
    assert mcl.paged and all(w.pool is not None for w in mcl.workers())
    with pytest.raises(ValueError, match="no stage API") as e:
        DejaVuCluster(dataclasses.replace(TCFG, family="encdec"), tm, tp, 2, **kw)
    assert "family=encdec" in str(e.value) and knob.split("_")[0] not in str(e.value)


def test_run_and_fault_injection_raise():
    """DecoderLM refuses a family it does not serve (fault injection,
    migration and repartition are served: tests/test_torch_recovery*.py)."""
    with pytest.raises(ValueError, match="family=encdec"):
        DecoderLM(dataclasses.replace(TCFG, family="encdec"), device="cpu")
    cfg, model, params = _moe()
    assert isinstance(DejaVuCluster(cfg, model, params, 2, device="cpu"), DejaVuCluster)
