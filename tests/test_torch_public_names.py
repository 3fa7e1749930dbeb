"""Public names of the JAX package that the port took over late, each held
to the reference: `PagedKVCache.apply_defrag`, `DejaVuCluster.prefill_seq`,
`Transport.reset_log`, `StreamEngine.reset`, `PipelineTopo.stage_of_layer`,
`primitives.gather`, `ICITransport` and `list_archs`.  Tolerances: pages,
stores and tokens exactly; prefill logits within 2e-5 (the fp32 band of
`test_torch_kernels.py`)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import PAPER_ARCHS as JAX_PAPER_ARCHS  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro.core import dejavulib as jdv  # noqa: E402
from repro.kvcache.paged import BlockPool as JaxBlockPool  # noqa: E402
from repro.kvcache.paged import PagedKVCache as JaxPagedKVCache  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.sampling import greedy as jax_greedy  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import PAPER_ARCHS, list_archs  # noqa: E402
from repro_torch.core import dejavulib as tdv  # noqa: E402
from repro_torch.kvcache.paged import BlockPool, PagedKVCache  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


def test_apply_defrag_moves_the_pages_as_the_reference():
    """tests/test_paged_kv.py's defrag case on both packages: the same moves,
    the same tables and every page the same after `apply_defrag`."""
    pages = {}
    for name, pool_cls, cache_cls in (("jax", JaxBlockPool, JaxPagedKVCache),
                                      ("port", BlockPool, PagedKVCache)):
        pool = pool_cls(16, 4)
        kv = cache_cls(pool, layers=2, num_kv_heads=2, head_dim=4)
        t1, _ = pool.allocate(1, 8)
        t2, _ = pool.allocate(2, 6)
        t3, _ = pool.allocate(3, 5)
        for i, t in enumerate((t1, t2, t3)):
            for j, bid in enumerate(t):
                kv.k[bid] = 10.0 * (i + 1) + j
                kv.v[bid] = -10.0 * (i + 1) - j
        pool.free_seq(1)
        moves = pool.defrag()
        kv.apply_defrag(moves)
        pages[name] = (moves, dict(pool.tables), np.asarray(kv.k), np.asarray(kv.v))
    (jm, jt, jk, jv), (tm, tt, tk, tv) = pages["jax"], pages["port"]
    assert jm == tm and jt == tt and tt[2] == [0, 1]
    live = sorted({b for t in tt.values() for b in t})
    np.testing.assert_array_equal(tk[live], jk[live])
    np.testing.assert_array_equal(tv[live], jv[live])


def test_prefill_seq_then_decode_seq_give_the_references_tokens():
    """tests/test_continuous_batching.py's per-sequence path: `prefill_seq`
    into the pool, then three `decode_seq` steps, on both packages from one
    set of weights: the same greedy tokens, prefill logits within 2e-5."""
    jcfg = dataclasses.replace(JAX_PAPER_ARCHS["gpt2-1.5b"].reduced(), dtype="float32",
                               num_layers=4)
    tcfg = dataclasses.replace(PAPER_ARCHS["gpt2-1.5b"].reduced(), dtype="float32",
                               num_layers=4)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,)).astype(np.int32) for n in (11, 6)]
    jcl = JaxEngine(jcfg, jm, jp, 2, paged=True, kv_pool_blocks=64).cluster
    tcl = ServingEngine(tcfg, build_model(tcfg, device="cpu"), tp, 2, paged=True,
                        kv_pool_blocks=64, device="cpu").cluster
    for rid, prompt in enumerate(prompts):
        jl = jcl.prefill_seq(rid, prompt, 4)
        tl = tcl.prefill_seq(rid, prompt.copy(), 4)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5, atol=2e-5)
        jt, tt = [int(jax_greedy(jl)[0])], [int(tl.argmax(-1)[0])]
        for step in range(1, 4):
            jl = jcl.decode_seq(rid, jnp.asarray([jt[-1]], jnp.int32), step)
            tl = tcl.decode_seq(rid, torch.tensor([tt[-1]], dtype=torch.int32), step)
            jt.append(int(jax_greedy(jl)[0]))
            tt.append(int(tl.argmax(-1)[0]))
        assert tt == jt, rid


def test_reset_log_and_stream_reset_start_the_counts_afresh():
    """After `reset_log` a transport's totals are 0, as the reference's
    (whose totals sum its log); `StreamEngine.reset` zeroes the modeled
    stream and compute seconds of `overlap_report` in both."""
    x = np.arange(64, dtype=np.float32)
    for dv, arr in ((jdv, jnp.asarray(x)), (tdv, torch.from_numpy(x))):
        tr = dv.HostLinkTransport()
        store = dv.HostMemoryStore()
        dv.flush(arr, store, "a", tr)
        assert tr.bytes_total() == 256
        tr.reset_log()
        assert tr.bytes_total() == 0
        eng = dv.StreamEngine()
        try:
            eng.compute_span(0.5)
            assert eng.overlap_report()["compute_s"] == 0.5
            eng.reset()
            rep = eng.overlap_report()
            assert rep["stream_s"] == 0.0 and rep["compute_s"] == 0.0
        finally:
            eng.close()


@pytest.mark.parametrize("depth,layers", [(2, 8), (3, 10), (4, 4)])
def test_stage_of_layer_matches_the_reference(depth, layers):
    jt = jdv.PipelineTopo(depth, layers, 2)
    tt = tdv.PipelineTopo(depth, layers, 2)
    assert [tt.stage_of_layer(i) for i in range(layers)] == \
        [jt.stage_of_layer(i) for i in range(layers)]
    with pytest.raises(ValueError):
        tt.stage_of_layer(layers)


def test_gather_assembles_the_chunks_as_the_reference():
    """Two layer chunks of a token window flushed into a store, then
    `gather`ed into a dense leaf (zeros elsewhere) by both packages."""
    rng = np.random.default_rng(1)
    leaf = rng.standard_normal((4, 2, 8, 2, 4)).astype(np.float32)
    chunks = [tdv.CacheChunk("k", (0, 2), (0, 2), (2, 6)),
              tdv.CacheChunk("k", (2, 4), (0, 2), (2, 6))]
    out = {}
    for name, dv, arr in (("jax", jdv, leaf), ("port", tdv, torch.from_numpy(leaf))):
        store, tr = dv.HostMemoryStore(), dv.LocalTransport()
        chs = [dv.CacheChunk(c.leaf, c.layers, c.batch, c.tokens) for c in chunks]
        for c in chs:
            dv.flush(arr[c.layers[0]:c.layers[1], :, c.tokens[0]:c.tokens[1]], store,
                     c.key(0), tr)
        got = dv.gather(store, "k", leaf.shape,
                        np.float32 if name == "jax" else torch.float32, chs, tr)
        out[name] = np.asarray(got)
    np.testing.assert_array_equal(out["port"], out["jax"])
    np.testing.assert_array_equal(out["port"][:, :, 2:6], leaf[:, :, 2:6])
    assert not out["port"][:, :, :2].any()


def test_ici_transport_and_list_archs_match_the_reference():
    """`ICITransport` on the reference's hardware (the port's default is the
    H100's) models a transfer as the reference's does."""
    hw = tdv.HardwareModel(**dataclasses.asdict(jdv.HardwareModel()))
    jt, tt = jdv.ICITransport(), tdv.ICITransport(hw)
    assert tt.kind == jt.kind == "ici"
    assert tt.model_time(1 << 20) == pytest.approx(jt.model_time(1 << 20), rel=1e-12)
    assert list_archs() == jax_list_archs()
    assert list_archs(include_paper=True) == jax_list_archs(include_paper=True)
