"""The port's plain paged kernels against the Pallas kernels in interpret mode:
`paged_decode_attention` and `paged_prefill_attention`, and the layer and
pool pieces around them.

Inputs come from numpy with a seed and go to both packages; tolerances are
the reference's bands (`tests/test_kernels.py`): 2e-5 for fp32, 2e-2 for
bf16.  The shapes are those of `tests/test_paged_kv.py` and
`tests/test_kernels.py`, plus cases that read one layer's strided view of a
pool [N, L, bs, Hkv, D], as the port's stages do.  Also here: a fused
layer over the pages in place gives the outputs, and leaves the pages, of
the same layer over a gathered dense cache.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread is faster, and steady on a shared host
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import \
    paged_decode_attention as jax_paged_decode  # noqa: E402
from repro.kernels.paged_prefill import \
    paged_prefill_attention as jax_paged_prefill  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import LAUNCHES, ops, ref  # noqa: E402
from repro_torch.kvcache.paged import BlockPool, PagedKVCache  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _pages(rng, ends, n_pages, bs, hkv, d, layers=0):
    """K/V pages for sequences holding `ends` tokens, with shuffled page ids
    (page 0 left as padding) and int32 tables [B, nb] padded with 0.  With
    `layers`, they are a pool [N, layers, bs, hkv, d] whose layer 1 the
    tests read (`_both`)."""
    nbs = [-(-int(e) // bs) for e in ends]
    perm = list(rng.permutation(n_pages - 1) + 1)
    tables = np.zeros((len(ends), max(nbs)), np.int32)
    for i, nb in enumerate(nbs):
        for j in range(nb):
            tables[i, j] = perm.pop()
    shape = (n_pages, layers, bs, hkv, d) if layers else (n_pages, bs, hkv, d)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return k, v, tables


def _both(k, v, dtype, layer=None):
    """(jax k, jax v), (torch k, torch v): the torch pages a strided layer
    view when `layer` is given."""
    jd, td = DTYPES[dtype]
    tk, tv = torch.from_numpy(k).to(td), torch.from_numpy(v).to(td)
    if layer is not None:
        tk, tv = tk[:, layer], tv[:, layer]
        assert not tk.is_contiguous()
        k, v = k[:, layer], v[:, layer]
    return (jnp.asarray(k, jd), jnp.asarray(v, jd)), (tk, tv)


# ---------------------------------------------------------------------------
# paged_decode_attention
# ---------------------------------------------------------------------------

DECODE_CASES = {        # b, hq, hkv, d, bs, lengths, pool layers (0 = a bare page array)
    "gqa_odd_lengths": (3, 8, 2, 16, 8, (5, 17, 24), 0),    # tests/test_paged_kv.py
    "mha_length_one": (2, 4, 4, 32, 16, (1, 31), 0),
    "tiny_blocks": (1, 6, 2, 64, 4, (13,), 0),
    "mqa_aligned_odd": (4, 8, 1, 16, 8, (8, 16, 9, 3), 0),
    "pool_layer_view": (3, 4, 2, 16, 8, (20, 7, 33), 3),    # layer 1 of [N,3,bs,H,D]
    # a row at length 0 reads its whole table (padded with page 0, a valid
    # id) and gets the average of V over those slots
    "length_zero": (3, 4, 2, 16, 8, (12, 0, 5), 0),
    # pages of 12 slots: a 64-key tile of the CUDA bodies ends mid-page
    "bs12": (2, 4, 2, 16, 12, (13, 70), 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_paged_decode_plain_matches_pallas(case, dtype):
    b, hq, hkv, d, bs, lengths, layers = DECODE_CASES[case]
    rng = np.random.default_rng(0)
    k, v, tables = _pages(rng, lengths, 24, bs, hkv, d, layers)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    (jk, jv), (tk, tv) = _both(k, v, dtype, 1 if layers else None)
    jd, td = DTYPES[dtype]
    lens = np.asarray(lengths, np.int32)
    out_j = jax_paged_decode(jnp.asarray(q, jd), jk, jv, tables, lens)
    tq, tt = torch.from_numpy(q).to(td), torch.from_numpy(tables)
    tl = torch.from_numpy(lens)
    n0 = dict(LAUNCHES)
    out_t = ref.paged_decode_attention_ref(tq, tk, tv, tt, tl)
    # the entry point the model calls, with the reference's [B,1,Hq,D] form
    routed = ops.paged_decode_attention_auto(tq[:, None], tk, tv, tt, tl)
    assert LAUNCHES == n0, "a CPU tensor must not reach a kernel"
    assert torch.equal(routed[:, 0], out_t)
    assert out_t.dtype == td and tuple(out_t.shape) == q.shape
    np.testing.assert_allclose(_f32(out_t), _f32(out_j), rtol=TOL[dtype], atol=TOL[dtype])


def test_paged_gather_reads_a_layer_view_in_table_order():
    rng = np.random.default_rng(3)
    k, _, tables = _pages(rng, (12, 3), 8, 4, 2, 8, layers=2)
    pool = torch.from_numpy(k)
    dense = ref.paged_gather_ref(pool[:, 1], torch.from_numpy(tables))
    assert tuple(dense.shape) == (2, tables.shape[1] * 4, 2, 8)
    for i, row in enumerate(tables):
        for j, page in enumerate(row):
            assert torch.equal(dense[i, 4 * j:4 * j + 4], pool[page, 1])


# ---------------------------------------------------------------------------
# paged_prefill_attention
# ---------------------------------------------------------------------------

PREFILL_CASES = {       # b, c, hq, hkv, d, bs, prefixes, q_lens (None = full), layers
    "aligned_mid_block": (2, 8, 4, 2, 16, 8, (16, 9), None, 0),     # tests/test_kernels.py
    "no_prefix": (1, 5, 6, 2, 32, 8, (0,), None, 0),
    "chunk_lt_block": (3, 3, 4, 4, 16, 4, (4, 7, 1), None, 0),
    "chunk_spans_blocks": (1, 16, 2, 1, 64, 8, (24,), None, 0),
    "ragged_pool_layer_view": (3, 8, 4, 2, 16, 8, (0, 13, 40), (8, 3, 5), 3),
    # pages of 12 slots; one chunk ends mid-page past the first 64-key tile
    "bs12": (2, 8, 4, 2, 16, 12, (58, 9), (8, 5), 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_paged_prefill_plain_matches_pallas(case, dtype):
    b, c, hq, hkv, d, bs, prefixes, qlens, layers = PREFILL_CASES[case]
    qlens = qlens or (c,) * b
    rng = np.random.default_rng(1)
    ends = [p + n for p, n in zip(prefixes, qlens)]
    k, v, tables = _pages(rng, ends, 24, bs, hkv, d, layers)
    q = rng.standard_normal((b, c, hq, d)).astype(np.float32)
    (jk, jv), (tk, tv) = _both(k, v, dtype, 1 if layers else None)
    jd, td = DTYPES[dtype]
    qs, ql = np.asarray(prefixes, np.int32), np.asarray(qlens, np.int32)
    out_j = jax_paged_prefill(jnp.asarray(q, jd), jk, jv, tables, qs, ql)
    args = (torch.from_numpy(q).to(td), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(qs), torch.from_numpy(ql))
    n0 = dict(LAUNCHES)
    out_t = ref.paged_prefill_attention_ref(*args)
    assert torch.equal(ops.paged_prefill_attention_auto(*args), out_t)
    assert LAUNCHES == n0, "a CPU tensor must not reach a kernel"
    assert out_t.dtype == td and tuple(out_t.shape) == q.shape
    # every row, the don't-care padding rows too: both compute them alike
    np.testing.assert_allclose(_f32(out_t), _f32(out_j), rtol=TOL[dtype], atol=TOL[dtype])


def test_paged_prefill_chunks_match_dense_causal():
    """Consecutive chunks over pages reproduce one dense causal prefill
    (`flash_attention_ref`), the exactness the chunk-set pass rests on."""
    s, hq, hkv, d, bs, chunk = 44, 4, 2, 16, 8, 10
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, s, h, d)).astype(np.float32))
               for h in (hq, hkv, hkv))
    dense = ref.flash_attention_ref(q, k, v, causal=True)
    nb = -(-s // bs)
    kp = torch.zeros(nb, bs, hkv, d)
    vp = torch.zeros(nb, bs, hkv, d)
    kp.view(-1, hkv, d)[:s], vp.view(-1, hkv, d)[:s] = k[0], v[0]
    bt = torch.arange(nb, dtype=torch.int32)[None].flip(1).contiguous()   # pages reversed
    kp, vp = kp.flip(0), vp.flip(0)
    for pos in range(0, s, chunk):
        c = min(chunk, s - pos)
        out = ref.paged_prefill_attention_ref(q[:, pos:pos + c], kp, vp, bt,
                                              torch.tensor([pos], dtype=torch.int32),
                                              torch.tensor([c], dtype=torch.int32))
        np.testing.assert_allclose(out.numpy(), dense[:, pos:pos + c].numpy(),
                                   rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the pool's helpers and a fused layer over the pages in place
# ---------------------------------------------------------------------------

def _pool(lens, layers=2, hkv=2, d=16, bs=8, n=16, seed=4):
    pool = BlockPool(n, bs)
    pages = PagedKVCache(pool, layers=layers, num_kv_heads=hkv, head_dim=d)
    rng = np.random.default_rng(seed)
    pool.allocate(99, 20)                  # a live sequence first: tables do not start at 0
    for seq, n_tok in enumerate(lens):
        pool.allocate(seq, n_tok)
    pages.k.copy_(torch.from_numpy(rng.standard_normal(pages.k.shape).astype(np.float32)))
    pages.v.copy_(torch.from_numpy(rng.standard_normal(pages.v.shape).astype(np.float32)))
    return pool, pages


def test_pool_tables_and_write_indices():
    pool, pages = _pool([17, 4])
    tab = pages.block_tables([1, 0])
    assert tab.dtype == torch.int32
    assert tab.tolist() == [pool.tables[1] + [0, 0], pool.tables[0]]
    w = pages.write_indices([0, 1], [14, 2], [3, 1], 4)
    assert w.dtype == torch.int64 and tuple(w.shape) == (3, 4)
    t0, t1 = pool.tables[0], pool.tables[1]
    assert w.tolist() == [[t0[1], t0[1], t0[2], t1[0]], [6, 7, 0, 2], [0, 1, 2, 4]]


@pytest.mark.parametrize("c,q_lens", [(1, None), (6, (6, 2, 4))])
def test_paged_layer_matches_the_gathered_layer(c, q_lens):
    """`attention_paged_batch` over the pages in place against
    `attention_decode_batch` over the gathered dense cache, then written back:
    the same outputs within 1e-5, the same pages, and padding rows never
    written.  C = 1 is a decode pass, C > 1 a ragged chunk-set pass."""
    cfg = get_arch("gpt2-1.5b").reduced()
    d, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    lens = [23, 9, 14]
    pool, pages = _pool(lens, hkv=hkv, d=d)
    pos = [n - c if q_lens is None else n - 6 for n in lens]
    ql = [c] * 3 if q_lens is None else list(q_lens)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, c, cfg.d_model)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    p = attn.attn_init(gen, cfg, torch.float32, "cpu")
    pos_t = torch.tensor(pos, dtype=torch.int32)
    ql_t = torch.tensor(ql, dtype=torch.int32)
    before = pages.k.clone()

    dense = pages.gather_dense([0, 1, 2], 24)
    slots = torch.arange(24, dtype=torch.int32)[None, :]
    kv_pos = torch.where(slots < (pos_t + ql_t)[:, None], slots, -1)
    kc, vc = dense["k"][1], dense["v"][1]
    want, _, _ = attn.attention_decode_batch(x, p, cfg, kc, vc, kv_pos, pos_t,
                                             None if q_lens is None else ql_t, rope=False)

    tables = pages.block_tables([0, 1, 2])
    widx = pages.write_indices([0, 1, 2], pos, ql, c)
    got = attn.attention_paged_batch(x, p, cfg, pages.k[:, 1], pages.v[:, 1], tables, widx,
                                     pos_t, lengths=pos_t + 1 if q_lens is None else None,
                                     q_lens=None if q_lens is None else ql_t, rope=False)
    for i in range(3):          # valid rows agree; padding rows are don't-care
        np.testing.assert_allclose(got[i, :ql[i]].numpy(), want[i, :ql[i]].numpy(),
                                   rtol=0, atol=1e-5)
        dk = pages.gather_dense(i, 24)["k"][1, 0]
        np.testing.assert_array_equal(dk[:lens[i]].numpy(), kc[i, :lens[i]].numpy())
    # only the written slots changed, and only in layer 1
    changed = (pages.k != before).any(dim=(3, 4))          # [N, L, bs]
    assert not changed[:, 0].any()
    assert int(changed.sum()) == sum(ql)
