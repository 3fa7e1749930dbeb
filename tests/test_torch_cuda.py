"""The port's CUDA kernels and engine on the card (marked ``cuda``).

Each hand-written kernel against its plain PyTorch version on the same CUDA
tensors, and the engine on the card against the engine on the CPU.  This
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch with CUDA:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test here skips (the check is made in a fixture).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread is faster, and steady on a shared host
torch.set_num_threads(1)

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import LAUNCHES, TRAIN_KERNELS, ops, ref, train_launches  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py bands


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,meta,alibi", [
    (0, 0, False), (24, 0, False), (24, 2, False), (0, 0, True), (24, 2, True)])
@pytest.mark.parametrize("b,s,hq,hkv,d,lengths", [
    (3, 96, 4, 2, 16, (90, 96, 7)),
    (2, 300, 25, 25, 64, (1, 300)),              # gpt2 heads, G = 1
    (2, 130, 32, 1, 128, (129, 64)),             # G = 32: dynamic shared memory
])
def test_batched_decode_attention_kernel_matches_plain(cuda, b, s, hq, hkv, d, lengths,
                                                       window, meta, alibi, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    slopes = (torch.tensor([2.0 ** -(i + 1) for i in range(hq)], device=cuda)
              if alibi else None)
    n0 = LAUNCHES["batched_decode_attention"]
    out = ops.batched_decode_attention_auto(q, k, v, lens, window=window, num_meta=meta,
                                            alibi=slopes)
    assert LAUNCHES["batched_decode_attention"] == n0 + 1
    ws = (lens - window).clamp(min=0) if window else None
    exp = ref.batched_decode_attention_ref(q, k, v, lens, ws, slopes, num_meta=meta)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_pack_kernels_match_plain_bit_for_bit(cuda, dtype):
    cache = torch.randn(3, 4, 64, 5, 16, device=cuda).to(dtype)
    n0 = dict(LAUNCHES)
    assert torch.equal(ops.kv_pack_auto(cache, 16, 24), ref.kv_pack_ref(cache, 16, 24))
    # a one-row view of the batch, as the chunk write-back passes it
    assert torch.equal(ops.kv_pack_auto(cache[:, 1:2], 8, 8),
                       ref.kv_pack_ref(cache[:, 1:2], 8, 8))
    starts = [0, 56, 8, 32]
    assert torch.equal(ops.kv_pack_ragged_auto(cache, starts, 8),
                       ref.kv_pack_ragged_ref(cache, starts, 8))
    assert LAUNCHES["kv_pack"] == n0["kv_pack"] + 2
    assert LAUNCHES["kv_pack_ragged"] == n0["kv_pack_ragged"] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", [
    (2, 64, 64, 4, 2, 16, True),                 # GQA, one tile
    (1, 100, 100, 6, 2, 32, True),               # ragged tails
    (2, 24, 96, 4, 4, 16, True),                 # a query block at the end of the keys
    (1, 70, 50, 2, 1, 64, False),                # full attention, Sq > Skv
    (2, 130, 130, 25, 25, 64, True),             # gpt2 heads
    (1, 65, 65, 8, 2, 128, True),                # head dim 128: dynamic shared memory
    (2, 1228, 1228, 25, 5, 64, True),            # Hymba's GQA, Skv not a multiple of 64
    (2, 100, 300, 8, 2, 64, True),               # Sq < Skv: the tile past a batch row's
    (2, 70, 200, 4, 2, 128, True),               # end reads zeros, not the next row
    (1, 130, 130, 32, 32, 96, True),             # phi-3-vision's heads: two boxes, half zeros
    (2, 50, 70, 4, 4, 96, False),                # D 96, full attention
    (1, 200, 200, 96, 8, 192, True),             # nemotron's heads: three boxes
    (1, 70, 150, 4, 2, 192, True),               # D 192, Sq < Skv, keys end mid-tile
    (4, 1, 1024, 16, 16, 64, False),             # seamless's decode cross-attention: one
    (4, 64, 1024, 16, 16, 64, False),            # query, then the prompt, over the source
    (2, 1, 100, 4, 2, 96, False),                # one query, keys end mid-tile
])
def test_flash_attention_kernel_matches_plain(cuda, b, sq, skv, hq, hkv, d, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    n0 = LAUNCHES["flash_attention"]
    mask = None
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool, device=cuda).tril(skv - sq)
    if sq == skv or not causal:
        out = ops.attention_auto(q, k, v, mask=mask)
    else:
        from repro_torch.kernels.flash_attention import flash_attention
        out = flash_attention(q, k, v, causal=True)
    assert LAUNCHES["flash_attention"] == n0 + 1
    exp = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])


LSE_TOL = 1e-4     # the forward's row log-sum-exp, absolute (chip_smoke.LSE_TOL)


def _plain_lse(q, k, causal):
    """Each query row's log-sum-exp of its scaled f32 scores, [B,Hq,Sq]."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float().reshape(b, sq, hkv, -1, d),
                          k.float()) * d ** -0.5
    if causal:
        vis = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril(skv - sq)
        scores = torch.where(vis, scores, ref.NEG_INF)
    return torch.logsumexp(scores, -1).reshape(b, hq, sq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 96, 192])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,skv", [(1, 1024), (5, 1024), (64, 1024), (1, 1030), (5, 1030),
                                    (64, 1030), (1, 130), (5, 130), (64, 130), (1, 64),
                                    (5, 64), (64, 64), (512, 512)])
def test_flash_attention_split_matches_plain(cuda, sq, skv, causal, d, dtype):
    """GQA 4:2 over one sequence: a few blocks a query tile leave the card
    short, so bf16 splits each query tile's key tiles over a cluster where
    the keys span 4 tiles or more (1,024 keys; 1,030, whose last tile holds
    6; 512, where causal, the first query tile's one key tile leaves blocks
    of its cluster with none).  130 and 64 keys do not split.  The output
    and the row LSE against the plain version, and a second call gives the
    same bits."""
    from repro_torch.kernels.flash_attention import flash_attention, split_plan
    b, hq, hkv = 1, 4, 2
    splits = split_plan(dtype, b, sq, skv, hq, d)
    assert (splits > 1) == (dtype == torch.bfloat16 and skv >= 256)
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    n0 = LAUNCHES["flash_attention"]
    out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
    assert LAUNCHES["flash_attention"] == n0 + 1
    out2, lse2 = flash_attention(q, k, v, causal=causal, with_lse=True)
    exp = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])
    assert (lse - _plain_lse(q, k, causal)).abs().max().item() <= LSE_TOL
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,causal", [
    (1, 70, 150, 4, 2, True),          # Sq < Skv, keys end mid-tile
    (2, 200, 130, 6, 2, False),        # full, Sq > Skv: the second consumer's rows past Sq
    (1, 130, 130, 8, 2, True),         # the last 128-row tile's second consumer has no row
    (1, 1, 100, 4, 2, False),          # one query
    (2, 384, 384, 48, 8, True),        # three query tiles a head, the lower halves stop early
])
def test_flash_attention_d192_two_consumer_body(cuda, b, sq, skv, hq, hkv, causal):
    """bf16 at head dim 192: the calls that do not split run the
    two-consumer body (128 query rows a block, a producer warpgroup over a
    two-stage TMA ring), each consumer stopping at its own causal limit.
    The output and the row LSE against the plain version, and a second call
    gives the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention, split_plan
    dtype, d = torch.bfloat16, 192
    assert split_plan(dtype, b, sq, skv, hq, d) == 1
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    n0 = LAUNCHES["flash_attention"]
    out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
    out2, lse2 = flash_attention(q, k, v, causal=causal, with_lse=True)
    assert LAUNCHES["flash_attention"] == n0 + 2
    exp = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])
    assert (lse - _plain_lse(q, k, causal)).abs().max().item() <= LSE_TOL
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["prefix", "window_meta", "scattered", "one_slot"])
@pytest.mark.parametrize("b,s,hq,hkv,d", [(2, 96, 4, 2, 16), (3, 200, 25, 25, 64),
                                          (1, 130, 32, 1, 128), (2, 150, 32, 32, 96),
                                          (1, 300, 96, 8, 192)])
def test_decode_attention_kernel_matches_plain(cuda, b, s, hq, hkv, d, kind, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, 1, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    pos = torch.arange(s, device=cuda)
    valid = {"prefix": pos < s - 7,
             "window_meta": (pos <= s - 20) & ((pos > s - 60) | (pos < 4)),
             "scattered": torch.rand(s, generator=g, device=cuda) < 0.3,
             "one_slot": pos == s // 2}[kind]
    valid[s // 2] = True
    n0 = LAUNCHES["decode_attention"]
    out = ops.decode_attention_auto(q, k, v, valid[None])
    assert LAUNCHES["decode_attention"] == n0 + 1
    exp = ref.decode_attention_ref(q[:, 0], k, v, valid)[:, None]
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])


def _split_edges(dtype, b, s, hq, hkv, d):
    """The first key of each block of the split body's cluster for this
    shape, and the capacity: [0, ..., s]."""
    from repro_torch.kernels.decode_attention import split_plan
    splits = split_plan(dtype, b, s, hq, hkv, d)[0]
    nt = -(-s // 64)
    return [min(nt * r // splits * 64, s) for r in range(splits + 1)]


# head dims of the split decode body: powers of two, and rows of 5, 12, 20,
# 24 and 25 bf16 chunks, whose lanes the lane plan maps with up to 3 chunks
# a lane (10, 24, 40, 48 and 50 in f32, which keeps one or two)
SPLIT_DIMS = [16, 32, 40, 64, 96, 128, 160, 192, 200, 256]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", SPLIT_DIMS)
@pytest.mark.parametrize("kind", ["split_edge", "mid_split", "one_tile", "uneven",
                                  "scattered_empty_splits", "none_valid"])
def test_decode_attention_split_matches_plain(cuda, kind, d, dtype):
    """Hymba's 25:5 heads over a ring of 1152 slots (8 blocks of 2-3 tiles),
    one of 40 (below one tile: one block) and one of 600 (10 tiles, the last
    partial, over 8 blocks); none_valid: no slot valid, the sum of V over
    the slots over the padded length.  At D 256 the ring has two stages
    (bf16) or one (f32)."""
    b, hq, hkv = 2, 25, 5
    s = {"one_tile": 40, "uneven": 600}.get(kind, 1152)
    edges = _split_edges(dtype, b, s, hq, hkv, d)
    assert len(edges) - 1 == (1 if kind == "one_tile" else 8)
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    pos = torch.arange(s, device=cuda)
    if kind == "split_edge":            # blocks 3.. wholly past the last valid key
        valid = pos < edges[3]
    elif kind == "mid_split":
        valid = pos < edges[3] + 37
    elif kind == "scattered_empty_splits":
        valid = torch.rand(s, generator=g, device=cuda) < 0.3
        valid[edges[1]:edges[3]] = False          # blocks 1 and 2 see no valid key
        valid[edges[6]:] = False
        valid[edges[4] + 5] = True
    elif kind == "none_valid":
        valid = pos < 0
    else:
        valid = pos < s - 3
    from repro_torch.kernels.decode_attention import decode_attention
    n0 = LAUNCHES["decode_attention"]
    out = decode_attention(q, k, v, valid)
    assert LAUNCHES["decode_attention"] == n0 + 1
    exp = ref.decode_attention_ref(q, k, v, valid)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_entries_average_v_where_no_key_is_valid(cuda, dtype):
    """A row with no valid key gets the sum of V over its S slots divided by
    what the Pallas kernel walks (S padded to a multiple of 512 over a dense
    cache, S over pages), as the plain versions give: an all-false validity
    vector for decode_attention, a length of 0 (or a window start past the
    length) for the others.  S = 544 is mb_serve's cache, padded to 1024."""
    from repro_torch.kernels.decode_attention import (batched_decode_attention,
                                                      decode_attention,
                                                      paged_decode_attention)
    g = torch.Generator(device=cuda).manual_seed(3)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    def close(out, exp):
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])

    for s in (70, 544, 1152):            # one block, and clusters of 8
        q, k, v = rand(2, 25, 64), rand(2, s, 5, 64), rand(2, s, 5, 64) + 1
        none = torch.zeros(s, dtype=torch.bool, device=cuda)
        close(decode_attention(q, k, v, none), ref.decode_attention_ref(q, k, v, none))
    lengths = [0, 77, 300]
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q, k, v = rand(3, 4, 16), rand(3, 300, 2, 16), rand(3, 300, 2, 16)
    close(batched_decode_attention(q, k, v, lens),
          ref.batched_decode_attention_ref(q, k, v, lens))
    # S = 544: a length-0 row, and a window start past a row's length, with
    # and without meta sinks and ALiBi
    lens = torch.tensor([0, 77, 544], dtype=torch.int32, device=cuda)
    ws = torch.tensor([0, 90, 500], dtype=torch.int32, device=cuda)
    slopes = torch.tensor([2.0 ** -(i + 1) for i in range(25)], device=cuda)
    q, k, v = rand(3, 25, 64), rand(3, 544, 5, 64), rand(3, 544, 5, 64) + 1
    for win, sl, meta in ((None, None, 0), (ws, None, 0), (ws, slopes, 0), (ws, slopes, 4)):
        close(batched_decode_attention(q, k, v, lens, win, sl, num_meta=meta),
              ref.batched_decode_attention_ref(q, k, v, lens, win, sl, num_meta=meta))
    # the row at 0 reads its whole table, padded with page 0
    kp, vp, tables = _paged(g, lengths, 5, 64, dtype)
    q = rand(3, 25, 64)
    close(paged_decode_attention(q, kp, vp, tables, lens),
          ref.paged_decode_attention_ref(q, kp, vp, tables, lens))


BATCHED_SPLIT_KINDS = {   # lengths, window starts (or a window), meta sinks, ALiBi, heads
    # window starts on a 64-key tile edge, and off one
    "window_on_tile_edge": ([1024, 700, 450, 64], [512, 640, 128, 0], 0, False, (25, 5)),
    "window_off_tile_edge": ([1024, 700, 450, 64], [515, 641, 100, 3], 0, False, (25, 5)),
    # meta sinks spanning all of tile 0 and part of tile 1, beside a window
    "meta_spans_tile": ([1024, 700, 450, 64], 32, 70, False, (25, 5)),
    # a 32-slot window: 1-2 live tiles for a cluster of 8 blocks
    "few_live_tiles": ([1024, 700, 450, 100], 32, 0, False, (25, 5)),
    "ragged_1_and_s": ([1, 1024, 2, 1023], None, 0, False, (25, 5)),
    "alibi_window_meta": ([1024, 700, 450, 64], 96, 4, True, (25, 5)),
    # G = 32: four blocks of 8 query rows (f32), two of 16 (bf16)
    "g32_alibi_window": ([1024, 700, 450, 64], 96, 4, True, (32, 1)),
    # no valid key: a length of 0, and a window start past the length
    "length_zero": ([0, 1024, 450, 64], [0, 1000, 500, 0], 0, False, (25, 5)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", SPLIT_DIMS)
@pytest.mark.parametrize("kind", list(BATCHED_SPLIT_KINDS))
def test_batched_decode_attention_split_matches_plain(cuda, kind, d, dtype):
    """batched_decode_attention on the split body over a dense cache of
    1024 slots: each block of a cluster of 8 takes its share of a sequence's
    live tiles (meta tiles, then the window's), masking per slot only on the
    tile that holds the window start."""
    lengths, win, meta, alibi, (hq, hkv) = BATCHED_SPLIT_KINDS[kind]
    from repro_torch.kernels.decode_attention import batched_decode_attention, split_plan
    b, s = len(lengths), 1024
    assert split_plan(dtype, b, s, hq, hkv, d)[0] == 8
    g = torch.Generator(device=cuda).manual_seed(10)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    if isinstance(win, int):
        ws = (lens - win).clamp(min=0)
    else:
        ws = None if win is None else torch.tensor(win, dtype=torch.int32, device=cuda)
    slopes = (torch.tensor([2.0 ** -(i % 8 + 1) for i in range(hq)], device=cuda)
              if alibi else None)
    n0 = LAUNCHES["batched_decode_attention"]
    out = batched_decode_attention(q, k, v, lens, ws, slopes, num_meta=meta)
    assert LAUNCHES["batched_decode_attention"] == n0 + 1
    exp = ref.batched_decode_attention_ref(q, k, v, lens, ws, slopes, num_meta=meta)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])


DECODE_LSE_TOL = 5e-3   # decode_attention's row LSE, absolute (chip_smoke.DECODE_LSE_TOL)


@pytest.mark.parametrize("d", [64, 128, 192])
@pytest.mark.parametrize("group", [6, 7, 8, 12, 16, 24])
@pytest.mark.parametrize("mode", ["valid", "paged", "ragged"])
def test_decode_tensor_core_instance_matches_plain(cuda, mode, group, d):
    """bf16 groups of 6 or more take the split body's tensor-core instance
    (16 query rows a block, 24 in blocks of 16 and 8): yi-34b's G 7,
    qwen3-moe's 8, nemotron-4-340b's 12.  Two KV heads over 600 slots, a
    cluster of several blocks.  decode_attention: a validity ending mid-tile and
    mid-split with holes, its LSE, then no valid slot; paged: lengths 0,
    mid-page, mid-tile and on a tile edge; ragged: window starts, meta sinks
    and ALiBi, then a window start past a length with no sinks."""
    from repro_torch.kernels.decode_attention import (batched_decode_attention,
                                                      decode_attention,
                                                      paged_decode_attention)
    dtype, hkv, s = torch.bfloat16, 2, 600
    hq = group * hkv
    g = torch.Generator(device=cuda).manual_seed(100 * group + d)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    def close(out, exp):
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == exp.shape
        torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])

    n0 = dict(LAUNCHES)
    if mode == "valid":
        q, k, v = rand(2, hq, d), rand(2, s, hkv, d), rand(2, s, hkv, d)
        edges = _split_edges(dtype, 2, s, hq, hkv, d)
        assert len(edges) - 1 > 1
        valid = ((torch.arange(s, device=cuda) < edges[len(edges) // 2] + 37)
                 & (torch.rand(s, generator=g, device=cuda) < 0.7))
        valid[5] = True
        out, lse = decode_attention(q, k, v, valid, with_lse=True)
        exp, exp_lse = ref.decode_attention_ref(q, k, v, valid, with_lse=True)
        close(out, exp)
        assert (lse - exp_lse).abs().max().item() <= DECODE_LSE_TOL
        none = torch.zeros(s, dtype=torch.bool, device=cuda)
        close(decode_attention(q, k, v, none), ref.decode_attention_ref(q, k, v, none))
        assert LAUNCHES["decode_attention"] == n0["decode_attention"] + 2
    elif mode == "paged":
        lengths = [0, 301, 517, 64]
        kp, vp, tables = _paged(g, lengths, hkv, d, dtype)
        q = rand(len(lengths), hq, d)
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        close(paged_decode_attention(q, kp, vp, tables, lens),
              ref.paged_decode_attention_ref(q, kp, vp, tables, lens))
        assert LAUNCHES["paged_decode_attention"] == n0["paged_decode_attention"] + 1
    else:
        q, k, v = rand(4, hq, d), rand(4, s, hkv, d), rand(4, s, hkv, d)
        lens = torch.tensor([600, 451, 77, 300], dtype=torch.int32, device=cuda)
        ws = torch.tensor([530, 200, 0, 400], dtype=torch.int32, device=cuda)
        slopes = torch.tensor([2.0 ** -(i % 8 + 1) for i in range(hq)], device=cuda)
        for sl, meta in ((slopes, 4), (None, 0)):
            close(batched_decode_attention(q, k, v, lens, ws, sl, num_meta=meta),
                  ref.batched_decode_attention_ref(q, k, v, lens, ws, sl, num_meta=meta))
        assert LAUNCHES["batched_decode_attention"] == n0["batched_decode_attention"] + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_unpack_kernel_matches_plain_bit_for_bit(cuda, dtype):
    cache = torch.randn(3, 4, 64, 5, 16, device=cuda).to(dtype)
    buf = torch.randn(3, 4, 24, 5, 16, device=cuda).to(dtype)
    mine, plain = cache.clone(), cache.clone()
    n0 = LAUNCHES["kv_unpack"]
    assert ops.kv_unpack_auto(mine, buf, 16) is mine
    assert torch.equal(mine, ref.kv_unpack_ref(plain, buf, 16))
    # a layer-and-row view of the cache, as the disaggregated landing writes
    part = torch.randn(2, 1, 8, 5, 16, device=cuda).to(dtype)
    ops.kv_unpack_auto(mine[1:3, 2:3], part, 56)
    ref.kv_unpack_ref(plain[1:3, 2:3], part, 56)
    assert torch.equal(mine, plain)
    assert LAUNCHES["kv_unpack"] == n0 + 2


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 4, 12, device=cuda)                     # D % 8 != 0
    k = torch.zeros(1, 8, 2, 12, device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.batched_decode_attention_auto(q, k, k, lens)
    with pytest.raises(TypeError):
        ops.kv_pack_auto(torch.zeros(1, 1, 16, 1, 8, device=cuda, dtype=torch.float16),
                         0, 8)
    with pytest.raises(ValueError, match="not aligned"):
        ops.kv_pack_ragged_auto(torch.zeros(1, 2, 16, 1, 8, device=cuda), [0, 4], 8)


def _paged(g, ends, hkv, d, dtype, layers=4, bs=8):
    """Pages for sequences holding `ends` tokens: layer 2's strided view of a
    pool [N, layers, bs, hkv, d] with page ids in a shuffled order, and the
    int32 tables [B, nb] padded with page 0."""
    nbs = [-(-e // bs) for e in ends]
    n = sum(nbs) + 3
    order = torch.randperm(n, generator=torch.Generator().manual_seed(n)).tolist()
    rows, o = [], 0
    for nb in nbs:
        rows.append(order[o:o + nb] + [0] * (max(nbs) - nb))
        o += nb
    pools = [torch.randn(n, layers, bs, hkv, d, generator=g, device=g.device).to(dtype)
             for _ in range(2)]
    return pools[0][:, 2], pools[1][:, 2], torch.tensor(rows, dtype=torch.int32,
                                                        device=g.device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,bs,lengths", [
    (4, 2, 16, 8, (90, 96, 7)),                  # GQA, ragged
    (25, 25, 64, 8, (1, 300, 64)),               # gpt2 heads, a one-token sequence
    (32, 1, 128, 16, (129, 64)),                 # G = 32: dynamic shared memory
    (6, 2, 64, 4, (13,)),                        # tiny pages
    (32, 32, 96, 8, (90, 33)),                   # phi-3-vision's heads
    (96, 8, 192, 8, (129, 64, 7)),               # nemotron's heads
])
def test_paged_decode_attention_kernel_matches_plain(cuda, hq, hkv, d, bs, lengths, dtype):
    g = torch.Generator(device=cuda).manual_seed(5)
    kp, vp, tables = _paged(g, list(lengths), hkv, d, dtype, bs=bs)
    q = torch.randn(len(lengths), 1, hq, d, generator=g, device=cuda).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n0 = LAUNCHES["paged_decode_attention"]
    out = ops.paged_decode_attention_auto(q, kp, vp, tables, lens)
    assert LAUNCHES["paged_decode_attention"] == n0 + 1
    exp = ref.paged_decode_attention_ref(q[:, 0], kp, vp, tables, lens)[:, None]
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,hq,hkv,d,prefixes,qlens", [
    (8, 4, 2, 16, (0, 9, 16), (8, 8, 8)),        # GQA, prefix 0, mid-block prefix
    (16, 2, 1, 64, (24,), (16,)),                # a chunk spanning blocks
    (64, 25, 25, 64, (0, 448, 130), (64, 64, 5)),   # gpt2 heads, a short final chunk
    (40, 8, 2, 128, (3, 70), (40, 33)),          # head dim 128, C*G of 160 rows
    (3, 4, 4, 32, (4, 7, 1), (3, 1, 2)),         # chunks shorter than a page
    (40, 32, 32, 96, (3, 70), (40, 33)),         # phi-3-vision's heads
    (64, 96, 8, 192, (0, 130, 7), (64, 17, 64)),  # nemotron's heads, a short chunk
])
def test_paged_prefill_attention_kernel_matches_plain(cuda, c, hq, hkv, d, prefixes, qlens,
                                                      dtype):
    g = torch.Generator(device=cuda).manual_seed(6)
    kp, vp, tables = _paged(g, [p + n for p, n in zip(prefixes, qlens)], hkv, d, dtype)
    q = torch.randn(len(prefixes), c, hq, d, generator=g, device=cuda).to(dtype)
    qs = torch.tensor(prefixes, dtype=torch.int32, device=cuda)
    ql = torch.tensor(qlens, dtype=torch.int32, device=cuda)
    n0 = LAUNCHES["paged_prefill_attention"]
    out = ops.paged_prefill_attention_auto(q, kp, vp, tables, qs, ql)
    assert LAUNCHES["paged_prefill_attention"] == n0 + 1
    exp = ref.paged_prefill_attention_ref(q, kp, vp, tables, qs, ql)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    valid = torch.arange(c, device=cuda)[None, :] < ql[:, None]     # padding: don't-care
    torch.testing.assert_close(out[valid].float(), exp[valid].float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


# chunks of 40: one ending mid-tile at 40, two ending mid-tile and mid-page
# for every page size below (113 and 207), and one that shows no slot
PREFILL_STARTS, PREFILL_LENS = (0, 83, 0, 190), (40, 30, 0, 17)


def _poisoned_tables(tables, ends, bs):
    """The tables with every entry past a sequence's ceil(end / bs) pages set
    to a page id far past the pool: a kernel that read one would fault."""
    bad = tables.clone()
    for i, e in enumerate(ends):
        bad[i, -(-e // bs):] = 10 ** 7
    return bad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 192])
@pytest.mark.parametrize("group", [1, 5])
@pytest.mark.parametrize("bs", [4, 8, 16, 12])
def test_paged_prefill_attention_kernel_matches_plain_over_page_sizes(cuda, bs, group, d,
                                                                      dtype):
    """Both bodies (bf16 on wgmma, f32 on the CUDA cores) at every page size,
    G 1 and 5 and every head dim, over tables whose padded entries hold a
    page id far past the pool: only the entries below each chunk's end are
    read.  The plain version reads the same tables padded with page 0."""
    hkv, c = 2, 40
    ends = [p + n for p, n in zip(PREFILL_STARTS, PREFILL_LENS)]
    g = torch.Generator(device=cuda).manual_seed(11)
    kp, vp, tables = _paged(g, ends, hkv, d, dtype, bs=bs)
    hq = hkv * group
    q = torch.randn(len(ends), c, hq, d, generator=g, device=cuda).to(dtype)
    qs = torch.tensor(PREFILL_STARTS, dtype=torch.int32, device=cuda)
    ql = torch.tensor(PREFILL_LENS, dtype=torch.int32, device=cuda)
    from repro_torch.kernels.paged_prefill import paged_prefill_attention
    n0 = LAUNCHES["paged_prefill_attention"]
    out = paged_prefill_attention(q, kp, vp, _poisoned_tables(tables, ends, bs), qs, ql)
    assert LAUNCHES["paged_prefill_attention"] == n0 + 1
    exp = ref.paged_prefill_attention_ref(q, kp, vp, tables, qs, ql)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (len(ends), c, hq, d)
    valid = torch.arange(c, device=cuda)[None, :] < ql[:, None]     # padding: don't-care
    torch.testing.assert_close(out[valid].float(), exp[valid].float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_prefill_attention_leaves_no_stale_shared_memory(cuda, dtype):
    """A launch over pages full of NaN leaves NaN in the shared memory the
    next launch's blocks get; that launch's last tiles are partial (chunks
    ending mid-tile and mid-page), and must zero their slots past the end
    rather than multiply a stale NaN by a probability of 0."""
    hkv, group, d, bs, c = 5, 5, 64, 12, 64
    starts, qlens = (0, 70, 131, 0, 300, 17), (64, 50, 64, 29, 64, 40)
    ends = [p + n for p, n in zip(starts, qlens)]
    g = torch.Generator(device=cuda).manual_seed(12)
    kp, vp, tables = _paged(g, ends, hkv, d, dtype, bs=bs)
    q = torch.randn(len(ends), c, hkv * group, d, generator=g, device=cuda).to(dtype)
    qs = torch.tensor(starts, dtype=torch.int32, device=cuda)
    ql = torch.tensor(qlens, dtype=torch.int32, device=cuda)
    from repro_torch.kernels.paged_prefill import paged_prefill_attention
    full = torch.tensor([c] * len(ends), dtype=torch.int32, device=cuda)
    nan_k, nan_v = torch.full_like(kp, float("nan")), torch.full_like(vp, float("nan"))
    for _ in range(3):
        paged_prefill_attention(q, nan_k, nan_v, tables, qs, full)
    out = paged_prefill_attention(q, kp, vp, tables, qs, ql)
    exp = ref.paged_prefill_attention_ref(q, kp, vp, tables, qs, ql)
    torch.cuda.synchronize()
    valid = torch.arange(c, device=cuda)[None, :] < ql[:, None]
    assert torch.isfinite(out[valid].float()).all()
    torch.testing.assert_close(out[valid].float(), exp[valid].float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [x for x in SPLIT_DIMS if x != 256])
@pytest.mark.parametrize("kind", ["split_edge", "one_tile", "uneven", "length_zero"])
def test_paged_decode_attention_split_matches_plain(cuda, kind, d, dtype):
    """Hymba's 25:5 heads over layer 2 of a pool with shuffled pages.
    split_edge: a capacity of 1024 slots over 8 blocks, lengths ending on a
    block's first key, inside a block, at 1 (every block but the first past
    it) and at the capacity; one_tile: a capacity below one tile; uneven: a
    capacity of 600 (10 tiles, the last partial, over 8 blocks);
    length_zero: split_edge's capacity with a row at length 0, which
    averages V over its whole table."""
    b, hq, hkv, bs = 4, 25, 5, 8
    s = {"one_tile": 40, "uneven": 600}.get(kind, 1024)
    edges = _split_edges(dtype, b, s, hq, hkv, d)
    assert len(edges) - 1 == (1 if kind == "one_tile" else 8)
    if kind == "split_edge":
        lengths = [edges[2], edges[2] + 37, 1, s]
    elif kind == "length_zero":
        lengths = [0, edges[2] + 37, s, 129]
    else:
        lengths = [5, 40, 17, 33] if kind == "one_tile" else [s, 333, 64, 129]
    g = torch.Generator(device=cuda).manual_seed(9)
    kp, vp, tables = _paged(g, lengths, hkv, d, dtype, bs=bs)
    assert tables.shape[1] * bs == s
    q = torch.randn(b, hq, d, generator=g, device=cuda).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    from repro_torch.kernels.decode_attention import paged_decode_attention
    n0 = LAUNCHES["paged_decode_attention"]
    out = paged_decode_attention(q, kp, vp, tables, lens)
    assert LAUNCHES["paged_decode_attention"] == n0 + 1
    exp = ref.paged_decode_attention_ref(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_paged_kernels_allocate_only_their_output(cuda):
    """A call on one layer's view of a pool copies nothing: the device
    memory it adds at its peak is its output (rounded to the allocator's
    512-byte blocks)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    kp, vp, tables = _paged(g, [500, 300, 64], 25, 64, torch.bfloat16, layers=8)
    lens = torch.tensor([500, 300, 64], dtype=torch.int32, device=cuda)
    q1 = torch.randn(3, 25, 64, generator=g, device=cuda).to(torch.bfloat16)
    q64 = torch.randn(3, 64, 25, 64, generator=g, device=cuda).to(torch.bfloat16)
    qs = torch.tensor([436, 236, 0], dtype=torch.int32, device=cuda)
    ql = torch.tensor([64, 64, 64], dtype=torch.int32, device=cuda)
    # decode_attention's dense cache and validity row, as the run() path passes them
    kd, vd = (torch.randn(3, 544, 25, 64, generator=g, device=cuda).to(torch.bfloat16)
              for _ in range(2))
    valid = torch.arange(544, device=cuda) <= 527
    for call, q in ((lambda: ops.paged_decode_attention_auto(q1, kp, vp, tables, lens), q1),
                    (lambda: ops.paged_prefill_attention_auto(q64, kp, vp, tables, qs, ql),
                     q64),
                    (lambda: ops.decode_attention_auto(q1[:, None], kd, vd, valid[None]), q1)):
        call()                                            # build and load first
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = call()
        torch.cuda.synchronize()
        out_bytes = -(-out.numel() * out.element_size() // 512) * 512
        assert torch.cuda.max_memory_allocated() - base <= out_bytes


def test_paged_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.paged_prefill import paged_prefill_attention
    kp = torch.zeros(6, 3, 8, 2, 16, device=cuda)[:, 1]           # a layer view
    q = torch.zeros(2, 4, 16, device=cuda)
    qc = torch.zeros(2, 5, 4, 16, device=cuda)
    tab = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    n0 = dict(LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_decode_attention(q.cpu(), kp.cpu(), kp.cpu(), tab.cpu(), lens.cpu())
    with pytest.raises(ValueError, match="block_tables"):
        paged_decode_attention(q, kp, kp, tab.long(), lens)
    with pytest.raises(ValueError, match="dense"):
        paged_decode_attention(q, kp.transpose(2, 3), kp.transpose(2, 3), tab, lens)
    with pytest.raises(ValueError, match="aligned"):
        odd = torch.zeros(6 * 8 * 2 * 16 + 1, device=cuda)[1:].view(6, 8, 2, 16)
        paged_decode_attention(q, odd, odd, tab, lens)
    with pytest.raises(TypeError):
        paged_prefill_attention(qc.to(torch.bfloat16), kp, kp, tab, lens, lens)
    with pytest.raises(ValueError, match="head dim"):
        kp12 = torch.zeros(6, 8, 2, 24, device=cuda)
        paged_prefill_attention(torch.zeros(2, 5, 4, 24, device=cuda), kp12, kp12, tab, lens,
                                lens)
    with pytest.raises(ValueError, match="q_lens"):
        paged_prefill_attention(qc, kp, kp, tab, lens, lens[:1])
    assert LAUNCHES == n0, "a refused call must not launch"


ENGINE_VARIANTS = {      # config changes -> the kernels the card run must launch
    # plain: the fused passes read the pages in place; each admission's first
    # chunk, a per-sequence pass, packs its window back
    "plain": ({}, ("paged_decode_attention", "paged_prefill_attention", "kv_pack")),
    # layer 1 windowed: stage 1 gathers, attends dense and packs back
    "window_meta": (dict(sliding_window=6, num_meta_tokens=2, full_attn_layers=(0,)),
                    ("paged_decode_attention", "paged_prefill_attention",
                     "batched_decode_attention", "kv_pack_ragged", "kv_pack")),
}


@pytest.mark.parametrize("variant", list(ENGINE_VARIANTS))
def test_engine_on_the_card_gives_the_cpu_tokens(cuda, variant):
    """Reduced gpt2-1.5b, fp32, 2 stage workers: the same weights and trace
    through the engine on the card and on the CPU give the same tokens, and
    the card's run went through exactly the kernels of its routes."""
    kw, launches = ENGINE_VARIANTS[variant]
    cfg = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), dtype="float32", **kw)
    params = DecoderLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (8, 12, 40, 9)]
    reps, launched = {}, {}
    for dev in ("cpu", "cuda"):
        reqs = [Request(rid=i, prompt=p.copy(), max_new=6) for i, p in enumerate(prompts)]
        eng = ServingEngine(cfg, DecoderLM(cfg, device=dev), params, 2, paged=True,
                            kv_pool_blocks=64, prefill_chunk_tokens=8, device=dev)
        n0 = dict(LAUNCHES)
        reps[dev] = eng.run_continuous(reqs, max_active=3)
        launched[dev] = {k: LAUNCHES[k] - n0[k] for k in LAUNCHES}
    assert reps["cuda"].tokens == reps["cpu"].tokens
    assert reps["cuda"].pass_trace == reps["cpu"].pass_trace
    # the kernels of the continuous-batching path's routes (run() has its own test)
    assert {k for k, n in launched["cuda"].items() if n} == set(launches), launched["cuda"]
    assert not any(launched["cpu"].values())


def test_run_on_the_card_gives_the_cpu_tokens(cuda):
    """run() in each mode on the card and on the CPU, same weights and
    trace: the same tokens and bytes moved, through the run() kernels."""
    cfg = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), dtype="float32",
                              num_layers=4)
    params = DecoderLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 12)).astype(np.int32)
    for n, kw, kernel in ((2, {}, "flash_attention"), (2, {"swapping": True}, "kv_pack"),
                          (4, {"mode": "disaggregated", "dp_split": (1, 3)}, "kv_unpack")):
        reps, launched = {}, {}
        for dev in ("cpu", "cuda"):
            reqs = [Request(rid=i, prompt=p.copy(), max_new=6) for i, p in enumerate(prompts)]
            eng = ServingEngine(cfg, DecoderLM(cfg, device=dev), params, n, microbatch=2,
                                device=dev, **kw)
            n0 = dict(LAUNCHES)
            reps[dev] = (eng.run(reqs).tokens, eng.transfer_summary())
            launched[dev] = {k: LAUNCHES[k] - n0[k] for k in LAUNCHES}
        assert reps["cuda"] == reps["cpu"], kw
        assert launched["cuda"][kernel] > 0 and launched["cuda"]["decode_attention"] > 0
        assert not any(launched["cpu"].values())


SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}   # tests/test_kernels.py SSD band


def _ssd_inputs(dev, b, s, nh, hd, g, n, dtype, with_h0, seed=0):
    # scaled so that |y| stays below 4, where one bf16 step is inside the band
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *sh: torch.randn(*sh, generator=gen, device=dev)   # noqa: E731
    return ((0.5 * r(b, s, nh, hd)).to(dtype), torch.nn.functional.softplus(r(b, s, nh)),
            -torch.exp(0.3 * r(nh)), (0.25 * r(b, s, g, n)).to(dtype),
            (0.25 * r(b, s, g, n)).to(dtype), 0.1 * r(b, nh, hd, n) if with_h0 else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,nh,hd,g,n,ch", [
    (2, 96, 4, 16, 1, 8, 32), (1, 64, 8, 8, 2, 16, 16), (2, 50, 4, 16, 1, 8, 32),
    (1, 33, 2, 8, 1, 4, 16),
    (8, 512, 48, 64, 1, 128, 128),              # mamba2-780m serving prefill
    (2, 1228, 50, 64, 1, 16, 128),              # hymba-1.5b, ragged last chunk
])
def test_ssd_scan_kernel_matches_plain(cuda, b, s, nh, hd, g, n, ch, with_h0, dtype):
    x, dt, a, bm, cm, h0 = _ssd_inputs(cuda, b, s, nh, hd, g, n, dtype, with_h0)
    n0 = LAUNCHES["ssd_scan"]
    y, hf = ops.ssd_auto(x, dt, a, bm, cm, chunk=ch, h0=h0)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == n0 + 1
    ye, he = ref.ssd_scan_ref(x, dt, a, bm, cm, h0=h0, chunk=min(ch, s))
    assert y.dtype == dtype and hf.dtype == torch.float32
    assert (y.float() - ye.float()).abs().max().item() <= SSD_TOL[dtype]
    # h_final is f32 whatever x's dtype, and feeds every later call: the f32 band
    assert (hf - he).abs().max().item() <= SSD_TOL[torch.float32]


def test_ssd_scan_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.ssd_scan import ssd_scan
    x, dt, a, bm, cm, h0 = _ssd_inputs(cuda, 1, 16, 4, 8, 1, 4, torch.float32, True)
    n0 = LAUNCHES["ssd_scan"]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(x.cpu(), dt.cpu(), a.cpu(), bm.cpu(), cm.cpu())
    with pytest.raises(TypeError):
        ssd_scan(x.half(), dt, a, bm.half(), cm.half())
    with pytest.raises(ValueError, match="dt must be float32"):
        ssd_scan(x, dt.double(), a, bm, cm)
    with pytest.raises(ValueError, match="h0"):
        ssd_scan(x, dt, a, bm, cm, h0[:, :2])
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, a, bm, cm)
    with pytest.raises(ValueError, match="nh % G"):
        ssd_scan(x, dt, a, torch.cat([bm] * 3, 2), torch.cat([cm] * 3, 2))
    big = _ssd_inputs(cuda, 1, 256, 2, 128, 1, 256, torch.float32, False)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_scan(*big[:5], chunk=256)
    assert LAUNCHES["ssd_scan"] == n0


@pytest.mark.parametrize("name", ["mamba2-780m", "hymba-1.5b"])
def test_ssm_families_on_the_card_give_the_cpu_tokens(cuda, name):
    """Reduced model, fp32: prefill and six greedy decode steps on the card
    and on the CPU with the same weights give the same tokens, and the card
    ran ssd_scan once per layer (and Hymba flash_attention once per
    full-attention layer and decode_attention per layer and step)."""
    cfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32")
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 30)).astype(np.int32)
    toks, launched = {}, {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        p = _tree_to(params, dev)
        n0 = dict(LAUNCHES)
        logits, state, pos = model.prefill(p, {"tokens": torch.as_tensor(prompts, device=dev)},
                                           max_len=cfg.context_overhead + 40)
        out = []
        for i in range(6):
            tok = logits.argmax(-1).to(torch.int32)
            out.append(tok.cpu())
            logits, state = model.decode_step(p, state, tok, pos + i)
        toks[dev] = torch.stack(out, 1)
        launched[dev] = {k: LAUNCHES[k] - n0[k] for k in LAUNCHES}
    assert torch.equal(toks["cuda"], toks["cpu"])
    assert launched["cuda"]["ssd_scan"] == cfg.num_layers
    assert launched["cuda"]["decode_attention"] == (
        6 * cfg.num_layers if cfg.family == "hybrid" else 0)
    assert launched["cuda"]["flash_attention"] == (
        len(cfg.full_attn_layers) if cfg.family == "hybrid" else 0)
    assert not any(launched["cpu"].values())


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# replication on the streamer's side stream, and recovery on the card
# ---------------------------------------------------------------------------

def _sync_copy(t):
    """The plain synchronous device-to-host copy the replica must equal."""
    torch.cuda.synchronize()
    return t.cpu()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_side_stream_replication_equals_a_synchronous_copy(cuda, dtype):
    """`replicate_to` and `replicate_block_to` copy on the streamer's side
    stream; the replica must equal a synchronous copy even when the compute
    stream frees the source right after the submit and writes over memory
    the allocator hands out next."""
    from repro_torch.core.dejavulib import StreamEngine
    from repro_torch.core.worker import CacheManager

    eng = StreamEngine("t", device=cuda)
    src, dst = CacheManager(0, eng), CacheManager(1, eng)
    acks = []
    g = torch.Generator(device=cuda).manual_seed(0)
    cache = {leaf: torch.randn(3, 2, 64, 5, 16, generator=g, device=cuda).to(dtype)
             for leaf in ("k", "v")}
    want = {leaf: _sync_copy(c) for leaf, c in cache.items()}
    n0 = LAUNCHES["kv_pack"]
    src.replicate_to(dst, 0, cache, (5, 40), 7, lambda *a: acks.append(a))
    assert LAUNCHES["kv_pack"] == n0 + 2
    block = {leaf: c[:, 0, 8:16].clone() for leaf, c in cache.items()}
    bwant = {leaf: _sync_copy(b) for leaf, b in block.items()}
    src.replicate_block_to(dst, 3, 1, block, 2, lambda *a: acks.append(a))
    # the compute stream drops every source and scribbles over what the
    # caching allocator gives back
    del cache, block
    junk = [torch.full((3, 2, 64, 5, 16), 7.0, device=cuda, dtype=dtype) for _ in range(8)]
    eng.drain(timeout=60)
    for leaf in ("k", "v"):
        rep = dst.replica.get(f"w0/mb0/{leaf}")
        assert torch.equal(rep[:, :, :40], want[leaf][:, :, :40])   # the aligned window
        assert not rep[:, :, 40:].any()
        assert torch.equal(dst.replica.get(f"w0/seq3/blk1/{leaf}"), bwant[leaf])
    assert acks == [(0, 0, 7), (0, 3, 2)]
    assert src.net.retransmits == 0 and junk[0].sum().item() != 0
    eng.close()


def _recovery_runs(cuda, fused: bool):
    cfg = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), dtype="float32", num_layers=4)
    model = DecoderLM(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in [8, 12, 8, 12, 8, 12]]
    mx = [6, 3, 7, 4, 3, 6]

    def run(paged, fail_at):
        kw = (dict(paged=True, kv_pool_blocks=64, fused_rounds=fused) if paged
              else dict(microbatch=2))
        eng = ServingEngine(cfg, model, params, 2 if paged else 4, replication=True,
                            device=cuda, **kw)
        reqs = [Request(rid=i, prompt=p.copy(), max_new=m if paged else 6)
                for i, (p, m) in enumerate(zip(prompts, mx))]
        rep = (eng.run_continuous(reqs, max_active=4, fail_at=fail_at) if paged
               else eng.run(reqs, fail_at=fail_at))
        return eng, rep
    return run


@pytest.mark.parametrize("fused", [True, False])
def test_recovery_on_the_card_gives_the_failure_free_tokens(cuda, fused):
    """fp32, 4 layers: run_continuous and run() with a worker failure give
    the failure-free run's tokens on the card, and leak nothing."""
    from repro_torch.core.dejavulib import assert_no_leaks

    run = _recovery_runs(cuda, fused)
    for paged, fails in ((True, ({9: 1}, {5: 0})), (False, ({9: 2}, {14: 0}))):
        _, clean = run(paged, None)
        for fail_at in fails:
            eng, rep = run(paged, fail_at)
            assert rep.failures == 1 and rep.recoveries == 1
            assert rep.tokens == clean.tokens, (paged, fail_at)
            assert_no_leaks(eng.cluster)


# ---------------------------------------------------------------------------
# the KV tiers on the card
# ---------------------------------------------------------------------------

def _tier_pages(cuda, dtype=torch.bfloat16):
    from repro_torch.kvcache import BlockPool, PagedKVCache
    pool = BlockPool(16, 8)
    pages = PagedKVCache(pool, layers=3, num_kv_heads=2, head_dim=64, dtype=dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    pages.k.copy_(torch.randn(pages.k.shape, generator=g, device=cuda).to(dtype))
    pages.v.copy_(torch.randn(pages.v.shape, generator=g, device=cuda).to(dtype))
    return pool, pages


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_bf16_blocks_through_every_tier_come_back_bit_exact(cuda, tmp_path):
    """bf16 prefix blocks demoted from the pages (a host tier of 1 block, so
    they spill to SSD), the host lost, the disk reattached by a new manager,
    promoted back to the card, then served again from the host tier: bit for
    bit the pages' bytes at every step."""
    from repro_torch.core.dejavulib import StreamEngine
    from repro_torch.kvcache import KVTierManager, TierConfig

    pool, pages = _tier_pages(cuda)
    cfg = TierConfig(host_capacity_blocks=1, ssd_root=str(tmp_path))
    want = {bid: {leaf: _sync_copy(a) for leaf, a in pages.block_arrays(bid).items()}
            for bid in range(4)}
    eng = StreamEngine("tier", device=cuda)
    mgr = KVTierManager(pool, pages, eng, cfg=cfg)
    for bid in range(4):
        mgr.cache_prefix_block(100 + bid, pages.block_arrays(bid))
    eng.drain(timeout=60)
    assert mgr.stats()["spills"] == 3
    mgr.on_host_failure()
    fresh = KVTierManager(pool, pages, eng, cfg=cfg)
    assert fresh.reattach() == 3               # the host-only block died with the host
    # the three that spilled, from SSD (the head earns the host slot), then
    # the head again, from the host tier
    for hashes in ([100, 101, 102], [100]):
        got = fresh.fetch_prefix_chain(hashes)
        torch.cuda.synchronize()
        for h in hashes:
            for leaf in ("k", "v"):
                assert got[h][leaf].device == pages.k.device
                assert got[h][leaf].dtype == torch.bfloat16
                assert torch.equal(_bits(got[h][leaf].cpu()), _bits(want[h - 100][leaf]))
    st = fresh.stats()
    assert st["ssd_hits"] == 3 and st["host_hits"] == 1
    eng.close()


@pytest.mark.parametrize("path", ["prefix", "swap"])
def test_a_block_demoted_before_its_page_is_reused_keeps_its_bytes(cuda, tmp_path, path):
    """The compute stream is held back, the block is demoted (its device
    copy is queued behind the hold), then the page is written over and the
    caching allocator's memory churned: the side stream's copy waits on the
    demotion's event, and `record_stream` keeps the copy's memory, so the
    tier holds the old bytes."""
    from repro_torch.core.dejavulib import StreamEngine
    from repro_torch.kvcache import KVTierManager, TierConfig

    pool, pages = _tier_pages(cuda)
    eng = StreamEngine("tier", device=cuda)
    mgr = KVTierManager(pool, pages, eng, cfg=TierConfig(ssd_root=str(tmp_path)))
    want = {leaf: _sync_copy(a) for leaf, a in pages.block_arrays(0).items()}
    torch.cuda._sleep(200_000_000)              # hold the compute stream back
    if path == "prefix":
        mgr.cache_prefix_block(7, pages.block_arrays(0))
    else:
        mgr.swap_out_blocks(3, {0: pages.block_arrays(0)})
    pages.k[0].fill_(9.0)                       # the pool hands the page out again
    pages.v[0].fill_(9.0)
    junk = [torch.full((2, 3, 8, 2, 64), 5.0, device=cuda, dtype=torch.bfloat16)
            for _ in range(16)]
    got = mgr.fetch_prefix_chain([7])[7] if path == "prefix" else mgr.swap_in_blocks(3)[0]
    torch.cuda.synchronize()
    for leaf in ("k", "v"):
        assert torch.equal(_bits(got[leaf].cpu()), _bits(want[leaf]))
    assert junk[0].float().sum().item() != 0
    eng.close()


# ---------------------------------------------------------------------------
# training: the flash backward, and the kernels that refuse to be differentiated
# ---------------------------------------------------------------------------

# the backward's band, relative to the largest |gradient| of the f32 plain
# version (chip_smoke.py's BWD_TOL): its sums run over up to G * Sq rows in
# another order (f32), and in bf16 P and dS enter their products, and
# dq/dk/dv are stored, rounded to 8 bits of mantissa
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", [
    (1, 150, 150, 4, 2, 16, True),               # keys end mid-tile: 150 = 2 * 64 + 22
    (1, 150, 150, 4, 2, 32, True),
    (1, 150, 150, 4, 2, 64, True),
    (1, 150, 150, 4, 2, 96, True),
    (1, 150, 150, 4, 2, 128, True),
    (1, 150, 150, 4, 2, 192, True),              # one block an SM: 231,424 bytes
    (2, 70, 130, 4, 1, 64, False),               # full attention, Sq != Skv, G = 4
    (1, 100, 260, 6, 2, 32, True),               # a query block at the end of the keys
    (2, 256, 256, 15, 5, 64, True),              # smollm's heads
    (1, 64, 64, 32, 4, 128, True),               # qwen3-moe's heads, one tile
    # lengths ending part-way through a 128-row run of the wgmma body, G = 1, 3, 8
    (1, 150, 150, 1, 1, 16, True),
    (1, 200, 200, 3, 1, 64, True),
    (1, 300, 300, 8, 1, 128, True),
    (1, 150, 300, 8, 1, 64, True),               # Sq < Skv, causal
    (1, 100, 300, 3, 1, 128, True),
    (1, 200, 300, 3, 1, 192, True),
    (1, 150, 200, 1, 1, 128, False),             # full, Sq < Skv
    (2, 200, 150, 6, 2, 192, False),             # full, Sq > Skv
    (2, 300, 300, 8, 1, 16, False),
    (2, 64, 32, 4, 2, 16, False),                # reduced seamless's cross: Sq > Skv
])
def test_flash_attention_backward_matches_autograd_through_plain(cuda, b, sq, skv, hq, hkv,
                                                                 d, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, dout = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                     for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                                   (b, sq, hq, d)))
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    n0 = dict(LAUNCHES)
    out = FlashAttentionFn.apply(qg, kg, vg, causal)
    out.backward(dout)
    assert LAUNCHES["flash_attention"] == n0["flash_attention"] + 1
    assert LAUNCHES["flash_attention_bwd"] == n0["flash_attention_bwd"] + 1
    q32, k32, v32 = (t.float().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(ref.flash_attention_ref(q32, k32, v32, causal=causal),
                               (q32, k32, v32), dout.float())
    torch.cuda.synchronize()
    for got, exp in zip((qg.grad, kg.grad, vg.grad), want):
        assert got.dtype == dtype and got.shape == exp.shape
        bound = BWD_TOL[dtype] * max(1.0, exp.abs().max().item())
        assert (got.float() - exp).abs().max().item() <= bound


@pytest.mark.parametrize("s,hq,hkv,d", [
    (200, 15, 5, 64),
    (1000, 15, 5, 64),           # smollm's heads: the ring wraps, the last run ends mid-way
    (300, 8, 2, 192),            # head dim 192, on the body that serves it
])
def test_flash_attention_backward_is_deterministic(cuda, s, hq, hkv, d):
    g = torch.Generator(device=cuda).manual_seed(3)
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    q, dout = (torch.randn(2, s, hq, d, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(2))
    k, v = (torch.randn(2, s, hkv, d, generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    out, lse = flash_attention(q, k, v, causal=True, with_lse=True)
    a = flash_attention_bwd(dout, q, k, v, out, lse, causal=True)
    b = flash_attention_bwd(dout, q, k, v, out, lse, causal=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_routes_through_the_backward_only_when_autograd_records(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(1, 80, 4, 32, generator=g, device=cuda)
    k, v = torch.randn(2, 1, 80, 2, 32, generator=g, device=cuda)
    n0 = dict(LAUNCHES)
    plain = ops.attention_auto(q, k, v, mask=torch.ones(80, 80, dtype=torch.bool,
                                                        device=cuda).tril())
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        assert ops.attention_auto(qg, k, v).grad_fn is None
    out = ops.attention_auto(qg, k, v)            # full attention, under autograd
    assert out.grad_fn is not None
    out.sum().backward()
    assert qg.grad is not None and qg.grad.abs().max().item() > 0
    assert LAUNCHES["flash_attention"] == n0["flash_attention"] + 3
    assert LAUNCHES["flash_attention_bwd"] == n0["flash_attention_bwd"] + 1


def test_kernels_without_a_backward_refuse_inputs_that_require_grad(cuda):
    """decode, paged and kv_pack wrappers raise under grad mode on an input
    that requires grad (and launch nothing); under no_grad they run."""
    from repro_torch.kernels.decode_attention import (batched_decode_attention,
                                                      decode_attention,
                                                      paged_decode_attention)
    from repro_torch.kernels.kv_pack import kv_pack, kv_pack_ragged, kv_unpack
    from repro_torch.kernels.paged_prefill import paged_prefill_attention
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(2, 4, 16, generator=g, device=cuda).requires_grad_()
    k, v = torch.randn(2, 2, 32, 2, 16, generator=g, device=cuda)
    lens = torch.tensor([32, 7], dtype=torch.int32, device=cuda)
    valid = torch.ones(32, dtype=torch.bool, device=cuda)
    pages = torch.randn(8, 8, 2, 16, generator=g, device=cuda)
    tables = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32, device=cuda)
    cache = torch.randn(2, 2, 32, 2, 16, generator=g, device=cuda).requires_grad_()
    zeros = torch.zeros(2, dtype=torch.int32, device=cuda)
    calls = {
        "batched_decode_attention": lambda: batched_decode_attention(q, k, v, lens),
        "decode_attention": lambda: decode_attention(q, k, v, valid),
        "paged_decode_attention": lambda: paged_decode_attention(q, pages, pages, tables,
                                                                 lens),
        "paged_prefill_attention": lambda: paged_prefill_attention(
            q[:, None].expand(2, 8, 4, 16).contiguous(), pages, pages, tables, zeros,
            torch.full((2,), 8, dtype=torch.int32, device=cuda)),
        "kv_pack": lambda: kv_pack(cache, 8, width=8),
        "kv_pack_ragged": lambda: kv_pack_ragged(cache, [0, 8], width=8),
        "kv_unpack": lambda: kv_unpack(cache.detach().clone(), cache[:, :, :8].contiguous(),
                                       0),
    }
    n0 = dict(LAUNCHES)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call()
    assert LAUNCHES == n0, "a refused call must not launch"
    with torch.no_grad():
        for call in calls.values():
            call()
    torch.cuda.synchronize()
    assert all(LAUNCHES[n] == n0[n] + 1 for n in calls)


def _ssd_grads_plain(x, dt, a, bm, cm, h0, dy, dhf, chunk):
    """autograd through the plain version, in f32 on the same values."""
    ins = [t.float().requires_grad_() for t in (x, dt, a, bm, cm)]
    h0g = None if h0 is None else h0.clone().requires_grad_()
    y, hf = ref.ssd_scan_ref(*ins, h0=h0g, chunk=chunk)
    outs, cots = [y], [dy.float()]
    if dhf is not None:
        outs.append(hf)
        cots.append(dhf)
    return torch.autograd.grad(outs, ins + ([h0g] if h0 is not None else []), cots)


def _ssd_grads_f64(x, dt, a, bm, cm, h0, dy, dhf):
    """autograd through the token-by-token recurrence in float64 on the same
    values."""
    ins = [t.double().requires_grad_() for t in (x, dt, a, bm, cm)]
    h0g = None if h0 is None else h0.double().requires_grad_()
    y, hf = ref.ssd_sequential_ref(*ins, h0=h0g)
    outs, cots = [y], [dy.double()]
    if dhf is not None:
        outs.append(hf)
        cots.append(dhf.double())
    return torch.autograd.grad(outs, ins + ([h0g] if h0 is not None else []), cots)


def _check_ssd_backward(cuda, b, s, nh, hd, g, n, ch, with_h0, with_dhf, dtype,
                        same_bc=False):
    from repro_torch.kernels.ssd_scan import SSDScanFn
    x, dt, a, bm, cm, h0 = _ssd_inputs(cuda, b, s, nh, hd, g, n, dtype, with_h0, seed=1)
    if same_bc:
        cm = bm.clone()
    gen = torch.Generator(device=cuda).manual_seed(2)
    dy = torch.randn(b, s, nh, hd, generator=gen, device=cuda).to(dtype)
    dhf = torch.randn(b, nh, hd, n, generator=gen, device=cuda) if with_dhf else None
    ins = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm)]
    h0g = None if h0 is None else h0.clone().requires_grad_()
    n0 = dict(LAUNCHES)
    y, hf = SSDScanFn.apply(*ins, h0g, min(ch, s))
    outs, cots = [y], [dy]
    if with_dhf:
        outs.append(hf)
        cots.append(dhf)
    got = torch.autograd.grad(outs, ins + ([h0g] if with_h0 else []), cots)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == n0["ssd_scan"] + 1
    assert LAUNCHES["ssd_scan_bwd"] == n0["ssd_scan_bwd"] + 1
    want = (_ssd_grads_f64(x, dt, a, bm, cm, h0, dy, dhf) if same_bc
            else _ssd_grads_plain(x, dt, a, bm, cm, h0, dy, dhf, min(ch, s)))
    for name, mine, exp in zip(("dx", "ddt", "da", "dB", "dC", "dh0"), got, want):
        assert mine.dtype == (dtype if name in ("dx", "dB", "dC") else torch.float32), name
        assert mine.shape == exp.shape, name
        bound = SSD_TOL[dtype] * max(1.0, exp.abs().max().item())
        err = (mine.double() - exp).abs().max().item()
        assert err <= bound, f"{name}: max |err| {err} > {bound}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nh,hd,g,n,ch,with_h0,with_dhf", [
    (2, 96, 4, 16, 1, 8, 32, True, True),
    (1, 200, 6, 16, 2, 16, 64, True, True),      # ragged, G = 2
    (2, 50, 4, 8, 2, 8, 16, False, True),        # the last chunk of 2 rows
    (1, 33, 2, 8, 1, 4, 16, True, False),
    (2, 300, 48, 64, 1, 128, 128, False, False),  # mamba2-780m's heads: 3 slices of 16
    (1, 200, 50, 64, 1, 16, 128, True, True),    # hymba-1.5b's 50 heads, N 16
    (1, 200, 4, 16, 1, 16, 48, True, True),      # Q 48: no multiple of 64; 200 = 4 * 48 + 8
    (2, 97, 4, 16, 1, 8, 32, False, True),       # a last chunk of one row
    (2, 70, 6, 8, 2, 4, 32, True, True),         # hd 8 and N 4, padded to the MMA tile
    (1, 150, 10, 16, 2, 8, 32, True, True),      # G = 2, five heads a group
    (2, 300, 4, 64, 1, 128, 128, True, True),    # mamba2's widths, the state terms' rows
    (1, 70, 4, 6, 1, 5, 32, True, True),         # odd hd and N: no 16-byte rows, hd * N % 4
])
def test_ssd_scan_backward_matches_autograd_through_plain(cuda, b, s, nh, hd, g, n, ch,
                                                         with_h0, with_dhf, dtype):
    _check_ssd_backward(cuda, b, s, nh, hd, g, n, ch, with_h0, with_dhf, dtype)


@pytest.mark.parametrize("b,s,nh,hd,g,n,ch,dtype", [
    (2, 200, 4, 16, 1, 16, 64, torch.float32),
    (2, 200, 4, 16, 1, 16, 64, torch.bfloat16),
    (1, 300, 6, 64, 1, 128, 128, torch.bfloat16),   # mamba2-780m's widths
])
def test_ssd_scan_backward_when_b_equals_c(cuda, b, s, nh, hd, g, n, ch, dtype):
    """B = C: dcum_i = C_i . dC_i - B_i . dB_i is a difference of two terms
    of one size, the case where a rounding before the dots would show.  The
    yardstick is the recurrence in float64.  At mamba2's widths f32 itself
    comes near or past the f32 band on da (the plain version's da sits up to
    1.4e-4 * max|da| from the float64 recurrence, the f32 body's up to
    1.6e-4, five to ten times their distances where B and C differ:
    tools/ssd_bwd_precision.py), so that shape runs in bf16, the body this
    checks."""
    _check_ssd_backward(cuda, b, s, nh, hd, g, n, ch, True, True, dtype, same_bc=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,n", [(48, 128), (50, 16)])   # mamba2-780m's and hymba-1.5b's
def test_ssd_scan_backward_is_deterministic(cuda, nh, n, dtype):
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    x, dt, a, bm, cm, h0 = _ssd_inputs(cuda, 2, 300, nh, 64, 1, n, dtype, True, seed=3)
    dy = torch.randn(x.shape, generator=torch.Generator(device=cuda).manual_seed(4),
                     device=cuda).to(dtype)
    _, hf, states = ssd_scan(x, dt, a, bm, cm, h0, chunk=128, with_states=True)
    one = ssd_scan_bwd(dy, None, x, dt, a, bm, cm, h0, states, hf, chunk=128)
    two = ssd_scan_bwd(dy, None, x, dt, a, bm, cm, h0, states, hf, chunk=128)
    assert all(torch.equal(p, q) for p, q in zip(one, two))


@pytest.mark.parametrize("dtype,body,not_body", [
    (torch.bfloat16, ("ssd_bwd_dc_mma_kernel", "ssd_bwd_scan_kernel", "ssd_bwd_dx_mma_kernel",
                      "ssd_bwd_reduce_kernel"), ("ssd_bwd_chunk_kernel", "ssd_bwd_state_kernel")),
    (torch.float32, ("ssd_bwd_state_kernel", "ssd_bwd_chunk_kernel", "ssd_bwd_reduce_kernel"),
     ("_mma_", "ssd_bwd_scan_kernel")),
])
def test_ssd_scan_backward_body_by_dtype(cuda, dtype, body, not_body):
    """The dtype picks the body: bf16 on the tensor cores (the chunk passes
    on mma.sync, the state pass an elementwise scan), f32 on the CUDA cores;
    the profile names the kernels that ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    x, dt, a, bm, cm, h0 = _ssd_inputs(cuda, 2, 300, 8, 64, 1, 128, dtype, True, seed=3)
    dy = torch.ones_like(x)
    _, hf, states = ssd_scan(x, dt, a, bm, cm, h0, chunk=128, with_states=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ssd_scan_bwd(dy, None, x, dt, a, bm, cm, h0, states, hf, chunk=128)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    for k in body:
        assert any(k in nm for nm in names), (k, names)
    for k in not_body:
        assert not any(k in nm for nm in names), (k, names)


def test_ssd_scan_backward_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    x, dt, a, bm, cm, h0 = _ssd_inputs(cuda, 1, 40, 4, 8, 1, 4, torch.float32, True)
    _, hf, states = ssd_scan(x, dt, a, bm, cm, h0, chunk=16, with_states=True)
    dy = torch.ones_like(x)
    n0 = LAUNCHES["ssd_scan_bwd"]

    def call(**kw):
        args = dict(dy=dy, dh_final=None, x=x, dt=dt, a_neg=a, bmat=bm, cmat=cm, h0=h0,
                    states=states, h_final=hf)
        args.update(kw)
        return ssd_scan_bwd(**args, chunk=16)

    with pytest.raises(ValueError, match="CUDA"):
        call(x=x.cpu(), dt=dt.cpu(), a_neg=a.cpu(), bmat=bm.cpu(), cmat=cm.cpu())
    with pytest.raises(ValueError, match="dy must be"):
        call(dy=dy.to(torch.bfloat16))
    with pytest.raises(ValueError, match="dy must be"):
        call(dy=dy[:, :20])
    with pytest.raises(ValueError, match="states must be"):
        call(states=states[:, :2])
    with pytest.raises(ValueError, match="dh_final must be"):
        call(dh_final=torch.ones_like(hf).double())
    with pytest.raises(ValueError, match="contiguous"):
        call(dy=dy.transpose(2, 3).contiguous().transpose(2, 3))
    big = _ssd_inputs(cuda, 1, 256, 2, 128, 1, 256, torch.float32, False)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_scan_bwd(torch.ones_like(big[0]), None, *big[:5], None,
                     torch.ones(1, 1, 2, 128, 256, device=cuda),
                     torch.ones(1, 2, 128, 256, device=cuda), chunk=256)
    assert LAUNCHES["ssd_scan_bwd"] == n0


def test_ssd_under_grad_on_the_card_never_runs_the_plain_scan(cuda, monkeypatch):
    """ssd_auto on CUDA tensors that require grad launches the forward with
    its states and the backward kernel; the plain scan is not called, and
    under no_grad the serving launch runs."""
    def plain(*a, **kw):
        raise AssertionError("the plain scan ran on the card")

    monkeypatch.setattr(ref, "ssd_scan_ref", plain)
    x, dt, a, bm, cm, _ = _ssd_inputs(cuda, 1, 40, 4, 8, 1, 4, torch.float32, False)
    x.requires_grad_()
    n0 = dict(LAUNCHES)
    y, _ = ops.ssd_auto(x, dt, a, bm, cm, chunk=16)
    assert y.grad_fn is not None
    y.sum().backward()
    assert x.grad is not None and x.grad.abs().max().item() > 0
    with torch.no_grad():
        assert ops.ssd_auto(x, dt, a, bm, cm, chunk=16)[0].grad_fn is None
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == n0["ssd_scan"] + 2
    assert LAUNCHES["ssd_scan_bwd"] == n0["ssd_scan_bwd"] + 1


def test_launch_train_runs_the_ssm_families_on_the_card(cuda, tmp_path):
    from repro_torch.launch.train import main
    for name in ("mamba2-780m", "hymba-1.5b"):
        n0 = LAUNCHES["ssd_scan_bwd"]
        main(["--arch", name, "--reduced", "--steps", "2", "--batch", "2", "--seq", "32",
              "--log-every", "1", "--ckpt-dir", str(tmp_path / name)])
        torch.cuda.synchronize()
        assert LAUNCHES["ssd_scan_bwd"] == n0 + 2 * get_arch(name).reduced().num_layers


@pytest.mark.parametrize("name", ["smollm-360m", "qwen3-moe-30b-a3b", "mamba2-780m",
                                  "hymba-1.5b", "phi-3-vision-4.2b",
                                  "seamless-m4t-large-v2"])
def test_loss_and_gradients_on_the_card_give_the_cpus(cuda, name):
    """Reduced model, fp32, remat on the card: the loss and every gradient
    leaf equal the CPU's (1e-4 relative to max(1, max|g|)), the attention
    through the flash forward (twice, remat) and backward kernels, the SSD
    scan through its forward (twice) and backward kernels."""
    from repro_torch.training import SyntheticDataPipeline
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.train import batch_to
    cfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32")
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = SyntheticDataPipeline(cfg.vocab_size, 48, 3, seed=1, family=cfg.family,
                                  d_model=cfg.d_model, num_patches=cfg.num_patches,
                                  src_len=min(cfg.max_source_len, 48)).batch_at(0)
    res = {}
    for dev in ("cpu", "cuda"):
        live = tree_map(lambda p: p.to(dev).requires_grad_(), params)
        n0 = dict(LAUNCHES)
        loss = build_model(cfg, device=dev, remat=dev == "cuda").loss(live, batch_to(batch,
                                                                                     dev))
        grads = torch.autograd.grad(loss, tree_leaves(live))
        res[dev] = (loss.item(), [gr.cpu() for gr in grads],
                    {n: LAUNCHES[n] - n0[n] for n in TRAIN_KERNELS})
    assert res["cpu"][2] == dict.fromkeys(TRAIN_KERNELS, 0)
    assert res["cuda"][2] == train_launches(cfg, 1, remat=True)
    assert res["cuda"][0] == pytest.approx(res["cpu"][0], rel=1e-5)
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item())


def test_moe_backward_repeats_bit_for_bit_at_qwen3_moes_width(cuda):
    """`moe_apply` at qwen3-moe-30b-a3b's width (d 2048, 128 experts, top 8,
    d_ff 768, bf16), two layers' experts chained over a training batch of
    4 x 1024 tokens with capacity dropping and the load-balancing loss:
    the forward and backward run twice on the same inputs, and the loss and
    every gradient (the tokens', each router's and each expert weight's)
    must repeat bit for bit.  The dispatch repeats each token's row for its
    k routed entries, so a backward that summed those rows by atomics
    would not repeat."""
    from repro_torch.models.moe import moe_apply, moe_init
    cfg = get_arch("qwen3-moe-30b-a3b")
    g = torch.Generator(device=cuda).manual_seed(0)
    layers = [moe_init(g, cfg, torch.bfloat16, cuda) for _ in range(2)]
    x0 = torch.randn(4 * 1024, cfg.d_model, generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn(4 * 1024, cfg.d_model, generator=g, device=cuda)

    def loss_and_grads():
        live = [{k: v.detach().requires_grad_() for k, v in p.items()} for p in layers]
        x = x0.detach().requires_grad_()
        h, aux = x, 0.0
        for p in live:
            y, a = moe_apply(h, p, cfg, return_aux=True)
            h, aux = h + y, aux + a
        loss = (h.float() * w).mean() + 0.01 * aux
        leaves = [x] + [p[k] for p in live for k in sorted(p)]
        return loss.detach(), torch.autograd.grad(loss, leaves)

    loss1, grads1 = loss_and_grads()
    grads1 = [t.cpu() for t in grads1]
    loss2, grads2 = loss_and_grads()
    assert torch.equal(loss1, loss2)
    for i, (a, b) in enumerate(zip(grads1, grads2)):
        assert torch.equal(a, b.cpu()), f"gradient leaf {i} differs between two backwards"
