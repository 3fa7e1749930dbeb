"""The port's kernels (`repro_torch.kernels`) against the JAX package's.

On the CPU each entry point of `repro_torch.kernels.ops` runs the kernel's
plain PyTorch version; here it is held against the Pallas kernel run in
interpret mode, on the same inputs made with numpy from a seed.  Tolerances
are the reference's bands (`tests/test_kernels.py`): 2e-5 for fp32, 2e-2 for
bf16; the copies are exact.  `tests/test_torch_cuda.py` holds each CUDA
kernel against its plain version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread is faster, and steady on a shared host
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import batched_decode_attention as jax_bda  # noqa: E402
from repro.kernels.kv_pack import kv_pack as jax_kv_pack  # noqa: E402
from repro.kernels.kv_pack import kv_pack_ragged as jax_kv_pack_ragged  # noqa: E402
from repro_torch.kernels import LAUNCHES, ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import batched_decode_attention  # noqa: E402
from repro_torch.kernels.kv_pack import kv_pack, kv_pack_ragged  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a torch tensor of the same type
    (both round float32 to bf16 to nearest even, so the bits agree)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ---------------------------------------------------------------------------
# batched_decode_attention: plain version vs the Pallas kernel
# ---------------------------------------------------------------------------

ATTN_SHAPES = {            # b, s, hq, hkv, d, lengths
    "gqa": (3, 96, 4, 2, 16, (90, 96, 7)),
    "mha_odd_heads": (2, 40, 5, 5, 8, (1, 33)),
    # the CUDA body walks 64-key tiles: a window start on a tile edge (row 0,
    # 192 - 128 = 64) and meta sinks spanning a whole tile
    "tile_edges": (2, 200, 4, 2, 16, (192, 130)),
}
VARIANTS = {               # window, num_meta, alibi
    "plain": (0, 0, False),
    "window": (24, 0, False),
    "window_meta": (24, 2, False),
    "alibi": (0, 0, True),
    "window_meta_alibi": (24, 2, True),
    "window_tile_edge": (128, 0, False),
    "meta_spans_tile": (32, 70, True),
}


def _attn_inputs(shape: str, seed: int = 0):
    b, s, hq, hkv, d, lengths = ATTN_SHAPES[shape]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    slopes = np.asarray([2.0 ** -(i + 1) for i in range(hq)], np.float32)
    return q, k, v, np.asarray(lengths, np.int32), slopes


# every variant at the GQA shape; the odd-head MHA shape plain and combined
ATTN_CASES = ([("gqa", v) for v in list(VARIANTS)[:5]]
              + [("mha_odd_heads", "plain"), ("mha_odd_heads", "window_meta_alibi"),
                 ("tile_edges", "window_tile_edge"), ("tile_edges", "meta_spans_tile")])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,variant", ATTN_CASES)
def test_batched_decode_attention_plain_matches_pallas(shape, variant, dtype):
    window, meta, use_alibi = VARIANTS[variant]
    q, k, v, lens, slopes = _attn_inputs(shape)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    jwin = jnp.maximum(jnp.asarray(lens) - window, 0) if window else None
    out_j = jax_bda(jq, jk, jv, jnp.asarray(lens), jwin,
                    jnp.asarray(slopes) if use_alibi else None, num_meta=meta)
    n0 = dict(LAUNCHES)
    out_t = ops.batched_decode_attention_auto(
        tq, tk, tv, torch.from_numpy(lens), window=window, num_meta=meta,
        alibi=torch.from_numpy(slopes) if use_alibi else None)
    assert LAUNCHES == n0, "a CPU tensor must not reach a kernel"
    assert out_t.dtype == DTYPES[dtype][1] and tuple(out_t.shape) == q.shape
    np.testing.assert_allclose(_f32(out_t), _f32(out_j), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS)[:5])
@pytest.mark.parametrize("s", [544, 600])
def test_batched_decode_attention_plain_matches_pallas_where_no_key_is_valid(s, variant,
                                                                            dtype):
    """Rows with no valid key at S > 512, not a multiple of it: the Pallas
    kernel, at the default block_k its callers keep, pads S with zero K/V
    rows to a multiple of 512 and averages V over that padded length (1024
    here).  Row 0 has length 0; with a window, row 2 is given a window start
    past its length, which leaves it no valid key where there are no meta
    sinks.  V is offset by 1 so that the divisors S and
    1024 lie far apart in both bands."""
    window, meta, use_alibi = VARIANTS[variant]
    b, hq, hkv, d = 3, 4, 2, 16
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32) + 1.0
    lens = np.asarray([0, s - 3, 300], np.int32)
    slopes = np.asarray([2.0 ** -(i + 1) for i in range(hq)], np.float32)
    ws = None
    if window:
        ws = np.maximum(lens - window, 0).astype(np.int32)
        ws[2] = 310
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    out_j = jax_bda(jq, jk, jv, jnp.asarray(lens), None if ws is None else jnp.asarray(ws),
                    jnp.asarray(slopes) if use_alibi else None, num_meta=meta)
    out_t = ref.batched_decode_attention_ref(
        tq, tk, tv, torch.from_numpy(lens), None if ws is None else torch.from_numpy(ws),
        torch.from_numpy(slopes) if use_alibi else None, num_meta=meta)
    np.testing.assert_allclose(_f32(out_t), _f32(out_j), rtol=TOL[dtype], atol=TOL[dtype])
    assert ref.no_key_divisor(s) == 1024


def test_batched_decode_attention_plain_matches_per_sequence_softmax():
    """The plain version against a numpy re-derivation of one sequence at a
    time: window start, meta sinks and ALiBi as the decode path defines
    them (visible iff pos < len and (pos >= len - w or pos < meta))."""
    q, k, v, lens, slopes = _attn_inputs("gqa", seed=3)
    b, s, hkv, d = k.shape
    hq = q.shape[1]
    g = hq // hkv
    w, meta = 12, 2
    out = ops.batched_decode_attention_auto(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), window=w, num_meta=meta,
        alibi=torch.from_numpy(slopes)).numpy()
    pos = np.arange(s)
    for i in range(b):
        n = int(lens[i])
        visible = (pos < n) & ((pos >= max(n - w, 0)) | (pos < meta))
        sc = np.einsum("hgd,shd->hgs", q[i].reshape(hkv, g, d), k[i]) / np.sqrt(d)
        sc = sc - slopes.reshape(hkv, g)[:, :, None] * np.maximum(n - 1 - pos, 0)
        sc = np.where(visible, sc, -np.inf)
        p = np.exp(sc - sc.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        o = np.einsum("hgs,shd->hgd", p, v[i]).reshape(hq, d)
        np.testing.assert_allclose(out[i], o, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# kv_pack / kv_pack_ragged: plain versions vs the Pallas kernels (exact)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,B,S,H,D,t0,w,tb", [
    (3, 2, 64, 4, 16, 16, 24, 8),
    (2, 1, 32, 2, 8, 0, 32, 8),                  # whole cache
    (4, 2, 48, 2, 16, 40, 8, 8),                 # tail window
    (1, 1, 16, 1, 8, 8, 8, 4),
])
def test_kv_pack_plain_matches_pallas(L, B, S, H, D, t0, w, tb, dtype):
    cache = np.random.default_rng(1).standard_normal((L, B, S, H, D)).astype(np.float32)
    jc, tc = _pair(cache, dtype)
    out_j = jax_kv_pack(jc, t0, width=w, token_block=tb)
    out_t = ops.kv_pack_auto(tc, t0, w, token_block=tb)
    assert out_t.is_contiguous() and out_t.dtype == tc.dtype
    np.testing.assert_array_equal(_f32(out_t), _f32(out_j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,B,S,H,D,starts,w,tb", [
    (3, 3, 64, 4, 16, (0, 16, 56), 8, 8),
    (2, 2, 32, 2, 8, (24, 0), 8, 8),             # tail + head windows
    (1, 4, 48, 2, 16, (8, 8, 40, 16), 8, 4),     # repeated offsets, tb 4
    (2, 1, 16, 1, 8, (8,), 8, 8),                # single row
])
def test_kv_pack_ragged_plain_matches_pallas(L, B, S, H, D, starts, w, tb, dtype):
    cache = np.random.default_rng(2).standard_normal((L, B, S, H, D)).astype(np.float32)
    jc, tc = _pair(cache, dtype)
    out_j = jax_kv_pack_ragged(jc, jnp.asarray(starts, jnp.int32), width=w,
                               token_block=tb)
    out_t = ops.kv_pack_ragged_auto(tc, list(starts), w, token_block=tb)
    np.testing.assert_array_equal(_f32(out_t), _f32(out_j))
    for bi, st in enumerate(starts):             # row b == that row's kv_pack
        np.testing.assert_array_equal(
            _f32(out_t[:, bi:bi + 1]), _f32(ops.kv_pack_auto(tc[:, bi:bi + 1], st, w, tb)))


@pytest.mark.parametrize("call,msg", [
    (lambda c: ops.kv_pack_auto(c, 4, 8), "not aligned"),
    (lambda c: ops.kv_pack_auto(c, 0, 12), "not a multiple"),
    (lambda c: ops.kv_pack_auto(c, 24, 16), "outside the cache"),
    (lambda c: ops.kv_pack_ragged_auto(c, [0, 3], 8), "not aligned"),
    (lambda c: ops.kv_pack_ragged_auto(c, [0], 8), "starts for 2 batch rows"),
])
def test_pack_refuses_what_the_tpu_kernel_would_round(call, msg):
    """The Pallas copy addresses its window in token blocks (start // bt), so
    an unaligned start silently rounds down there; the port refuses it."""
    cache = torch.zeros(1, 2, 32, 1, 8)
    with pytest.raises(ValueError, match=msg):
        call(cache)


def test_kernel_wrappers_take_cuda_tensors_only():
    """On a CPU tensor a wrapper raises: only `ops` routes the CPU to the
    plain version, and nothing falls back from a kernel to it."""
    q, k, v = torch.zeros(1, 2, 8), torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8)
    lens = torch.ones(1, dtype=torch.int32)
    cache = torch.zeros(1, 1, 16, 1, 8)
    n0 = dict(LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        batched_decode_attention(q, k, v, lens)
    with pytest.raises(ValueError, match="CUDA"):
        kv_pack(cache, 0, width=8)
    with pytest.raises(ValueError, match="CUDA"):
        kv_pack_ragged(cache, [0], width=8)
    assert LAUNCHES == n0


def test_build_is_lazy():
    """Importing the kernel modules builds nothing; the CPU tests never need
    nvcc (the sources compile on the card at first use)."""
    from repro_torch.kernels import _build
    assert _build._libs == {}
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == [
        f"{n}.cu" for n in sorted(_build.SOURCES)]
