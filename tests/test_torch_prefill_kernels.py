"""The port's plain versions of the run() path's kernels against the Pallas
kernels in interpret mode: `flash_attention`, `decode_attention` and
`kv_unpack`.

Inputs come from numpy with a seed and go to both packages; tolerances are
the reference's bands (`tests/test_kernels.py`): 2e-5 for fp32, 2e-2 for
bf16, copies bit-exact.  The sweeps are `tests/test_kernels.py`'s, cut to
small shapes.  Also here: the routing rule of `ops.attention_auto`, which
picks `flash_attention` from the layer's configuration and never from the
mask's shape.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread is faster, and steady on a shared host
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.kv_pack import kv_unpack as jax_kv_unpack  # noqa: E402
from repro_torch.kernels import LAUNCHES, ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.kv_pack import kv_unpack  # noqa: E402
from repro_torch.models.attention import attend, build_mask  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

FLASH_CASES = {          # b, sq, skv, hq, hkv, d, causal, block_q, block_k
    "gqa_causal": (2, 64, 64, 4, 2, 16, True, 32, 32),
    "ragged_tail": (1, 40, 40, 4, 2, 16, True, 32, 32),
    "sq_lt_skv": (2, 24, 56, 4, 2, 16, True, 16, 32),
    "non_causal": (1, 48, 40, 4, 2, 16, False, 32, 32),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_plain_matches_pallas(case, dtype):
    b, sq, skv, hq, hkv, d, causal, bq, bk = FLASH_CASES[case]
    q, k, v = _normal(1, (b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    out_j = jax_flash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk)
    n0 = dict(LAUNCHES)
    out_t = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    if sq == skv or not causal:        # the entry point the model calls
        mask = build_mask(torch.arange(sq), torch.arange(skv), causal=True) if causal else None
        routed = ops.attention_auto(tq, tk, tv, mask=mask)
        assert torch.equal(routed, out_t)
    assert LAUNCHES == n0, "a CPU tensor must not reach a kernel"
    assert out_t.dtype == DTYPES[dtype][1] and tuple(out_t.shape) == q.shape
    np.testing.assert_allclose(_f32(out_t), _f32(out_j), rtol=TOL[dtype], atol=TOL[dtype])


def _spy_flash(monkeypatch):
    calls = []
    real = ops._flash

    def spy(q, k, v, *, causal):
        calls.append(causal)
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(ops, "_flash", spy)
    return calls


@pytest.mark.parametrize("kw,to_flash", [
    (dict(), True),                                    # plain causal
    (dict(window=6), False),
    (dict(window=6, num_meta=2), False),
    (dict(num_meta=2), True),                          # meta tokens, no window: causal
    (dict(alibi=True), False),
])
def test_attention_auto_routes_by_the_layer_not_the_mask_shape(kw, to_flash, monkeypatch):
    """A windowed layer's mask has the plain causal mask's shape; the
    reference's `attention_auto` tells them apart by shape alone and would
    drop the window under backend="pallas".  The port routes by the layer's
    window and ALiBi; meta tokens without a window leave the mask causal, so
    that layer goes to the kernel.  The output always equals `attend`'s."""
    calls = _spy_flash(monkeypatch)
    s, hq, hkv, d = 20, 4, 2, 16
    q, k, v = (torch.from_numpy(a) for a in _normal(2, (1, s, hq, d), (1, s, hkv, d),
                                                    (1, s, hkv, d)))
    pos = torch.arange(s)
    window, meta = kw.get("window", 0), kw.get("num_meta", 0)
    mask = build_mask(pos, pos, causal=True, window=window, num_meta=meta)
    bias = None
    if kw.get("alibi"):
        bias = -torch.tensor([0.5, 0.25, 0.125, 0.0625])[:, None, None] * \
            (pos[:, None] - pos[None, :]).clamp(min=0).float()
    out = ops.attention_auto(q, k, v, mask=mask, bias=bias, window=window)
    assert calls == ([True] if to_flash else [])
    assert torch.equal(out, attend(q, k, v, mask=mask, bias=bias))


def test_attention_auto_sends_a_chunk_over_a_longer_cache_to_attend(monkeypatch):
    calls = _spy_flash(monkeypatch)
    q, k, v = (torch.from_numpy(a) for a in _normal(3, (1, 8, 4, 16), (1, 24, 2, 16),
                                                    (1, 24, 2, 16)))
    mask = build_mask(torch.arange(16, 24), torch.arange(24), causal=True)
    out = ops.attention_auto(q, k, v, mask=mask)
    assert calls == [] and torch.equal(out, attend(q, k, v, mask=mask))
    # no mask and no bias: full attention through the kernel's non-causal mode
    assert torch.equal(ops.attention_auto(q, k, v), ref.flash_attention_ref(q, k, v,
                                                                            causal=False))
    assert calls == [False]


# ---------------------------------------------------------------------------
# decode_attention: one validity row shared by the batch
# ---------------------------------------------------------------------------

def _valid(kind: str, s: int) -> np.ndarray:
    pos = np.arange(s)
    if kind == "prefix":
        return pos < 70
    if kind == "window_meta":           # query at 80, window 24, 4 meta sinks
        return (pos <= 80) & ((pos > 80 - 24) | (pos < 4))
    if kind == "none_valid":            # every slot weighs the same: the average of V
        return np.zeros(s, bool)
    rng = np.random.default_rng(4)      # scattered, no structure at all
    v = rng.random(s) < 0.3
    v[17] = True
    return v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["prefix", "window_meta", "scattered", "none_valid"])
def test_decode_attention_plain_matches_pallas(kind, dtype):
    b, s, hq, hkv, d = 2, 96, 4, 2, 16
    q, k, v = _normal(5, (b, hq, d), (b, s, hkv, d), (b, s, hkv, d))
    valid = _valid(kind, s)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    out_j = jax_decode(jq, jk, jv, jnp.asarray(valid), block_k=32)
    n0 = dict(LAUNCHES)
    out_t = ops.decode_attention_auto(tq[:, None], tk, tv,
                                      torch.from_numpy(valid)[None])[:, 0]
    assert LAUNCHES == n0, "a CPU tensor must not reach a kernel"
    assert out_t.dtype == DTYPES[dtype][1] and tuple(out_t.shape) == q.shape
    np.testing.assert_allclose(_f32(out_t), _f32(out_j), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [544, 600])
def test_decode_attention_plain_matches_pallas_where_no_key_is_valid_past_one_block(s, dtype):
    """At S > 512 and not a multiple of it the Pallas kernel, at the default
    block_k its callers keep, pads S with zero K/V rows to a multiple of 512:
    a row with no valid key averages V over that padded length (1024 here),
    not over S.  V is offset by 1 so that the two divisors lie far apart in
    both bands."""
    b, hq, hkv, d = 2, 4, 2, 16
    q, k, v = _normal(7, (b, hq, d), (b, s, hkv, d), (b, s, hkv, d))
    v = v + 1.0
    valid = np.zeros(s, bool)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    out_j = jax_decode(jq, jk, jv, jnp.asarray(valid))
    out_t = ops.decode_attention_auto(tq[:, None], tk, tv, torch.from_numpy(valid)[None])[:, 0]
    np.testing.assert_allclose(_f32(out_t), _f32(out_j), rtol=TOL[dtype], atol=TOL[dtype])
    assert ref.no_key_divisor(s) == 1024


# ---------------------------------------------------------------------------
# kv_unpack: the inverse of kv_pack, in place
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,B,S,H,D,t0,w,tb", [
    (3, 2, 64, 4, 16, 16, 24, 8),
    (2, 1, 32, 2, 8, 0, 32, 8),                  # whole cache
    (4, 2, 48, 2, 16, 40, 8, 8),                 # tail window
    (1, 1, 16, 1, 8, 8, 8, 4),
])
def test_kv_unpack_plain_matches_pallas_and_round_trips(L, B, S, H, D, t0, w, tb, dtype):
    cache, buf = _normal(6, (L, B, S, H, D), (L, B, w, H, D))
    (jc, tc), (jb, tb_) = _pair(cache, dtype), _pair(buf, dtype)
    out_j = jax_kv_unpack(jc.copy(), jb, t0, token_block=tb)
    target = tc.clone()
    out_t = ops.kv_unpack_auto(target, tb_, t0, token_block=tb)
    assert out_t is target, "the copy is in place"
    np.testing.assert_array_equal(_f32(out_t), _f32(out_j))
    assert torch.equal(ops.kv_pack_auto(out_t, t0, w, token_block=tb), tb_)
    # outside the window the cache is untouched
    keep = torch.ones(S, dtype=torch.bool)
    keep[t0:t0 + w] = False
    assert torch.equal(out_t[:, :, keep], tc[:, :, keep])


def test_kv_unpack_writes_through_a_view():
    """The landing writes one layer-and-row slice of a larger cache."""
    big = torch.zeros(4, 3, 32, 2, 8)
    buf = torch.randn(2, 1, 16, 2, 8, generator=torch.Generator().manual_seed(0))
    ops.kv_unpack_auto(big[1:3, 2:3], buf, 8)
    assert torch.equal(big[1:3, 2:3, 8:24], buf)
    # nothing outside the window was written
    outside = torch.ones(big.shape, dtype=torch.bool)
    outside[1:3, 2:3, 8:24] = False
    assert not big[outside].any()


@pytest.mark.parametrize("t0,w,msg", [(4, 8, "not aligned"), (0, 12, "not a multiple"),
                                      (24, 16, "outside the cache")])
def test_unpack_refuses_what_the_tpu_kernel_would_round(t0, w, msg):
    with pytest.raises(ValueError, match=msg):
        ops.kv_unpack_auto(torch.zeros(1, 2, 32, 1, 8), torch.zeros(1, 2, w, 1, 8), t0)
    with pytest.raises(ValueError, match="does not fit"):
        ops.kv_unpack_auto(torch.zeros(1, 2, 32, 1, 8), torch.zeros(1, 1, 8, 1, 8), 0)


def test_new_kernel_wrappers_take_cuda_tensors_only():
    """On a CPU tensor a wrapper raises: only `ops` routes the CPU to the
    plain version, and nothing falls back from a kernel to it."""
    q, k = torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16)
    n0 = dict(LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(q[:, 0], k, k, torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        kv_unpack(torch.zeros(1, 1, 16, 1, 8), torch.zeros(1, 1, 8, 1, 8), 0)
    assert LAUNCHES == n0
