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
from repro_torch.kernels import LAUNCHES, ops, ref  # noqa: E402
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


def test_engine_on_the_card_gives_the_cpu_tokens(cuda):
    """Reduced gpt2-1.5b, fp32, 2 stage workers: the same weights and trace
    through the engine on the card and on the CPU give the same tokens, and
    the card's run went through every kernel."""
    cfg = dataclasses.replace(get_arch("gpt2-1.5b").reduced(), dtype="float32")
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
    assert all(n > 0 for n in launched["cuda"].values()), launched["cuda"]
    assert not any(launched["cpu"].values())
