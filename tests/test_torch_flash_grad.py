"""The flash backward's yardstick against the JAX package, on the CPU.

On the card `flash_attention_bwd` is held to `torch.autograd.grad` through
the port's plain `flash_attention_ref` (`chip_smoke.py`'s kernels phase,
`tests/test_torch_cuda.py`).  Here that yardstick is held to `jax.vjp` of
the JAX package's `flash_attention_ref`, at fp32, on the same inputs and
output gradient made by numpy from a seed: head dims 16 to 192, G = 1, 3
and 8 query heads a KV head, causal with Sq = Skv and with Sq < Skv (a
query block at the end of the keys), full attention, and lengths that end
part-way through a 128-key block.  Tolerance: 1e-5 * max(1, max|g|), what
two f32 summation orders leave.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402

TOL = 1e-5


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", [
    (1, 150, 150, 1, 1, 16, True),               # G = 1, keys end mid-block
    (1, 200, 200, 3, 1, 64, True),               # G = 3 (smollm's 15:5)
    (1, 300, 300, 8, 1, 128, True),              # G = 8 (qwen3-moe's 32:4)
    (1, 150, 150, 3, 1, 192, True),
    (1, 150, 300, 8, 1, 64, True),               # a query block at the end of the keys
    (1, 200, 300, 3, 1, 16, True),
    (1, 100, 300, 3, 1, 128, True),
    (1, 150, 200, 1, 1, 128, False),             # full, Sq < Skv
    (2, 200, 150, 6, 2, 192, False),             # full, Sq > Skv
    (2, 150, 150, 8, 1, 16, False),
    (1, 300, 300, 1, 1, 64, False),
])
def test_plain_backward_matches_jax_vjp(b, sq, skv, hq, hkv, d, causal):
    rng = np.random.default_rng(sq * 1000 + skv + d + hq)
    q, dout = (rng.standard_normal((b, sq, hq, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, skv, hkv, d), dtype=np.float32) for _ in range(2))

    _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash_ref(q_, k_, v_, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]

    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention_ref(qt, kt, vt, causal=causal)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(dout))

    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        bound = TOL * max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g.numpy() - w).max())
        assert err <= bound, f"{name}: max |err| {err} > {bound}"
