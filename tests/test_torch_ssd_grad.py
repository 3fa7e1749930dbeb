"""The SSD scan backward's yardstick against the JAX package, on the CPU.

On the card `ssd_scan_bwd` is held to `torch.autograd.grad` through the
port's plain `ssd_scan_ref` (`chip_smoke.py`'s kernels phase,
`tests/test_torch_cuda.py`).  Here that yardstick is held to `jax.vjp` of
the JAX package's `ssd_chunked` (the function the reference trains
through), at fp32, on the same inputs and cotangents (dy and dh_final) made
by numpy from a seed: ragged S at chunks of 16, 64 and 128, one and two
groups, with and without h0, and mamba2-780m's heads and state at one
sequence.  So is `ssd_scan_bwd_ref`, the kernel's algebra written as tensor
code.  Tolerance: 2e-5 * max(1, max|g|), what two f32 summation orders
leave (the largest seen was 3.4e-6); 1e-4 for da, a sum over every token
whose terms cancel: at S = 130 the JAX and the port's f32 gradients sit
2.9e-5 and 3.8e-5 from a float64 computation, on either side of it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.kernels.ref import ssd_scan_bwd_ref, ssd_scan_ref, ssd_sequential_ref  # noqa: E402,E501

TOL = {"dx": 2e-5, "ddt": 2e-5, "da": 1e-4, "dB": 2e-5, "dC": 2e-5, "dh0": 2e-5}
NAMES = ("dx", "ddt", "da", "dB", "dC", "dh0")


def _inputs(b, s, nh, hd, g, n, with_h0, with_dhf, seed):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    ins = {"x": r(b, s, nh, hd, scale=0.5),
           "dt": np.log1p(np.exp(r(b, s, nh))).astype(np.float32),      # softplus
           "a_neg": -np.exp(r(nh, scale=0.3)).astype(np.float32),
           "B": r(b, s, g, n, scale=0.25), "C": r(b, s, g, n, scale=0.25)}
    if with_h0:
        ins["h0"] = r(b, nh, hd, n, scale=0.1)
    cots = {"dy": r(b, s, nh, hd), "dh_final": r(b, nh, hd, n) if with_dhf else None}
    return ins, cots


def _jax_grads(ins, cots, chunk):
    names = list(ins)

    def f(*args):
        kw = dict(zip(names, args))
        return ssd_chunked(kw["x"], kw["dt"], kw["a_neg"], kw["B"], kw["C"], chunk=chunk,
                           h0=kw.get("h0"))

    @jax.jit
    def grads(args, dy, dhf):
        (_, hf), vjp = jax.vjp(f, *args)
        return vjp((dy, jnp.zeros_like(hf) if dhf is None else dhf))

    dhf = cots["dh_final"]
    got = grads(tuple(jnp.asarray(v) for v in ins.values()), jnp.asarray(cots["dy"]),
                None if dhf is None else jnp.asarray(dhf))
    return {nm: np.asarray(v) for nm, v in zip(("dx", "ddt", "da", "dB", "dC", "dh0"), got)}


def _check(name, got, want, tag):
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, (tag, name)
    bound = TOL[name] * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= bound, f"{tag} {name}: max |err| {err} > {bound}"


@pytest.mark.parametrize("b,s,nh,hd,g,n,chunk,with_h0,with_dhf", [
    (2, 200, 4, 16, 1, 8, 64, True, True),        # ragged: 200 = 3 * 64 + 8
    (2, 200, 4, 16, 2, 8, 64, False, True),       # G = 2
    (1, 50, 6, 8, 2, 16, 16, True, False),        # Q 16, the last chunk of 2 rows
    (2, 37, 4, 8, 1, 4, 16, False, False),
    (1, 300, 4, 16, 2, 8, 128, True, True),       # Q 128: 300 = 2 * 128 + 44
    (2, 130, 3, 8, 1, 8, 128, False, True),       # a last chunk of 2 rows
    (1, 256, 48, 64, 1, 128, 128, False, True),   # mamba2-780m's heads and state
    (1, 200, 50, 8, 1, 16, 128, True, True),      # hymba-1.5b's 50 heads and N 16
    (2, 100, 6, 16, 3, 8, 32, True, True),        # G = 3
    (1, 128, 4, 16, 1, 8, 128, True, False),      # one whole chunk
])
def test_plain_backward_matches_jax_vjp(b, s, nh, hd, g, n, chunk, with_h0, with_dhf):
    ins, cots = _inputs(b, s, nh, hd, g, n, with_h0, with_dhf, seed=s * 31 + nh + g)
    want = _jax_grads(ins, cots, chunk)

    t = {k: torch.from_numpy(v).requires_grad_() for k, v in ins.items()}
    y, hf = ssd_scan_ref(t["x"], t["dt"], t["a_neg"], t["B"], t["C"], h0=t.get("h0"),
                         chunk=chunk)
    dhf = None if cots["dh_final"] is None else torch.from_numpy(cots["dh_final"])
    outs, grads_out = [y], [torch.from_numpy(cots["dy"])]
    if dhf is not None:
        outs.append(hf)
        grads_out.append(dhf)
    auto = torch.autograd.grad(outs, list(t.values()), grads_out)
    for name, got in zip(NAMES, auto):
        _check(name, got, want[name], "autograd")

    plain = {k: torch.from_numpy(v) for k, v in ins.items()}
    explicit = ssd_scan_bwd_ref(torch.from_numpy(cots["dy"]), dhf, plain["x"], plain["dt"],
                                plain["a_neg"], plain["B"], plain["C"], h0=plain.get("h0"),
                                chunk=chunk)
    assert (explicit[5] is None) == ("h0" not in ins)
    for name, got in zip(NAMES, explicit):
        if got is not None:
            _check(name, got, want[name], "ssd_scan_bwd_ref")


@pytest.mark.parametrize("b,s,nh,hd,g,n,chunk", [
    (2, 200, 4, 16, 1, 16, 64),                   # ragged: 200 = 3 * 64 + 8
    (1, 200, 6, 16, 2, 8, 32),                    # G = 2
])
def test_plain_backward_matches_jax_vjp_when_b_equals_c(b, s, nh, hd, g, n, chunk):
    """B = C, where dcum_i = C_i . dC_i - B_i . dB_i is a difference of two
    terms of one size: `ssd_scan_bwd_ref` against `jax.vjp` of
    `ssd_chunked` on the same inputs, under the file's tolerances.  Not at
    mamba2-780m's widths: there the port's f32 da alone drifts up to 1.4e-4
    * max|da| from a float64 recurrence (tools/ssd_bwd_precision.py), past
    the 1e-4 this file allows between the two sides."""
    ins, cots = _inputs(b, s, nh, hd, g, n, True, True, seed=s * 37 + nh)
    ins["C"] = ins["B"].copy()
    want = _jax_grads(ins, cots, chunk)
    plain = {k: torch.from_numpy(v) for k, v in ins.items()}
    got = ssd_scan_bwd_ref(torch.from_numpy(cots["dy"]), torch.from_numpy(cots["dh_final"]),
                           plain["x"], plain["dt"], plain["a_neg"], plain["B"], plain["C"],
                           h0=plain["h0"], chunk=chunk)
    for name, g_ in zip(NAMES, got):
        _check(name, g_, want[name], "ssd_scan_bwd_ref, B = C")


@pytest.mark.parametrize("b,s,nh,hd,g,n", [
    (1, 256, 48, 64, 1, 128),                     # mamba2-780m's heads, head width and state
    (1, 300, 6, 64, 1, 128),                      # tools/ssd_bwd_precision.py's shape
])
def test_b_equals_c_at_mamba2_widths_port_no_farther_from_float64_than_jax(b, s, nh, hd, g,
                                                                          n):
    """B = C at mamba2-780m's widths, where each side's f32 da alone drifts
    past the 1e-4 that the test above allows between the two sides.  The
    yardstick is autograd through `ssd_sequential_ref` in float64 on the
    same values.  Over seeds 0-2 the worst distance of the port's
    `ssd_scan_bwd_ref` da, in units of max(1, max |da|), must be no farther
    than that of `jax.vjp` of the reference's `ssd_chunked`; every other
    gradient sits within the file's f32 band of float64 on both sides."""
    worst = {"jax": 0.0, "port": 0.0}
    for seed in range(3):
        ins, cots = _inputs(b, s, nh, hd, g, n, True, True, seed=seed)
        ins["C"] = ins["B"].copy()
        sides = {"jax": _jax_grads(ins, cots, 128)}
        plain = {k: torch.from_numpy(v) for k, v in ins.items()}
        got = ssd_scan_bwd_ref(torch.from_numpy(cots["dy"]), torch.from_numpy(cots["dh_final"]),
                               plain["x"], plain["dt"], plain["a_neg"], plain["B"], plain["C"],
                               h0=plain["h0"], chunk=128)
        sides["port"] = {nm: g_.numpy() for nm, g_ in zip(NAMES, got)}
        d = {k: torch.from_numpy(v).double().requires_grad_() for k, v in ins.items()}
        y, hf = ssd_sequential_ref(d["x"], d["dt"], d["a_neg"], d["B"], d["C"], h0=d["h0"])
        exact = torch.autograd.grad(
            [y, hf], [d[k] for k in ("x", "dt", "a_neg", "B", "C", "h0")],
            [torch.from_numpy(cots["dy"]).double(), torch.from_numpy(cots["dh_final"]).double()])
        for name, e in zip(NAMES, exact):
            e = e.numpy()
            scale = max(1.0, float(np.abs(e).max()))
            for side, grads in sides.items():
                err = float(np.abs(grads[name].astype(np.float64) - e).max()) / scale
                if name == "da":
                    worst[side] = max(worst[side], err)
                else:
                    assert err <= TOL[name], f"seed {seed} {side} {name}: {err} of float64"
    assert worst["port"] <= worst["jax"], worst
