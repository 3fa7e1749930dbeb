"""Mamba-2 (SSD, state-space duality) block (counterpart of `repro.models.ssm`).

Prefill runs the chunked SSD scan through `ops.ssd_auto` (the `ssd_scan`
kernel on the card, its plain version on the CPU), as the reference's
``backend="pallas"`` does; decode is the O(1) recurrent update in plain
PyTorch, as it is plain JAX in the reference.  The recurrent state (``ssd``
[B,nh,hd,N] f32 and ``conv`` [B,K-1,conv_dim]) is this family's decode state
for DéjàVu streaming.

`torch.nn.functional.softplus` returns its input above 20, where
`jax.nn.softplus` is exact; the two differ there by log(1 + e^-x) < 2.1e-9,
below float32's resolution of any value above 20.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.common import dense_init, rmsnorm

DEFAULT_CHUNK = 128


def ssm_init(generator, cfg, dtype, device):
    d, di = cfg.d_model, cfg.d_inner
    g, n, nh, kconv = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_conv
    conv_dim = di + 2 * g * n
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": dense_init(generator, (d, 2 * di + 2 * g * n + nh), dtype, device),
        "w_out": dense_init(generator, (di, d), dtype, device),
        "conv_w": dense_init(generator, (kconv, conv_dim), dtype, device, scale=0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.zeros((nh,), **f32),
        "D": torch.ones((nh,), **f32),
        "norm_scale": torch.zeros((di,), dtype=dtype, device=device),
    }


def _dims(p, cfg):
    """(heads, inner width, B/C width) of the block `p`: the whole block's,
    or under split compute the rank's heads' (its weights' widths)."""
    nh = p["A_log"].shape[0]
    return nh, nh * cfg.ssm_head_dim, cfg.ssm_ngroups * cfg.ssm_state


def _proj_in_parts(x, p, cfg, tp=None):
    """The input projection as one matmul, split into (z, x, B, C, dt).
    (The reference's five-way split of the weight exists for its sharding
    rules; under split compute `tp.ssm_in` gives the rank's columns.)"""
    _, di, gn = _dims(p, cfg)
    h = x @ p["w_in"] if tp is None else tp.ssm_in(x, p["w_in"])
    return (h[..., :di], h[..., di: 2 * di], h[..., 2 * di: 2 * di + gn],
            h[..., 2 * di + gn: 2 * di + 2 * gn], h[..., 2 * di + 2 * gn:])


def _conv_slices(di: int, gn: int):
    """(x, b, c) channel slices of conv buffers [x (di) | B | C]."""
    return slice(0, di), slice(di, di + gn), slice(di + gn, di + 2 * gn)


def _causal_conv(xbc, w, bias):
    """Depthwise causal conv.  xbc [B,S,C]; w [K,C]."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):                     # the reference's order of summation
        out = out + pad[:, i: i + s, :] * w[i]
    return out + bias


def ssd_decode_step(x, dt, a_neg, bmat, cmat, h):
    """One-token recurrent update.  x [B,nh,hd]; dt [B,nh]; b/c [B,G,N];
    h [B,nh,hd,N] f32.  Returns (y [B,nh,hd], h')."""
    rep = x.shape[1] // bmat.shape[1]
    xf = x.float()
    da = torch.exp(dt.float() * a_neg.float())                       # [B,nh]
    b_h = torch.repeat_interleave(bmat.float(), rep, dim=1)          # [B,nh,N]
    c_h = torch.repeat_interleave(cmat.float(), rep, dim=1)
    h_new = h * da[:, :, None, None] + (dt.float()[:, :, None, None]
                                        * xf[:, :, :, None] * b_h[:, :, None, :])
    y = torch.einsum("bhdn,bhn->bhd", h_new, c_h)
    return y.to(x.dtype), h_new


def ssm_prefill(x, p, cfg, h0=None, conv0=None, tp=None):
    """x [B,S,d] -> (out [B,S,d], ssd_state [B,nh,hd,N] f32, conv_state
    [B,K-1,conv_dim]).  h0 / conv0 resume from a state streamed in (not
    under `tp`).  Under
    `tp` (a `distributed.tensor_parallel.Split`), x has passed through
    `tp.enter`, `p` is the rank's heads' share, the states are its heads'
    and its x channels' (then B, C), and `out` is summed over `model`
    (`tp.ssm_out`)."""
    nh, di, gn = _dims(p, cfg)
    z, xp, bp, cp, dt = _proj_in_parts(x, p, cfg, tp)
    sx, sb, sc = _conv_slices(di, gn)
    km1 = cfg.ssm_conv - 1

    def conv_part(part, ch, ctx):
        w, bias = p["conv_w"][:, ch], p["conv_b"][ch]
        if ctx is not None:
            full = torch.cat([ctx.to(part.dtype), part], dim=1)
            return _causal_conv(full, w, bias)[:, ctx.shape[1]:]
        return _causal_conv(part, w, bias)

    ctx = [None] * 3 if conv0 is None else [conv0[:, :, s] for s in (sx, sb, sc)]
    xin = F.silu(conv_part(xp, sx, ctx[0]))
    bmat = F.silu(conv_part(bp, sb, ctx[1]))
    cmat = F.silu(conv_part(cp, sc, ctx[2]))

    def tail(part, c):
        seq = torch.cat([c, part], dim=1) if c is not None else F.pad(part, (0, 0, km1, 0))
        return seq[:, -km1:]

    conv_state = torch.cat([tail(xp, ctx[0]), tail(bp, ctx[1]), tail(cp, ctx[2])], dim=2)

    b, s, _ = x.shape
    xh = xin.reshape(b, s, nh, cfg.ssm_head_dim)
    bm = bmat.reshape(b, s, cfg.ssm_ngroups, cfg.ssm_state)
    cm = cmat.reshape(b, s, cfg.ssm_ngroups, cfg.ssm_state)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    a_neg = -torch.exp(p["A_log"])
    y, hfin = kops.ssd_auto(xh, dtv, a_neg, bm, cm, chunk=min(DEFAULT_CHUNK, s), h0=h0)
    y = y + (p["D"][:, None] * xh.float()).to(y.dtype)
    y = rmsnorm(y.reshape(b, s, di) * F.silu(z), p["norm_scale"], tp=tp)
    out = y @ p["w_out"] if tp is None else tp.ssm_out(y, p["w_out"])
    return out, hfin, conv_state.to(x.dtype)


def ssm_decode(x, p, cfg, ssd_state, conv_state, tp=None):
    """x [B,1,d] -> (out [B,1,d], ssd_state', conv_state').  Under `tp`,
    `p` and `ssd_state` are the rank's heads' share, `conv_state` is whole
    (the rank reads its x channels and B, C; the new x channels are
    all-gathered over `model`) and `out` is summed over `model`.  With
    opt-rowssm's row-split `w_in` and `w_out` the partial projections are
    summed instead (`Split.ssm_in`, `ssm_out`), whether the rank decodes
    its heads or, where the state is whole, all of them."""
    b = x.shape[0]
    nh, di, gn = _dims(p, cfg)
    z, xp, bp, cp, dt = _proj_in_parts(x[:, 0], p, cfg, tp)
    sx, sb, sc = _conv_slices(di, gn)
    # the conv state's channels: [x (all of d_inner) | B | C]
    cx, cb, cc = _conv_slices(cfg.d_inner, gn)
    if tp is not None:
        cx = slice(*tp.ssm_inner)

    def conv_step(part, ch, ctx):
        w, bias = p["conv_w"][:, ch], p["conv_b"][ch]
        win = torch.cat([ctx.to(part.dtype), part[:, None, :]], dim=1)
        return F.silu(torch.einsum("bkc,kc->bc", win, w) + bias)

    xin = conv_step(xp, sx, conv_state[:, :, cx])
    bmat = conv_step(bp, sb, conv_state[:, :, cb])
    cmat = conv_step(cp, sc, conv_state[:, :, cc])
    new = torch.cat([xp if tp is None else tp.gather_inner(xp), bp, cp], dim=1)
    new_conv = torch.cat([conv_state[:, 1:], new[:, None, :].to(conv_state.dtype)], dim=1)

    xh = xin.reshape(b, nh, cfg.ssm_head_dim)
    bm = bmat.reshape(b, cfg.ssm_ngroups, cfg.ssm_state)
    cm = cmat.reshape(b, cfg.ssm_ngroups, cfg.ssm_state)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    a_neg = -torch.exp(p["A_log"])
    y, h_new = ssd_decode_step(xh, dtv, a_neg, bm, cm, ssd_state)
    y = y + (p["D"][:, None] * xh.float()).to(y.dtype)
    y = rmsnorm(y.reshape(b, di) * F.silu(z), p["norm_scale"], tp=tp)
    out = (y @ p["w_out"] if tp is None else tp.ssm_out(y, p["w_out"]))[:, None, :]
    return out, h_new, new_conv
