"""Hymba-style hybrid LM: parallel attention and Mamba heads in every layer
(counterpart of `repro.models.hybrid.HybridLM`).

Each layer runs attention and an SSD block in parallel on the same normed
input and mean-fuses their rms-normalised outputs.  Most layers use
sliding-window attention over a ring-buffer KV cache of M + W slots (M meta
tokens, window W); the `full_attn_layers` attend globally.  The M learnable
meta tokens are prepended to every prompt and stay visible from every
window.  Decode state (see `kvcache.cache`): kv_swa [Lswa,B,M+W,Hkv,Dh] ring,
kv_full [Lfull,B,M+S,Hkv,Dh], swa_pos [M+W] absolute position per slot, and
the conv and ssd states of every layer.  `decode_step` updates the state in
place and returns it.  ``swa_pos`` is one vector for the whole batch, so a
batch holds prompts of one length, as in the reference.

The reference's ``backend="pallas"`` would send a windowed layer's prefill
to `flash_attention` by the mask's shape and lose its window; the port
routes by the layer's configuration (`ops.attention_auto`): the
full-attention layers' prefill runs the `flash_attention` kernel (meta
tokens leave a window-0 mask causal), the sliding-window layers attend
through the plain `attend`, and the reference to hold it against is
``backend="xla"``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.common import (embed_init, head_init, layer_params, norm_apply,
                                       norm_init, rmsnorm, stack_layers, unembed)
from repro_torch.models.mlp import mlp_apply, mlp_init


def _segments(cfg: ArchConfig):
    """[('full', layer_idx, full_idx) | ('swa', start, stop, swa_start)]"""
    full = set(cfg.full_attn_layers)
    segs, i, swa_count, full_count = [], 0, 0, 0
    while i < cfg.num_layers:
        if i in full:
            segs.append(("full", i, full_count))
            full_count += 1
            i += 1
        else:
            j = i
            while j < cfg.num_layers and j not in full:
                j += 1
            segs.append(("swa", i, j, swa_count))
            swa_count += j - i
            i = j
    return segs


def _layer_slots(segs) -> List[tuple]:
    """Per layer (kind, index into its cache stack), in layer order."""
    out = []
    for seg in segs:
        if seg[0] == "full":
            out.append(("full", seg[2]))
        else:
            _, lo, hi, so = seg
            out.extend(("swa", so + k) for k in range(hi - lo))
    return out


class HybridLM:
    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.family != "hybrid":
            raise ValueError(f"HybridLM serves the hybrid family, not {cfg.family}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.slots = _layer_slots(_segments(cfg))

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Dict:
        """Random weights drawn from `generator` (on its own device), in the
        reference's layout, placed on this model's device."""
        cfg, dev, g = self.cfg, self.device, generator
        dtype = torch_dtype(cfg.dtype)
        z = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=dev)   # noqa: E731
        p: Dict = {"embed": embed_init(g, (cfg.vocab_size, cfg.d_model), dtype, dev),
                   "meta": embed_init(g, (cfg.num_meta_tokens, cfg.d_model), dtype, dev)}
        p["layers"] = stack_layers([
            {"ln1": norm_init(cfg.norm, cfg.d_model, dtype, dev),
             "attn": attn.attn_init(g, cfg, dtype, dev),
             "ssm": ssm.ssm_init(g, cfg, dtype, dev),
             "fuse_na": z(), "fuse_ns": z(),
             "ln2": norm_init(cfg.norm, cfg.d_model, dtype, dev),
             "mlp": mlp_init(g, cfg, dtype, dev)}
            for _ in range(cfg.num_layers)])
        p.update(head_init(g, cfg, dtype, dev))
        return p

    def _fuse_mlp(self, x, lp, a_out, s_out):
        cfg = self.cfg
        fused = 0.5 * (rmsnorm(a_out, lp["fuse_na"]) + rmsnorm(s_out, lp["fuse_ns"]))
        x = x + fused
        return x + mlp_apply(norm_apply(cfg.norm, x, lp["ln2"]), lp["mlp"], cfg)

    def _layer_parallel(self, x, lp, positions, window: int):
        """Full-sequence layer: returns (x, k, v, ssd_state, conv_state)."""
        cfg = self.cfg
        h = norm_apply(cfg.norm, x, lp["ln1"])
        a_out, k, v = attn.attention_prefill(h, lp["attn"], cfg, positions, window=window,
                                             num_meta=cfg.num_meta_tokens)
        s_out, hfin, conv = ssm.ssm_prefill(h, lp["ssm"], cfg)
        return self._fuse_mlp(x, lp, a_out, s_out), k, v, hfin, conv

    # ------------------------------------------------------------------
    def prefill(self, params, batch, max_len=None):
        """batch {"tokens": [B,S]} -> (last-token logits [B,V], decode state,
        the next position M + S).  The full-attention caches grow to
        `max_len` slots (meta tokens included) when it is larger."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        m, w = cfg.num_meta_tokens, cfg.sliding_window
        x = F.embedding(tokens, params["embed"])
        meta = params["meta"][None].expand(b, m, cfg.d_model).to(x.dtype)
        x = torch.cat([meta, x], dim=1)
        st = m + s
        positions = torch.arange(st, dtype=torch.int32, device=x.device)

        # ring slot -> absolute position of the sliding-window cache (static)
        ring = np.full((m + w,), -1, np.int64)
        ring[:m] = np.arange(m)
        for p_abs in range(max(m, st - w), st):
            ring[m + (p_abs - m) % w] = p_abs
        gather_idx = torch.as_tensor(np.where(ring >= 0, ring, 0), device=x.device)
        valid = torch.as_tensor(ring >= 0, device=x.device)[None, :, None, None]

        kv = {"full": ([], []), "swa": ([], [])}
        convs, ssds = [], []
        for i, (kind, _) in enumerate(self.slots):
            lp = layer_params(params["layers"], i)
            window = 0 if kind == "full" else w
            x, k, v, hfin, conv = self._layer_parallel(x, lp, positions, window)
            if kind == "swa":
                k = k[:, gather_idx] * valid.to(k.dtype)
                v = v[:, gather_idx] * valid.to(v.dtype)
            kv[kind][0].append(k)
            kv[kind][1].append(v)
            convs.append(conv)
            ssds.append(hfin)

        logits = unembed(cfg, params, x[:, -1:, :])[:, 0]
        full_k, full_v = torch.stack(kv["full"][0]), torch.stack(kv["full"][1])
        if max_len is not None and max_len > st:   # grow the full-attention cache
            full_k = F.pad(full_k, (0, 0, 0, 0, 0, max_len - st))
            full_v = F.pad(full_v, (0, 0, 0, 0, 0, max_len - st))
        state = {
            "kv_full": {"k": full_k, "v": full_v},
            "kv_swa": {"k": torch.stack(kv["swa"][0]), "v": torch.stack(kv["swa"][1])},
            "swa_pos": torch.as_tensor(ring, dtype=torch.int32, device=x.device),
            "conv": torch.stack(convs),
            "ssd": torch.stack(ssds),
        }
        return logits, state, st

    # ------------------------------------------------------------------
    def decode_step(self, params, state, token, pos: int):
        """token [B] at absolute position `pos` (meta offset included) ->
        (logits [B,V], the state, updated in place)."""
        cfg = self.cfg
        m, w = cfg.num_meta_tokens, cfg.sliding_window
        pos = int(pos)
        x = F.embedding(token[:, None], params["embed"])
        slot = m + (pos - m) % w
        swa_pos = state["swa_pos"]
        swa_pos[slot] = pos
        full_len = state["kv_full"]["k"].shape[2]
        full_pos = torch.arange(full_len, dtype=torch.int32, device=x.device)
        full_pos = torch.where(full_pos <= pos, full_pos, -1)

        for i, (kind, ci) in enumerate(self.slots):
            lp = layer_params(params["layers"], i)
            cache = state["kv_" + kind]
            if kind == "full":
                window, kv_positions, write_index = 0, full_pos, pos
            else:
                window, kv_positions, write_index = w, swa_pos, slot
            h = norm_apply(cfg.norm, x, lp["ln1"])
            a_out, _, _ = attn.attention_decode(
                h, lp["attn"], cfg, cache["k"][ci], cache["v"][ci], kv_positions, pos,
                window=window, num_meta=m, write_index=write_index)
            s_out, ssd_new, conv_new = ssm.ssm_decode(h, lp["ssm"], cfg, state["ssd"][i],
                                                      state["conv"][i])
            state["ssd"][i] = ssd_new
            state["conv"][i] = conv_new
            x = self._fuse_mlp(x, lp, a_out, s_out)
        return unembed(cfg, params, x)[:, 0], state
