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
batch holds prompts of one length, as in the reference.  `loss` drops the
meta positions before the head; on the card it trains through the SSD scan
and flash attention kernels and their backward kernels.  `loss`, `prefill`
and `decode_step` take ``tp`` for split compute on a mesh
(`distributed.tensor_parallel.Split`); with ``tp=None`` nothing of it runs.

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
from repro_torch.models.common import (embed_init, head, head_init, hooked, layer_params,
                                       lm_loss, lookup, norm_apply, norm_init, on_seq,
                                       rmsnorm, run_layer, scatter, stack_layers,
                                       unstack_layers)
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
    def __init__(self, cfg: ArchConfig, device="cuda", remat: bool = False):
        if cfg.family != "hybrid":
            raise ValueError(f"HybridLM serves the hybrid family, not {cfg.family}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.remat = remat
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

    def _fuse_mlp(self, x, lp, a_out, s_out, tp=None):
        """Both branches' outputs, each whole (under `tp` summed over `model`
        before its norm; on a stream cut over `model` the rank's slice),
        fused; then the MLP."""
        cfg = self.cfg
        fused = 0.5 * (rmsnorm(a_out, lp["fuse_na"]) + rmsnorm(s_out, lp["fuse_ns"]))
        x = x + fused
        return x + mlp_apply(norm_apply(cfg.norm, x, lp["ln2"]), lp["mlp"], cfg, tp)

    def _layer_parallel(self, x, lp, positions, window: int, tp=None):
        """Full-sequence layer: returns (x, k, v, ssd_state, conv_state)
        (under `tp`, the rank's KV heads and SSM heads)."""
        cfg = self.cfg
        h = norm_apply(cfg.norm, x, lp["ln1"])
        kw = dict(window=window, num_meta=cfg.num_meta_tokens)
        if tp is None:
            a_out, k, v = attn.attention_prefill(h, lp["attn"], cfg, positions, **kw)
        else:
            h = tp.enter(h)                     # once: both branches read it
            a_out, k, v = tp.attention("prefill", h, lp["attn"], positions=positions, **kw)
        s_out, hfin, conv = ssm.ssm_prefill(h, lp["ssm"], cfg, tp=tp)
        return self._fuse_mlp(x, lp, a_out, s_out, tp), k, v, hfin, conv

    def _embed_meta(self, params, tokens, tp=None):
        """The M meta tokens, then the prompt's embeddings: [B, M+S, d]."""
        x = lookup(params["embed"], tokens, tp)
        meta = params["meta"][None].expand(tokens.shape[0], -1, -1).to(x.dtype)
        return torch.cat([meta, x], dim=1)

    def _train_layer(self, x, lp, positions, window: int, tp=None):
        return self._layer_parallel(x, hooked(lp, tp), positions, window, tp)[0]

    def loss(self, params, batch, tp=None):
        """batch {"tokens", "targets": [B,S] int, "loss_mask": [B,S]} -> the
        causal-LM loss over the prompt's positions (the meta tokens' are
        dropped before the head), f32 scalar.  Under `tp` (split compute,
        `distributed.tensor_parallel.Split`) `params` are this rank's
        shards; under the opt rules the residual stream, meta tokens
        included, is cut over `model` (`Split.on_seq`) after the embedding's
        sum."""
        cfg = self.cfg
        x = self._embed_meta(params, batch["tokens"], tp)
        tp = on_seq(tp, x.shape[1])
        x = scatter(x, tp)
        positions = torch.arange(cfg.num_meta_tokens + batch["tokens"].shape[1],
                                 dtype=torch.int32, device=x.device)
        for lp, (kind, _) in zip(unstack_layers(params["layers"], cfg.num_layers),
                                 self.slots):
            window = 0 if kind == "full" else cfg.sliding_window
            x = run_layer(self._train_layer, self.remat, x, lp, positions, window, tp)
        return lm_loss(cfg, params, x, batch, tp, skip=cfg.num_meta_tokens)

    # ------------------------------------------------------------------
    def prefill(self, params, batch, max_len=None, tp=None):
        """batch {"tokens": [B,S]} -> (last-token logits [B,V], decode state,
        the next position M + S).  The full-attention caches grow to
        `max_len` slots (meta tokens included) when it is larger.  Under
        `tp` the state is placed as the rules place it (`Split.place_kv`,
        `place_ssm`)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        s = tokens.shape[1]
        m, w = cfg.num_meta_tokens, cfg.sliding_window
        x = self._embed_meta(params, tokens, tp)
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
            lp = hooked(layer_params(params["layers"], i), tp)
            window = 0 if kind == "full" else w
            x, k, v, hfin, conv = self._layer_parallel(x, lp, positions, window, tp)
            if kind == "swa":
                k = k[:, gather_idx] * valid.to(k.dtype)
                v = v[:, gather_idx] * valid.to(v.dtype)
            kv[kind][0].append(k)
            kv[kind][1].append(v)
            convs.append(conv)
            ssds.append(hfin)

        logits = head(cfg, params, x[:, -1:, :], tp)[:, 0]
        full_k, full_v = torch.stack(kv["full"][0]), torch.stack(kv["full"][1])
        swa_k, swa_v = torch.stack(kv["swa"][0]), torch.stack(kv["swa"][1])
        swa_pos = torch.as_tensor(ring, dtype=torch.int32, device=x.device)
        if tp is not None:
            fk, fv = tp.place_kv("kv_full", full_k, full_v, max(st, max_len or st))
            sk, sv = tp.place_kv("kv_swa", swa_k, swa_v, m + w)
            tp.place("swa_pos", swa_pos.shape, swa_pos.dtype)
            return tp.gather_vocab(logits), {
                "kv_full": {"k": fk, "v": fv}, "kv_swa": {"k": sk, "v": sv},
                "swa_pos": swa_pos, **tp.place_ssm(torch.stack(ssds), torch.stack(convs))}, st
        if max_len is not None and max_len > st:   # grow the full-attention cache
            full_k = F.pad(full_k, (0, 0, 0, 0, 0, max_len - st))
            full_v = F.pad(full_v, (0, 0, 0, 0, 0, max_len - st))
        state = {
            "kv_full": {"k": full_k, "v": full_v},
            "kv_swa": {"k": swa_k, "v": swa_v},
            "swa_pos": swa_pos,
            "conv": torch.stack(convs),
            "ssd": torch.stack(ssds),
        }
        return logits, state, st

    # ------------------------------------------------------------------
    def decode_step(self, params, state, token, pos: int, tp=None):
        """token [B] at absolute position `pos` (meta offset included) ->
        (logits [B,V], the state, updated in place).  Under `tp` attention
        runs over the rank's slices of the caches and the SSM on the rank's
        heads where the state's lie over `model`, whole where the rules keep
        the state whole."""
        cfg = self.cfg
        m, w = cfg.num_meta_tokens, cfg.sliding_window
        pos = int(pos)
        x = lookup(params["embed"], token[:, None], tp)
        slot = m + (pos - m) % w
        swa_pos = state["swa_pos"]
        swa_pos[slot] = pos
        full_len = state["kv_full"]["k"].shape[2]
        full_pos = torch.arange(full_len, dtype=torch.int32, device=x.device)
        full_pos = torch.where(full_pos <= pos, full_pos, -1)

        for i, (kind, ci) in enumerate(self.slots):
            lp = hooked(layer_params(params["layers"], i), tp)
            cache = state["kv_" + kind]
            if kind == "full":
                window, kv_positions, write_index = 0, full_pos, pos
            else:
                window, kv_positions, write_index = w, swa_pos, slot
            h = norm_apply(cfg.norm, x, lp["ln1"])
            if tp is None:
                a_out, _, _ = attn.attention_decode(
                    h, lp["attn"], cfg, cache["k"][ci], cache["v"][ci], kv_positions, pos,
                    window=window, num_meta=m, write_index=write_index)
            else:
                h = tp.enter(h)
                a_out, _, _ = tp.attention(
                    "decode", h, lp["attn"], kc=cache["k"][ci], vc=cache["v"][ci], pos=pos,
                    window=window, num_meta=m, key="kv_" + kind,
                    kv_positions=None if kind == "full" else swa_pos, write_index=write_index)
            s_out, ssd_new, conv_new = ssm.ssm_decode(h, lp["ssm"], cfg, state["ssd"][i],
                                                      state["conv"][i],
                                                      tp=None if tp is None else tp.ssm_tp)
            state["ssd"][i] = ssd_new
            state["conv"][i] = conv_new
            x = self._fuse_mlp(x, lp, a_out, s_out, tp)
        logits = head(cfg, params, x, tp)[:, 0]
        return (logits if tp is None else tp.gather_vocab(logits)), state
