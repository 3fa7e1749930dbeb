"""Mamba-2 LM, the attention-free SSD backbone (counterpart of
`repro.models.mamba_lm.MambaLM`).

Decode state = {"conv": [L,B,K-1,conv_dim], "ssd": [L,B,nh,hd,N] f32}: the
fixed-size generalisation of the KV cache for DéjàVu streaming.  Parameters
are a nested dict with the layers stacked ``[L, ...]``, the reference's
layout.  `decode_step` updates the state in place and returns it.  `loss`
trains through the plain SSD scan on the CPU and, on the card, through the
`ssd_scan` kernel and its backward kernel (`kernels.ssd_scan.SSDScanFn`).
`loss`, `prefill` and `decode_step` take ``tp`` for split compute on a mesh
(`distributed.tensor_parallel.Split`); with ``tp=None`` nothing of it runs.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm
from repro_torch.models.common import (embed_init, head, head_init, hooked, layer_params,
                                       lm_loss, lookup, norm_apply, norm_init, on_seq,
                                       run_layer, stack_layers, unstack_layers)


class MambaLM:
    def __init__(self, cfg: ArchConfig, device="cuda", remat: bool = False):
        if cfg.family != "ssm":
            raise ValueError(f"MambaLM serves the ssm family, not {cfg.family}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.remat = remat

    def init(self, generator: torch.Generator) -> Dict:
        """Random weights drawn from `generator` (on its own device), in the
        reference's layout, placed on this model's device."""
        cfg, dev, g = self.cfg, self.device, generator
        dtype = torch_dtype(cfg.dtype)
        p: Dict = {"embed": embed_init(g, (cfg.vocab_size, cfg.d_model), dtype, dev)}
        p["layers"] = stack_layers([{"ln": norm_init(cfg.norm, cfg.d_model, dtype, dev),
                                     "ssm": ssm.ssm_init(g, cfg, dtype, dev)}
                                    for _ in range(cfg.num_layers)])
        p.update(head_init(g, cfg, dtype, dev))
        return p

    def _normed(self, x, lp, tp):
        """The block's input: under `tp` through `enter`."""
        h = norm_apply(self.cfg.norm, x, lp["ln"])
        return h if tp is None else tp.enter(h)

    def _train_layer(self, x, lp, tp=None):
        lp = hooked(lp, tp)
        out, _, _ = ssm.ssm_prefill(self._normed(x, lp, tp), lp["ssm"], self.cfg, tp=tp)
        return x + out

    def loss(self, params, batch, tp=None):
        """batch {"tokens", "targets": [B,S] int, "loss_mask": [B,S]} -> the
        causal-LM loss, f32 scalar.  Under `tp` (split compute,
        `distributed.tensor_parallel.Split`) `params` are this rank's
        shards; under the opt rules the residual stream is cut over `model`
        (`Split.on_seq`)."""
        cfg = self.cfg
        tp = on_seq(tp, batch["tokens"].shape[1])
        x = lookup(params["embed"], batch["tokens"], tp)
        for lp in unstack_layers(params["layers"], cfg.num_layers):
            x = run_layer(self._train_layer, self.remat, x, lp, tp)
        return lm_loss(cfg, params, x, batch, tp)

    def prefill(self, params, batch, max_len=None, tp=None):
        """batch {"tokens": [B,S]} -> (last-token logits [B,V], decode state,
        the next position S).  The state has a fixed size: `max_len` is
        accepted for the Model API and not needed.  Under `tp` the state is
        placed as the rules place it (`Split.place_ssm`)."""
        cfg = self.cfg
        x = lookup(params["embed"], batch["tokens"], tp)
        hs, convs = [], []
        for i in range(cfg.num_layers):
            lp = hooked(layer_params(params["layers"], i), tp)
            out, hfin, conv = ssm.ssm_prefill(self._normed(x, lp, tp), lp["ssm"], cfg, tp=tp)
            x = x + out
            hs.append(hfin)
            convs.append(conv)
        logits = head(cfg, params, x[:, -1:, :], tp)[:, 0]
        if tp is not None:
            return (tp.gather_vocab(logits), tp.place_ssm(torch.stack(hs), torch.stack(convs)),
                    x.shape[1])
        return logits, {"conv": torch.stack(convs), "ssd": torch.stack(hs)}, x.shape[1]

    def decode_step(self, params, state, token, pos, tp=None):
        """token [B] -> (logits [B,V], the state, updated in place).  The
        recurrence needs no position: `pos` is accepted for the Model API.
        Under `tp` the SSM runs on the rank's heads where the state's lie
        over `model`, whole where the rules keep the state whole."""
        cfg = self.cfg
        x = lookup(params["embed"], token[:, None], tp)
        stp = None if tp is None else tp.ssm_tp
        for i in range(cfg.num_layers):
            lp = hooked(layer_params(params["layers"], i), tp)
            out, h, conv = ssm.ssm_decode(self._normed(x, lp, stp), lp["ssm"], cfg,
                                          state["ssd"][i], state["conv"][i], tp=stp)
            state["ssd"][i] = h
            state["conv"][i] = conv
            x = x + out
        logits = head(cfg, params, x, tp)[:, 0]
        return (logits if tp is None else tp.gather_vocab(logits)), state
