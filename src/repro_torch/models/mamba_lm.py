"""Mamba-2 LM, the attention-free SSD backbone (counterpart of
`repro.models.mamba_lm.MambaLM`).

Decode state = {"conv": [L,B,K-1,conv_dim], "ssd": [L,B,nh,hd,N] f32}: the
fixed-size generalisation of the KV cache for DéjàVu streaming.  Parameters
are a nested dict with the layers stacked ``[L, ...]``, the reference's
layout.  `decode_step` updates the state in place and returns it.  `loss`
trains through the plain SSD scan on the CPU and, on the card, through the
`ssd_scan` kernel and its backward kernel (`kernels.ssd_scan.SSDScanFn`).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm
from repro_torch.models.common import (embed_init, head_init, layer_params, norm_apply,
                                       norm_init, run_layer, stack_layers, unembed,
                                       unstack_layers)
from repro_torch.models.losses import causal_lm_loss


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

    def _train_layer(self, x, lp):
        out, _, _ = ssm.ssm_prefill(norm_apply(self.cfg.norm, x, lp["ln"]), lp["ssm"],
                                    self.cfg)
        return x + out

    def loss(self, params, batch):
        """batch {"tokens", "targets": [B,S] int, "loss_mask": [B,S]} -> the
        causal-LM loss, f32 scalar."""
        cfg = self.cfg
        x = F.embedding(batch["tokens"], params["embed"])
        for lp in unstack_layers(params["layers"], cfg.num_layers):
            x = run_layer(self._train_layer, self.remat, x, lp)
        return causal_lm_loss(unembed(cfg, params, x), batch["targets"], batch["loss_mask"])

    def prefill(self, params, batch, max_len=None):
        """batch {"tokens": [B,S]} -> (last-token logits [B,V], decode state,
        the next position S).  The state has a fixed size: `max_len` is
        accepted for the Model API and not needed."""
        cfg = self.cfg
        x = F.embedding(batch["tokens"], params["embed"])
        hs, convs = [], []
        for i in range(cfg.num_layers):
            lp = layer_params(params["layers"], i)
            out, hfin, conv = ssm.ssm_prefill(norm_apply(cfg.norm, x, lp["ln"]), lp["ssm"], cfg)
            x = x + out
            hs.append(hfin)
            convs.append(conv)
        logits = unembed(cfg, params, x[:, -1:, :])[:, 0]
        return logits, {"conv": torch.stack(convs), "ssd": torch.stack(hs)}, x.shape[1]

    def decode_step(self, params, state, token, pos):
        """token [B] -> (logits [B,V], the state, updated in place).  The
        recurrence needs no position: `pos` is accepted for the Model API."""
        cfg = self.cfg
        x = F.embedding(token[:, None], params["embed"])
        for i in range(cfg.num_layers):
            lp = layer_params(params["layers"], i)
            out, h, conv = ssm.ssm_decode(norm_apply(cfg.norm, x, lp["ln"]), lp["ssm"], cfg,
                                          state["ssd"][i], state["conv"][i])
            state["ssd"][i] = h
            state["conv"][i] = conv
            x = x + out
        return unembed(cfg, params, x)[:, 0], state
