"""Encoder-decoder backbone, the encdec family (SeamlessM4T; counterpart of
`repro.models.encdec.EncDecLM`).

The modality frontend is a stub: callers pass frame embeddings
``src_embeds [B, Ssrc, d]``.  The encoder is bidirectional and stateless;
its attention has no mask, so it runs full `flash_attention`.  The decoder
has learned positions and no rope; each layer runs causal self-attention,
then cross-attention over the encoder's output (full `flash_attention`, the
prompt's S queries or one in decode over Ssrc keys), then the MLP.  The
decode state is the self-attention cache plus each layer's cross-attention
K/V, computed once at `prefill` and reused by every `decode_step`: both
belong to the DéjàVu decode state.

Parameters keep the reference's layout, the encoder's and the decoder's
layers stacked apart (``enc_layers`` [Lenc, ...], ``dec_layers`` [L, ...]),
so `repro_torch.bridge` hands the reference's weights over unchanged.
``remat`` checkpoints each decoder layer of `loss`, as the reference's
``jax.checkpoint`` does; the encoder runs without it there too.  The model
has no stage API: the cluster does not serve it, nor does the reference's.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models.common import (embed_init, norm_apply, norm_init, run_layer,
                                       stack_layers, unstack_layers)
from repro_torch.models.losses import causal_lm_loss
from repro_torch.models.mlp import mlp_apply, mlp_init


class EncDecLM:
    def __init__(self, cfg: ArchConfig, device="cuda", remat: bool = False):
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM serves the encdec family, not family={cfg.family}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.remat = remat

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Dict:
        """Random weights drawn from `generator` (on its own device), in the
        reference's layout, placed on this model's device."""
        cfg, dev, g = self.cfg, self.device, generator
        dtype = torch_dtype(cfg.dtype)
        d = cfg.d_model
        p: Dict = {"embed": embed_init(g, (cfg.vocab_size, d), dtype, dev),
                   "src_pos": embed_init(g, (cfg.max_source_len, d), dtype, dev),
                   "pos_table": embed_init(g, (cfg.max_seq_len, d), dtype, dev)}

        def norm():
            return norm_init(cfg.norm, d, dtype, dev)

        def enc_layer():
            return {"ln1": norm(), "attn": attn.attn_init(g, cfg, dtype, dev), "ln2": norm(),
                    "mlp": mlp_init(g, cfg, dtype, dev)}

        def dec_layer():
            return {"ln1": norm(), "attn": attn.attn_init(g, cfg, dtype, dev), "lnx": norm(),
                    "cross": attn.attn_init(g, cfg, dtype, dev), "ln2": norm(),
                    "mlp": mlp_init(g, cfg, dtype, dev)}

        p["enc_layers"] = stack_layers([enc_layer() for _ in range(cfg.num_encoder_layers)])
        p["dec_layers"] = stack_layers([dec_layer() for _ in range(cfg.num_layers)])
        p["enc_final"] = norm()
        p["final_norm"] = norm()
        p["lm_head"] = embed_init(g, (d, cfg.vocab_size), dtype, dev)
        return p

    # ------------------------------------------------------------------
    def encode(self, params, src_embeds):
        """src_embeds [B,Ssrc,d] -> the encoder's output [B,Ssrc,d]."""
        cfg = self.cfg
        s = src_embeds.shape[1]
        x = src_embeds.to(torch_dtype(cfg.dtype)) + params["src_pos"][:s][None]
        for lp in unstack_layers(params["enc_layers"], cfg.num_encoder_layers):
            h = norm_apply(cfg.norm, x, lp["ln1"])
            q, k, v = attn.qkv_proj(h, lp["attn"], cfg)
            x = x + attn.out_proj(kops.attention_auto(q, k, v), lp["attn"])   # bidirectional
            x = x + mlp_apply(norm_apply(cfg.norm, x, lp["ln2"]), lp["mlp"], cfg)
        return norm_apply(cfg.norm, x, params["enc_final"])

    def _embed(self, params, tokens):
        return F.embedding(tokens, params["embed"]) + params["pos_table"][:tokens.shape[1]][None]

    def _head(self, params, x):
        return norm_apply(self.cfg.norm, x, params["final_norm"]) @ params["lm_head"]

    def _dec_layer(self, x, lp, enc_out, positions):
        """One decoder layer over whole prompts -> (x, its self-attention
        K/V [B,S,Hkv,Dh], its cross-attention K/V [B,Ssrc,Hkv,Dh])."""
        cfg = self.cfg
        h = norm_apply(cfg.norm, x, lp["ln1"])
        a, k, v = attn.attention_prefill(h, lp["attn"], cfg, positions, rope=False)
        x = x + a
        h = norm_apply(cfg.norm, x, lp["lnx"])
        ck, cv = attn.cross_kv(enc_out, lp["cross"], cfg)
        x = x + attn.cross_attention(h, lp["cross"], cfg, ck, cv)
        x = x + mlp_apply(norm_apply(cfg.norm, x, lp["ln2"]), lp["mlp"], cfg)
        return x, k, v, ck, cv

    def _train_layer(self, x, lp, enc_out, positions):
        return self._dec_layer(x, lp, enc_out, positions)[0]

    # ------------------------------------------------------------------
    def loss(self, params, batch):
        """batch {"src_embeds": [B,Ssrc,d], "tokens", "targets": [B,S] int,
        "loss_mask": [B,S]} -> the causal-LM loss, f32 scalar."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["src_embeds"])
        x = self._embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        for lp in unstack_layers(params["dec_layers"], cfg.num_layers):
            x = run_layer(self._train_layer, self.remat, x, lp, enc_out, positions)
        return causal_lm_loss(self._head(params, x), batch["targets"], batch["loss_mask"])

    def prefill(self, params, batch, max_len=None):
        """batch {"tokens": [B,S], "src_embeds": [B,Ssrc,d]} -> (last-token
        logits [B,V], decode state {"kv": {"k", "v": [L,B,max_len,Hkv,Dh]}
        holding the prompt's K/V, "cross": {"k", "v": [L,B,Ssrc,Hkv,Dh]}},
        the next position S)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        enc_out = self.encode(params, batch["src_embeds"])
        x = self._embed(params, tokens)
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        shape = (cfg.num_layers, b, max(max_len or s, s), cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        kc = torch.zeros(shape, dtype=x.dtype, device=x.device)
        vc = torch.zeros_like(kc)
        cks, cvs = [], []
        for i, lp in enumerate(unstack_layers(params["dec_layers"], cfg.num_layers)):
            x, k, v, ck, cv = self._dec_layer(x, lp, enc_out, positions)
            kc[i, :, :s] = k
            vc[i, :, :s] = v
            cks.append(ck)
            cvs.append(cv)
        logits = self._head(params, x[:, -1:])[:, 0]
        state = {"kv": {"k": kc, "v": vc},
                 "cross": {"k": torch.stack(cks), "v": torch.stack(cvs)}}
        return logits, state, s

    def decode_step(self, params, state, token, pos: int):
        """token [B] at position `pos` -> (logits [B,V], the state, its
        self-attention cache updated in place; the cross K/V as they were)."""
        cfg = self.cfg
        pos = int(pos)
        x = F.embedding(token[:, None], params["embed"]) + params["pos_table"][pos:pos + 1][None]
        kc, vc = state["kv"]["k"], state["kv"]["v"]
        slots = torch.arange(kc.shape[2], dtype=torch.int32, device=x.device)
        kv_positions = torch.where(slots <= pos, slots, -1)
        for i, lp in enumerate(unstack_layers(params["dec_layers"], cfg.num_layers)):
            h = norm_apply(cfg.norm, x, lp["ln1"])
            a, _, _ = attn.attention_decode(h, lp["attn"], cfg, kc[i], vc[i], kv_positions,
                                            pos, rope=False)
            x = x + a
            h = norm_apply(cfg.norm, x, lp["lnx"])
            x = x + attn.cross_attention(h, lp["cross"], cfg, state["cross"]["k"][i],
                                         state["cross"]["v"][i])
            x = x + mlp_apply(norm_apply(cfg.norm, x, lp["ln2"]), lp["mlp"], cfg)
        return self._head(params, x)[:, 0], state
