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
`loss`, `encode`, `prefill` and `decode_step` take ``tp`` for split compute
on a mesh (`distributed.tensor_parallel.Split`); with ``tp=None`` nothing
of it runs.  Under the opt rules `loss` cuts both residual streams, the
encoder's and the decoder's, over `model` (`Split.on_seq`), and the
encoder's output is gathered once for cross-attention.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models.common import (embed_init, head, hooked, lm_loss, lookup, norm_apply,
                                       norm_init, on_seq, run_layer, scatter, shared,
                                       stack_layers, unstack_layers)
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
    def _enc_layer(self, x, lp, tp=None):
        """One bidirectional encoder layer (the hook gathers its weights)."""
        cfg = self.cfg
        lp = hooked(lp, tp, "enc_layers")
        h = norm_apply(cfg.norm, x, lp["ln1"])
        if tp is None:
            q, k, v = attn.qkv_proj(h, lp["attn"], cfg)
            a = attn.out_proj(kops.attention_auto(q, k, v), lp["attn"])
        else:
            a = tp.attention("full", tp.enter(h), lp["attn"])[0]
        x = x + a
        return x + mlp_apply(norm_apply(cfg.norm, x, lp["ln2"]), lp["mlp"], cfg, tp)

    def encode(self, params, src_embeds, tp=None):
        """src_embeds [B,Ssrc,d] -> the encoder's output [B,Ssrc,d] (under a
        `tp` whose stream is cut over `model`, the rank's slice)."""
        cfg = self.cfg
        s = src_embeds.shape[1]
        x = scatter(src_embeds.to(torch_dtype(cfg.dtype)) + params["src_pos"][:s][None], tp)
        for lp in unstack_layers(params["enc_layers"], cfg.num_encoder_layers):
            x = self._enc_layer(x, lp, tp)
        return norm_apply(cfg.norm, x, shared(params["enc_final"], tp))

    def _embed(self, params, tokens, tp=None):
        pos = params["pos_table"][:tokens.shape[1]]
        return lookup(params["embed"], tokens, tp) + scatter(pos, tp, 0)[None]

    def _dec_layer(self, x, lp, enc_out, positions, tp=None):
        """One decoder layer over whole prompts (the hook gathers its
        weights) -> (x, its self-attention K/V [B,S,Hkv,Dh], its
        cross-attention K/V [B,Ssrc,Hkv,Dh]; under `tp` the rank's KV
        heads)."""
        cfg = self.cfg
        lp = hooked(lp, tp, "dec_layers")
        h = norm_apply(cfg.norm, x, lp["ln1"])
        if tp is None:
            a, k, v = attn.attention_prefill(h, lp["attn"], cfg, positions, rope=False)
        else:
            a, k, v = tp.attention("prefill", tp.enter(h), lp["attn"], positions=positions,
                                   rope=False)
        x = x + a
        h = norm_apply(cfg.norm, x, lp["lnx"])
        if tp is None:
            ck, cv = attn.cross_kv(enc_out, lp["cross"], cfg)
            c = attn.cross_attention(h, lp["cross"], cfg, ck, cv)
        else:
            c, ck, cv = tp.cross("prefill", tp.enter(h), lp["cross"], enc_out=enc_out)
        x = x + c
        x = x + mlp_apply(norm_apply(cfg.norm, x, lp["ln2"]), lp["mlp"], cfg, tp)
        return x, k, v, ck, cv

    def _train_layer(self, x, lp, enc_out, positions, tp=None):
        return self._dec_layer(x, lp, enc_out, positions, tp)[0]

    def _encoded(self, params, src_embeds, tp=None):
        """The encoder's output as the decoder layers read it: under `tp`
        through `enter` once (its gradient then sums as the unsharded one
        does; a stream cut over `model` is gathered)."""
        tp = on_seq(tp, src_embeds.shape[1])
        enc_out = self.encode(params, src_embeds, tp)
        return enc_out if tp is None else tp.enter(enc_out)

    # ------------------------------------------------------------------
    def loss(self, params, batch, tp=None):
        """batch {"src_embeds": [B,Ssrc,d], "tokens", "targets": [B,S] int,
        "loss_mask": [B,S]} -> the causal-LM loss, f32 scalar.  Under `tp`
        (split compute, `distributed.tensor_parallel.Split`) `params` are
        this rank's shards."""
        cfg = self.cfg
        enc_out = self._encoded(params, batch["src_embeds"], tp)
        tp = on_seq(tp, batch["tokens"].shape[1])
        x = self._embed(params, batch["tokens"], tp)
        positions = torch.arange(batch["tokens"].shape[1], dtype=torch.int32, device=x.device)
        for lp in unstack_layers(params["dec_layers"], cfg.num_layers):
            x = run_layer(self._train_layer, self.remat, x, lp, enc_out, positions, tp)
        return lm_loss(cfg, params, x, batch, tp)

    def prefill(self, params, batch, max_len=None, tp=None):
        """batch {"tokens": [B,S], "src_embeds": [B,Ssrc,d]} -> (last-token
        logits [B,V], decode state {"kv": {"k", "v": [L,B,max_len,Hkv,Dh]}
        holding the prompt's K/V, "cross": {"k", "v": [L,B,Ssrc,Hkv,Dh]}},
        the next position S).  Under `tp` each cache is placed as the rules
        place it (`Split.place_kv`)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        enc_out = self._encoded(params, batch["src_embeds"], tp)
        x = self._embed(params, tokens, tp)
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        total = max(max_len or s, s)
        kvs, crosses = ([], []), ([], [])
        for lp in unstack_layers(params["dec_layers"], cfg.num_layers):
            x, k, v, ck, cv = self._dec_layer(x, lp, enc_out, positions, tp)
            for out, t in zip(kvs + crosses, (k, v, ck, cv)):
                out.append(t)
        logits = head(cfg, params, x[:, -1:], tp)[:, 0]
        (ks, vs), (cks, cvs) = ([torch.stack(t) for t in pair] for pair in (kvs, crosses))
        if tp is not None:
            k, v = tp.place_kv("kv", ks, vs, total)
            ck, cv = tp.place_kv("cross", cks, cvs, cks.shape[2])
            return tp.gather_vocab(logits), {"kv": {"k": k, "v": v},
                                             "cross": {"k": ck, "v": cv}}, s
        kc = ks.new_zeros(ks.shape[:2] + (total,) + ks.shape[3:])
        vc = torch.zeros_like(kc)
        kc[:, :, :s] = ks
        vc[:, :, :s] = vs
        return logits, {"kv": {"k": kc, "v": vc}, "cross": {"k": cks, "v": cvs}}, s

    def decode_step(self, params, state, token, pos: int, tp=None):
        """token [B] at position `pos` -> (logits [B,V], the state, its
        self-attention cache updated in place; the cross K/V as they were).
        Under `tp` both attentions run over the rank's slices of their
        caches."""
        cfg = self.cfg
        pos = int(pos)
        x = lookup(params["embed"], token[:, None], tp) + params["pos_table"][pos:pos + 1][None]
        kc, vc = state["kv"]["k"], state["kv"]["v"]
        ck, cv = state["cross"]["k"], state["cross"]["v"]
        slots = torch.arange(kc.shape[2], dtype=torch.int32, device=x.device)
        kv_positions = torch.where(slots <= pos, slots, -1)
        for i, lp in enumerate(unstack_layers(params["dec_layers"], cfg.num_layers)):
            lp = hooked(lp, tp, "dec_layers")
            h = norm_apply(cfg.norm, x, lp["ln1"])
            if tp is None:
                a, _, _ = attn.attention_decode(h, lp["attn"], cfg, kc[i], vc[i], kv_positions,
                                                pos, rope=False)
            else:
                a, _, _ = tp.attention("decode", tp.copy(h), lp["attn"], kc=kc[i], vc=vc[i],
                                       pos=pos, rope=False)
            x = x + a
            h = norm_apply(cfg.norm, x, lp["lnx"])
            if tp is None:
                x = x + attn.cross_attention(h, lp["cross"], cfg, ck[i], cv[i])
            else:
                x = x + tp.cross("decode", tp.copy(h), lp["cross"], kc=ck[i], vc=cv[i])
            x = x + mlp_apply(norm_apply(cfg.norm, x, lp["ln2"]), lp["mlp"], cfg, tp)
        logits = head(cfg, params, x, tp)[:, 0]
        return (logits if tp is None else tp.gather_vocab(logits)), state
