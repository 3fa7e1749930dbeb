"""Decoder-only transformer LM, dense family (counterpart of
`repro.models.transformer.DecoderLM`).

Parameters are a nested dict of tensors with the layers stacked ``[L, ...]``,
the layout of the reference's params pytree, so `repro_torch.bridge` can hand
the reference's weights over unchanged.  The stage functions run one
pipeline stage's layer slice; their caches ``[Lstage,B,S,H,D]`` are updated
in place and also returned, mirroring the reference's signatures.  The
whole-model `prefill` and `decode_step` are the one-stage case, the oracle
the serving tests hold the pipeline against.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from repro_torch import not_ported, resolve_device, torch_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.kvcache.cache import init_decode_state
from repro_torch.models import attention as attn
from repro_torch.models.common import (alibi_slopes, embed_init, head_init, layer_params,
                                       norm_apply, norm_init, stack_layers, unembed)
from repro_torch.models.mlp import mlp_apply, mlp_init


class DecoderLM:
    """Dense decoder (the families moe / vlm are later slices)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        not_ported(**{f"family={cfg.family}": cfg.family != "dense",
                      "num_patches": cfg.num_patches})
        self.cfg = cfg
        self.device = resolve_device(device)
        self._alibi = (torch.as_tensor(alibi_slopes(cfg.num_heads), device=self.device)
                       if cfg.pos_emb == "alibi" else None)
        # per-layer sliding window (0 = full attention)
        self._layer_window: List[int] = [
            0 if i in cfg.full_attn_layers else cfg.sliding_window
            for i in range(cfg.num_layers)]

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Dict:
        """Random weights drawn from `generator` (on its own device), in the
        reference's layout, placed on this model's device."""
        cfg, dev = self.cfg, self.device
        dtype = torch_dtype(cfg.dtype)
        g = generator
        p: Dict = {"embed": embed_init(g, (cfg.vocab_size, cfg.d_model), dtype, dev)}
        if cfg.pos_emb == "learned":
            p["pos_table"] = embed_init(g, (cfg.max_seq_len, cfg.d_model), dtype, dev)

        def one_layer():
            return {"ln1": norm_init(cfg.norm, cfg.d_model, dtype, dev),
                    "attn": attn.attn_init(g, cfg, dtype, dev),
                    "ln2": norm_init(cfg.norm, cfg.d_model, dtype, dev),
                    "mlp": mlp_init(g, cfg, dtype, dev)}

        p["layers"] = stack_layers([one_layer() for _ in range(cfg.num_layers)])
        p.update(head_init(g, cfg, dtype, dev))
        return p

    # ------------------------------------------------------------------
    def _final(self, sp, x):
        return unembed(self.cfg, sp, x)

    def _layer(self, x, lp, *, mode, kc=None, vc=None, kv_positions=None, pos=None,
               q_lens=None, positions=None, window=0):
        """One layer.  Returns (x, kc, vc): the caches updated in place, or
        in "prefill" mode the prompt's own K/V [B,S,H,D]."""
        cfg = self.cfg
        h = norm_apply(cfg.norm, x, lp["ln1"])
        kw = dict(window=window, num_meta=cfg.num_meta_tokens,
                  rope=cfg.pos_emb == "rope", alibi=self._alibi)
        if mode == "prefill":
            a, kc, vc = attn.attention_prefill(h, lp["attn"], cfg, positions, **kw)
        elif mode == "decode_batch":
            a, kc, vc = attn.attention_decode_batch(h, lp["attn"], cfg, kc, vc,
                                                    kv_positions, pos,
                                                    q_lens=q_lens, **kw)
        else:
            a, kc, vc = attn.attention_decode(h, lp["attn"], cfg, kc, vc,
                                              kv_positions, pos, **kw)
        x = x + a
        h = norm_apply(cfg.norm, x, lp["ln2"])
        return x + mlp_apply(h, lp["mlp"], cfg), kc, vc

    def _layers(self, sp, x, kc, vc, **kw):
        for i, w in enumerate(sp["layer_window"]):
            x, _, _ = self._layer(x, layer_params(sp["layers"], i), kc=kc[i], vc=vc[i],
                                  window=w, **kw)
        return x

    def _embed(self, sp, tokens):
        x = F.embedding(tokens, sp["embed"])
        if self.cfg.pos_emb == "learned":
            x = x + sp["pos_table"][:tokens.shape[1]][None]
        return x

    # ------------------------------------------------------------------
    # Stage-wise API for the pipeline workers: a stage owns a contiguous
    # layer slice; stage 0 also embeds, the last stage also applies the final
    # norm and the LM head.
    # ------------------------------------------------------------------
    def slice_params(self, params, lo: int, hi: int, *, first: bool, last: bool):
        def cut(t):
            return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) else t[lo:hi]
        sp = {"layers": cut(params["layers"]),
              "layer_window": self._layer_window[lo:hi]}
        if first:
            for k in ("embed", "pos_table"):
                if k in params:
                    sp[k] = params[k]
        if last:
            sp["final_norm"] = params["final_norm"]
            if self.cfg.tie_embeddings:
                sp["embed"] = params["embed"]
            elif "lm_head" in params:
                sp["lm_head"] = params["lm_head"]
        return sp

    def stage_prefill(self, sp, x, *, first: bool, last: bool, tokens=None):
        """Run one stage over whole prompts at positions 0..S-1 (stage 0
        takes `tokens` [B,S]).  Returns (x or, on the last stage, the final
        token's logits [B,V], ks, vs) with ks/vs [Lstage,B,S,H,D]."""
        if first:
            x = self._embed(sp, tokens)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        ks, vs = [], []
        for i, w in enumerate(sp["layer_window"]):
            x, k, v = self._layer(x, layer_params(sp["layers"], i), mode="prefill",
                                  positions=positions, window=w)
            ks.append(k)
            vs.append(v)
        if last:
            x = self._final(sp, x[:, -1:, :])[:, 0]
        return x, torch.stack(ks), torch.stack(vs)

    def stage_prefill_chunk(self, sp, x, kc, vc, pos: int, *, first: bool,
                            last: bool, tokens=None):
        """A chunk of C prompt tokens at positions pos..pos+C-1 attends
        causally over the cache prefix [0, pos) plus itself, writing its K/V
        into the cache at `pos`.  Stage 0 takes `tokens` [B,C]; the last
        stage returns the chunk's final-token logits.  kc/vc [Lstage,B,S,H,D]."""
        if first:
            x = F.embedding(tokens, sp["embed"])
            if self.cfg.pos_emb == "learned":
                c, table = tokens.shape[1], sp["pos_table"]
                p0 = min(max(pos, 0), table.shape[0] - c)
                x = x + table[p0:p0 + c][None]
        c = x.shape[1]
        slots = torch.arange(kc.shape[2], dtype=torch.int32, device=x.device)
        kv_positions = torch.where(slots < pos + c, slots, -1)
        x = self._layers(sp, x, kc, vc, mode="decode", kv_positions=kv_positions,
                         pos=pos)
        if last:
            x = self._final(sp, x[:, -1:, :])[:, 0]
        return x, kc, vc

    def stage_decode(self, sp, x, kc, vc, pos: int, *, first: bool, last: bool,
                     token=None):
        """One decode step of one sequence at position `pos` (the
        per-sequence path).  kc/vc [Lstage,B,S,H,D]."""
        if first:
            x = F.embedding(token[:, None], sp["embed"])
            if self.cfg.pos_emb == "learned":
                x = x + sp["pos_table"][pos:pos + 1][None]
        slots = torch.arange(kc.shape[2], dtype=torch.int32, device=x.device)
        kv_positions = torch.where(slots <= pos, slots, -1)
        x = self._layers(sp, x, kc, vc, mode="decode", kv_positions=kv_positions,
                         pos=pos)
        if last:
            x = self._final(sp, x)[:, 0]
        return x, kc, vc

    def _embed_batch(self, sp, tokens, pos):
        """Embed a fused pass's tokens [B,C], sequence b's at positions
        pos[b].. (int32 [B])."""
        x = F.embedding(tokens, sp["embed"])
        if self.cfg.pos_emb == "learned":
            c, table = tokens.shape[1], sp["pos_table"]
            posm = pos[:, None].long() + torch.arange(c, device=x.device)[None, :]
            x = x + table[posm.clamp(0, table.shape[0] - 1)]
        return x

    def _final_rows(self, sp, x, q_lens):
        """Logits [B,V] of each sequence's final valid row, q_lens[b] - 1."""
        rows = (q_lens.long() - 1).clamp(0, x.shape[1] - 1)
        x = x[torch.arange(x.shape[0], device=x.device), rows]
        return self._final(sp, x[:, None])[:, 0]

    def stage_decode_batch(self, sp, x, kc, vc, pos, *, first: bool, last: bool,
                           token=None):
        """Fused-round decode: B sequences each advance one step, sequence
        b's new token at its own position pos[b] (int32 [B])."""
        if first:
            x = self._embed_batch(sp, token[:, None], pos)
        slots = torch.arange(kc.shape[2], dtype=torch.int32, device=x.device)[None, :]
        kv_positions = torch.where(slots <= pos[:, None], slots, -1)
        x = self._layers(sp, x, kc, vc, mode="decode_batch",
                         kv_positions=kv_positions, pos=pos)
        if last:
            x = self._final(sp, x)[:, 0]
        return x, kc, vc

    def stage_prefill_chunk_batch(self, sp, x, kc, vc, pos, q_lens, *,
                                  first: bool, last: bool, tokens=None):
        """Fused chunk-set pass: one prefill chunk of each of B sequences.
        Sequence b's chunk holds q_lens[b] valid tokens at positions
        pos[b].. (rows past q_lens[b] are padding) and attends causally over
        its own cache prefix plus itself.  The last stage returns each
        chunk's final-valid-token logits [B,V]."""
        if first:
            x = self._embed_batch(sp, tokens, pos)
        slots = torch.arange(kc.shape[2], dtype=torch.int32, device=x.device)[None, :]
        kv_positions = torch.where(slots < (pos + q_lens)[:, None], slots, -1)
        x = self._layers(sp, x, kc, vc, mode="decode_batch",
                         kv_positions=kv_positions, pos=pos, q_lens=q_lens)
        if last:
            x = self._final_rows(sp, x, q_lens)
        return x, kc, vc

    # ------------------------------------------------------------------
    # fused passes over the pool's pages, read in place (plain causal stages)
    # ------------------------------------------------------------------
    def reads_pages(self, sp) -> bool:
        """Whether the fused passes of this stage read the pool's pages in
        place: every layer is plain causal (window 0, no ALiBi; meta tokens
        matter only beside a window), which is all the paged kernels
        compute.  Decided by configuration, never by a tensor's shape."""
        return self.cfg.pos_emb != "alibi" and not any(sp["layer_window"])

    def _paged_layers(self, sp, x, k_pages, v_pages, tables, write_idx, pos, *,
                      lengths=None, q_lens=None):
        cfg = self.cfg
        for i in range(len(sp["layer_window"])):
            lp = layer_params(sp["layers"], i)
            h = norm_apply(cfg.norm, x, lp["ln1"])
            x = x + attn.attention_paged_batch(
                h, lp["attn"], cfg, k_pages[:, i], v_pages[:, i], tables, write_idx, pos,
                lengths=lengths, q_lens=q_lens, rope=cfg.pos_emb == "rope")
            h = norm_apply(cfg.norm, x, lp["ln2"])
            x = x + mlp_apply(h, lp["mlp"], cfg)
        return x

    def stage_decode_paged(self, sp, x, k_pages, v_pages, tables, write_idx, pos, *,
                           first: bool, last: bool, token=None):
        """`stage_decode_batch` over the stage's pages [N,Lstage,bs,H,D], read
        and written in place through `tables` [B,nb] and `write_idx` (see
        `attention_paged_batch`).  Only where `reads_pages(sp)`."""
        if first:
            x = self._embed_batch(sp, token[:, None], pos)
        x = self._paged_layers(sp, x, k_pages, v_pages, tables, write_idx, pos,
                               lengths=pos + 1)
        if last:
            x = self._final(sp, x)[:, 0]
        return x

    def stage_prefill_chunk_paged(self, sp, x, k_pages, v_pages, tables, write_idx, pos,
                                  q_lens, *, first: bool, last: bool, tokens=None):
        """`stage_prefill_chunk_batch` over the stage's pages, read and
        written in place: sequence b's chunk of q_lens[b] valid rows at
        positions pos[b].. attends over its prefix plus itself.  Only where
        `reads_pages(sp)`."""
        if first:
            x = self._embed_batch(sp, tokens, pos)
        x = self._paged_layers(sp, x, k_pages, v_pages, tables, write_idx, pos,
                               q_lens=q_lens)
        if last:
            x = self._final_rows(sp, x, q_lens)
        return x

    # ------------------------------------------------------------------
    # whole-model generation: the one-stage case of the stage API
    # ------------------------------------------------------------------
    def prefill(self, params, batch, max_len=None):
        """batch {"tokens": [B,S]} -> (last-token logits [B,V], decode state
        {"kv": {"k", "v": [L,B,max_len,H,D]}} holding the prompt's K/V, the
        next position S)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        sp = self.slice_params(params, 0, self.cfg.num_layers, first=True, last=True)
        logits, ks, vs = self.stage_prefill(sp, None, first=True, last=True, tokens=tokens)
        state = init_decode_state(self.cfg, b, max(max_len or s, s), device=ks.device)
        state["kv"]["k"][:, :, :s] = ks
        state["kv"]["v"][:, :, :s] = vs
        return logits, state, s

    def decode_step(self, params, state, token, pos: int):
        """token [B] at position `pos` -> (logits [B,V], the state, its cache
        updated in place)."""
        sp = self.slice_params(params, 0, self.cfg.num_layers, first=True, last=True)
        logits, _, _ = self.stage_decode(sp, None, state["kv"]["k"], state["kv"]["v"],
                                         int(pos), first=True, last=True, token=token)
        return logits, state
