"""Decoder-only transformer LM, dense, moe and vlm families (counterpart of
`repro.models.transformer.DecoderLM`).

Parameters are a nested dict of tensors with the layers stacked ``[L, ...]``,
the layout of the reference's params pytree, so `repro_torch.bridge` can hand
the reference's weights over unchanged.  `loss` is the training forward
(capacity-dropping experts with their load-balancing loss, each layer under
activation checkpointing with ``remat``).  The stage functions run one
pipeline stage's layer slice; their caches ``[Lstage,B,S,H,D]`` are updated
in place and also returned, mirroring the reference's signatures.  The
whole-model `prefill` and `decode_step` are the one-stage case, the oracle
the serving tests hold the pipeline against.

The vlm family (phi-3-vision) is the backbone behind a stub vision tower:
callers pass ``patch_embeds [B, num_patches, d]``, which stage 0 casts to
the model's dtype, projects by ``patch_proj`` and prepends to the token
embeddings.  Positions run over the patch slots, so a prompt of S tokens
fills num_patches + S cache slots and decoding starts there; the loss drops
the patch positions before the head.

Split compute on a mesh: `loss`, `prefill` and `decode_step` (and the
stage functions they run) take ``tp``, a `distributed.tensor_parallel.Split`
built from the mesh.  A per-layer hook hands each layer the weights its
rank computes with (FSDP rows gathered, the rank's heads, ff columns or
experts); the embedding, the head and the loss take their vocabulary-
parallel forms; the decode state is the rank's sequence slice.  Under the
opt rules `loss` runs the residual stream cut over `model`
(`Split.on_seq`).  With ``tp=None`` (the default) nothing of this runs.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from repro_torch import resolve_device, torch_dtype
from repro_torch.configs.base import ArchConfig
from repro_torch.kvcache.cache import init_decode_state
from repro_torch.models import attention as attn
from repro_torch.models.common import (alibi_slopes, embed_init, head, head_init, hooked,
                                       layer_params, lm_loss, lookup, norm_apply, norm_init,
                                       on_seq, run_layer, stack_layers, unstack_layers)
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.models.moe import moe_apply, moe_init


class DecoderLM:
    """Dense, moe and vlm decoder."""

    def __init__(self, cfg: ArchConfig, device="cuda", remat: bool = False):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"DecoderLM serves the dense, moe and vlm families, "
                             f"not family={cfg.family}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.remat = remat
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
        if cfg.family == "vlm":
            p["patch_proj"] = embed_init(g, (cfg.d_model, cfg.d_model), dtype, dev)

        def one_layer():
            lp = {"ln1": norm_init(cfg.norm, cfg.d_model, dtype, dev),
                  "attn": attn.attn_init(g, cfg, dtype, dev),
                  "ln2": norm_init(cfg.norm, cfg.d_model, dtype, dev)}
            if cfg.is_moe:
                lp["moe"] = moe_init(g, cfg, dtype, dev)
            else:
                lp["mlp"] = mlp_init(g, cfg, dtype, dev)
            return lp

        p["layers"] = stack_layers([one_layer() for _ in range(cfg.num_layers)])
        p.update(head_init(g, cfg, dtype, dev))
        return p

    # ------------------------------------------------------------------
    def _final(self, sp, x, tp=None):
        """Logits [.., V] (under `tp`, this rank's vocabulary columns)."""
        return head(self.cfg, sp, x, tp)

    def _ffn(self, h, lp, aux=None, tp=None):
        """The MLP, or the experts over the flattened tokens.  Inference
        takes the lossless dispatch: a token's output must not depend on how
        the scheduler packed its pass.  Training (`aux`, a list) takes the
        capacity-bounded one and appends its load-balancing loss."""
        if not self.cfg.is_moe:
            return mlp_apply(h, lp["mlp"], self.cfg, tp)
        b, s, d = h.shape
        if aux is None:
            return moe_apply(h.reshape(b * s, d), lp["moe"], self.cfg,
                             drop=False, tp=tp).view(b, s, d)
        out, a = moe_apply(h.reshape(b * s, d), lp["moe"], self.cfg, return_aux=True, tp=tp)
        aux.append(a)
        return out.view(b, s, d)

    def _layer(self, x, lp, *, mode, kc=None, vc=None, kv_positions=None, pos=None,
               q_lens=None, positions=None, window=0, aux=None, tp=None):
        """One layer.  Returns (x, kc, vc): the caches updated in place, or
        in "prefill" mode the prompt's own K/V [B,S,H,D].  `aux` as `_ffn`."""
        cfg = self.cfg
        h = norm_apply(cfg.norm, x, lp["ln1"])
        kw = dict(window=window, num_meta=cfg.num_meta_tokens,
                  rope=cfg.pos_emb == "rope", alibi=self._alibi)
        if tp is not None:
            a, kc, vc = tp.attention(mode, tp.enter(h), lp["attn"], positions=positions,
                                     kc=kc, vc=vc, pos=pos, **kw)
        elif mode == "prefill":
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
        return x + self._ffn(h, lp, aux, tp), kc, vc

    def _train_layer(self, x, lp, positions, window: int, tp=None):
        """One layer of the training forward -> (x, the moe aux loss or None).
        The hook runs here, inside the layer's activation checkpoint."""
        aux = []
        x, _, _ = self._layer(x, hooked(lp, tp), mode="prefill", positions=positions,
                              window=window, aux=aux, tp=tp)
        return x, aux[0] if aux else None

    def loss(self, params, batch, tp=None):
        """batch {"tokens", "targets": [B,S] int, "loss_mask": [B,S]} (vlm:
        and "patch_embeds") -> the causal-LM loss, f32 scalar, plus 0.01 times
        the mean moe aux loss.  Under `tp`, `params` are this rank's shards."""
        cfg = self.cfg
        prefix = cfg.num_patches if cfg.family == "vlm" else 0
        s = prefix + batch["tokens"].shape[1]
        tp = on_seq(tp, s)
        x = self._embed(params, batch["tokens"], batch.get("patch_embeds"), tp)
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        auxs = []
        for lp, w in zip(unstack_layers(params["layers"], cfg.num_layers),
                         self._layer_window):
            x, aux = run_layer(self._train_layer, self.remat, x, lp, positions, w, tp)
            auxs.append(aux)
        # the head reads a vlm's text positions only
        loss = lm_loss(cfg, params, x, batch, tp, skip=prefix)
        if cfg.is_moe:
            loss = loss + 0.01 * torch.stack(auxs).mean()
        return loss

    def _layers(self, sp, x, kc, vc, tp=None, **kw):
        for i, w in enumerate(sp["layer_window"]):
            x, _, _ = self._layer(x, hooked(layer_params(sp["layers"], i), tp), kc=kc[i],
                                  vc=vc[i], window=w, tp=tp, **kw)
        return x

    def _embed(self, sp, tokens, patch_embeds=None, tp=None):
        """Token embeddings [B,S,d]; vlm: the projected patches prepended,
        [B,num_patches+S,d].  On a stream cut over `model` the rank's
        slice: the embedding's sum reduce-scattered, or behind a vlm's
        patches summed whole and then cut."""
        cfg = self.cfg
        if tp is not None and tp.seq and cfg.family != "vlm":
            x = lookup(sp["embed"], tokens, tp)
            if cfg.pos_emb == "learned":
                x = x + tp.scatter(sp["pos_table"][:tokens.shape[1]], 0)[None]
            return x
        x = lookup(sp["embed"], tokens, tp and tp.unsplit)
        if cfg.family == "vlm":
            if patch_embeds is None:
                raise ValueError(f"family=vlm ({cfg.name}) needs patch_embeds "
                                 f"[B,{cfg.num_patches},{cfg.d_model}] with the tokens")
            patches = patch_embeds.to(x.dtype) @ sp["patch_proj"]
            x = torch.cat([patches, x], dim=1)
        if cfg.pos_emb == "learned":
            x = x + sp["pos_table"][:x.shape[1]][None]
        return x if tp is None else tp.scatter(x)

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
            for k in ("embed", "pos_table", "patch_proj"):
                if k in params:
                    sp[k] = params[k]
        if last:
            sp["final_norm"] = params["final_norm"]
            if self.cfg.tie_embeddings:
                sp["embed"] = params["embed"]
            elif "lm_head" in params:
                sp["lm_head"] = params["lm_head"]
        return sp

    def stage_prefill(self, sp, x, *, first: bool, last: bool, tokens=None,
                      patch_embeds=None, tp=None):
        """Run one stage over whole prompts at positions 0..S-1 (stage 0
        takes `tokens` [B,S], and a vlm's `patch_embeds`, which it
        prepends: S counts them).  Returns (x or, on the last stage, the
        final token's logits [B,V], ks, vs) with ks/vs [Lstage,B,S,H,D]."""
        if first:
            x = self._embed(sp, tokens, patch_embeds, tp)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        ks, vs = [], []
        for i, w in enumerate(sp["layer_window"]):
            x, k, v = self._layer(x, hooked(layer_params(sp["layers"], i), tp),
                                  mode="prefill", positions=positions, window=w, tp=tp)
            ks.append(k)
            vs.append(v)
        if last:
            x = self._final(sp, x[:, -1:, :], tp)[:, 0]
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
                     token=None, tp=None):
        """One decode step of one sequence at position `pos` (the
        per-sequence path).  kc/vc [Lstage,B,S,H,D] (under `tp`, the rank's
        sequence slice)."""
        if first:
            x = lookup(sp["embed"], token[:, None], tp)
            if self.cfg.pos_emb == "learned":
                x = x + sp["pos_table"][pos:pos + 1][None]
        slots = torch.arange(kc.shape[2], dtype=torch.int32, device=x.device)
        kv_positions = torch.where(slots <= pos, slots, -1)
        x = self._layers(sp, x, kc, vc, mode="decode", kv_positions=kv_positions,
                         pos=pos, tp=tp)
        if last:
            x = self._final(sp, x, tp)[:, 0]
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
            x = x + self._ffn(h, lp)
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
    def prefill(self, params, batch, max_len=None, tp=None):
        """batch {"tokens": [B,S]} (vlm: and "patch_embeds") -> (last-token
        logits [B,V], decode state {"kv": {"k", "v": [L,B,max_len,H,D]}}
        holding the prompt's K/V, the next position S).  A vlm's S and
        max_len count its num_patches slots.  Under `tp` the state is the
        rank's sequence slice [L,B,max_len/n,H,D]."""
        tokens = batch["tokens"]
        sp = self.slice_params(params, 0, self.cfg.num_layers, first=True, last=True)
        logits, ks, vs = self.stage_prefill(sp, None, first=True, last=True, tokens=tokens,
                                            patch_embeds=batch.get("patch_embeds"), tp=tp)
        b, s = ks.shape[1], ks.shape[2]
        if tp is not None:
            k, v = tp.place_kv("kv", ks, vs, max(max_len or s, s))
            return tp.gather_vocab(logits), {"kv": {"k": k, "v": v}}, s
        state = init_decode_state(self.cfg, b, max(max_len or s, s), device=ks.device)
        state["kv"]["k"][:, :, :s] = ks
        state["kv"]["v"][:, :, :s] = vs
        return logits, state, s

    def decode_step(self, params, state, token, pos: int, tp=None):
        """token [B] at position `pos` -> (logits [B,V], the state, its cache
        updated in place)."""
        sp = self.slice_params(params, 0, self.cfg.num_layers, first=True, last=True)
        logits, _, _ = self.stage_decode(sp, None, state["kv"]["k"], state["kv"]["v"],
                                         int(pos), first=True, last=True, token=token, tp=tp)
        return (logits if tp is None else tp.gather_vocab(logits)), state

