"""Split compute for the dense, moe and vlm families on a DeviceMesh (the
port's counterpart of what GSPMD does with the reference's cells once
`sharding.param_spec` has placed their weights).

One rank's share, given the rules' placements and nothing else:

- heads: rank r of the `model` axis (size n) computes the whole query heads
  floor(rH/n) to floor((r+1)H/n), and the KV heads they read (h // G); a
  rank may have none.  Where those columns are not the rank's stored shard
  (56 heads on 16 ranks; 8 KV heads on 16) it all-gathers its shard of
  the leaf over `model`, before the FSDP row gather, and keeps them; the
  gather's backward reduce-scatters.  Where the
  rules left a leaf replicated over `model`, the rank slices it locally,
  behind `copy` (its gradient is summed over `model`).  Query head h still
  reads KV head h // G in every rank's own numbering: a rank whose heads
  do not group evenly over its KV heads holds one KV slot a query head;
- the ff columns, the experts and the vocabulary likewise, in balanced
  contiguous ranges;
- FSDP: the d_model rows a leaf's spec splits over the data axes are
  all-gathered where a layer uses them (`gather_rows`, whose backward
  reduce-scatters, once per use), inside the layer's activation
  checkpoint, so remat's recompute gathers them again.

Activations cross between replicated and per-rank compute through two
functions: `copy` (identity forward, all-reduce over `model` backward) into
a rank's share, `reduce` (all-reduce forward, identity backward) out of it.
The embedding is a masked lookup of the rank's vocabulary rows then a
`reduce`; the causal-LM loss reduces each token's max, sum of exps and
target logit over `model` (the f32 function of `models.losses`).

Decode runs over a KV cache whose sequence is split over `model` (the
rules' state placement): each rank makes q and the new K/V for its heads,
all-gathers them over `model` (B x H x D), the rank holding slot `pos`
writes the new K/V, every rank runs `decode_attention` with its LSE over
its slice, and `combine` merges the partials: o = sum_r exp(lse_r - M) o_r
/ sum_r exp(lse_r - M), M = max_r lse_r.  A slice with no valid key has an
LSE of NEG_INF and weighs exactly 0.  Prefill runs flash over the rank's
heads for the whole prompt and hands each rank its slice of the K/V by
one all-to-all over `model` (`seq_state`).

On a world of one every collective is a copy and every selection is the
whole leaf, so the unsharded model's function comes out bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import _axes, _names, shard_index
from repro_torch.kernels import ops as kops
from repro_torch.kvcache.cache import init_decode_state
from repro_torch.models import attention as attn
from repro_torch.models.common import apply_rope, norm_apply

MODEL = "model"

# the tensor dim of each layer leaf that `model` splits, and what it counts
_LAYER_DIMS = {("attn", "wq"): (1, "q"), ("attn", "wk"): (1, "kv"), ("attn", "wv"): (1, "kv"),
               ("attn", "wo"): (0, "q"), ("mlp", "w_gate"): (1, "ff"),
               ("mlp", "w_up"): (1, "ff"), ("mlp", "w_down"): (0, "ff"),
               ("moe", "w_gate"): (0, "experts"), ("moe", "w_up"): (0, "experts"),
               ("moe", "w_down"): (0, "experts")}


def balanced(items: int, n: int, r: int) -> Tuple[int, int]:
    """Rank r's contiguous share [lo, hi) of `items` split n ways."""
    return items * r // n, items * (r + 1) // n


# ---------------------------------------------------------------------------
# collectives as autograd functions
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    """Into a rank's share: identity forward, gradient summed over `model`."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduced(g, MODEL), None


class _Reduce(torch.autograd.Function):
    """Out of a rank's share: summed over `model` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduced(x, MODEL)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _DataSum(torch.autograd.Function):
    """Summed over the data axes, forward and backward: a term every data
    rank's loss holds (the moe load-balancing loss of a microbatch)."""

    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return comm.all_reduced(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduced(g, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    """All-gather along `dim` over one mesh axis; the backward reduce-scatters."""

    @staticmethod
    def forward(ctx, t, comm, dim: int, axis: str):
        ctx.comm, ctx.dim, ctx.axis = comm, dim, axis
        return comm.all_gather(t, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g, ctx.dim, ctx.axis), None, None, None


def gather_rows(t: torch.Tensor, spec, comm, skip=()) -> torch.Tensor:
    """`t` gathered whole along every dim its spec splits over data axes
    (FSDP rows), minor axis first; dims in `skip` left as they are."""
    dp, _ = _axes(comm.mesh)
    for dim, entry in enumerate(spec):
        if entry is None or dim in skip:
            continue
        axes = _names(entry)
        if all(a in dp for a in axes):
            for a in reversed(axes):
                t = _Gather.apply(t, comm, dim, a)
    return t


def _segments(ids: Sequence[int], width: int) -> List[Tuple[int, int]]:
    """Column ranges [lo, hi) of the blocks `ids` (each `width` wide), the
    adjacent ones merged."""
    out: List[Tuple[int, int]] = []
    for i in ids:
        if out and out[-1][1] == i * width:
            out[-1] = (out[-1][0], (i + 1) * width)
        else:
            out.append((i * width, (i + 1) * width))
    return out


def combine(o, lse, reduce_max, reduce_sum):
    """Attention partials over slices of one cache, o [.., B,H,D] with their
    LSEs [.., B,H] f32, merged: sum_r exp(lse_r - M) o_r / sum_r exp(lse_r -
    M), M = max_r lse_r, the sums over slices taken by `reduce_max` and
    `reduce_sum` (over ranks, or over a leading dim of local partials).  A
    slice with no valid key (lse NEG_INF) weighs exactly 0 beside one with
    a key.  The reductions leave their operands as they are."""
    m = reduce_max(lse)
    w = torch.exp(lse - m)[..., None]
    acc = reduce_sum(torch.cat([w * o.float(), w], dim=-1))
    return (acc[..., :-1] / acc[..., -1:]).to(o.dtype)


class Split:
    """One rank's share of a `DecoderLM` on a mesh: built from the model's
    config, the step's `train_step.Collectives` (mesh, coordinates,
    transport), the spec tree of the stored parameters and whether the
    tokens are this rank's slice of training microbatches split over the
    data axes (`train_step.rank_batch`); the model's `loss`, `prefill` and
    `decode_step` take it as ``tp``."""

    def __init__(self, cfg, comm, p_specs: Dict, data_split: bool):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"split compute covers the dense, moe and vlm families, "
                             f"not {cfg.family}")
        self.cfg, self.comm, self.specs = cfg, comm, p_specs
        self.n, self.r = comm.mesh.shape[MODEL], comm.coords[MODEL]
        # a microbatch split over more than one data rank
        self.dp = _axes(comm.mesh)[0]
        self.data_split = data_split and comm.size(self.dp) > 1
        self.dh = cfg.resolved_head_dim
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        g = hq // hkv
        heads = [balanced(hq, self.n, r) for r in range(self.n)]
        # the KV head each local query head reads, per rank; one slot each
        # where a rank's heads do not group evenly over their KV heads
        kv_ids = []
        for lo, hi in heads:
            ids = sorted({h // g for h in range(lo, hi)})
            if ids and (hi - lo) % len(ids) == 0 and all(
                    ids.index(h // g) == (h - lo) // ((hi - lo) // len(ids))
                    for h in range(lo, hi)):
                kv_ids.append(ids)
            else:
                kv_ids.append([h // g for h in range(lo, hi)])
        self.heads, self.kv_ids = heads[self.r], kv_ids[self.r]
        self.q_sizes = [hi - lo for lo, hi in heads]
        # the rank that hands on each KV head in prefill: the first that has it
        owner = {}
        for r, ids in enumerate(kv_ids):
            for j in ids:
                owner.setdefault(j, r)
        self.own = [self.kv_ids.index(j) for j in sorted(owner) if owner[j] == self.r]
        self.own_sizes = [sum(1 for j in owner if owner[j] == r) for r in range(self.n)]
        nq, nkv = self.q_sizes[self.r], len(self.kv_ids)
        self.local_cfg = _replace(cfg, num_heads=nq, num_kv_heads=nkv, head_dim=self.dh)
        self.vocab = balanced(cfg.vocab_size, self.n, self.r)
        self.vocab_sizes = [b - a for a, b in (balanced(cfg.vocab_size, self.n, r)
                                               for r in range(self.n))]
        # each rank's columns of each split dim, as ranges [lo, hi)
        ranges = {"q": [_segments(range(*hs), self.dh) for hs in heads],
                  "kv": [_segments(ids, self.dh) for ids in kv_ids]}
        if cfg.is_moe:
            if cfg.num_experts < self.n:
                raise ValueError(f"{cfg.num_experts} experts on {self.n} ranks of `model`")
            self.experts = balanced(cfg.num_experts, self.n, self.r)
            ranges["experts"] = [[balanced(cfg.num_experts, self.n, r)] for r in range(self.n)]
        elif cfg.d_ff:
            ranges["ff"] = [[balanced(cfg.d_ff, self.n, r)] for r in range(self.n)]
        ranges["vocab"] = [[balanced(cfg.vocab_size, self.n, r)] for r in range(self.n)]
        self.ranges = ranges

    # ------------------------------------------------------------------
    def copy(self, x):
        return _Copy.apply(x, self.comm)

    def reduce(self, x):
        return _Reduce.apply(x, self.comm)

    def _take(self, t, spec, mdim: int, kind: str) -> torch.Tensor:
        """`t` (a stored shard under `spec`) cut to this rank's columns of
        `kind` of the whole leaf along `mdim`, then its FSDP rows gathered:
        cutting first, the row gathers move only the columns the rank
        computes with.  The all-gather over `model` runs where any rank's
        columns are not its stored shard, so every rank issues the same
        collectives."""
        segs = self.ranges[kind][self.r]
        if spec[mdim] == MODEL:
            w = t.shape[mdim]
            if all(rs == [(r * w, (r + 1) * w)] for r, rs in enumerate(self.ranges[kind])):
                return gather_rows(t, spec, self.comm, skip=(mdim,))
            t = _Gather.apply(t, self.comm, mdim, MODEL)
        else:
            t = self.copy(t)
        parts = [t.narrow(mdim, lo, hi - lo) for lo, hi in segs]
        t = parts[0] if len(parts) == 1 else torch.cat(parts, mdim)
        return gather_rows(t, spec, self.comm, skip=(mdim,))

    def layer(self, lp: Dict) -> Dict:
        """The per-layer hook: one layer's stored shards -> the weights this
        rank computes with."""
        out = {}
        for name, sub in lp.items():
            specs = self.specs["layers"][name]
            out[name] = {}
            for leaf, t in sub.items():
                spec = tuple(specs[leaf])[1:]            # the stacked [L] dim dropped
                what = _LAYER_DIMS.get((name, leaf))
                out[name][leaf] = (gather_rows(t, spec, self.comm) if what is None
                                   else self._take(t, spec, *what))
        return out

    # the microbatch over the data axes (moe training)
    def data_tokens(self, t: int) -> int:
        return t * self.comm.size(self.dp)

    def data_sum(self, x):
        return _DataSum.apply(x, self.comm, self.dp)

    def expert_rows(self, kept, capacity: int) -> int:
        """The rows a buffer of one of this rank's experts needs: the most
        entries `kept` [E/n] says one of them keeps (one read to the host).
        A fake tensor carries no routing: the dry run takes the rank's even
        share of the microbatch's capacity."""
        from torch._subclasses.fake_tensor import FakeTensor
        if isinstance(kept, FakeTensor):
            return max(1, -(-capacity // self.comm.size(self.dp)))
        return max(1, int(kept.max()))

    def data_offsets(self, counts):
        """counts [E] of this rank's entries per expert -> those of the data
        ranks before it in the microbatch's order (major to minor)."""
        every = counts[None]
        for a in reversed(self.dp):
            every = self.comm.all_gather(every, 0, a)
        mine = shard_index(self.dp, self.comm.mesh, self.comm.coords)[0]
        return every[:mine].sum(dim=0)

    # ------------------------------------------------------------------
    # attention
    # ------------------------------------------------------------------
    def attention(self, mode: str, h, p, *, positions=None, kc=None, vc=None, pos=None,
                  window: int = 0, num_meta: int = 0, rope: bool = True, alibi=None, **_):
        """The layer's attention on this rank's heads, summed over `model`:
        (out [B,S,d], k, v).  "prefill": a whole prompt at `positions`, k/v
        [B,S,Hkv_local,D] for `seq_state`; "decode": one token at `pos` over
        the cache slices kc/vc [B,S/n,Hkv,D] (updated in place)."""
        hf = self.copy(h)
        if mode == "decode":
            if alibi is not None:
                raise ValueError("sequence-sharded decode takes no ALiBi slopes")
            return self._decode(hf, p, kc, vc, int(pos), window, num_meta, rope)
        if mode != "prefill":
            raise ValueError(f"split attention runs prefill and decode, not {mode!r}")
        if self.local_cfg.num_heads == 0:
            return self._no_heads(hf, p)
        if alibi is not None:
            alibi = alibi[self.heads[0]:self.heads[1]]
        a, k, v = attn.attention_prefill(hf, p, self.local_cfg, positions, window=window,
                                         num_meta=num_meta, rope=rope, alibi=alibi)
        return self.reduce(a), k, v

    def _no_heads(self, hf, p):
        """A rank with no query head: its (empty) projections stay in the
        graph, so that the backward collectives of their gathers run on
        every rank; it adds zeros."""
        b, s, _ = hf.shape
        q, k, v = hf @ p["wq"], hf @ p["wk"], hf @ p["wv"]
        out = (q + (k.sum() + v.sum())) @ p["wo"]
        return self.reduce(out), k.view(b, s, 0, self.dh), v.view(b, s, 0, self.dh)

    def _gather_model(self, t, dim: int, sizes: Sequence[int]):
        """Per-rank blocks of `sizes` along `dim` all-gathered over `model`
        (padded to the largest block for the collective)."""
        m = max(sizes)
        if t.shape[dim] < m:
            pad = list(t.shape)
            pad[dim] = m - t.shape[dim]
            t = torch.cat([t, t.new_zeros(pad)], dim)
        whole = self.comm.all_gather(t, dim, MODEL)
        parts = [c.narrow(dim, 0, n) for c, n in zip(whole.split(m, dim), sizes)]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

    def _decode(self, hf, p, kc, vc, pos: int, window: int, num_meta: int, rope: bool):
        cfg, b, dh = self.local_cfg, hf.shape[0], self.dh
        s_loc = kc.shape[1]
        # a row's own key, at slot pos, lies in some slice and is valid there
        assert 0 <= pos < s_loc * self.n, (pos, s_loc * self.n)
        q, k, v = attn.qkv_proj(hf, p, cfg)
        posv = torch.full((1,), pos, dtype=torch.int32, device=hf.device)
        if rope:
            q = apply_rope(q, posv[None, :], cfg.rope_theta)
            k = apply_rope(k, posv[None, :], cfg.rope_theta)
        q_all = self._gather_model(q[:, 0], 1, self.q_sizes)              # [B,H,D]
        kv = torch.stack([k[:, 0], v[:, 0]])[:, :, self.own]
        kv_all = self._gather_model(kv, 2, self.own_sizes)                # [2,B,Hkv,D]
        if pos // s_loc == self.r:
            kc[:, pos % s_loc] = kv_all[0].to(kc.dtype)
            vc[:, pos % s_loc] = kv_all[1].to(vc.dtype)
        slots = self.r * s_loc + torch.arange(s_loc, dtype=torch.int32, device=hf.device)
        valid = attn.build_mask(posv, torch.where(slots <= pos, slots, -1), causal=True,
                                window=window, num_meta=num_meta)[0]
        o, lse = kops.decode_attention_auto(q_all[:, None], kc, vc, valid, with_lse=True)
        o = self.combine(o[:, 0], lse)
        mine = o[:, self.heads[0]:self.heads[1]]
        out = mine.reshape(b, 1, cfg.num_heads * dh) @ p["wo"]
        return self.reduce(out), kc, vc

    def combine(self, o, lse):
        """This rank's attention partial over its slice of the cache, merged
        with the other ranks' over `model` (`combine`)."""
        return combine(o, lse, lambda t: self.comm.all_reduced(t, MODEL, op="max"),
                       lambda t: self.comm.all_reduce(t, MODEL))

    def seq_state(self, ks, vs, max_len: int) -> Dict:
        """The prompt's K/V of this rank's KV heads, ks/vs [L,B,S,Hkv_local,D],
        as this rank's sequence slice of the decode state {"kv": {"k", "v":
        [L,B,max_len/n,Hkv,D]}}: one all-to-all over `model`, each KV head
        sent by the first rank that has it (heads to sequence)."""
        if max_len % self.n:
            raise ValueError(f"a {max_len}-slot cache does not split over {self.n} ranks")
        s_loc, s = max_len // self.n, ks.shape[2]
        state = init_decode_state(self.cfg, ks.shape[1], s_loc, device=ks.device)
        span = [(min(t * s_loc, s), min((t + 1) * s_loc, s)) for t in range(self.n)]
        kv = torch.stack([ks, vs])[:, :, :, :, self.own]
        mine = span[self.r][1] - span[self.r][0]
        shape = (2,) + tuple(kv.shape[1:3])
        got = self.comm.all_to_all(
            [kv[:, :, :, lo:hi] for lo, hi in span],
            [shape + (mine, n, self.dh) for n in self.own_sizes], MODEL)
        got = torch.cat(got, dim=4)
        state["kv"]["k"][:, :, :mine] = got[0]
        state["kv"]["v"][:, :, :mine] = got[1]
        return state

    # ------------------------------------------------------------------
    # vocabulary
    # ------------------------------------------------------------------
    def embed(self, table, tokens):
        """Token embeddings [.., d] from this rank's vocabulary rows, summed
        over `model`."""
        lo, hi = self.vocab
        w = self._take(table, self.specs["embed"], 0, "vocab")
        idx = tokens.long() - lo
        inside = (idx >= 0) & (idx < hi - lo)
        e = F.embedding(idx.clamp(0, hi - lo - 1), w)
        return self.reduce(torch.where(inside[..., None], e, e.new_zeros(())))

    def logits(self, sp, x):
        """The final norm and the head on this rank's vocabulary columns."""
        cfg = self.cfg
        h = self.copy(norm_apply(cfg.norm, x, sp["final_norm"]))
        if cfg.tie_embeddings:
            return h @ self._take(sp["embed"], self.specs["embed"], 0, "vocab").t()
        return h @ self._take(sp["lm_head"], self.specs["lm_head"], 1, "vocab")

    def gather_vocab(self, logits):
        """Logits [.., V/n] of this rank's columns -> [.., V], for sampling."""
        return self._gather_model(logits, logits.dim() - 1, self.vocab_sizes)

    def lm_loss(self, logits, targets, loss_mask):
        """`models.losses.causal_lm_loss` over logits split by vocabulary:
        each token's max, sum of exps and target logit reduced over
        `model`."""
        lse = torch.logsumexp(logits.float(), dim=-1)
        m = self.comm.all_reduced(lse.detach(), MODEL, op="max")
        lse = m + torch.log(self.reduce(torch.exp(lse - m)))
        lo, hi = self.vocab
        idx = targets.long() - lo
        inside = (idx >= 0) & (idx < hi - lo)
        tgt = logits.gather(-1, idx.clamp(0, hi - lo - 1)[..., None])[..., 0].float()
        tgt = self.reduce(torch.where(inside, tgt, tgt.new_zeros(())))
        mask = loss_mask.float()
        denom = torch.clamp(mask.sum(), min=1.0)
        return ((lse - tgt) * mask).sum() / denom


def _replace(cfg, **kw):
    import dataclasses
    return dataclasses.replace(cfg, **kw)
