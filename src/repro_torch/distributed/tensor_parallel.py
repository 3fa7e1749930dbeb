"""Split compute on a DeviceMesh for every model family (the port's
counterpart of what GSPMD does with the reference's cells once
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
  do not group evenly over their KV heads holds one KV slot a query head.
  Self-attention, an encoder's bidirectional attention and
  cross-attention split alike;
- the ff columns, the experts and the vocabulary likewise, in balanced
  contiguous ranges;
- the Mamba-2 block by SSM heads, in balanced whole-head ranges: a rank's
  columns of z, x and dt in `w_in`, its x channels of the conv, its
  entries of `A_log`, `dt_bias` and `D`, its slice of `norm_scale` and its
  rows of `w_out`; the B and C columns (one group, read by every head) are
  taken whole.  The gated RMSNorm over d_inner sums its squares over
  `model`;
- FSDP: the rows a leaf's spec splits over the data axes are all-gathered
  where a layer uses them (`gather_rows`, whose backward reduce-scatters,
  once per use), inside the layer's activation checkpoint, so remat's
  recompute gathers them again.

Activations cross between replicated and per-rank compute through two
functions: `enter` into a rank's share, `leave` out of it.  Under the
baseline rules they are `copy` (identity forward, all-reduce over `model`
backward) and `reduce` (all-reduce forward, identity backward).  The
embedding is a masked lookup of the rank's vocabulary rows then a `leave`;
the causal-LM loss reduces each token's max, sum of exps and target logit
over `model` (the f32 function of `models.losses`).

The reference's `opt` variants (`variant=`, the rules of
`launch.specs.cell_rules`) change four things, each where its rule and the
mesh allow it (a dim that `model` does not divide stays unconstrained, as
the reference's ``logical_constraint`` leaves it):

- sequence parallelism (``seq`` -> model, training, every family but moe):
  the residual stream between blocks is the rank's slice [B, S/n, d]
  (`on_seq`); `enter` all-gathers the sequence (its backward
  reduce-scatters), `leave` reduce-scatters it (its backward all-gathers),
  the embedding's sum is a reduce-scatter, norms and residual adds run on
  the slice (their weights through `copy`: each rank's gradient covers its
  tokens) and the hidden states are gathered after the final norm, for the
  head;
- opt-zmlp (``ff`` None, ``mlp_seq`` -> model): the MLP weights are
  FSDP-only and the MLP runs on the rank's tokens: the residual slice in
  training, with no collective; in prefill the rank's slice of the
  sequence, its output all-gathered;
- opt-rowssm (decode of a pure SSM): `w_in`'s d_model rows and `w_out`'s
  d_inner rows lie over `model`; the rank multiplies its slice of x (of y)
  by them and the partial projections are summed over `model`; where the
  vocabulary does not divide, the embedding's d_model columns lie over
  `model` (each rank looks its columns up, then all-gathers them) and the
  tied head's rows give partial logits summed over `model`;
- blocked attention in training and prefill (`attention.attend_blocked`)
  wherever attention does not run the flash kernel on the card.

Every other rule of the variants (heads, kv_heads, vocab, experts,
d_inner, ssm_heads -> model) is what the port computes under the baseline
rules already; those that decode drops (heads, kv_heads, d_inner,
ssm_heads) change nothing either, since a decode step attends over the
rank's slice of the cache with every head.

Serving follows the rules' decode-state placement (`state_shardings`): a
cache [L,B,S,H,D] has its sequence over `model`, over the data axes
(batch 1, long_500k) or nowhere (a length that divides neither); the SSD
state has its heads over `model` where they divide, else it is whole on
every rank; the conv state is whole.  Decode makes q and the new K/V for
the rank's heads, all-gathers them over `model` (B x H x D), the rank
holding the write slot writes the new K/V, every rank runs
`decode_attention` with its LSE over its slice (slot positions given for a
ring), and `combine` merges the partials over the axes that split the
sequence: o = sum_r exp(lse_r - M) o_r / sum_r exp(lse_r - M), M = max_r
lse_r.  A slice with no valid key has an LSE of NEG_INF and weighs exactly
0.  Cross-attention decodes its one query over the rank's source slice
with `flash_attention`'s LSE, combined likewise.  An SSD state whole on
every rank is decoded whole, with the whole block, on every rank, so its
copies stay equal with no gather.  Prefill computes the rank's heads for
the whole prompt, hands each rank its slice of every cache (one
all-to-all over `model`, or an all-gather of the heads where `model` does
not split the sequence) and all-gathers the SSD final states once where
the rules keep them whole.

On a world of one every collective is a copy and every selection is the
whole leaf, so the unsharded model's function comes out bit for bit.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (_axes, _names, shard_index,
                                              state_shardings)
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models.common import apply_rope, norm_apply
from repro_torch.models.mlp import mlp_apply

MODEL = "model"

# the tensor dim of each layer leaf that `model` splits, and what it counts
_ATTN_DIMS = {"wq": (1, "q"), "wk": (1, "kv"), "wv": (1, "kv"), "wo": (0, "q")}
_LAYER_DIMS = {**{("attn", k): v for k, v in _ATTN_DIMS.items()},
               **{("cross", k): v for k, v in _ATTN_DIMS.items()},
               ("mlp", "w_gate"): (1, "ff"), ("mlp", "w_up"): (1, "ff"),
               ("mlp", "w_down"): (0, "ff"),
               ("moe", "w_gate"): (0, "experts"), ("moe", "w_up"): (0, "experts"),
               ("moe", "w_down"): (0, "experts"),
               ("ssm", "w_in"): (1, "ssm_in"), ("ssm", "conv_w"): (1, "ssm_conv"),
               ("ssm", "conv_b"): (0, "ssm_conv"), ("ssm", "A_log"): (0, "ssm_heads"),
               ("ssm", "dt_bias"): (0, "ssm_heads"), ("ssm", "D"): (0, "ssm_heads"),
               ("ssm", "norm_scale"): (0, "ssm_inner"), ("ssm", "w_out"): (0, "ssm_inner")}


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


class _ReduceScatter(torch.autograd.Function):
    """Out of a rank's share onto its slice of the stream: summed over
    `model` and cut along `dim` forward; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, comm, dim: int):
        ctx.comm, ctx.dim = comm, dim
        return comm.reduce_scatter(x, dim, MODEL)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.dim, MODEL), None, None


class _Scatter(torch.autograd.Function):
    """A tensor whole on every rank of `model` -> the rank's block along
    `dim`; the backward all-gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, comm, dim: int, r: int, n: int):
        ctx.comm, ctx.dim = comm, dim
        w = x.shape[dim] // n
        return x.narrow(dim, r * w, w).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.dim, MODEL), None, None, None, None


class _Assemble(torch.autograd.Function):
    """The ranks' blocks along `dim` all-gathered over `model` into a tensor
    that replicated compute reads; the backward keeps the rank's block of
    the (whole, equal on every rank) gradient."""

    @staticmethod
    def forward(ctx, x, comm, dim: int, r: int):
        ctx.dim, ctx.r, ctx.w = dim, r, x.shape[dim]
        return comm.all_gather(x, dim, MODEL)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.r * ctx.w, ctx.w), None, None, None


class _Sum(torch.autograd.Function):
    """Summed over `axes`, forward and backward: a term that every rank's
    per-rank compute reads (the moe load-balancing loss of a microbatch
    over the data axes; the gated norm's sum of squares over `model`)."""

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


def _merged(ranges) -> List[Tuple[int, int]]:
    """Column ranges [lo, hi) in order, the empty ones dropped and the
    adjacent ones merged."""
    out: List[Tuple[int, int]] = []
    for lo, hi in ranges:
        if lo == hi:
            continue
        if out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def _segments(ids: Sequence[int], width: int) -> List[Tuple[int, int]]:
    """Column ranges [lo, hi) of the blocks `ids` (each `width` wide), the
    adjacent ones merged."""
    return _merged((i * width, (i + 1) * width) for i in ids)


def _ssm_ranges(cfg, lo: int, hi: int) -> Dict[str, List[Tuple[int, int]]]:
    """The columns of SSM heads [lo, hi) in each split leaf: `w_in` is [z |
    x | B | C | dt], the conv's channels [x | B | C]."""
    hd, di, gn = cfg.ssm_head_dim, cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    inner = (lo * hd, hi * hd)
    return {"ssm_heads": [(lo, hi)], "ssm_inner": [inner],
            "ssm_conv": _merged([inner, (di, di + 2 * gn)]),
            "ssm_in": _merged([inner, (di + inner[0], di + inner[1]),
                               (2 * di, 2 * di + 2 * gn),
                               (2 * di + 2 * gn + lo, 2 * di + 2 * gn + hi)])}


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
    """One rank's share of a model on a mesh, built from the model's
    config, the step's `train_step.Collectives` (mesh, coordinates,
    transport), the spec tree of the stored parameters and whether the
    tokens are this rank's slice of training microbatches split over the
    data axes (`train_step.rank_batch`).  A prefill also gives `batch`, the
    global rows (the decode state is placed for it, `place_kv`,
    `place_ssm`); a decode step gives `state_specs`, the specs of the
    decode state it runs on.  `variant` names the reference's rules
    ("baseline", "opt", "opt-zmlp"), which `launch.specs.cell_rules` turns
    into this step's activation rules.  The parameters must lie as those
    rules' parameter variant places them (opt-zmlp's FSDP-only MLP,
    opt-rowssm's SSM rows: both read from `p_specs`).  The model's `loss`,
    `prefill` and `decode_step` take it as ``tp``."""

    def __init__(self, cfg, comm, p_specs: Dict, data_split: bool = False, *,
                 batch: int = None, state_specs: Dict = None, variant: str = "baseline"):
        from repro_torch.launch.specs import cell_rules
        self.cfg, self.comm, self.specs = cfg, comm, p_specs
        self.n, self.r = comm.mesh.shape[MODEL], comm.coords[MODEL]
        # a microbatch split over more than one data rank
        self.dp = _axes(comm.mesh)[0]
        self.data_split = data_split and comm.size(self.dp) > 1
        self.batch = batch
        kind = "decode" if state_specs is not None else "train" if batch is None else "prefill"
        rules = cell_rules(cfg, kind, variant, comm.mesh)[0] or {}
        self.sp = rules.get("seq") == MODEL                 # sequence parallelism (`on_seq`)
        self.ff_split = rules.get("ff", MODEL) == MODEL     # else opt-zmlp's FSDP-only MLP
        self.mlp_tokens = rules.get("mlp_seq") == MODEL
        self.blocked = variant.startswith("opt") and kind != "decode"
        self.seq = False                 # this stream is cut over `model` (`on_seq`)
        self.unsplit = self
        # the spec of each top-level entry of the decode state (its leaves
        # share it), as given for a decode step or as `place_*` set them
        self.layout = {k: next(iter(v.values())) if isinstance(v, dict) else v
                       for k, v in (state_specs or {}).items()}
        # leaves the rules keep whole over `model` that the baseline splits
        self.whole_leaves = set()
        if not self.ff_split:
            self.whole_leaves |= {("mlp", k) for k in ("w_gate", "w_up", "w_down")}
        stack = p_specs.get("layers") or p_specs.get("dec_layers") or {}
        if any(e == MODEL for e in stack.get("mlp", {}).get("w_up", ())) and not self.ff_split:
            raise ValueError("opt-zmlp computes with MLP weights placed FSDP-only, not "
                             f"{stack['mlp']['w_up']}")
        # opt-rowssm: the SSM's weight rows and, where the vocabulary does
        # not divide, the embedding's d_model columns over `model`
        self.ssm_rows = stack.get("ssm", {}).get("w_in", (None, None))[1] == MODEL
        if self.ssm_rows:
            self.whole_leaves |= {("ssm", "w_in"), ("ssm", "w_out")}
        self.embed_cols = p_specs["embed"][1] == MODEL
        if (self.ssm_rows or self.embed_cols) and kind != "decode":
            raise ValueError("row-split SSM weights and d_model-split embeddings "
                             "(opt-rowssm) serve decode steps only")
        ranges: Dict[str, list] = {}
        if cfg.family != "ssm":
            self._heads(cfg, ranges)
        if cfg.is_moe:
            if cfg.num_experts < self.n:
                raise ValueError(f"{cfg.num_experts} experts on {self.n} ranks of `model`")
            self.experts = balanced(cfg.num_experts, self.n, self.r)
            ranges["experts"] = [[balanced(cfg.num_experts, self.n, r)] for r in range(self.n)]
        elif cfg.d_ff:
            ranges["ff"] = [[balanced(cfg.d_ff, self.n, r)] for r in range(self.n)]
        if cfg.family in ("ssm", "hybrid"):
            self._ssm_heads(cfg, ranges, state_specs is not None)
        self.vocab = balanced(cfg.vocab_size, self.n, self.r)
        self.vocab_sizes = [b - a for a, b in (balanced(cfg.vocab_size, self.n, r)
                                               for r in range(self.n))]
        ranges["vocab"] = [[balanced(cfg.vocab_size, self.n, r)] for r in range(self.n)]
        self.ranges = ranges

    def on_seq(self, length: int) -> "Split":
        """This Split for a residual stream of `length` tokens: where the
        rules put the sequence over `model` (training, every family but
        moe) and `model` divides `length`, a copy whose stream is cut over
        `model` (rank r holds tokens [rL/n, (r+1)L/n)); else itself.  Each
        stream of a step takes its own (an encoder's and a decoder's
        lengths differ)."""
        if not self.sp or length % self.n:
            return self
        out = copy.copy(self)
        out.seq = True
        return out

    def _heads(self, cfg, ranges) -> None:
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
        self.local_cfg = dataclasses.replace(cfg, num_heads=self.q_sizes[self.r],
                                             num_kv_heads=len(self.kv_ids), head_dim=self.dh)
        # each rank's columns of each split dim, as ranges [lo, hi)
        ranges["q"] = [_segments(range(*hs), self.dh) for hs in heads]
        ranges["kv"] = [_segments(ids, self.dh) for ids in kv_ids]

    def _ssm_heads(self, cfg, ranges, decode: bool) -> None:
        """SSM heads in balanced ranges over `model`; a decode step whose SSD
        state the rules keep whole runs the whole block on every rank
        (`ssm_tp` None, or with opt-rowssm's row-split projections this
        Split with `ssm_whole` set)."""
        nh = cfg.ssm_nheads
        whole = decode and self.layout["ssd"][2] != MODEL
        heads = [(0, nh) if whole else balanced(nh, self.n, r) for r in range(self.n)]
        if not whole and self.n > 1:
            if nh < self.n:
                raise ValueError(f"{nh} SSM heads on {self.n} ranks of `model`")
            if cfg.ssm_ngroups != 1:
                raise ValueError("split SSM heads need one B/C group (every head reads it), "
                                 f"not {cfg.ssm_ngroups}")
        self.ssm_whole = whole
        self.ssm_tp = self if self.ssm_rows or not whole else None
        self.ssm_sizes = [hi - lo for lo, hi in heads]
        self.ssm_inner = (heads[self.r][0] * cfg.ssm_head_dim,
                          heads[self.r][1] * cfg.ssm_head_dim)
        if self.ssm_rows and not whole:      # the rank's heads are its rows of w_out
            rows = cfg.d_inner // self.n
            assert self.ssm_inner == (self.r * rows, (self.r + 1) * rows), self.ssm_inner
        per_rank = [_ssm_ranges(cfg, lo, hi) for lo, hi in heads]
        for kind in per_rank[0]:
            ranges[kind] = [rs[kind] for rs in per_rank]

    # ------------------------------------------------------------------
    def copy(self, x):
        return _Copy.apply(x, self.comm)

    def reduce(self, x):
        return _Reduce.apply(x, self.comm)

    def enter(self, h):
        """An activation of the stream into the rank's share: on a stream
        cut over `model` the sequence all-gathered (the backward
        reduce-scatters), else `copy`."""
        return _Gather.apply(h, self.comm, 1, MODEL) if self.seq else self.copy(h)

    def leave(self, a):
        """The rank's share of a block's output [B,S,..] back onto the
        stream: on a stream cut over `model` reduce-scattered onto the
        rank's slice (the backward all-gathers), else `reduce`."""
        return _ReduceScatter.apply(a, self.comm, 1) if self.seq else self.reduce(a)

    def scatter(self, t, dim: int = 1):
        """A tensor whole on every rank, cut to the rank's slice of a stream
        cut over `model` along `dim` (the backward all-gathers); else
        itself."""
        return _Scatter.apply(t, self.comm, dim, self.r, self.n) if self.seq else t

    def shared(self, tree):
        """Weights whole over `model` that a rank applies to its slice of a
        stream cut over `model` (the final norms): through `copy`, whose
        backward sums the ranks' gradients; elsewhere as they are."""
        if not self.seq:
            return tree
        return {k: self.shared(v) for k, v in tree.items()} if isinstance(tree, dict) \
            else self.copy(tree)

    def _take(self, t, spec, mdim: int, kind: str) -> torch.Tensor:
        """`t` (a stored shard under `spec`) cut to this rank's columns of
        `kind` of the whole leaf along `mdim`, then its FSDP rows gathered:
        cutting first, the row gathers move only the columns the rank
        computes with.  The all-gather over `model` runs where any rank's
        columns are not its stored shard, so every rank issues the same
        collectives.  Where the data axes split `mdim` itself (`w_out`'s
        d_inner rows), those rows are gathered before the cut."""
        segs = self.ranges[kind][self.r]
        if spec[mdim] == MODEL:
            w = t.shape[mdim]
            if all(rs == [(r * w, (r + 1) * w)] for r, rs in enumerate(self.ranges[kind])):
                return gather_rows(t, spec, self.comm, skip=(mdim,))
            t = _Gather.apply(t, self.comm, mdim, MODEL)
        else:
            if spec[mdim] is not None:
                t = gather_rows(t, tuple(e if d == mdim else None for d, e in enumerate(spec)),
                                self.comm)
            t = self.copy(t)
        parts = [t.narrow(mdim, lo, hi - lo) for lo, hi in segs]
        t = parts[0] if len(parts) == 1 else torch.cat(parts, mdim)
        return gather_rows(t, spec, self.comm, skip=(mdim,))

    def layer(self, lp: Dict, stack: str = "layers") -> Dict:
        """The per-layer hook: one layer's stored shards (of the stacked
        layers `stack`) -> the weights this rank computes with."""
        return self._hook(lp, self.specs[stack], ())

    def _hook(self, t, specs, path):
        if isinstance(t, dict):
            return {k: self._hook(v, specs[k], path + (k,)) for k, v in t.items()}
        spec = tuple(specs)[1:]                      # the stacked [L] dim dropped
        what = None if path[-2:] in self.whole_leaves else _LAYER_DIMS.get(path[-2:])
        if what is not None:
            return self._take(t, spec, *what)
        # whole over `model`: on a stream cut over it, the leaf is applied to
        # the rank's tokens, so its gradient is summed over `model` (the
        # shard's, before the FSDP gather's reduce-scatter widens it)
        return gather_rows(self.copy(t) if self.seq else t, spec, self.comm)

    def mlp(self, x, p):
        """The MLP of the stream `x`: on the rank's ff columns, summed over
        `model`; under opt-zmlp (weights whole over `model`) on the rank's
        tokens: a stream cut over `model` as it is, with no collective, or
        (prefill, which takes no gradient) the rank's slice of the sequence
        where `model` divides it, all-gathered after; else whole on every
        rank."""
        if self.ff_split:
            return self.leave(mlp_apply(self.enter(x), p, self.cfg))
        if self.seq or not self.mlp_tokens or x.shape[1] % self.n:
            return mlp_apply(x, p, self.cfg)
        mine = mlp_apply(_Scatter.apply(x, self.comm, 1, self.r, self.n), p, self.cfg)
        return _Assemble.apply(mine, self.comm, 1, self.r)

    # the microbatch over the data axes (moe training)
    def data_tokens(self, t: int) -> int:
        return t * self.comm.size(self.dp)

    def data_sum(self, x):
        return _Sum.apply(x, self.comm, self.dp)

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
    # the SSM block (`models.ssm` calls these with its ``tp``)
    # ------------------------------------------------------------------
    def inner_mean(self, mean, width: int):
        """A mean over this rank's `width` channels of d_inner -> the mean
        over all of d_inner, summed over `model` both ways (each rank's
        gated norm reads it); the mean itself where the block runs whole."""
        if self.ssm_whole:
            return mean
        return _Sum.apply(mean * (width / self.cfg.d_inner), self.comm, MODEL)

    def gather_inner(self, t):
        """This rank's d_inner channels along the last dim -> all of them."""
        if self.ssm_whole:
            return t
        return self._gather_model(t, t.dim() - 1, [n * self.cfg.ssm_head_dim
                                                   for n in self.ssm_sizes])

    def ssm_in(self, x, w):
        """The SSM's input projection of `x` (through `enter`) on the rank's
        heads' columns of `w_in` [z | x | B | C | dt].  With its d_model
        rows over `model` (opt-rowssm), the rank's rows multiply its slice
        of x and the partial projections are summed over `model`, then the
        rank's heads' columns are cut (all of them where the block runs
        whole)."""
        if not self.ssm_rows:
            return x @ w
        k = w.shape[0]
        h = self.reduce(x[..., self.r * k:(self.r + 1) * k] @ w)
        if self.ssm_whole:
            return h
        return torch.cat([h[..., lo:hi] for lo, hi in self.ranges["ssm_in"][self.r]], dim=-1)

    def ssm_out(self, y, w):
        """The SSM's output projection of y [.., d_inner of the rank's heads]
        by the rank's rows of `w_out`, summed over `model` (`leave`).  With
        opt-rowssm's rows and the block whole, the rank takes its rows'
        slice of y first."""
        if self.ssm_rows and self.ssm_whole:
            k = w.shape[0]
            y = y[..., self.r * k:(self.r + 1) * k]
        return self.leave(y @ w)

    def place_ssm(self, ssd, conv) -> Dict:
        """The prompt's final states of this rank's SSM heads, ssd
        [L,B,nh_local,hd,N] and conv [L,B,K-1,x_local | B | C], as the rules
        place them: the SSD heads kept where they lie over `model`, else
        all-gathered once; the conv state whole (its x channels
        all-gathered)."""
        xw = self.ssm_sizes[self.r] * self.cfg.ssm_head_dim
        conv = torch.cat([self.gather_inner(conv[..., :xw]), conv[..., xw:]], dim=-1)
        spec = self.place("ssd", (ssd.shape[0], self.batch, self.cfg.ssm_nheads)
                           + tuple(ssd.shape[3:]), ssd.dtype)
        self.place("conv", (conv.shape[0], self.batch) + tuple(conv.shape[2:]), conv.dtype)
        if spec[2] != MODEL:
            ssd = self._gather_model(ssd, 2, self.ssm_sizes)
        return {"conv": conv, "ssd": ssd}

    # ------------------------------------------------------------------
    # attention
    # ------------------------------------------------------------------
    def attention(self, mode: str, hf, p, *, positions=None, kc=None, vc=None, pos=None,
                  window: int = 0, num_meta: int = 0, rope: bool = True, alibi=None,
                  key: str = "kv", kv_positions=None, write_index=None, **_):
        """The layer's attention on this rank's heads of its normed input
        `hf`, which the caller has passed through `copy` (once for every
        branch that reads it, so that its gradient sums as the unsharded
        one does), summed over `model`: (out [B,S,d], k, v).  "prefill": a
        whole prompt at `positions`, k/v
        [B,S,Hkv_local,D] for `place_kv`; "full": bidirectional, no mask (an
        encoder); "decode": one token at `pos` over this rank's slice kc/vc
        [B,S_local,Hkv,D] of the decode state's cache `key` (updated in
        place), its slots at positions `kv_positions` [S] (default the slot
        indices) and the new K/V written at slot `write_index` (default
        `pos`)."""
        if mode == "decode":
            if alibi is not None:
                raise ValueError("sequence-sharded decode takes no ALiBi slopes")
            return self._decode(hf, p, kc, vc, int(pos), window, num_meta, rope, key,
                                kv_positions, write_index)
        if mode not in ("prefill", "full"):
            raise ValueError(f"split attention runs prefill, full and decode, not {mode!r}")
        if self.local_cfg.num_heads == 0:
            return self._no_heads(hf, p)
        if mode == "full":
            q, k, v = attn.qkv_proj(hf, p, self.local_cfg)
            return self.leave(attn.out_proj(attn.full_attention(q, k, v, self.blocked),
                                            p)), k, v
        if alibi is not None:
            alibi = alibi[self.heads[0]:self.heads[1]]
        a, k, v = attn.attention_prefill(hf, p, self.local_cfg, positions, window=window,
                                         num_meta=num_meta, rope=rope, alibi=alibi,
                                         blocked=self.blocked)
        return self.leave(a), k, v

    def cross(self, mode: str, hf, p, *, enc_out=None, kc=None, vc=None):
        """Cross-attention on this rank's heads of `hf` (through `copy`, as
        `attention` takes it), summed over `model`.  "prefill": (out, k, v)
        over the encoder's output `enc_out` (through `copy` once for every
        layer), k/v [B,Ssrc,Hkv_local,D] of the rank's KV heads for
        `place_kv`; "decode": out of one query over this rank's slice kc/vc
        of the state's cross K/V, the partials (`flash_attention` with its
        LSE) combined over the axes that split the source."""
        b, s, _ = hf.shape
        q = (hf @ p["wq"]).reshape(b, s, self.local_cfg.num_heads, self.dh)
        if mode == "prefill":
            k, v = attn.cross_kv(enc_out, p, self.local_cfg)
            return self.leave(attn.out_proj(attn.full_attention(q, k, v, self.blocked),
                                            p)), k, v
        if mode != "decode":
            raise ValueError(f"split cross-attention runs prefill and decode, not {mode!r}")
        q_all = self._gather_model(q[:, 0], 1, self.q_sizes)[:, None]    # [B,1,H,D]
        o, lse = kops.attention_auto(q_all, kc, vc, with_lse=True)
        o = self._merge(o[:, 0], lse[..., 0], self.layout["cross"][2])
        mine = o[:, self.heads[0]:self.heads[1]]
        return self.leave(mine.reshape(b, 1, -1) @ p["wo"])

    def _no_heads(self, hf, p):
        """A rank with no query head: its (empty) projections stay in the
        graph, so that the backward collectives of their gathers run on
        every rank; it adds zeros."""
        b, s, _ = hf.shape
        q, k, v = hf @ p["wq"], hf @ p["wk"], hf @ p["wv"]
        out = (q + (k.sum() + v.sum())) @ p["wo"]
        return self.leave(out), k.view(b, s, 0, self.dh), v.view(b, s, 0, self.dh)

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

    def _decode(self, hf, p, kc, vc, pos: int, window: int, num_meta: int, rope: bool,
                key: str, kv_positions, write_index):
        cfg, b, dh = self.local_cfg, hf.shape[0], self.dh
        axes = self.layout[key][2]
        part, parts = shard_index(axes, self.comm.mesh, self.comm.coords)
        s_loc = kc.shape[1]
        lo = part * s_loc
        wi = pos if write_index is None else int(write_index)
        # a row's own key, at its write slot, lies in some slice and is valid there
        assert 0 <= wi < s_loc * parts, (wi, s_loc * parts)
        q, k, v = attn.qkv_proj(hf, p, cfg)
        posv = torch.full((1,), pos, dtype=torch.int32, device=hf.device)
        if rope:
            q = apply_rope(q, posv[None, :], cfg.rope_theta)
            k = apply_rope(k, posv[None, :], cfg.rope_theta)
        q_all = self._gather_model(q[:, 0], 1, self.q_sizes)              # [B,H,D]
        kv = torch.stack([k[:, 0], v[:, 0]])[:, :, self.own]
        kv_all = self._gather_model(kv, 2, self.own_sizes)                # [2,B,Hkv,D]
        if lo <= wi < lo + s_loc:
            kc[:, wi - lo] = kv_all[0].to(kc.dtype)
            vc[:, wi - lo] = kv_all[1].to(vc.dtype)
        slots = lo + torch.arange(s_loc, dtype=torch.int32, device=hf.device)
        valid = attn.build_mask(posv, torch.where(slots <= pos, slots, -1) if kv_positions is None
                                else kv_positions[lo:lo + s_loc], causal=True, window=window,
                                num_meta=num_meta)[0]
        o, lse = kops.decode_attention_auto(q_all[:, None], kc, vc, valid, with_lse=True)
        o = self._merge(o[:, 0], lse, axes)
        mine = o[:, self.heads[0]:self.heads[1]]
        out = mine.reshape(b, 1, cfg.num_heads * dh) @ p["wo"]
        return self.leave(out), kc, vc

    def _merge(self, o, lse, axes):
        """This rank's attention partial over its slice of a cache, merged
        with the other slices' over `axes` (`combine`); a cache no axis
        splits is whole here."""
        if axes is None:
            return o
        return combine(o, lse, lambda t: self.comm.all_reduced(t, axes, op="max"),
                       lambda t: self.comm.all_reduce(t, axes))

    # ------------------------------------------------------------------
    # the decode state of a prefill
    # ------------------------------------------------------------------
    def place(self, key: str, shape, dtype):
        """The rules' spec of the decode state's entry `key` of global
        `shape` for this prefill's global batch, recorded in `layout`."""
        spec = state_shardings({key: (tuple(shape), dtype)}, self.cfg, self.comm.mesh,
                               self.batch)[key]
        self.layout[key] = spec
        return spec

    def state_specs(self, state: Dict) -> Dict:
        """The spec tree of a decode state whose entries `place_*` placed."""
        return {k: {kk: self.layout[k] for kk in v} if isinstance(v, dict) else self.layout[k]
                for k, v in state.items()}

    def place_kv(self, key: str, ks, vs, total: int):
        """The prompt's K/V of this rank's KV heads, ks/vs [L,B,S,Hkv_local,D],
        as this rank's slice (k, v) [L,B,S_local,Hkv,D] of the state's cache
        `key` of `total` slots, zeros past the prompt.  Where `model` splits
        the sequence, one all-to-all over it, each KV head sent by the first
        rank that has it (heads to sequence); elsewhere each rank gathers
        every head over `model` and keeps its data slice, if any."""
        n_l, b, s = ks.shape[0], ks.shape[1], ks.shape[2]
        hkv = self.cfg.num_kv_heads
        axes = self.place(key, (n_l, self.batch, total, hkv, self.dh), ks.dtype)[2]
        part, parts = shard_index(axes, self.comm.mesh, self.comm.coords)
        s_loc = total // parts
        kv = torch.stack([ks, vs])[:, :, :, :, self.own]
        out = torch.zeros((2, n_l, b, s_loc, hkv, self.dh), dtype=kv.dtype, device=kv.device)
        if axes == MODEL:
            span = [(min(t * s_loc, s), min((t + 1) * s_loc, s)) for t in range(self.n)]
            mine = span[self.r][1] - span[self.r][0]
            got = self.comm.all_to_all(
                [kv[:, :, :, lo:hi] for lo, hi in span],
                [(2, n_l, b, mine, n, self.dh) for n in self.own_sizes], MODEL)
            out[:, :, :, :mine] = torch.cat(got, dim=4)
        else:
            whole = self._gather_model(kv, 4, self.own_sizes)
            lo = part * s_loc
            mine = max(0, min(s, lo + s_loc) - lo)
            out[:, :, :, :mine] = whole[:, :, :, lo:lo + mine]
        return out[0], out[1]

    # ------------------------------------------------------------------
    # vocabulary
    # ------------------------------------------------------------------
    def embed(self, table, tokens):
        """Token embeddings [.., d] from this rank's vocabulary rows, summed
        over `model` (`leave`: onto the rank's slice of a stream cut over
        `model`).  With the table's d_model columns over `model`
        (opt-rowssm), the rank looks its columns up and they are
        all-gathered."""
        if self.embed_cols:
            e = F.embedding(tokens, table)
            return _Assemble.apply(e, self.comm, e.dim() - 1, self.r)
        lo, hi = self.vocab
        w = self._take(table, self.specs["embed"], 0, "vocab")
        idx = tokens.long() - lo
        inside = (idx >= 0) & (idx < hi - lo)
        e = F.embedding(idx.clamp(0, hi - lo - 1), w)
        return self.leave(torch.where(inside[..., None], e, e.new_zeros(())))

    def logits(self, sp, x, skip: int = 0):
        """The final norm and the head on this rank's vocabulary columns,
        for the positions of `x` past its first `skip` (a stream cut over
        `model` is normed on the rank's slice, then gathered).  With the
        head's d_model rows over `model` (opt-rowssm) every rank's rows
        give partial logits of the whole vocabulary, summed over
        `model`."""
        cfg = self.cfg
        if self.seq:
            h = self.enter(norm_apply(cfg.norm, x, self.shared(sp["final_norm"])))[:, skip:]
        else:
            h = self.copy(norm_apply(cfg.norm, x[:, skip:] if skip else x, sp["final_norm"]))
        if self.embed_cols:
            w = sp["embed"].t() if cfg.tie_embeddings else sp["lm_head"]
            k = w.shape[0]
            return self.reduce(h[..., self.r * k:(self.r + 1) * k] @ w)
        if cfg.tie_embeddings:
            return h @ self._take(sp["embed"], self.specs["embed"], 0, "vocab").t()
        return h @ self._take(sp["lm_head"], self.specs["lm_head"], 1, "vocab")

    def gather_vocab(self, logits):
        """Logits [.., V/n] of this rank's columns -> [.., V], for sampling
        (with opt-rowssm's head the logits are whole already)."""
        if self.embed_cols:
            return logits
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
