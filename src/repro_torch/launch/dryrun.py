"""Dry run of every (arch × shape) cell on the production meshes, on fake
tensors (counterpart of `repro.launch.dryrun`):

    python -m repro_torch.launch.dryrun --mesh both   # 80 records, in --out

For each cell and mesh, one rank's step of the port (`launch.specs.
make_cell`: the split train step of `distributed.train_step`, prefill and
serve_step of `distributed.serve_step`) runs on fake tensors at the
per-device batch:
split over the data axes where `batch_shardings` splits it, whole where it
does not.  Nothing is allocated and no device is used.  Per device:

- flops: ``FlopCounterMode`` over the step (the plain versions' matmuls
  and attention products, forward and backward);
- bytes_accessed: what the step's aten ops read and write (every tensor
  input and output of each op that is not a view or an ``empty``);
- argument_bytes: the cell's inputs cut by the rules (`local_shape`);
- temp_bytes: the peak of live bytes the step allocated that are not its
  outputs, tracked op by op (an output's storage counts from the op that
  made it until it is freed);
- output_bytes, alias_bytes: the outputs' bytes, and those of the outputs
  that are inputs updated in place;
- collective_bytes: the operand bytes of the collectives the fake step
  issues, counted as it issues them by the real step's counter
  (`train_step.Collectives`, its transport left out by
  `specs.ShapeCollectives`, backward collectives included): the FSDP
  rows each layer gathers and reduce-scatters, the column gathers a
  rank's heads need, the row-parallel, vocabulary and gated-norm
  reductions over `model` and the gradients of leaves it leaves
  replicated, prefill's all-to-all (or head gather) of each cache and
  gather of whole SSD states, decode's gathers of q, the new K/V and the
  new conv channels and its combine; and the train step's gradient, loss
  and mask-count all-reduces over the data axes and its norm all-reduce;

against the H100 SXM's datasheet rates (`HardwareModel`).  The records
keep the keys of the reference's, so `benchmarks/render_tables.py` reads
them. The FLOPs are what each rank computes (the fake rank is the last of
`model`, which takes the largest share of an uneven split); an SSD state
the rules keep whole decodes whole on every rank of `model`. A fake
run cannot enter a CUDA kernel, so each kernel's share is its plain
version's: plain attention computes and holds the whole S x S score
matrix, causal or not, where the kernels skip the masked tiles and hold
none, so flops, bytes_accessed and temp_bytes overstate the card's step
wherever attention runs over long sequences.  A fake tensor carries no
routing either: a moe training step whose microbatch is split over the
data axes sizes its expert buffers by the rank's even share of the
microbatch's capacity (`Split.expert_rows`), where a real run takes the
most entries one of its experts keeps (up to dp times that share): those
cells' expert FLOPs and temp bytes are a lower bound.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import time
import traceback
import weakref
from typing import Dict, List, Sequence

import torch

from repro_torch.configs import SHAPES, get_arch, supports_shape
from repro_torch.core.dejavulib.transport import DEFAULT_HW
from repro_torch.distributed.sharding import local_shape
from repro_torch.launch.mesh import MeshShape, production_mesh_shape
from repro_torch.launch.specs import Cell, make_cell
from repro_torch.training.optimizer import tree_leaves

# the reference's 10 assigned architectures (`repro.configs.ARCHS`); the
# port's registry also holds gpt2-1.5b, a paper model the dry run skips
DRYRUN_ARCHS = ("hymba-1.5b", "internlm2-1.8b", "mamba2-780m", "moonshot-v1-16b-a3b",
                "nemotron-4-340b", "phi-3-vision-4.2b", "qwen3-moe-30b-a3b",
                "seamless-m4t-large-v2", "smollm-360m", "yi-34b")
# H100 SXM5 80GB: 80 GB of HBM3 per GPU (NVIDIA data sheet)
HBM_CAPACITY_BYTES = 80e9


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# arithmetic from the rules
# ---------------------------------------------------------------------------

def argument_bytes(inputs, specs, mesh: MeshShape) -> int:
    """Per-device bytes of the inputs under their specs (trees of one
    structure; a scalar is whole on every device)."""
    return sum(math.prod(local_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in zip(tree_leaves(_flat(inputs)), tree_leaves(_flat(specs))))


def _flat(tree):
    """Dicts of dicts from a tree that may hold NamedTuples (AdamWState)."""
    if isinstance(tree, dict):
        return {k: _flat(v) for k, v in tree.items()}
    if hasattr(tree, "_asdict"):
        return {k: _flat(v) for k, v in tree._asdict().items()}
    return tree


# ---------------------------------------------------------------------------
# the fake run
# ---------------------------------------------------------------------------

_NO_TRAFFIC = ("empty", "empty_strided", "new_empty", "new_empty_strided", "empty_like")


class StepMemory:
    """A dispatch mode over a fake run: the bytes each op reads and writes,
    and each new storage's life (its bytes from the op that made it until
    it is freed), to find the peak of what the step holds."""

    def __init__(self, known: Sequence[torch.Tensor]):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.weak import WeakIdKeyDictionary

        owner = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                owner._op(func, args, kwargs or {}, out)
                return out

        self.mode = _Mode()
        self.ids = WeakIdKeyDictionary()          # live storage -> its id
        self.next_id = itertools.count()          # never reused: a freed storage's id
        self.events: List[tuple] = []             # (id, +bytes or -bytes)
        self.accessed = 0
        self.inputs = set()
        for t in known:
            sid = self._id(t.untyped_storage())
            self.inputs.add(sid)

    def _id(self, st) -> int:
        if st not in self.ids:
            self.ids[st] = next(self.next_id)
        return self.ids[st]

    def _op(self, func, args, kwargs, out) -> None:
        from torch.utils._pytree import tree_leaves as leaves
        outs = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
        name = func.overloadpacket.__name__
        if not func.is_view and name not in _NO_TRAFFIC:
            ins = [t for t in leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            if st in self.ids:
                continue
            sid, nb = self._id(st), st.nbytes()
            self.events.append((sid, nb))
            weakref.finalize(st, self.events.append, (sid, -nb))

    def storage_ids(self, tensors) -> set:
        return {self.ids[t.untyped_storage()] for t in tensors
                if t.untyped_storage() in self.ids}

    def peak(self, exclude: set) -> int:
        """The most bytes live at once among storages the step made, leaving
        out those in `exclude` (the outputs)."""
        live = peak = 0
        for sid, nb in self.events:
            if sid not in exclude:
                live += nb
                peak = max(peak, live)
        return peak


def analyse_cell(cell: Cell) -> Dict:
    """Run one rank's step of `cell` on its fake inputs: flops, bytes
    accessed, output bytes, the peak of its own live bytes and its
    collectives' bytes by kind."""
    from torch.utils.flop_counter import FlopCounterMode
    t0 = time.time()
    from torch.utils._pytree import tree_leaves as leaves
    args = [t for t in leaves(cell.args) if isinstance(t, torch.Tensor)]
    cell.comm.reset()
    with cell.mode:
        mem = StepMemory(args)
        with FlopCounterMode(display=False) as fc, mem.mode:
            out = cell.fn(*cell.args)
        outs = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
        out_ids = mem.storage_ids(outs)
        temp = mem.peak(out_ids)
        alias = sum(_nbytes(t) for t in outs if t.untyped_storage() in mem.ids
                    and mem.ids[t.untyped_storage()] in mem.inputs)
    return {"name": cell.name, "multiplier": 1.0, "flops": float(fc.get_total_flops()),
            "bytes_accessed": float(mem.accessed),
            "memory": {"output_bytes": sum(_nbytes(t) for t in outs), "temp_bytes": temp,
                       "alias_bytes": alias},
            "collective_bytes": dict(cell.comm.bytes), "run_s": time.time() - t0}


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             variant: str = "baseline") -> Dict:
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    mesh = production_mesh_shape(multi_pod=multi_pod)
    ok, reason = supports_shape(cfg, shape)
    if not ok:
        return {"arch": arch_name, "shape": shape_name, "mesh": mesh.name,
                "status": "skipped", "reason": reason}
    cell = make_cell(cfg, shape, mesh, variant=variant)
    part = analyse_cell(cell)
    coll = part["collective_bytes"]
    part["collective_total"] = float(sum(coll.values()))
    part["memory"]["argument_bytes"] = argument_bytes(cell.inputs, cell.specs, mesh)
    mem = part["memory"]
    flops, mem_bytes, coll_total = part["flops"], part["bytes_accessed"], part["collective_total"]

    n_chips = mesh.size
    # model FLOPs (per device): 6·N·D train / 2·N·D forward, MoE uses active N
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        model_flops = 6.0 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:
        model_flops = 2.0 * n_active * shape.global_batch
    model_flops_per_dev = model_flops / n_chips

    compute_s = flops / DEFAULT_HW.peak_flops
    memory_s = mem_bytes / DEFAULT_HW.hbm_bw
    collective_s = coll_total / DEFAULT_HW.ici_bw
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]
    hbm_per_dev = mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
    return {
        "arch": arch_name, "shape": shape_name, "mesh": mesh.name,
        "status": "ok",
        "step": cell.name,
        "chips": n_chips,
        "per_device": {
            "flops": flops, "bytes_accessed": mem_bytes,
            "collective_bytes": coll_total,
            "argument_bytes": mem["argument_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "output_bytes": mem["output_bytes"],
            "hbm_total_bytes": hbm_per_dev,
        },
        "roofline": {
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dominant,
            "model_flops_per_dev": model_flops_per_dev,
            "useful_flops_ratio": (model_flops_per_dev / flops) if flops else 0.0,
        },
        "fits_hbm": bool(hbm_per_dev <= HBM_CAPACITY_BYTES),
        "collective_breakdown": dict(coll),
        "parts": [part],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the port's dry run on fake tensors")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--variant", choices=["baseline", "opt", "opt-zmlp"], default="baseline")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    args = ap.parse_args(argv)

    archs = sorted(DRYRUN_ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results: List[Dict] = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                meshname = production_mesh_shape(multi_pod=mp).name
                if (arch, shape, meshname) in done:
                    continue
                t0 = time.time()
                try:
                    res = run_cell(arch, shape, mp, variant=args.variant)
                except Exception as e:  # a failure here is a bug in the port
                    res = {"arch": arch, "shape": shape, "mesh": meshname,
                           "status": "error", "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                res["wall_s"] = time.time() - t0
                res["variant"] = args.variant
                results.append(res)
                _summ(res)
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    print(f"\nwrote {args.out} ({len(results)} cells)")


def _summ(res: Dict) -> None:
    tag = f"{res['arch']:24s} {res['shape']:12s} {res['mesh']:8s}"
    if res["status"] == "skipped":
        print(f"{tag} SKIP ({res['reason'][:60]}...)")
        return
    if res["status"] == "error":
        print(f"{tag} ERROR {res['error'][:100]}")
        return
    r = res["roofline"]
    pd = res["per_device"]
    print(f"{tag} ok  hbm/dev={pd['hbm_total_bytes']/1e9:6.2f}GB "
          f"compute={r['compute_s']*1e3:8.3f}ms memory={r['memory_s']*1e3:8.3f}ms "
          f"coll={r['collective_s']*1e3:8.3f}ms dom={r['dominant']:10s} "
          f"useful={r['useful_flops_ratio']*100:5.1f}% [{res['wall_s']:.0f}s]")


if __name__ == "__main__":
    main()
