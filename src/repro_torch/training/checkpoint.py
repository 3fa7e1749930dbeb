"""Checkpointing with atomic manifests and auto-resume (counterpart of
`repro.training.checkpoint`, the same layout).

Layout: <dir>/step_<N>/ holds one .npy per leaf (path-encoded) plus a
manifest.json written LAST via atomic rename: a crash mid-save can never
yield a readable-but-torn checkpoint, and restart code simply picks the
largest step whose manifest exists.  This is the training half of the
paper's fault-tolerance story (serving state is covered by KV replication).

numpy has no bfloat16 (and the port needs no ml_dtypes): a bf16 leaf is
saved as its int16 view, with "bfloat16" as its dtype in the manifest, and
restored bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix="") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if hasattr(tree, "_asdict"):  # NamedTuple (AdamWState)
        out = []
        for k, v in tree._asdict().items():
            out.extend(_flatten(v, f"{prefix}{k}/"))
        return out
    return [(prefix[:-1], tree)]


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for path, leaf in _flatten(tree):
        arr, dtype = _to_numpy(leaf)
        fname = path.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"path": path, "file": fname,
                                   "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json.tmp"), "w") as f:
        json.dump(manifest, f)
    os.replace(os.path.join(tmp, "manifest.json.tmp"),
               os.path.join(tmp, "manifest.json"))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(_valid_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def _valid_steps(ckpt_dir: str) -> List[int]:
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                out.append(int(name[5:]))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _valid_steps(ckpt_dir)
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, template, step: Optional[int] = None):
    """Restore into the structure of `template` (nested dicts and
    NamedTuples of tensors): each leaf takes its template's dtype and
    device.  Returns (tree, step)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path: Dict[str, torch.Tensor] = {}
    for leaf in manifest["leaves"]:
        t = torch.from_numpy(np.load(os.path.join(d, leaf["file"])))
        by_path[leaf["path"]] = t.view(torch.bfloat16) if leaf["dtype"] == "bfloat16" else t

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k], f"{prefix}{k}/") for k in tree}
        if hasattr(tree, "_asdict"):
            return type(tree)(**{k: rebuild(v, f"{prefix}{k}/")
                                 for k, v in tree._asdict().items()})
        return by_path[prefix[:-1]].to(device=tree.device, dtype=tree.dtype)

    return rebuild(template), step
