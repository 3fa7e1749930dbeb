"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source under ``csrc/`` becomes one shared library with a plain C
interface, compiled for ``sm_90a`` at first use into ``build/repro_torch/``
at the root of the checkout.  A library's file name carries a hash of its
source, the headers under ``csrc/`` and the flags, so an edited source or
header rebuilds and an unchanged one loads.
All sources compile in parallel, one nvcc each.  A failed build raises with
nvcc's stderr.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("kv_pack", "decode_attention", "flash_attention", "ssd_scan", "paged_prefill")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}

_vp, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ip = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "kv_pack": {
        "repro_kv_pack": (_i, [_vp, _vp, _vp, _i, _i, _i, _ll, _ll, _ll, _i, _i, _vp]),
        "repro_kv_pack_max_rows": (_i, []),
        "repro_kv_unpack": (_i, [_vp, _vp, _i, _i, _i, _ll, _ll, _ll, _i, _i, _vp]),
    },
    "decode_attention": {
        "repro_batched_decode_attention": (
            _i, [_i, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _f, _i,
                 _vp]),
        "repro_decode_split_plan": (_ll, [_i, _i, _i, _i, _i, _i, _ip, _ip]),
        "repro_decode_attention": (
            _i, [_i, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _f, _i, _vp]),
        "repro_paged_decode_attention": (
            _i, [_i, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _ll, _i, _i, _i, _f, _vp]),
    },
    "flash_attention": {
        "repro_flash_attention": (
            _i, [_i, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _f, _vp]),
        "repro_flash_attention_smem": (_ll, [_i, _i]),
    },
    "ssd_scan": {
        "repro_ssd_scan": (
            _i, [_i, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _vp]),
        "repro_ssd_scan_smem": (_ll, [_i, _i, _i, _i]),
    },
    "paged_prefill": {
        "repro_paged_prefill_attention": (
            _i, [_i, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _ll, _i, _i, _i, _f,
                 _vp]),
        "repro_paged_prefill_smem": (_ll, [_i, _i]),
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME and /usr/local/cuda)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):      # what a source may include
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (res, args) in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype, f.argtypes = res, args
    return lib


def build_all() -> Dict[str, str]:
    """Compile every source that has no current library, all at once, and
    load them.  Returns nvcc's output (the -Xptxas -v register and shared
    memory report) per source built in this call."""
    with _lock:
        todo: List[str] = [n for n in SOURCES if n not in _libs]
        procs = {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name in todo:
            path = _lib_path(name)
            if path.exists():
                continue
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True),
                           tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, err = proc.communicate()
            _logs[name] = out + err
            if proc.returncode != 0:
                failed.append(f"nvcc failed for csrc/{name}.cu:\n{err}")
                continue
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in todo:
            _libs[name] = _bind(name, _lib_path(name))
        return {n: _logs[n] for n in procs}


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it on first use."""
    if name not in _libs:
        build_all()
    return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
