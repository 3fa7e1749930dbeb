"""Dense MLP blocks: gated (SiLU) and plain (GELU / squared-ReLU)."""
from __future__ import annotations

from repro_torch.models.common import activation_fn, dense_init


def mlp_init(generator, cfg, dtype, device):
    d, ff = cfg.d_model, cfg.d_ff
    names = ("w_gate", "w_up", "w_down") if cfg.activation == "silu" else ("w_up", "w_down")
    return {n: dense_init(generator, (ff, d) if n == "w_down" else (d, ff), dtype, device)
            for n in names}


def mlp_apply(x, p, cfg):
    act = activation_fn(cfg.activation)
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = act(x @ p["w_up"])
    return h @ p["w_down"]
