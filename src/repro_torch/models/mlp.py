"""Dense MLP blocks (gated-SiLU / GELU), port of ``repro.models.mlp``."""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from . import base as B
from .common import act_fn, dense_init


def init_mlp(cfg: B.ArchConfig, gen: torch.Generator, d_ff: int = 0,
             lead=()) -> Dict[str, Any]:
    """``lead`` prepends stacked dims (``(L,)`` for a layer stack)."""
    D = cfg.d_model
    F_ = d_ff or cfg.d_ff
    lead = tuple(lead)
    p = {
        "w_up": dense_init(gen, lead + (D, F_), D),
        "w_down": dense_init(gen, lead + (F_, D), F_),
    }
    if cfg.act == "silu":  # gated
        p["w_gate"] = dense_init(gen, lead + (D, F_), D)
    return p


def mlp_axes(cfg: B.ArchConfig) -> Dict[str, Any]:
    p = {"w_up": (B.D_MODEL, B.D_FF), "w_down": (B.D_FF, B.D_MODEL)}
    if cfg.act == "silu":
        p["w_gate"] = (B.D_MODEL, B.D_FF)
    return p


def mlp_forward(cfg: B.ArchConfig, p, x):
    up = torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype))
    if cfg.act == "silu":
        gate = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(x.dtype))
        h = F.silu(gate) * up
    else:
        h = act_fn(cfg.act)(up)
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(x.dtype))
