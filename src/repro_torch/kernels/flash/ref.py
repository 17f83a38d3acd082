"""Plain PyTorch version of the flash-attention kernel (port of
``repro.kernels.flash.ref``): scores materialised, f32 softmax.

The wrapper in ``ops.py`` takes it for tensors that lie on the CPU, the
tests hold it against the JAX kernel, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q [B, Sq, H, dh]; k/v [B, Skv, K, dh] (GQA: H = K·G). fp32 softmax."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    Skv = k.shape[1]
    G = H // K
    qg = q.reshape(B, Sq, K, G, dh).float() / math.sqrt(dh)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    pos_q = torch.arange(Sq, device=q.device)[:, None]
    pos_k = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (pos_q >= pos_k)
    if window > 0:
        mask = mask & (pos_q - pos_k < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, Sq, H, dh).to(q.dtype)
