"""Decoder-only LM (port of ``repro.models.transformer``), dense blocks only.

This slice carries the static-batch greedy serving path: ``prefill`` /
``prefill_into`` for admission and the dense ``decode_step`` for each tick.
Params keep the JAX tree (``embed``, ``final_norm``, stacked ``blocks``), so
``repro_torch.bridge`` copies JAX params in key for key.  MoE, MLA, SSM,
hybrid, audio and VLM blocks, and the paged cache, come with later slices.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import attention as A
from . import base as B
from . import mlp as M
from . import stacked as ST
from .common import apply_norm, embed_init, norm_params

_STACK = "blocks"   # the one homogeneous dense stack, as named in JAX


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------
def init_dense_block(cfg: B.ArchConfig, gen: torch.Generator, lead=()):
    lead = tuple(lead)
    norm = lambda: {k: v.expand(lead + v.shape).clone()  # noqa: E731
                    for k, v in norm_params(cfg, gen.device).items()}
    return {
        "attn_norm": norm(),
        "attn": A.init_gqa(cfg, gen, lead),
        "mlp_norm": norm(),
        "mlp": M.init_mlp(cfg, gen, lead=lead),
    }


def decode_block(cfg, p, cache, x, positions):
    h = apply_norm(cfg, p["attn_norm"], x)
    h, new_cache = A.gqa_decode(cfg, p["attn"], cache, h, positions)
    x = x + h
    h = apply_norm(cfg, p["mlp_norm"], x)
    return x + M.mlp_forward(cfg, p["mlp"], h), new_cache


def _pad_cache_seq(k, max_len, window):
    """k [B,S,...] -> cache layout [B,L,...] (ring-packed when windowed),
    padded with zeros."""
    S = k.shape[1]
    if window and window > 0:
        L = min(max_len, window)
        take = min(S, L)
        tail = k[:, S - take:]
        if S <= L:
            slots = torch.arange(take, device=k.device)
        else:
            slots = torch.arange(S - take, S, device=k.device) % L
        out = torch.zeros((k.shape[0], L) + tuple(k.shape[2:]), dtype=k.dtype,
                          device=k.device)
        out[:, slots] = tail
        return out
    if S >= max_len:
        return k[:, :max_len]
    out = torch.zeros((k.shape[0], max_len) + tuple(k.shape[2:]), dtype=k.dtype,
                      device=k.device)
    out[:, :S] = k
    return out


def prefill_block(cfg, p, x, positions, max_len, cache_dtype):
    """One dense layer of prefill; also returns its decode-ready cache."""
    h = apply_norm(cfg, p["attn_norm"], x)
    h, (k, v) = A.gqa_forward(cfg, p["attn"], h, positions, return_kv=True)
    cache = {
        "k": _pad_cache_seq(k.to(cache_dtype), max_len, cfg.window),
        "v": _pad_cache_seq(v.to(cache_dtype), max_len, cfg.window),
    }
    x = x + h
    h = apply_norm(cfg, p["mlp_norm"], x)
    return x + M.mlp_forward(cfg, p["mlp"], h), cache


class DecoderLM(B.Model):
    """Decoder-only language model; this slice serves ``dense`` archs."""

    def __init__(self, cfg: B.ArchConfig):
        if cfg.arch_type != "dense" or cfg.mla or cfg.n_patches:
            raise NotImplementedError(
                f"{cfg.name}: the port serves dense decoder blocks only so "
                f"far (arch_type {cfg.arch_type!r})")
        super().__init__(cfg)

    # -- params --------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random params on ``gen.device``, f32, in the JAX tree layout."""
        cfg = self.cfg
        p: Dict[str, Any] = {
            "embed": embed_init(gen, (cfg.vocab, cfg.d_model)),
            "final_norm": norm_params(cfg, gen.device),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab))
        p[_STACK] = ST.stack_init(
            lambda g, lead: init_dense_block(cfg, g, lead), gen, cfg.n_layers)
        return p

    # -- forward pieces ------------------------------------------------------
    def logits(self, params, x):
        cfg = self.cfg
        x = apply_norm(cfg, params["final_norm"], x)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))

    def embed_tokens(self, params, tokens, dtype=torch.bfloat16):
        # gather, then cast: the same numbers as JAX's cast-then-gather,
        # without casting the whole [vocab, D] table every call
        return params["embed"][tokens].to(dtype)

    # -- serving -------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, batch, max_len=None, cache_dtype=torch.bfloat16):
        """Run the full prompt, returning (last-token logits, decode cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self.embed_tokens(params, tokens)
        S = x.shape[1]
        max_len = max_len or S
        positions = torch.arange(S, device=x.device)

        def body(x, lp):
            return prefill_block(cfg, lp, x, positions, max_len, cache_dtype)

        x, cs = ST.layer_loop(body, params[_STACK], x, cfg.n_layers)
        logits = self.logits(params, x[:, -1:])[:, 0]
        return logits, {_STACK: cs}

    def prefill_into(self, params, batch, cache, slot, max_len=None,
                     cache_dtype=torch.bfloat16):
        """Prefill one batch=1 request into slot ``slot`` of a slot-pool
        cache; returns ``(last-token logits [1, vocab], pool cache)``."""
        logits, req_cache = self.prefill(params, batch, max_len=max_len,
                                         cache_dtype=cache_dtype)
        return logits, self.insert_cache(cache, req_cache, slot)

    def init_cache(self, batch, max_len, dtype=torch.bfloat16, device=None):
        one = A.gqa_init_cache(self.cfg, batch, max_len, dtype, device)
        L = self.cfg.n_layers
        return {_STACK: {k: torch.zeros((L,) + tuple(v.shape), dtype=v.dtype,
                                        device=v.device)
                         for k, v in one.items()}}

    def supports_paged_cache(self) -> bool:
        """The paged cache comes with the paged-engine slice."""
        return False

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, positions):
        """One token for every slot: logits [B, vocab]; the cache is updated
        in place and returned."""
        cfg = self.cfg
        x = self.embed_tokens(params, tokens[:, None])

        def body(x, inp):
            lp, lc = inp
            x, _ = decode_block(cfg, lp, lc, x, positions)
            return x, None

        x, _ = ST.layer_loop(body, (params[_STACK], cache[_STACK]), x,
                             cfg.n_layers)
        return self.logits(params, x)[:, 0], cache
