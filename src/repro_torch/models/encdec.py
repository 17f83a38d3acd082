"""Encoder-decoder backbone, Whisper-style (port of ``repro.models.encdec``;
arXiv:2212.04356).

The audio frontend (mel spectrogram and conv downsampling) is a stub, as in
the JAX package: the batch carries precomputed frame embeddings ``frames
[B, F, d_model]``.  The backbone is a bidirectional encoder and a causal
decoder with cross-attention, pre-LN, learned positions on both sides.  The
decoder's self-attention also applies rope on top of its learned positions,
as the reference does, and with ``cfg.use_flash_kernel`` its prefill goes
through the flash kernel like every decoder's; the encoder's and the cross
attention take the plain path, as in JAX.

Params keep JAX's tree (``embed``, ``pos_embed``, ``enc_pos_embed``,
``enc_blocks``, ``enc_norm``, ``dec_blocks``, ``final_norm``; blocks stacked
on a leading layer axis), so ``repro_torch.bridge`` copies them key for
key.  The decode cache is ``self`` (per-layer K/V stacked on L) and the
cross-attention's ``cross_k``/``cross_v``, filled once per request.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import attention as A
from . import base as B
from . import mlp as M
from . import stacked as ST
from .common import (apply_norm, embed_init, embed_lookup, norm_axes,
                     norm_params)
from .transformer import _pad_cache_seq, _stacked_norm, _with_layer_axis


def _init_enc_block(cfg, gen, lead):
    return {
        "attn_norm": _stacked_norm(cfg, gen, lead),
        "attn": A.init_gqa(cfg, gen, lead),
        "mlp_norm": _stacked_norm(cfg, gen, lead),
        "mlp": M.init_mlp(cfg, gen, lead=lead),
    }


def _init_dec_block(cfg, gen, lead):
    return {
        "self_norm": _stacked_norm(cfg, gen, lead),
        "self_attn": A.init_gqa(cfg, gen, lead),
        "cross_norm": _stacked_norm(cfg, gen, lead),
        "cross_attn": A.init_gqa(cfg, gen, lead),
        "mlp_norm": _stacked_norm(cfg, gen, lead),
        "mlp": M.init_mlp(cfg, gen, lead=lead),
    }


def _enc_block_axes(cfg):
    return {
        "attn_norm": norm_axes(cfg),
        "attn": A.gqa_axes(cfg),
        "mlp_norm": norm_axes(cfg),
        "mlp": M.mlp_axes(cfg),
    }


def _dec_block_axes(cfg):
    return {
        "self_norm": norm_axes(cfg),
        "self_attn": A.gqa_axes(cfg),
        "cross_norm": norm_axes(cfg),
        "cross_attn": A.gqa_axes(cfg),
        "mlp_norm": norm_axes(cfg),
        "mlp": M.mlp_axes(cfg),
    }


class EncDecLM(B.Model):
    """Encoder-decoder LM: the ``audio`` arch."""

    #: activation dtype (tests and the chip's checks set f32 on an instance)
    act_dtype = torch.bfloat16

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random params on ``gen.device``, f32, in JAX's tree layout."""
        cfg = self.cfg
        return {
            "embed": embed_init(gen, (cfg.vocab, cfg.d_model)),
            "pos_embed": embed_init(gen, (cfg.max_positions, cfg.d_model)),
            "enc_pos_embed": embed_init(gen, (cfg.encoder_frames,
                                              cfg.d_model)),
            "enc_blocks": ST.stack_init(
                lambda g, lead: _init_enc_block(cfg, g, lead), gen,
                cfg.n_encoder_layers),
            "enc_norm": norm_params(cfg, gen.device),
            "dec_blocks": ST.stack_init(
                lambda g, lead: _init_dec_block(cfg, g, lead), gen,
                cfg.n_layers),
            "final_norm": norm_params(cfg, gen.device),
        }

    def param_axes(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "embed": (B.VOCAB, B.D_MODEL),
            "pos_embed": (None, B.D_MODEL),
            "enc_pos_embed": (None, B.D_MODEL),
            "enc_blocks": _with_layer_axis(_enc_block_axes(cfg)),
            "enc_norm": norm_axes(cfg),
            "dec_blocks": _with_layer_axis(_dec_block_axes(cfg)),
            "final_norm": norm_axes(cfg),
        }

    # -- forward pieces ------------------------------------------------------
    def encode(self, params, frames):
        """frames ``[B, F, D]`` stub embeddings -> the encoder's states."""
        cfg = self.cfg
        x = frames.to(self.act_dtype)
        x = x + params["enc_pos_embed"][: x.shape[1]].to(x.dtype)

        def body(x, bp):
            h = apply_norm(cfg, bp["attn_norm"], x)
            x = x + A.bidir_forward(cfg, bp["attn"], h)
            h = apply_norm(cfg, bp["mlp_norm"], x)
            return x + M.mlp_forward(cfg, bp["mlp"], h)

        stack = ST.Stacked(body, cfg.n_encoder_layers, remat=cfg.remat)
        return apply_norm(cfg, params["enc_norm"],
                          stack.fold(params["enc_blocks"], x))

    def _decoder_in(self, params, tokens):
        x = embed_lookup(params["embed"], tokens.long(), self.act_dtype)
        return x + params["pos_embed"][: x.shape[1]].to(x.dtype)

    def _logits(self, params, x):
        x = apply_norm(self.cfg, params["final_norm"], x)
        return torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))

    def apply(self, params, batch):
        """Training forward: (logits ``[B, S, vocab]``, {})."""
        cfg = self.cfg
        enc = self.encode(params, batch["frames"])
        x = self._decoder_in(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)

        def body(x, bp):
            h = apply_norm(cfg, bp["self_norm"], x)
            x = x + A.gqa_forward(cfg, bp["self_attn"], h, positions)
            h = apply_norm(cfg, bp["cross_norm"], x)
            kv = A.cross_kv(cfg, bp["cross_attn"], enc)
            x = x + A.cross_forward(cfg, bp["cross_attn"], h, kv)
            h = apply_norm(cfg, bp["mlp_norm"], x)
            return x + M.mlp_forward(cfg, bp["mlp"], h)

        x = ST.Stacked(body, cfg.n_layers,
                       remat=cfg.remat).fold(params["dec_blocks"], x)
        return self._logits(params, x), {}

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch, max_len, dtype=torch.bfloat16, device=None):
        cfg = self.cfg
        one = A.gqa_init_cache(cfg, batch, max_len, dtype, device)
        L = cfg.n_layers
        K, dh = cfg.n_kv_heads, cfg.head_dim_
        cross = (L, batch, cfg.encoder_frames, K, dh)
        return {
            "self": {k: torch.zeros((L,) + tuple(v.shape), dtype=v.dtype,
                                    device=v.device) for k, v in one.items()},
            # the cross-attention's K/V, computed once a request by
            # ``prefill_cross``; zeros here for the shape
            "cross_k": torch.zeros(cross, dtype=dtype, device=device),
            "cross_v": torch.zeros(cross, dtype=dtype, device=device),
        }

    @torch.no_grad()
    def prefill_cross(self, params, cache, frames):
        """Encode ``frames`` and fill the cross-attention K/V of ``cache``."""
        enc = self.encode(params, frames)

        def body(_, bp):
            return None, A.cross_kv(self.cfg, bp["cross_attn"], enc)

        _, (ks, vs) = ST.layer_loop(body, params["dec_blocks"], None,
                                    self.cfg.n_layers)
        return {**cache, "cross_k": ks.to(cache["cross_k"].dtype),
                "cross_v": vs.to(cache["cross_v"].dtype)}

    @torch.no_grad()
    def prefill(self, params, batch, max_len=None, cache_dtype=torch.bfloat16):
        """Encode the frames and run the decoder's prompt: (last-token
        logits ``[B, vocab]``, decode cache)."""
        cfg = self.cfg
        enc = self.encode(params, batch["frames"])
        x = self._decoder_in(params, batch["tokens"])
        S = x.shape[1]
        max_len = max_len or S
        positions = torch.arange(S, device=x.device)

        def body(x, bp):
            h = apply_norm(cfg, bp["self_norm"], x)
            h, (k, v) = A.gqa_forward(cfg, bp["self_attn"], h, positions,
                                      return_kv=True)
            x = x + h
            h = apply_norm(cfg, bp["cross_norm"], x)
            ck, cv = A.cross_kv(cfg, bp["cross_attn"], enc)
            x = x + A.cross_forward(cfg, bp["cross_attn"], h, (ck, cv))
            h = apply_norm(cfg, bp["mlp_norm"], x)
            x = x + M.mlp_forward(cfg, bp["mlp"], h)
            return x, ({"k": _pad_cache_seq(k.to(cache_dtype), max_len, 0),
                        "v": _pad_cache_seq(v.to(cache_dtype), max_len, 0)},
                       ck.to(cache_dtype), cv.to(cache_dtype))

        x, (self_c, cks, cvs) = ST.layer_loop(body, params["dec_blocks"], x,
                                              cfg.n_layers)
        logits = self._logits(params, x[:, -1:])[:, 0]
        return logits, {"self": self_c, "cross_k": cks, "cross_v": cvs}

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, positions):
        """One token for every row: logits ``[B, vocab]``; the self cache is
        updated in place.  Activations follow the cache's dtype, and the
        learned position is read at the position clipped to the table."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], tokens[:, None].long(),
                         cache["cross_k"].dtype)
        pe = params["pos_embed"]
        idx = torch.clamp(positions, 0, pe.shape[0] - 1).long()
        x = x + pe[idx].to(x.dtype)[:, None, :]

        def body(x, inp):
            bp, sc, ck, cv = inp
            h = apply_norm(cfg, bp["self_norm"], x)
            h, _ = A.gqa_decode(cfg, bp["self_attn"], sc, h, positions)
            x = x + h
            h = apply_norm(cfg, bp["cross_norm"], x)
            x = x + A.cross_forward(cfg, bp["cross_attn"], h, (ck, cv))
            h = apply_norm(cfg, bp["mlp_norm"], x)
            return x + M.mlp_forward(cfg, bp["mlp"], h), None

        x, _ = ST.layer_loop(body, (params["dec_blocks"], cache["self"],
                                    cache["cross_k"], cache["cross_v"]), x,
                             cfg.n_layers)
        return self._logits(params, x)[:, 0], cache
