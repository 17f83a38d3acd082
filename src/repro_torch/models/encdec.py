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
from .transformer import (_pad_cache_seq, _residual, _stacked_norm,
                          _with_layer_axis)


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
    def _mesh_inputs(self, params, mesh_ctx, decode: bool = False):
        """Under a mesh: (the params with their unstacked leaves gathered,
        the learned position tables among them, and a gather for each
        layer's leaves in its loop); with no mesh (the params, None).
        ``decode``: no encoder leaf (a decode step reads none)."""
        if mesh_ctx is None or mesh_ctx.mesh is None:
            return params, None
        stacks = ("enc_blocks", "dec_blocks")
        skip = ("enc_blocks", "enc_pos_embed", "enc_norm") if decode else ()
        return ({k: v if k in stacks else B.gather_fsdp(v, mesh_ctx)
                 for k, v in params.items() if k not in skip},
                lambda lp: B.gather_fsdp(lp, mesh_ctx))

    def encode(self, params, frames, mesh_ctx=None):
        """frames ``[B, F, D]`` stub embeddings -> the encoder's states.
        Under a mesh the residual stream is laid out where JAX's
        ``encode`` constrains it (plain frames taken as replicated)."""
        params, gather = self._mesh_inputs(params, mesh_ctx)
        return self._encode(params, frames, mesh_ctx, gather)

    def _encode(self, params, frames, mesh_ctx, gather):
        cfg = self.cfg
        pe = params["enc_pos_embed"]
        x = B.replicate_like(frames, pe).to(self.act_dtype)
        x = B.constrain(x + pe[: x.shape[1]].to(x.dtype), mesh_ctx)

        def body(x, bp):
            x = B.constrain(x, mesh_ctx)
            h = apply_norm(cfg, bp["attn_norm"], x)
            x = _residual(x, A.bidir_forward(cfg, bp["attn"], h), mesh_ctx)
            h = apply_norm(cfg, bp["mlp_norm"], x)
            return B.constrain(x + M.mlp_forward(cfg, bp["mlp"], h), mesh_ctx)

        stack = ST.Stacked(body, cfg.n_encoder_layers, remat=cfg.remat,
                           gather=gather)
        return apply_norm(cfg, params["enc_norm"],
                          stack.fold(params["enc_blocks"], x))

    def _decoder_in(self, params, tokens, mesh_ctx=None):
        table = params["embed"]
        x = embed_lookup(table, B.replicate_like(tokens, table).long(),
                         self.act_dtype)
        x = x + params["pos_embed"][: x.shape[1]].to(x.dtype)
        return B.constrain(x, mesh_ctx)

    def _logits(self, params, x, mesh_ctx=None):
        x = apply_norm(self.cfg, params["final_norm"], x)
        out = torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))
        if mesh_ctx is not None and mesh_ctx.tp_axis is not None:
            out = B.constrain(out, mesh_ctx, None, mesh_ctx.tp_axis)
        return out

    def _dec_body(self, bp, x, self_fn, cross_fn, mesh_ctx):
        """One decoder layer around its self-attention ``self_fn`` (the
        training or prefill forward, or the decode step, returning (out,
        extra)) and its cross-attention ``cross_fn``, then the MLP; returns
        (x, extra).  Under a mesh the residual stream is laid out at the
        layer's ends and the attentions' partial sums over ``model``
        reduced where they meet it (``transformer._residual``)."""
        cfg = self.cfg
        x = B.constrain(x, mesh_ctx)
        h, extra = self_fn(apply_norm(cfg, bp["self_norm"], x))
        x = _residual(x, h, mesh_ctx)
        h = cross_fn(apply_norm(cfg, bp["cross_norm"], x))
        x = _residual(x, h, mesh_ctx)
        h = apply_norm(cfg, bp["mlp_norm"], x)
        return B.constrain(x + M.mlp_forward(cfg, bp["mlp"], h),
                           mesh_ctx), extra

    def apply(self, params, batch, mesh_ctx=None, storage_axes=()):
        """Training forward: (logits ``[B, S, vocab]``, {}).  Under a mesh
        (the params and the batch, ``frames`` with the tokens, DTensors
        laid out by a sharding plan) the unstacked leaves are gathered
        here, each layer's in its loop, and the activations constrained
        where JAX constrains them; the decoder's self-attention runs its
        kernel on each rank's heads, the encoder's and the
        cross-attention the plain path on them."""
        cfg = self.cfg
        params, gather = self._mesh_inputs(params, mesh_ctx)
        enc = self._encode(params, batch["frames"], mesh_ctx, gather)
        x = self._decoder_in(params, batch["tokens"], mesh_ctx)
        positions = torch.arange(x.shape[1], device=x.device)

        def body(x, bp):
            def attend(h):
                return A.gqa_forward(cfg, bp["self_attn"], h, positions), None

            kv = A.cross_kv(cfg, bp["cross_attn"], enc)
            return self._dec_body(
                bp, x, attend,
                lambda h: A.cross_forward(cfg, bp["cross_attn"], h, kv),
                mesh_ctx)[0]

        x = ST.Stacked(body, cfg.n_layers, remat=cfg.remat,
                       gather=gather).fold(params["dec_blocks"], x)
        return self._logits(params, x, mesh_ctx), {}

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
    def prefill_cross(self, params, cache, frames, mesh_ctx=None):
        """Encode ``frames`` and fill the cross-attention K/V of ``cache``
        (under a mesh as DTensors laid out as the encoder's states)."""
        params, gather = self._mesh_inputs(params, mesh_ctx)
        enc = self._encode(params, frames, mesh_ctx, gather)

        def body(_, bp):
            if gather is not None:
                bp = gather(bp)
            return None, A.cross_kv(self.cfg, bp["cross_attn"], enc)

        _, (ks, vs) = ST.layer_loop(body, params["dec_blocks"], None,
                                    self.cfg.n_layers)
        return {**cache, "cross_k": ks.to(cache["cross_k"].dtype),
                "cross_v": vs.to(cache["cross_v"].dtype)}

    @torch.no_grad()
    def prefill(self, params, batch, max_len=None, cache_dtype=torch.bfloat16,
                mesh_ctx=None, storage_axes=()):
        """Encode the frames and run the decoder's prompt: (last-token
        logits ``[B, vocab]``, decode cache).  Under a mesh as ``apply``
        runs; the cache's leaves come back DTensors laid out as the
        activations they were cut from (the serving shim lays them out by
        ``plans.cache_shardings``)."""
        cfg = self.cfg
        params, gather = self._mesh_inputs(params, mesh_ctx)
        enc = self._encode(params, batch["frames"], mesh_ctx, gather)
        x = self._decoder_in(params, batch["tokens"], mesh_ctx)
        S = x.shape[1]
        max_len = max_len or S
        positions = torch.arange(S, device=x.device)

        def body(x, bp):
            if gather is not None:
                bp = gather(bp)

            def attend(h):
                return A.gqa_forward(cfg, bp["self_attn"], h, positions,
                                     return_kv=True)

            ck, cv = A.cross_kv(cfg, bp["cross_attn"], enc)
            x, (k, v) = self._dec_body(
                bp, x, attend,
                lambda h: A.cross_forward(cfg, bp["cross_attn"], h, (ck, cv)),
                mesh_ctx)
            return x, ({"k": _pad_cache_seq(k.to(cache_dtype), max_len, 0),
                        "v": _pad_cache_seq(v.to(cache_dtype), max_len, 0)},
                       ck.to(cache_dtype), cv.to(cache_dtype))

        x, (self_c, cks, cvs) = ST.layer_loop(body, params["dec_blocks"], x,
                                              cfg.n_layers)
        logits = self._logits(params, x[:, -1:], mesh_ctx)[:, 0]
        return logits, {"self": self_c, "cross_k": cks, "cross_v": cvs}

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, positions, mesh_ctx=None):
        """One token for every row: logits ``[B, vocab]``; the self cache is
        updated in place.  Activations follow the cache's dtype, and the
        learned position is read at the position clipped to the table.
        Under a mesh (the cache laid out by ``plans.cache_shardings``) each
        rank attends over its own block of the self and the cross cache
        and writes its own rows of the self cache
        (``attention._mesh_attend``)."""
        cfg = self.cfg
        params, gather = self._mesh_inputs(params, mesh_ctx, decode=True)
        table = params["embed"]
        dtype = cache["cross_k"].dtype
        x = embed_lookup(table, B.replicate_like(tokens, table)[:, None].long(),
                         dtype)
        pe = params["pos_embed"]
        idx = torch.clamp(positions, 0, pe.shape[0] - 1).long()
        x = x + embed_lookup(pe, B.replicate_like(idx, pe), dtype)[:, None, :]

        def body(x, inp):
            bp, sc, ck, cv = inp
            if gather is not None:
                bp = gather(bp)

            def attend(h):
                return A.gqa_decode(cfg, bp["self_attn"], sc, h, positions)

            def cross(h):
                return A.cross_decode(cfg, bp["cross_attn"], h, ck, cv)

            return self._dec_body(bp, x, attend, cross, mesh_ctx)[0], None

        # a decode step reads no cross K/V projection (its K/V are cached):
        # ``jax.jit`` prunes them, and a dryrun counts no bytes for them
        blocks = params["dec_blocks"]
        blocks = {**blocks, "cross_attn": {
            k: v for k, v in blocks["cross_attn"].items()
            if k in ("wq", "bq", "wo")}}
        x, _ = ST.layer_loop(body, (blocks, cache["self"], cache["cross_k"],
                                    cache["cross_v"]), x, cfg.n_layers)
        return self._logits(params, x, mesh_ctx)[:, 0], cache
