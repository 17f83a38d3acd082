"""Decoder-only LM (port of ``repro.models.transformer``): dense, MoE
(leading dense layers, then shared + routed experts), SSM (Mamba2) and
hybrid (Zamba2: Mamba2 layers with one weight-shared attention block after
every ``attn_every - 1`` of them) stacks; attention is GQA, or MLA where
``cfg.mla`` is set (DeepSeek-V3), whose ``cfg.mtp`` adds the depth-1
multi-token-prediction head (``p["mtp"]``, its loss ``aux["mtp"]``).
The ``vlm`` arch is the dense stack behind a prefix of stub image-patch
embeddings (``batch["patch_embeds"] [B, n_patches, D]``), which ``apply``
and ``prefill`` put in front of the token embeddings.

Training runs ``apply`` (embed, the ``Stacked`` fold with its remat policy,
logits).  Serving has two cache layouts: the dense slot pool (``prefill`` /
``prefill_into`` for admission, ``decode_step`` for each tick) and, for
dense and MoE full-context attention, the paged block pool
(``init_paged_cache``, ``prefill_chunk`` for admission in fixed-shape
chunks, ``decode_step`` with ``pages``/``active`` for each tick).  Params
keep the JAX tree (``embed``, ``final_norm``, one stacked tree per
homogeneous stack: ``blocks`` for dense layers, ``dense_blocks`` and
``moe_blocks`` for a MoE arch with leading dense layers, ``ssm_blocks`` for
Mamba2 layers, for the hybrid one unstacked ``shared_attn`` dense block,
and with MTP the unstacked ``mtp`` head), so ``repro_torch.bridge`` copies
JAX params in key for key.  The ``audio`` arch is ``encdec.EncDecLM``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import attention as A
from . import base as B
from . import mlp as M
from . import moe as MOE
from . import ssm as S
from . import stacked as ST
from .common import (apply_norm, embed_init, embed_lookup, norm_axes,
                     norm_params, sharded_cross_entropy)


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------
def _layer_kind(cfg: B.ArchConfig, i: int) -> str:
    if cfg.arch_type == "ssm":
        return "ssm"
    if cfg.arch_type == "hybrid":
        return "attn_block" if (i + 1) % cfg.attn_every == 0 else "ssm"
    if cfg.arch_type == "moe" and i >= cfg.moe.n_dense_layers:
        return "moe_block"
    return "dense_block"


def _stacked_norm(cfg, gen, lead):
    return {k: v.expand(lead + v.shape).clone()
            for k, v in norm_params(cfg, gen.device).items()}


def _init_attn(cfg, gen, lead):
    return (A.init_mla if cfg.mla else A.init_gqa)(cfg, gen, lead)


def _attn_axes(cfg):
    return A.mla_axes(cfg) if cfg.mla else A.gqa_axes(cfg)


def init_dense_block(cfg: B.ArchConfig, gen: torch.Generator, lead=()):
    lead = tuple(lead)
    return {
        "attn_norm": _stacked_norm(cfg, gen, lead),
        "attn": _init_attn(cfg, gen, lead),
        "mlp_norm": _stacked_norm(cfg, gen, lead),
        "mlp": M.init_mlp(cfg, gen, lead=lead),
    }


def init_moe_block(cfg: B.ArchConfig, gen: torch.Generator, lead=()):
    lead = tuple(lead)
    return {
        "attn_norm": _stacked_norm(cfg, gen, lead),
        "attn": _init_attn(cfg, gen, lead),
        "mlp_norm": _stacked_norm(cfg, gen, lead),
        "moe": MOE.init_moe(cfg, gen, lead),
    }


def init_ssm_block(cfg: B.ArchConfig, gen: torch.Generator, lead=()):
    lead = tuple(lead)
    return {"norm": _stacked_norm(cfg, gen, lead),
            "ssm": S.init_ssm(cfg, gen, lead)}


_INIT_BY_KIND = {"dense_block": init_dense_block, "moe_block": init_moe_block,
                 "ssm": init_ssm_block}


def dense_block_axes(cfg: B.ArchConfig):
    return {
        "attn_norm": norm_axes(cfg),
        "attn": _attn_axes(cfg),
        "mlp_norm": norm_axes(cfg),
        "mlp": M.mlp_axes(cfg),
    }


def moe_block_axes(cfg: B.ArchConfig):
    return {
        "attn_norm": norm_axes(cfg),
        "attn": _attn_axes(cfg),
        "mlp_norm": norm_axes(cfg),
        "moe": MOE.moe_axes(cfg),
    }


def ssm_block_axes(cfg: B.ArchConfig):
    return {"norm": norm_axes(cfg), "ssm": S.ssm_axes(cfg)}


def _with_layer_axis(axes_tree):
    """Prepend the stacked-layer axis to every leaf's axis tuple."""
    if isinstance(axes_tree, dict):
        return {k: _with_layer_axis(v) for k, v in axes_tree.items()}
    return (B.LAYER,) + tuple(axes_tree)


_AXES_BY_KIND = {"dense_block": dense_block_axes,
                 "moe_block": moe_block_axes, "ssm": ssm_block_axes}


def _ffn(cfg, kind, p, h, mesh_ctx=None, storage_axes=()):
    """The block's feed-forward half on the normed ``h``: (out, stats),
    stats the MoE layer's router statistics ``[2, E]``
    (``moe.route_stats``), None for a dense MLP."""
    if kind == "moe_block":
        return MOE.moe_layer(cfg, p["moe"], h, mesh_ctx, storage_axes)
    return M.mlp_forward(cfg, p["mlp"], h), None


def apply_block(cfg, kind, p, x, positions, mesh_ctx=None, storage_axes=(),
                stats=False):
    """Residual block of the training forward; returns (x, aux).  ``aux``
    is the router balance loss of MoE blocks over the tokens of ``x``, zero
    for the others; with ``stats`` a MoE block returns its router
    statistics instead (``moe.route_stats``), which the pipelined backbone
    sums over microbatches.  Under a mesh the residual stream is laid out
    by ``constrain`` where JAX constrains it: batch over the dp axes,
    replicated over ``model``."""
    x = B.constrain(x, mesh_ctx)
    zero = B.replicate_like(torch.zeros((), dtype=torch.float32,
                                        device=x.device), x)
    if kind == "ssm":
        return x + S.ssm_forward(cfg, p["ssm"],
                                 apply_norm(cfg, p["norm"], x)), zero
    h = apply_norm(cfg, p["attn_norm"], x)
    attn = A.mla_forward if cfg.mla else A.gqa_forward
    x = _residual(x, attn(cfg, p["attn"], h, positions), mesh_ctx)
    h, st = _ffn(cfg, kind, p, apply_norm(cfg, p["mlp_norm"], x), mesh_ctx,
                 storage_axes)
    x = B.constrain(x + h, mesh_ctx)
    if st is None:
        return x, zero
    if stats:
        return x, st
    return x, MOE.balance_loss(cfg, st, x.shape[0] * x.shape[1])


def _residual(x, h, mesh_ctx):
    """``x + h`` after attention.  Under tensor parallelism ``h`` is a
    partial sum over the ``model`` axis (the output projection contracts
    the sharded heads), and DTensor would carry the sum as ``Partial``
    through the norm's linear steps into the MLP, where it then gathers
    the MLP's weights over ``model`` rather than reduce the activations:
    every rank would run the whole MLP.  So the sum is reduced here, as
    XLA reduces it before the norm (JAX constrains only the block's
    ends)."""
    if mesh_ctx is None or mesh_ctx.tp_axis is None:
        return x + h
    return B.constrain(x + h, mesh_ctx)


def decode_block(cfg, kind, p, cache, x, positions, mesh_ctx=None,
                 storage_axes=()):
    """One layer of decode; the cache is updated in place.  Under a mesh
    the residual stream is laid out as in ``apply_block`` (the partial sums
    of TP reduced where they meet it) and the MoE's experts run as in
    training, through ``moe_ep`` where the plan has EP."""
    x = B.constrain(x, mesh_ctx)
    if kind == "ssm":
        h, new_cache = S.ssm_decode(cfg, p["ssm"], cache,
                                    apply_norm(cfg, p["norm"], x))
        return _residual(x, h, mesh_ctx), new_cache
    h = apply_norm(cfg, p["attn_norm"], x)
    if cfg.mla:
        h, new_cache = A.mla_decode(cfg, p["attn"], cache, h, positions,
                                    absorb=cfg.mla_absorb)
    else:
        h, new_cache = A.gqa_decode(cfg, p["attn"], cache, h, positions)
    x = _residual(x, h, mesh_ctx)
    h, _ = _ffn(cfg, kind, p, apply_norm(cfg, p["mlp_norm"], x), mesh_ctx,
                storage_axes)
    return B.constrain(x + h, mesh_ctx), new_cache


def decode_block_paged(cfg, kind, p, cache, x, positions, pages, active,
                       mesh_ctx=None, storage_axes=()):
    """``decode_block`` reading/writing K/V through page tables."""
    x = B.constrain(x, mesh_ctx)
    h = apply_norm(cfg, p["attn_norm"], x)
    if cfg.mla:
        h, new_cache = A.mla_decode_paged(cfg, p["attn"], cache, h, positions,
                                          pages, active, absorb=cfg.mla_absorb)
    else:
        h, new_cache = A.gqa_decode_paged(cfg, p["attn"], cache, h, positions,
                                          pages, active)
    x = _residual(x, h, mesh_ctx)
    h, _ = _ffn(cfg, kind, p, apply_norm(cfg, p["mlp_norm"], x), mesh_ctx,
                storage_axes)
    return B.constrain(x + h, mesh_ctx), new_cache


def prefill_chunk_block(cfg, kind, p, cache, x, positions, pages_row, n_valid,
                        mesh_ctx=None, storage_axes=()):
    """One layer of the fixed-shape chunked-prefill program."""
    x = B.constrain(x, mesh_ctx)
    h = apply_norm(cfg, p["attn_norm"], x)
    chunk = A.mla_prefill_chunk if cfg.mla else A.gqa_prefill_chunk
    h, new_cache = chunk(cfg, p["attn"], cache, h, positions, pages_row,
                         n_valid)
    x = _residual(x, h, mesh_ctx)
    h, _ = _ffn(cfg, kind, p, apply_norm(cfg, p["mlp_norm"], x), mesh_ctx,
                storage_axes)
    return B.constrain(x + h, mesh_ctx), new_cache


def _pad_cache_seq(k, max_len, window):
    """k [B,S,...] -> cache layout [B,L,...] (ring-packed when windowed),
    padded with zeros.  A DTensor (prefill under a mesh: the sequence dim
    is not sharded) is padded block by block."""
    if B.is_dtensor(k):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(_pad_cache_seq(k.to_local(), max_len,
                                                 window),
                                  k.device_mesh, k.placements,
                                  run_check=False)
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


def prefill_block(cfg, kind, p, x, positions, max_len, cache_dtype,
                  mesh_ctx=None, storage_axes=()):
    """One layer of prefill; also returns its decode-ready cache.  Under a
    mesh the residual stream is laid out as in ``apply_block``."""
    x = B.constrain(x, mesh_ctx)
    if kind == "ssm":
        h, st = S.ssm_forward(cfg, p["ssm"], apply_norm(cfg, p["norm"], x),
                              return_state=True)
        return x + h, st
    h = apply_norm(cfg, p["attn_norm"], x)
    if cfg.mla:
        h, (c_kv, k_rope) = A.mla_forward(cfg, p["attn"], h, positions,
                                          return_latent=True)
        cache = {
            "c_kv": _pad_cache_seq(c_kv.to(cache_dtype), max_len, 0),
            "k_rope": _pad_cache_seq(k_rope.to(cache_dtype), max_len, 0),
        }
    else:
        h, (k, v) = A.gqa_forward(cfg, p["attn"], h, positions,
                                  return_kv=True)
        cache = {
            "k": _pad_cache_seq(k.to(cache_dtype), max_len, cfg.window),
            "v": _pad_cache_seq(v.to(cache_dtype), max_len, cfg.window),
        }
    x = _residual(x, h, mesh_ctx)
    h, _ = _ffn(cfg, kind, p, apply_norm(cfg, p["mlp_norm"], x), mesh_ctx,
                storage_axes)
    return B.constrain(x + h, mesh_ctx), cache


def init_cache_block(cfg, kind, batch, max_len, dtype, device=None):
    if kind == "ssm":
        return S.ssm_init_state(cfg, batch, device=device)
    if cfg.mla:
        return A.mla_init_cache(cfg, batch, max_len, dtype, device)
    return A.gqa_init_cache(cfg, batch, max_len, dtype, device)


class DecoderLM(B.Model):
    """Decoder-only language model: ``dense``, ``moe``, ``ssm``,
    ``hybrid`` and ``vlm`` archs."""

    def __init__(self, cfg: B.ArchConfig):
        from . import unported

        why = unported(cfg)
        if why or cfg.arch_type == "audio":
            raise NotImplementedError(
                why or f"{cfg.name}: the audio arch is an encoder-decoder "
                f"(build_model gives its EncDecLM)")
        super().__init__(cfg)
        self.kinds = [_layer_kind(cfg, i) for i in range(cfg.n_layers)]

    # -- structure -----------------------------------------------------------
    def _stacks(self):
        """(name, kind, layer indices) of each homogeneous stack; dense and
        ssm archs have one, and so has the hybrid: its Mamba2 layers (the
        shared attention block is one unstacked tree).  A MoE arch with
        leading dense layers has two, ``dense_blocks`` then
        ``moe_blocks``."""
        cfg = self.cfg
        if cfg.arch_type == "hybrid":
            return [("ssm_blocks", "ssm",
                     [i for i, k in enumerate(self.kinds) if k == "ssm"])]
        if cfg.arch_type == "moe" and cfg.moe.n_dense_layers:
            nd = cfg.moe.n_dense_layers
            return [("dense_blocks", "dense_block", list(range(nd))),
                    ("moe_blocks", "moe_block", list(range(nd, cfg.n_layers)))]
        kind = self.kinds[0]
        name = {"dense_block": "blocks", "moe_block": "moe_blocks",
                "ssm": "ssm_blocks"}[kind]
        return [(name, kind, list(range(cfg.n_layers)))]

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
        for name, kind, idxs in self._stacks():
            init = _INIT_BY_KIND[kind]
            p[name] = ST.stack_init(lambda g, lead, init=init: init(cfg, g, lead),
                                    gen, len(idxs))
        if cfg.arch_type == "hybrid":
            p["shared_attn"] = init_dense_block(cfg, gen)
        if cfg.mtp:
            p["mtp"] = {
                "proj": embed_init(gen, (2 * cfg.d_model, cfg.d_model)),
                "block": init_dense_block(cfg, gen),
                "norm": norm_params(cfg, gen.device),
            }
        return p

    def param_axes(self) -> Dict[str, Any]:
        """Logical axis names of every leaf (JAX's ``param_axes``): stacked
        leaves lead with :data:`~repro_torch.models.base.LAYER`, the
        hybrid's ``shared_attn`` block does not."""
        cfg = self.cfg
        p: Dict[str, Any] = {
            "embed": (B.VOCAB, B.D_MODEL),
            "final_norm": norm_axes(cfg),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = (B.D_MODEL, B.VOCAB)
        for name, kind, _ in self._stacks():
            p[name] = _with_layer_axis(_AXES_BY_KIND[kind](cfg))
        if cfg.arch_type == "hybrid":
            p["shared_attn"] = dense_block_axes(cfg)
        if cfg.mtp:
            p["mtp"] = {
                "proj": (B.D_MODEL, B.D_MODEL),
                "block": dense_block_axes(cfg),
                "norm": norm_axes(cfg),
            }
        return p

    def _hybrid_groups(self):
        """(groups, layers a group): the hybrid runs ``attn_every - 1``
        Mamba2 layers, then the shared block, ``groups`` times."""
        seg = self.cfg.attn_every - 1
        return len(self._stacks()[0][2]) // seg, seg

    # -- training forward ------------------------------------------------------
    def _scan_stack(self, stack_params, kind, x, positions, n_layers,
                    shared_attn=None, force_group=None, mesh_ctx=None,
                    storage_axes=(), stats=None):
        """Fold over layer groups of ``cfg.scan_block_size`` (or
        ``force_group``) with the arch's remat policy (JAX's
        ``_scan_stack``); returns (x, summed aux).  With ``shared_attn`` the
        weight-shared dense block runs after each group, inside its remat
        wrap, so the backward recomputes it too.  Under a mesh each layer's
        FSDP shards are gathered in the loop (``B.gather_fsdp``); the
        shared block comes in gathered once, outside the fold
        (:meth:`_gathered`), so no recompute gathers it again, its uses'
        gradients add up in that one gathered tree, and the gather's
        backward reduce-scatters their sum once.  With
        ``stats`` (a ``[n, 2, E]`` shift register) each MoE layer's router
        statistics go in at its end and the oldest row out, and the
        register comes back in place of the aux."""
        cfg = self.cfg
        register = stats is not None

        def body(carry, lp):
            x, aux = carry
            x, a = apply_block(cfg, kind, lp, x, positions, mesh_ctx,
                               storage_axes, stats=register)
            if register:
                return x, torch.cat([aux[1:], a[None]])
            return x, aux + a

        def tail(carry):
            x, aux = carry
            x, _ = apply_block(cfg, "dense_block", shared_attn, x, positions,
                               mesh_ctx)
            return x, aux

        stack = ST.Stacked(body, n_layers,
                           block_size=force_group or cfg.scan_block_size,
                           remat=cfg.remat,
                           tail=tail if shared_attn is not None else None,
                           gather=(None if mesh_ctx is None
                                   or mesh_ctx.mesh is None else
                                   lambda lp: B.gather_fsdp(lp, mesh_ctx)))
        if not register:
            stats = B.replicate_like(torch.zeros(
                (), dtype=torch.float32, device=x.device), x)
        return stack.fold(stack_params, (x, stats))

    def backbone(self, params, x, positions, mesh_ctx=None, storage_axes=()):
        """Every stack in layer order; returns (x, summed aux).  The hybrid
        folds its Mamba2 layers in groups of ``attn_every - 1`` with the
        shared block as each group's tail.  With ``mesh_ctx.pp > 1`` the
        stacks run the GPipe schedule (:meth:`_backbone_pipelined`)."""
        if mesh_ctx is not None and mesh_ctx.pp > 1:
            if self.cfg.arch_type == "hybrid":
                raise ValueError(
                    "pipeline parallelism does not compose with the "
                    "weight-shared hybrid stack; use an unpipelined plan")
            return self._backbone_pipelined(params, x, positions, mesh_ctx,
                                            storage_axes)
        if self.cfg.arch_type == "hybrid":
            n_groups, seg = self._hybrid_groups()
            return self._scan_stack(params["ssm_blocks"], "ssm", x, positions,
                                    n_groups * seg,
                                    shared_attn=params["shared_attn"],
                                    force_group=seg, mesh_ctx=mesh_ctx,
                                    storage_axes=storage_axes)
        aux_total = None
        for name, kind, idxs in self._stacks():
            x, aux = self._scan_stack(params[name], kind, x, positions,
                                      len(idxs), mesh_ctx=mesh_ctx,
                                      storage_axes=storage_axes)
            aux_total = aux if aux_total is None else aux_total + aux
        return x, aux_total

    def _backbone_pipelined(self, params, x, positions, mesh_ctx,
                            storage_axes=()):
        """GPipe the backbone (JAX's ``_backbone_pipelined``): each stack's
        layers in ``mesh_ctx.pp`` stages, the batch in M microbatches
        (``effective_n_micro``), each stage body the :class:`Stacked` fold
        over its layers with remat, ``scan_block_size`` and the FSDP
        gather.  Stage-local without a pipe group (``mesh_ctx.pipe``); with
        one, each rank runs its stage on its local block of the stacked
        leaves, laid out on the stage's submesh, so the stage body's A8a
        code (``constrain``, ``gather_fsdp``, ``local_call``) runs unchanged.
        Heterogeneous stacks (a dense prelude, then MoE) are pipelined one
        after another.

        The router balance loss is not JAX's: JAX sums each microbatch's
        Switch loss, which is not the whole batch's (ROADMAP C8).  Here each
        MoE layer's router statistics ride the carry and are summed over the
        microbatches, and the loss is formed once from the whole batch's,
        so it equals the unpipelined one up to the order of f32 sums."""
        from ..sharding import pipeline as PIPE

        cfg = self.cfg
        n_stages = mesh_ctx.pp
        stacks = self._stacks()
        for name, _, idxs in stacks:
            if len(idxs) % n_stages:
                raise ValueError(
                    f"stack {name!r} has {len(idxs)} layers — not divisible "
                    f"into pp={n_stages} stages")
        pipe = mesh_ctx.pipe
        stage_ctx = mesh_ctx.stage_context()
        n_micro = PIPE.effective_n_micro(mesh_ctx.n_micro, n_stages,
                                         x.shape[0])
        n_tokens = x.shape[0] * x.shape[1]
        aux = B.replicate_like(torch.zeros((), dtype=torch.float32,
                                           device=x.device), x)
        for name, kind, idxs in stacks:
            per_stage = len(idxs) // n_stages
            carry = {"x": PIPE.enter(x, n_micro, pipe)}
            if kind == "moe_block":
                zeros = torch.zeros((n_micro, len(idxs), 2, cfg.moe.n_routed),
                                    dtype=torch.float32, device=x.device)
                carry["stats"] = B.replicate_like(zeros, carry["x"])
            if pipe is None:
                staged = PIPE.stage_split(params[name], n_stages)
            else:
                staged = PIPE.local_stage(params[name], pipe)

            def stage_fn(sp, c, kind=kind, per_stage=per_stage):
                xx, st = self._scan_stack(sp, kind, c["x"], positions,
                                          per_stage, mesh_ctx=stage_ctx,
                                          storage_axes=storage_axes,
                                          stats=c.get("stats"))
                return {"x": xx, "stats": st} if "stats" in c else {"x": xx}

            carry = PIPE.pipeline_apply(stage_fn, staged, carry, pipe)
            x = PIPE.leave(carry["x"], pipe)
            if "stats" in carry:
                stats = PIPE.leave(carry["stats"], pipe, merge=False).sum(0)
                for layer in range(len(idxs)):
                    aux = aux + MOE.balance_loss(cfg, stats[layer], n_tokens)
        return x, aux

    def apply(self, params, batch, mesh_ctx=None, storage_axes=()):
        """Training forward: (logits [B, S, vocab], {"router_lb": aux}),
        and with an MTP head and ``labels`` in the batch also ``"mtp"``,
        its loss.

        Activations are bf16 (``embed_tokens``); with tied embeddings the
        table takes gradient from both uses, the gather and the logits.
        A VLM batch's ``patch_embeds`` go in front of the tokens, so the
        logits cover ``n_patches + S`` rows (``compute_loss`` drops the
        patches' rows).

        Under a mesh (``mesh_ctx``, the params and the batch DTensors laid
        out by a sharding plan) every arch runs the same code on DTensors:
        the unstacked leaves are gathered here (the hybrid's shared block
        among them), each layer's in the loop, and the activations
        constrained where JAX constrains them; a VLM's ``patch_embeds``
        are laid out with the tokens (``plans.batch_shardings``).
        ``storage_axes`` are the mesh axes the experts' ``d_model`` dim is
        stored sharded over (the EP plans' ``ep_storage_axes``).
        """
        if mesh_ctx is not None and mesh_ctx.mesh is not None:
            params = self._gathered(params, mesh_ctx,
                                    mtp="labels" in batch)
        x = self._with_patches(batch, self.embed_tokens(
            params, batch["tokens"].long()))
        x = B.constrain(x, mesh_ctx)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = self.backbone(params, x, positions, mesh_ctx, storage_axes)
        aux_d = {"router_lb": aux}
        if self.cfg.mtp and "labels" in batch:
            aux_d["mtp"] = self._mtp_loss(params, x, batch, positions,
                                          mesh_ctx)
        return self.logits(params, x, mesh_ctx), aux_d

    def _mtp_loss(self, params, h, batch, positions, mesh_ctx=None):
        """DeepSeek-V3's depth-1 MTP head (JAX's ``_mtp_loss``): the
        backbone's output normed by the head's own norm (before the final
        norm), beside the embeddings of ``labels`` (token t+1), projected
        and run through one dense block; the shared logits head predicts
        token t+2, ``roll(labels, -1)``, its last column masked.  Under a
        mesh the block and the logits run as the backbone's do (the head's
        leaves gathered with the other unstacked ones in ``apply``), the
        logits' vocab over ``model``, and the loss is
        ``sharded_cross_entropy``'s (``softmax_cross_entropy`` where the
        vocab is whole), replicated."""
        cfg = self.cfg
        mp = params["mtp"]
        labels = batch["labels"].long()
        emb_next = self.embed_tokens(params, labels)
        z = torch.cat([apply_norm(cfg, mp["norm"], h), emb_next], dim=-1)
        z = torch.einsum("bse,ed->bsd", z, mp["proj"].to(h.dtype))
        z, _ = apply_block(cfg, "dense_block", mp["block"], z, positions,
                           mesh_ctx)
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
        mask[:, -1] = 0.0
        if B.is_dtensor(labels):
            # the roll as the two slices it is (the sequence is whole on
            # every rank), the mask laid out as the labels
            labels2 = torch.cat([labels[:, 1:], labels[:, :1]], dim=1)
            mask = B.replicate_like(mask, labels).redistribute(
                labels.device_mesh, labels.placements)
        else:
            labels2 = torch.roll(labels, -1, dims=1)
        if "loss_mask" in batch:
            mask = mask * batch["loss_mask"]
        loss = sharded_cross_entropy(self.logits(params, z, mesh_ctx),
                                     labels2, mask)
        if B.is_dtensor(loss):
            # the masked mean comes back a partial sum where ``ce`` (no
            # mask) is a partial mean, and DTensor adds the two only once
            # one of them is whole
            loss = B.replicate(loss)
        return loss

    # -- forward pieces ------------------------------------------------------
    def _with_patches(self, batch, x):
        """``batch["patch_embeds"]``, cast to the activations' dtype, in
        front of the token embeddings ``x`` when the arch has patches and
        the batch carries them (JAX's ``apply`` and ``prefill``).  Under a
        mesh plain patches (the serving shim's) are taken as replicated."""
        if self.cfg.n_patches and "patch_embeds" in batch:
            patches = B.replicate_like(batch["patch_embeds"], x)
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        return x

    def logits(self, params, x, mesh_ctx=None):
        cfg = self.cfg
        x = apply_norm(cfg, params["final_norm"], x)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        out = torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))
        if mesh_ctx is not None and mesh_ctx.tp_axis is not None:
            out = B.constrain(out, mesh_ctx, None, mesh_ctx.tp_axis)
        return out

    def embed_tokens(self, params, tokens, dtype=torch.bfloat16):
        """The token embeddings in ``dtype`` (``common.embed_lookup``)."""
        return embed_lookup(params["embed"], tokens, dtype)

    # -- serving -------------------------------------------------------------
    def _serve_inputs(self, params, tokens, mesh_ctx):
        """Under a mesh: the params with their unstacked leaves gathered
        (:meth:`_gathered`, no MTP head), a gather for each layer's, and
        ``tokens`` a DTensor (replicated when the caller's are plain: the
        engine keeps its slot state on every rank).  With no mesh: the
        params, no gather, the tokens."""
        if mesh_ctx is None or mesh_ctx.mesh is None:
            return params, None, tokens
        params = self._gathered(params, mesh_ctx, mtp=False)
        return (params, lambda lp: B.gather_fsdp(lp, mesh_ctx),
                B.replicate_like(tokens, params["embed"]))

    def _gathered(self, params, mesh_ctx, mtp: bool):
        """The params with their unstacked leaves gathered
        (``B.gather_fsdp``), the stacks left for the layer loop's gather;
        the MTP head only where it runs (``mtp``), as a step that never
        reads it never gathers it (``jax.jit`` prunes such an argument)."""
        stacks = {name for name, _, _ in self._stacks()}
        return {k: v if k in stacks else B.gather_fsdp(v, mesh_ctx)
                for k, v in params.items() if mtp or k != "mtp"}

    @torch.no_grad()
    def prefill(self, params, batch, max_len=None, cache_dtype=torch.bfloat16,
                mesh_ctx=None, storage_axes=()):
        """Run the full prompt, returning (last-token logits, decode cache).
        A VLM batch's patches come first: the cache then holds ``n_patches
        + S`` rows, and decoding goes on at position ``n_patches + S``.

        Under a mesh (``mesh_ctx``, the params and the batch DTensors laid
        out by a sharding plan) every arch runs as in ``apply``: unstacked
        leaves gathered here, each layer's in the loop; the MoE's experts
        as in ``apply``.  A plan's pipe axis plays no part: prefill runs
        the layers in order (as JAX's)."""
        cfg = self.cfg
        params, gather, tokens = self._serve_inputs(params, batch["tokens"],
                                                    mesh_ctx)
        x = self._with_patches(batch, self.embed_tokens(params, tokens))
        x = B.constrain(x, mesh_ctx)
        S = x.shape[1]
        max_len = max_len or S
        positions = torch.arange(S, device=x.device)
        if cfg.arch_type == "hybrid":
            x, cache = self._prefill_hybrid(params, x, positions, max_len,
                                            cache_dtype, gather, mesh_ctx)
            return self.logits(params, x[:, -1:], mesh_ctx)[:, 0], cache
        cache: Dict[str, Any] = {}
        for name, kind, idxs in self._stacks():

            def body(x, lp, kind=kind):
                if gather is not None:
                    lp = gather(lp)
                return prefill_block(cfg, kind, lp, x, positions, max_len,
                                     cache_dtype, mesh_ctx, storage_axes)

            x, cache[name] = ST.layer_loop(body, params[name], x, len(idxs))
            if not idxs:
                # a stack cut to no layers (DeepSeek-V3 at its dense
                # depth): its cache has no rows, as JAX's scan gives it
                one = init_cache_block(cfg, kind, x.shape[0], max_len,
                                       cache_dtype, x.device)
                cache[name] = {k: v.new_zeros((0,) + tuple(v.shape))
                               for k, v in one.items()}
        logits = self.logits(params, x[:, -1:], mesh_ctx)[:, 0]
        return logits, cache

    def _prefill_hybrid(self, params, x, positions, max_len, cache_dtype,
                        gather=None, mesh_ctx=None):
        """Each group's Mamba2 layers, then the shared block, whose K/V of
        this use go to row ``g`` of the ``shared_attn`` cache ``[n_attn, B,
        max_len, K, dh]`` (JAX's ``_prefill_hybrid``).  Under a mesh each
        Mamba2 layer's params are gathered as it runs (``gather``), the
        shared block's came gathered (:meth:`_serve_inputs`)."""
        cfg = self.cfg
        n_groups, seg = self._hybrid_groups()
        ssm_c, attn_c = [], []
        for g in range(n_groups):
            for i in range(seg):
                lp = ST.take_layer(params["ssm_blocks"], g * seg + i)
                if gather is not None:
                    lp = gather(lp)
                x, c = prefill_block(cfg, "ssm", lp, x, positions, max_len,
                                     cache_dtype, mesh_ctx)
                ssm_c.append(c)
            x, c = prefill_block(cfg, "dense_block", params["shared_attn"], x,
                                 positions, max_len, cache_dtype, mesh_ctx)
            attn_c.append(c)
        return x, {"ssm_blocks": ST.stack_layers(ssm_c),
                   "shared_attn": ST.stack_layers(attn_c)}

    def prefill_into(self, params, batch, cache, slot, max_len=None,
                     cache_dtype=torch.bfloat16, mesh_ctx=None,
                     storage_axes=()):
        """Prefill one batch=1 request into slot ``slot`` of a slot-pool
        cache; returns ``(last-token logits [1, vocab], pool cache)``.  Under
        a mesh the request's cache is written on the rank whose block of
        the pool holds the slot (``base.put_slot``)."""
        logits, req_cache = self.prefill(params, batch, max_len=max_len,
                                         cache_dtype=cache_dtype,
                                         mesh_ctx=mesh_ctx,
                                         storage_axes=storage_axes)
        return logits, self.insert_cache(cache, req_cache, slot)

    def init_cache(self, batch, max_len, dtype=torch.bfloat16, device=None):
        """One stacked cache tree per stack: K/V for dense layers, the f32
        (conv, ssm) state for ssm layers, and for the hybrid the K/V of
        each use of the shared block (JAX's ``init_cache``)."""
        cfg = self.cfg
        cache: Dict[str, Any] = {}
        stacks = [(name, kind, len(idxs)) for name, kind, idxs
                  in self._stacks()]
        if cfg.arch_type == "hybrid":
            stacks.append(("shared_attn", "dense_block",
                           self.kinds.count("attn_block")))
        for name, kind, n in stacks:
            one = init_cache_block(cfg, kind, batch, max_len, dtype, device)
            cache[name] = {k: torch.zeros((n,) + tuple(v.shape),
                                          dtype=v.dtype, device=v.device)
                           for k, v in one.items()}
        return cache

    def supports_paged_cache(self) -> bool:
        """Paged serving needs every decode layer to be full-context
        attention over an append-only KV stream: sliding windows re-use
        ring positions (a page would need rewriting after sharing) and SSM
        state is a dense recurrence with no token axis to page."""
        cfg = self.cfg
        return (cfg.arch_type in ("dense", "moe") and cfg.window == 0
                and not cfg.n_patches)

    def init_paged_cache(self, n_blocks, block_len, dtype=torch.bfloat16,
                         device=None):
        """One stacked block pool per stack, every leaf ``[L, n_blocks + 1,
        block_len, ...]``: the allocator's ``n_blocks`` pages and the
        scratch block that takes suppressed writes (``attention.py``)."""
        cfg = self.cfg
        if not self.supports_paged_cache():
            raise NotImplementedError(
                f"{cfg.name}: paged KV cache needs full-context attention "
                f"layers (arch {cfg.arch_type}, window {cfg.window})")
        cache: Dict[str, Any] = {}
        for name, kind, idxs in self._stacks():
            one = (A.mla_init_paged_cache if cfg.mla
                   else A.gqa_init_paged_cache)(cfg, n_blocks, block_len,
                                                dtype, device)
            cache[name] = {k: torch.zeros((len(idxs),) + tuple(v.shape),
                                          dtype=v.dtype, device=v.device)
                           for k, v in one.items()}
        return cache

    @torch.no_grad()
    def prefill_chunk(self, params, cache, pages_row, tokens, start: int,
                      n_valid: int, mesh_ctx=None, storage_axes=()):
        """Run one fixed-shape prompt chunk into a request's pages.

        ``tokens`` [C] (entries past ``n_valid`` are padding, zeroed by the
        caller), ``start`` the absolute position of ``tokens[0]``,
        ``pages_row`` int32 [max_pages] this request's physical block ids.
        Returns (logits of the last valid row [1, vocab], the cache updated
        in place) — the logits only matter on an admission's final chunk.
        Under a mesh each rank writes the rows its block of the pool holds
        (``attention._mesh_attend``).
        """
        cfg = self.cfg
        params, gather, tokens = self._serve_inputs(params, tokens, mesh_ctx)
        x = self.embed_tokens(params, tokens[None])
        x = B.constrain(x, mesh_ctx)
        positions = start + torch.arange(tokens.shape[0], device=x.device)
        for name, kind, idxs in self._stacks():

            def body(x, inp, kind=kind):
                lp, lc = inp
                if gather is not None:
                    lp = gather(lp)
                x, _ = prefill_chunk_block(cfg, kind, lp, lc, x, positions,
                                           pages_row, n_valid, mesh_ctx,
                                           storage_axes)
                return x, None

            x, _ = ST.layer_loop(body, (params[name], cache[name]), x,
                                 len(idxs))
        last = x[:, n_valid - 1]                                 # [1, D]
        return self.logits(params, last[:, None], mesh_ctx)[:, 0], cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, positions, mesh_ctx=None,
                    pages=None, active=None, storage_axes=()):
        """One token for every slot: logits [B, vocab]; the cache is updated
        in place and returned.  With ``pages`` (int32 [B, max_pages]) the
        cache is the block pool, read and written through the page tables;
        ``active`` suppresses the writes of dead slots.

        Under a mesh (``mesh_ctx``; the params laid out by a plan, the cache
        by ``plans.cache_shardings``) the same code runs on DTensors, as
        ``prefill`` does, and each rank reads and writes only its own block
        of the cache; the logits come back a DTensor, the vocab dim over
        ``model`` under TP."""
        cfg = self.cfg
        params, gather, tokens = self._serve_inputs(params, tokens, mesh_ctx)
        x = B.constrain(self.embed_tokens(params, tokens[:, None]), mesh_ctx)
        if cfg.arch_type == "hybrid" and pages is None:
            x = self._decode_hybrid(params, cache, x, positions, gather,
                                    mesh_ctx)
            return self.logits(params, x, mesh_ctx)[:, 0], cache
        for name, kind, idxs in self._stacks():

            def body(x, inp, kind=kind):
                lp, lc = inp
                if gather is not None:
                    lp = gather(lp)
                if pages is not None:
                    x, _ = decode_block_paged(cfg, kind, lp, lc, x, positions,
                                              pages, active, mesh_ctx,
                                              storage_axes)
                else:
                    x, _ = decode_block(cfg, kind, lp, lc, x, positions,
                                        mesh_ctx, storage_axes)
                return x, None

            x, _ = ST.layer_loop(body, (params[name], cache[name]), x,
                                 len(idxs))
        return self.logits(params, x, mesh_ctx)[:, 0], cache

    def _decode_hybrid(self, params, cache, x, positions, gather=None,
                       mesh_ctx=None):
        """One token through each group's Mamba2 layers and the shared
        block, with that use's K/V cache (JAX's ``_decode_hybrid``); the
        cache is updated in place.  Under a mesh as :meth:`_prefill_hybrid`
        runs, each rank on its own block of the cache: row ``g`` of the
        ``shared_attn`` leaves, laid out by ``plans.cache_shardings``, is
        use ``g``'s (``attention._mesh_attend``)."""
        cfg = self.cfg
        n_groups, seg = self._hybrid_groups()
        for g in range(n_groups):
            for i in range(seg):
                li = g * seg + i
                lp = ST.take_layer(params["ssm_blocks"], li)
                if gather is not None:
                    lp = gather(lp)
                x, _ = decode_block(cfg, "ssm", lp,
                                    ST.take_layer(cache["ssm_blocks"], li),
                                    x, positions, mesh_ctx)
            x, _ = decode_block(cfg, "dense_block", params["shared_attn"],
                                ST.take_layer(cache["shared_attn"], g), x,
                                positions, mesh_ctx)
        return x
