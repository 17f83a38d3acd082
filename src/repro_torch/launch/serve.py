"""Static-batch serving shim, routed through the dense engine, or for the
audio and VLM archs a direct prefill and greedy loop (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch serve --config examples/configs/serve.yaml
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np


def serve_benchmark(model, *, batch: int = 4, prompt_len: int = 32,
                    gen: int = 16, ckpt: str = "", seed: int = 0,
                    params: Any = None, device=None, mesh: Any = None,
                    plan: Any = None,
                    log: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
    """Prefill + greedy-decode ``batch`` requests; returns throughput metrics.

    ``batch`` identical-length greedy requests are admitted at once into
    ``batch`` slots of the dense pool (``block_len=0``).  Every request
    generates ``gen`` tokens: the first comes from the prefill logits
    (counted in ``prefill_s``), the other ``gen - 1`` are decode ticks
    (``decode_tok_s`` covers exactly those).

    The prompts are made with ``numpy.random.default_rng(seed + 1)``, over
    the same range ``[3, vocab)`` as JAX's ``jax.random.randint`` but not
    the same numbers: the two generators differ, so the tests hand both
    packages the same numpy prompts instead.  Params come from
    ``load_params`` unless given: a training checkpoint's params with
    ``ckpt`` (either format), else a seeded ``torch.Generator``; ``device``
    is the card unless the caller asks for the CPU.  ``mesh``/``plan``
    shard the serve exactly like the engine path (JAX's), so an
    engine-vs-shim comparison stays equal-footing.  The audio and VLM
    archs take ``_multimodal_benchmark`` instead of the engine (under a
    plan they raise naming ROADMAP A8b).
    """
    from ..device import resolve_device
    from ..serve.engine import ServeEngine, load_params
    from ..serve.workload import static_trace

    log = log or (lambda msg: print(msg, flush=True))
    cfg = model.cfg
    dev = resolve_device(device)
    if params is None:
        params = load_params(model, ckpt=ckpt, seed=seed, device=dev)
    B, P, G = int(batch), int(prompt_len), int(gen)
    prompts = np.random.default_rng(seed + 1).integers(
        3, cfg.vocab, size=(B, P), dtype=np.int32)
    if cfg.arch_type == "audio" or cfg.n_patches:
        if mesh is not None and plan is not None:
            from ..models.transformer import refuse_mesh

            refuse_mesh(cfg)
        return _multimodal_benchmark(model, params, prompts, G, dev, log)
    # block_len=0 pins the dense slot pool, as in JAX
    engine = ServeEngine(model, params, n_slots=B, max_len=P + G,
                         mesh=mesh, plan=plan, greedy=True, block_len=0)
    out = engine.run(static_trace(prompts, G, seed=seed), realtime=False)

    rows = out["requests"]
    t_prefill, t_decode = out["prefill_s"], out["decode_s"]
    res = {
        "arch": cfg.name,
        "batch": B,
        "prompt_len": P,
        "gen": G,
        "prefill_s": round(t_prefill, 3),
        "prefill_tok_s": int(B * P / max(t_prefill, 1e-9)),
        "decode_s": round(t_decode, 3),
        "decode_steps": G - 1,
        "decode_tokens": out["decode_tokens"],
        "decode_tok_s": out["decode_tok_s"],
        "tpot_ms": out["tpot_ms"],
        "gen_tokens_total": out["generated_tokens"],
        "generated_ids": [r["gen_ids"] for r in rows],
        "generated_ids_0": rows[0]["gen_ids"] if rows else [],
    }
    log(f"prefill: {B}x{P} tokens in {t_prefill:.3f}s "
        f"({res['prefill_tok_s']} tok/s, first token of each request "
        f"sampled here)")
    log(f"decode:  {B}x{G - 1} tokens in {t_decode:.3f}s "
        f"({res['decode_tok_s']} tok/s)")
    log(f"generated ids[0]: {res['generated_ids_0']}")
    return res


def _multimodal_benchmark(model, params, prompts, gen: int, device,
                          log: Callable[[str], None]) -> Dict[str, Any]:
    """The audio and VLM archs' static path (JAX's
    ``_multimodal_benchmark``): the engine's slot scheduler carries no
    modality extras, so one prefill of the whole batch, on zero frames or
    zero patch embeddings, then ``gen - 1`` greedy ticks of
    ``make_serve_step``.  The result has JAX's keys (no ``tpot_ms``), and
    ``prefill_tok_s`` counts the ``B x P`` prompt tokens, as JAX's does.

    Unlike JAX's, the cache holds ``n_patches + P + gen`` rows and the
    ticks decode at positions ``n_patches + P + i``: a VLM's prefill covers
    the patches and the prompt, and JAX's ``P + gen`` rows keep only the
    patches' and decode over them, losing the prompt (ROADMAP C).  Whisper
    has no patches, so for it the two are the same."""
    import time

    import torch

    from ..train import steps as ST

    cfg = model.cfg
    B, P = prompts.shape
    G = int(gen)
    n_pre = cfg.n_patches
    max_len = n_pre + P + G
    batch_in: Dict[str, Any] = {"tokens": torch.as_tensor(
        prompts, dtype=torch.int64, device=device)}
    if cfg.arch_type == "audio":
        batch_in["frames"] = torch.zeros((B, cfg.encoder_frames, cfg.d_model),
                                         device=device)
    if n_pre:
        batch_in["patch_embeds"] = torch.zeros((B, n_pre, cfg.d_model),
                                               device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch_in, max_len=max_len)
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    sync()
    t_prefill = time.perf_counter() - t0

    serve_step = ST.make_serve_step(model)
    generated = [tokens]
    t0 = time.perf_counter()
    for i in range(G - 1):
        pos = torch.full((B,), n_pre + P + i, dtype=torch.int64,
                         device=device)
        tokens, _, cache = serve_step(params, cache, tokens, pos)
        generated.append(tokens)
    sync()
    t_decode = time.perf_counter() - t0
    gen_ids = torch.stack(generated, dim=1).cpu().numpy()

    res = {
        "arch": cfg.name,
        "batch": B,
        "prompt_len": P,
        "gen": G,
        "prefill_s": round(t_prefill, 3),
        "prefill_tok_s": int(B * P / max(t_prefill, 1e-9)),
        "decode_s": round(t_decode, 3),
        "decode_steps": G - 1,
        "decode_tokens": B * (G - 1),
        "decode_tok_s": int(B * (G - 1) / max(t_decode, 1e-9)),
        "gen_tokens_total": B * G,
        "generated_ids": [row.tolist() for row in gen_ids],
        "generated_ids_0": gen_ids[0].tolist(),
    }
    log(f"prefill: {B}x{P} tokens in {t_prefill:.3f}s "
        f"({res['prefill_tok_s']} tok/s)")
    log(f"decode:  {B}x{G - 1} tokens in {t_decode:.3f}s "
        f"({res['decode_tok_s']} tok/s)")
    return res
