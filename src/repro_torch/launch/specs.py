"""Input stand-ins for every (arch × input-shape) pair (port of
``repro.launch.specs``): ``meta`` tensors with JAX's shapes and dtypes
where JAX has ``ShapeDtypeStruct``s — no device memory, and a plan lays
them out like real inputs."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..configs.shapes import InputShape
from ..models import base as B

I32 = torch.int32
BF16 = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Numeric policy, addressable from YAML (``precision`` component)."""

    bf16_params: bool = False   # train: bf16 weights + f32 master copies
    serve_bf16: bool = False    # serve/decode: weights kept in bf16


def sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype`` (JAX's
    ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def adapt_config(cfg: B.ArchConfig, shape: InputShape) -> B.ArchConfig:
    """Shape-specific config tweaks (e.g. sliding window for long-context
    decode on full-attention archs)."""
    if shape.name == "long_500k" and cfg.arch_type in ("dense", "vlm"):
        return cfg.with_(window=8192)
    return cfg


def supports_shape(cfg: B.ArchConfig, shape: InputShape) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.arch_type == "audio":
        return False, (
            "enc-dec with fixed encoder frames and a short decoder context has "
            "no 524k-token decode regime (noted skip in DESIGN.md)"
        )
    return True, ""


def input_specs(cfg: B.ArchConfig, shape: InputShape,
                model=None) -> Dict[str, Any]:
    """Inputs for the step function that `shape.kind` lowers."""
    Bg, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {}
        s_text = S
        if cfg.n_patches:
            s_text = S - cfg.n_patches
            batch["patch_embeds"] = sds((Bg, cfg.n_patches, cfg.d_model), BF16)
        if cfg.arch_type == "audio":
            batch["frames"] = sds((Bg, cfg.encoder_frames, cfg.d_model),
                                  torch.float32)
        batch["tokens"] = sds((Bg, s_text), I32)
        if shape.kind == "train":
            batch["labels"] = sds((Bg, s_text), I32)
        return {"batch": batch}
    # decode: one new token against a seq_len cache
    assert model is not None
    cache = model.init_cache(Bg, S, dtype=BF16, device="meta")
    return {
        "cache": cache,
        "tokens": sds((Bg,), I32),
        "positions": sds((Bg,), I32),
    }
