"""Models of the port (``repro.models`` counterpart)."""
from .base import ArchConfig, MLAConfig, Model, MoEConfig, SSMConfig  # noqa: F401


def build_model(cfg: ArchConfig) -> Model:
    """The model for ``cfg``; this slice ports the dense decoder only."""
    kind = "mla" if cfg.mla else cfg.arch_type
    if kind != "dense" or cfg.n_patches:
        raise NotImplementedError(
            f"{cfg.name}: arch {kind!r} is not ported yet (the port serves "
            f"dense decoders; moe, mla, ssm, hybrid, audio and vlm come in "
            f"later slices)")
    from .transformer import DecoderLM

    return DecoderLM(cfg)
