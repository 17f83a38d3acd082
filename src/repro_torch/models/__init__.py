"""Models of the port (``repro.models`` counterpart)."""
from .base import ArchConfig, MLAConfig, Model, MoEConfig, SSMConfig  # noqa: F401


def unported(cfg: ArchConfig) -> str:
    """Why ``cfg`` cannot be built yet (its ROADMAP item), or ``""``."""
    if cfg.arch_type == "audio":
        item = "the encoder-decoder comes with ROADMAP A7.5"
    elif cfg.arch_type == "vlm" or cfg.n_patches:
        item = "the VLM patch prefix comes with ROADMAP A7.6"
    elif cfg.arch_type not in ("dense", "moe", "ssm", "hybrid"):
        item = "the port has no such decoder"
    else:
        return ""
    return (f"{cfg.name}: arch {cfg.arch_type!r} is not ported yet: {item} "
            f"(the port has the dense, moe, ssm and hybrid decoders)")


def build_model(cfg: ArchConfig) -> Model:
    """The model for ``cfg``: the dense, MoE (MLA and MTP included), ssm
    (Mamba2) and hybrid (Zamba2) decoders."""
    why = unported(cfg)
    if why:
        raise NotImplementedError(why)
    from .transformer import DecoderLM

    return DecoderLM(cfg)
