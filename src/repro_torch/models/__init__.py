"""Models of the port (``repro.models`` counterpart)."""
from .base import ArchConfig, MLAConfig, Model, MoEConfig, SSMConfig  # noqa: F401

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def unported(cfg: ArchConfig) -> str:
    """Why ``cfg`` cannot be built (an arch type the repo does not have),
    or ``""``."""
    if cfg.arch_type in ARCH_TYPES:
        return ""
    return (f"{cfg.name}: arch {cfg.arch_type!r}: the port has no such "
            f"model (arch types {', '.join(ARCH_TYPES)})")


def build_model(cfg: ArchConfig) -> Model:
    """The model for ``cfg``: ``EncDecLM`` for the ``audio`` arch, else
    ``DecoderLM`` (dense, MoE with MLA and MTP, ssm, hybrid, and vlm with
    its patch prefix)."""
    why = unported(cfg)
    if why:
        raise NotImplementedError(why)
    if cfg.arch_type == "audio":
        from .encdec import EncDecLM

        return EncDecLM(cfg)
    from .transformer import DecoderLM

    return DecoderLM(cfg)
