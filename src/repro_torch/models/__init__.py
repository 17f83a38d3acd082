"""Models of the port (``repro.models`` counterpart)."""
from .base import ArchConfig, MLAConfig, Model, MoEConfig, SSMConfig  # noqa: F401


def build_model(cfg: ArchConfig) -> Model:
    """The model for ``cfg``; the port has the dense, the ssm (Mamba2) and
    the hybrid (Zamba2) decoders so far."""
    kind = "mla" if cfg.mla else cfg.arch_type
    if kind not in ("dense", "ssm", "hybrid") or cfg.n_patches:
        raise NotImplementedError(
            f"{cfg.name}: arch {kind!r} is not ported yet (the port has the "
            f"dense, ssm and hybrid decoders; moe, mla, audio and vlm come "
            f"with ROADMAP A7)")
    from .transformer import DecoderLM

    return DecoderLM(cfg)
