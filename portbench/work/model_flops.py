"""Model FLOPs of one training step, counted from the configuration alone
by the architecture's reference module (``reference/<arch_type>.py``,
``flops_per_token``): 6·N·D with every weight counted at every
application, plus whatever products that architecture adds.
Recomputation (remat) is not counted."""
from ..reference import model


def flops_per_token(arch, seq_len: int) -> float:
    return model(arch).flops_per_token(arch, seq_len)


def flops_per_step(arch, global_batch: int, seq_len: int) -> float:
    return flops_per_token(arch, seq_len) * global_batch * seq_len
