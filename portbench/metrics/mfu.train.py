"""Model FLOPs of the window's steps (``work/model_flops.py``: every
weight at every application, plus the attention's products) over the
window's seconds at the card's bf16 peak, in %."""
from portbench.work.model_flops import flops_per_step
from portbench.work.peaks import PEAK_FLOPS_BF16


def read(run):
    w, cell = run["window"], run["cell"]
    tr = cell["traffic"]
    if w["seconds"] <= 0:
        return None
    flops = w["steps"] * flops_per_step(cell["config"]["arch"],
                                        tr["global_batch"], tr["seq_len"])
    return 100.0 * flops / (w["seconds"] * PEAK_FLOPS_BF16)
