"""``ssd_scan``'s share of its roofline in the traced chunk, in %: the
least time its calls could take (``work/ssd.py`` at the cell's shape, bytes
at the HBM rate or operations at the bf16 peak) over the summed device time
of ``ssd_scan.cu``'s three kernels.  A call launches ``ssd_states`` once."""
from portbench.reference.ssm import ssm_dims
from portbench.trace import kernel_time
from portbench.work.peaks import bound_s
from portbench.work.ssd import ssd_work


def read(run):
    prof = run["profile"]
    calls, _ = kernel_time(prof, ("ssd_states",))
    _, t = kernel_time(prof, ("ssd_states", "ssd_pass", "ssd_outputs"))
    if not calls or t <= 0:
        return None
    a, tr = run["cell"]["config"]["arch"], run["cell"]["traffic"]
    s = a["ssm"]
    _, heads, _, _ = ssm_dims(a)
    S = tr["seq_len"]
    one = bound_s(*ssd_work(tr["global_batch"], S, heads, s["head_dim"],
                            s["n_groups"], s["d_state"], min(s["chunk"], S)))
    return 100.0 * calls * one / t
