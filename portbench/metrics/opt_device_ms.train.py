"""The card's time in the train step's optimizer update (AdamW), in ms a
step: the ``device/optimizer`` spans (timing events at the phase's edges,
on the host clock), a mean over the window's steps."""
from portbench.phases import ms_per_step


def read(run):
    return ms_per_step(run, "device/optimizer")
