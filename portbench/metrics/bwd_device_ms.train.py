"""The card's time in the train step's backward (autograd: the remat
recompute and the SSD's recompute backward included), in ms a step: the
``device/backward`` spans (timing events at the phase's edges, on the host
clock), a mean over the window's steps."""
from portbench.phases import ms_per_step


def read(run):
    return ms_per_step(run, "device/backward")
