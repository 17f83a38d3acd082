"""The card's time in the SSD scan's recompute backward, in ms a step: the
``device/ssd_backward`` spans (timing events at the edges of each call,
inside the step's backward, on the host clock) summed over a step, a mean
over the window's steps."""
from portbench.phases import ms_per_step


def read(run):
    return ms_per_step(run, "device/ssd_backward")
