"""The card's time in the train step's forward (the model's apply and the
cross entropy), in ms a step: the ``device/forward`` spans (timing events
at the phase's edges, on the host clock), a mean over the window's steps."""
from portbench.phases import ms_per_step


def read(run):
    return ms_per_step(run, "device/forward")
