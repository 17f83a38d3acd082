"""Faults planted under the timed path, for the tests and the calibration
(never in a benchmark run).  Each takes the gym after its set-up and breaks
what its train step does."""
from __future__ import annotations

import torch


def unchanged(gym) -> None:
    """A step that returns its state unchanged: the optimizer writes
    nothing."""
    gym.optimizer.update = lambda grads, state, params: (params, state)


def half_batch(gym) -> None:
    """Half of the batch left out, the mean taken over the rest."""
    step = gym._step

    def halved(state, batch):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    gym._step = halved


def leaf_unmoved(gym, leaf: str = "embed") -> None:
    """An answer altered where it is produced: the step's update of one
    leaf is lost (the leaf keeps its old values)."""
    update = gym.optimizer.update

    def lost(grads, state, params):
        before = params[leaf].detach().clone()
        params, state = update(grads, state, params)
        with torch.no_grad():
            params[leaf].copy_(before)
        return params, state

    gym.optimizer.update = lost


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "leaf_unmoved": leaf_unmoved}
