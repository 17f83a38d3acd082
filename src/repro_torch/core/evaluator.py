"""Evaluation components (port of ``repro.core.evaluator``): held-out
perplexity over a dataset slice, pluggable into the gym's ``eval_fn`` hook
or runnable on its own."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..train.steps import compute_loss
from ..tree import tree_leaves


@dataclasses.dataclass
class PerplexityEvaluator:
    dataset: Any                 # ChunkedLMDataset-like
    n_samples: int = 16
    offset: Optional[int] = None  # default: tail of the dataset
    batch: int = 4
    # the loss function, built once per model: one (model, fn) pair, as in
    # JAX, so an evaluator pins no model it no longer serves
    _fn_for: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def _loss_fn(self, model) -> Callable:
        if self._fn_for is None or self._fn_for[0] is not model:
            @torch.no_grad()
            def fn(params, batch):
                return compute_loss(model, params, batch)[0]

            self._fn_for = (model, fn)
        return self._fn_for[1]

    def __call__(self, model, params) -> Dict[str, float]:
        n = len(self.dataset)
        start = self.offset if self.offset is not None else max(
            0, n - self.n_samples)
        fn = self._loss_fn(model)
        device = tree_leaves(params)[0].device
        # each batch's mean loss weighted by its sample count, so a ragged
        # final batch is not over-weighted (every sample holds seq_len
        # tokens, so sample weights are token weights)
        total = 0.0
        count = 0
        for lo in range(start, min(start + self.n_samples, n), self.batch):
            xs, ys = [], []
            for i in range(lo, min(lo + self.batch, n)):
                x, y = self.dataset.sample(i)
                xs.append(x)
                ys.append(y)
            batch = {"tokens": torch.as_tensor(np.stack(xs), device=device),
                     "labels": torch.as_tensor(np.stack(ys), device=device)}
            total += float(fn(params, batch)) * len(xs)
            count += len(xs)
        mean = total / count if count else float("nan")
        return {"loss": mean, "ppl": float(np.exp(mean))}
