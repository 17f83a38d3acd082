"""The plain PyTorch training step every reference language model shares,
in float32 with TF32 off.

Written from the equations, not from the program: the embedding, the
architecture's layers (its module in this package, found by the
configuration's ``arch_type``), the final RMSNorm, the output head (tied to
the embedding or not) and the mean token cross-entropy; the gradients by
autograd; AdamW with global-norm clipping.

Every matrix product goes through ``mm``, so the control computes the same
model with its products' operands rounded to fp8 (``fp8_mm``).  Layers are
recomputed in the backward and the batch is taken in blocks of rows, so the
reference fits beside nothing else on one card.  Stacked ``[L, ...]``
leaves are held as one leaf a layer (views of the stacked weights); norms
are reported per leaf of the port's tree.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import model as arch_module
from .params import get_leaf, make_weights, param_specs, path_name

Mm = Callable[..., torch.Tensor]


def learning_rate(lr, t: int) -> float:
    """The rate of step ``t`` (1 for the first): a number, or a linear
    warm-up to ``peak_lr`` over ``warmup_steps`` and a cosine to
    ``final_frac`` of it at ``total_steps``."""
    if not isinstance(lr, dict):
        return float(lr)
    if lr["schedule"] != "warmup_cosine":
        raise ValueError(f"no reference for schedule {lr['schedule']!r}")
    peak, warm = lr["peak_lr"], max(lr["warmup_steps"], 1)
    if t < lr["warmup_steps"]:
        return peak * t / warm
    prog = min(max((t - lr["warmup_steps"])
                   / max(lr["total_steps"] - lr["warmup_steps"], 1), 0.0), 1.0)
    f = lr["final_frac"]
    return f * peak + (1 - f) * peak * 0.5 * (1 + math.cos(math.pi * prog))


def f32_mm(eq, a, b):
    return torch.einsum(eq, a, b)


def _fp8(x):
    """x rounded to float8 e4m3 with a per-tensor scale (its amax at 448),
    the gradient passed straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def fp8_mm(eq, a, b):
    return torch.einsum(eq, _fp8(a), _fp8(b))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# the model and one training step
# ---------------------------------------------------------------------------
class Reference:
    """The reference's params (one leaf a layer for the stacked leaves),
    AdamW state and step."""

    def __init__(self, arch, opt, seed: int, device, mm: Mm = f32_mm,
                 rows_per_block: int = 1):
        self.arch, self.opt, self.mm = arch, opt, mm
        self.rows = max(1, int(rows_per_block))
        self.device = device
        self.seed = seed
        self.specs = param_specs(arch)
        self.weights = make_weights(arch, seed, device)
        self.body = arch_module(arch).body
        self.stacks = arch_module(arch).stacks(arch)
        # leaves: (path, index into the stack or None, tensor)
        self.leaves: List[Any] = []
        for path, shape, _ in self.specs:
            w = get_leaf(self.weights, path)
            if path[0] in self.stacks:
                for i in range(self.stacks[path[0]]):
                    self.leaves.append((path, i, w[i].detach()
                                        .requires_grad_(True)))
            else:
                self.leaves.append((path, None, w.detach().requires_grad_(True)))
        self.m = [torch.zeros_like(t) for _, _, t in self.leaves]
        self.v = [torch.zeros_like(t) for _, _, t in self.leaves]
        self.count = 0

    def _tree(self):
        """The params as the forward reads them: stacked leaves as lists."""
        tree: Dict[str, Any] = {}
        for (path, i, t) in self.leaves:
            node = tree
            if i is not None:
                layers = node.setdefault(path[0], [
                    dict() for _ in range(self.stacks[path[0]])])
                node = layers[i]
                path = path[1:]
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        return tree

    def loss_sum(self, tree, tokens, labels):
        """Summed token NLL of rows ``tokens`` [b, S]."""
        arch, mm = self.arch, self.mm
        eps = arch["norm_eps"]
        x = self.body(arch, tree, tree["embed"][tokens.long()], mm)

        def head(x):
            x = rmsnorm(x, tree["final_norm"]["scale"], eps)
            w = tree["embed"].T if arch.get("tie_embeddings") else \
                tree["lm_head"]
            logits = mm("bsd,dv->bsv", x, w)
            return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   labels.reshape(-1).long(),
                                   reduction="sum")

        return checkpoint(head, x, use_reentrant=False)

    def step(self, tokens, labels) -> float:
        """One AdamW step on the batch; returns its mean loss."""
        tree = self._tree()
        for _, _, t in self.leaves:
            t.grad = None
        n_tok = tokens.numel()
        total = 0.0
        for lo in range(0, tokens.shape[0], self.rows):
            loss = self.loss_sum(tree, tokens[lo:lo + self.rows],
                                 labels[lo:lo + self.rows]) / n_tok
            loss.backward()
            total += float(loss.detach())
        self._adamw()
        return total

    @torch.no_grad()
    def _adamw(self):
        o = self.opt
        grads = [t.grad if t.grad is not None else torch.zeros_like(t)
                 for _, _, t in self.leaves]
        gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads))
        scale = min(1.0, o["grad_clip"] / max(gnorm, 1e-9)) \
            if o["grad_clip"] > 0 else 1.0
        self.count += 1
        c1 = 1.0 - o["b1"] ** self.count
        c2 = 1.0 - o["b2"] ** self.count
        lr = learning_rate(o["lr"], self.count)
        for (path, i, p), g, m, v in zip(self.leaves, grads, self.m, self.v):
            g = g * scale
            m.mul_(o["b1"]).add_((1 - o["b1"]) * g)
            v.mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
            upd = (m / c1) / (torch.sqrt(v / c2) + o["eps"])
            # the port decays a leaf of rank >= 2 of its tree (a stacked
            # layer leaf always is)
            if o["weight_decay"] > 0 and (i is not None or p.dim() >= 2):
                upd = upd + o["weight_decay"] * p
            p.sub_(lr * upd)
            p.grad = None

    # -- readings -----------------------------------------------------------
    def _per_leaf(self, tensors) -> Dict[str, float]:
        sq: Dict[str, float] = {}
        for (path, _, _), t in zip(self.leaves, tensors):
            k = path_name(path)
            sq[k] = sq.get(k, 0.0) + float(torch.sum(t.double() ** 2))
        return {k: math.sqrt(v) for k, v in sq.items()}

    def grad_norms(self) -> Dict[str, float]:
        """Each leaf's first gradient as the optimizer took it (clipped),
        worked out from the first moment after one step."""
        return {k: v / (1 - self.opt["b1"])
                for k, v in self._per_leaf(self.m).items()}

    def change_norms(self) -> Dict[str, float]:
        """Each leaf's change from the seeded weights."""
        w0 = make_weights(self.arch, self.seed, self.device)
        diffs = []
        for path, i, t in self.leaves:
            w = get_leaf(w0, path)
            diffs.append(t.detach() - (w[i] if i is not None else w))
        out = self._per_leaf(diffs)
        del w0, diffs
        return out


def run_reference(arch, opt, seed: int, batches, device, mm: Mm = f32_mm,
                  rows_per_block: int = 1) -> Dict[str, Any]:
    """The reference's readings over ``batches`` (a list of (tokens,
    labels) on ``device``): each step's loss, the first gradient's norm
    per leaf, and each leaf's change after the last step."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = Reference(arch, opt, seed, device, mm, rows_per_block)
        losses, grads = [], None
        for tokens, labels in batches:
            losses.append(ref.step(tokens, labels))
            if grads is None:
                grads = ref.grad_norms()
        out = {"losses": losses, "grad_norms": grads,
               "change_norms": ref.change_norms()}
        del ref
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
