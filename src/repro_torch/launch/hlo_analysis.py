"""Per-device cost of one traced step: the port's stand-in for
``repro.launch.hlo_analysis``.

JAX compiles the step and walks the partitioned HLO text, multiplying each
while body by its trip count.  PyTorch has no compiled program to read, so
the port runs the step once — on ``meta`` tensors over a fake world for a
dryrun, on the card for the check that holds the dryrun against it — under
:class:`CostCounter`, a ``TorchDispatchMode`` that sees every op each rank
runs on its local blocks.  A call that carries a DTensor is handed back to
DTensor (``NotImplemented``), which redistributes the blocks through
functional collectives and runs the op on them; those calls then reach the
mode with plain tensors.  Calls on or making ``FakeTensor``s are DTensor's
own sharding propagation at global shapes and are not counted.  The counts are
therefore per device from the start: the work of rank 0's blocks.

The conventions are ``hlo_analysis.py``'s:

* ``flops`` — 2·M·N·K for every matmul (``torch.utils.flop_counter``'s
  formulas for ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and convolutions,
  and the formulas the hand-written kernels register: ``flash_fwd``,
  ``ssd_scan``), plus 1 per output element for the elementwise and
  reduction set :data:`_EW_OPS`, JAX's ``_EW_OPS`` in aten's names;
* ``bytes`` — the bytes each op reads and writes (its tensor inputs and
  outputs), with views and bookkeeping ops (:data:`_NO_TRAFFIC`) carrying
  no traffic;
* ``collective_bytes`` — by kind, in JAX's five kinds, an all-reduce
  counted twice (a ring's reduce-scatter plus all-gather), a
  reduce-scatter's message its input and every other kind's its output;
  ``messages`` lists ``(kind, bytes, count)`` per distinct message size.

Where a convention cannot carry over:

* there is no fusion.  JAX does not count the elementwise ops and the
  bytes inside a fusion (they stay in registers); eager PyTorch runs every
  op as its own kernel, so ``flops`` counts every elementwise op of the set
  and ``bytes`` every op's inputs and outputs: an upper bound on what a
  fused program moves;
* there are no loops to multiply: the step runs every layer, so a layer's
  ops are seen as often as they run;
* an in-place cache write (``index_put_``, :data:`_INPLACE_UPDATES`: a
  decode step's new K/V rows into the cache, through indices) moves JAX's
  ``dynamic-update-slice`` traffic: twice the bytes of its operands but
  the largest (read and write of the update and the indices), not the
  whole buffer, which aliases the output;
* memory: the live bytes of the storages the step makes are tracked as
  they are made and freed (:meth:`CostCounter.memory`), the arguments
  apart; kernels' own workspaces (allocated inside an op) and the CUDA
  caching allocator's rounding are not seen.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: JAX's collective kinds, in its order
_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the collectives DTensor issues, by op name, and JAX's kind of each
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
}
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                    "_dtensor", "c10d")

#: elementwise/transcendental/reduction ops counted at 1 flop per output
#: element: JAX's ``_EW_OPS`` (add, subtract, multiply, divide,
#: exponential, tanh, rsqrt, sqrt, log, power, maximum, minimum, compare,
#: select, negate, abs, floor, convert, cosine, sine, logistic, reduce) in
#: aten's names; an in-place variant counts as its op
_EW_OPS = frozenset({
    "add", "sub", "rsub", "mul", "div", "exp", "tanh", "rsqrt", "sqrt",
    "log", "pow", "maximum", "minimum", "eq", "ne", "lt", "le", "gt", "ge",
    "where", "neg", "abs", "floor", "_to_copy", "cos", "sin", "sigmoid",
    "sum", "mean", "amax", "amin", "max", "min", "prod"})

#: bookkeeping ops with no memory traffic of their own (JAX's
#: ``_NO_TRAFFIC``: allocation, aliasing, the collectives' wait); every
#: view op is one too
_NO_TRAFFIC = frozenset({
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "aten.detach", "aten.alias", "aten.lift_fresh",
    "aten._local_scalar_dense", "aten.set_", "aten.resize_",
    "_c10d_functional.wait_tensor", "_c10d_functional._wrap_tensor_autograd"})


#: in-place updates of a buffer through indices (JAX's
#: ``_is_inplace_update``): traffic is twice the operands but the buffer
_INPLACE_UPDATES = frozenset({"aten.index_put_", "aten._index_put_impl_"})


def _tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            out += _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            out += _tensors(x)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block; a plain tensor itself."""
    return getattr(t, "_local_tensor", t)


def local_bytes(tree) -> int:
    """The bytes of the distinct storages of ``tree``'s tensors (a
    DTensor's local block): what the tree holds on one device."""
    seen = set()
    total = 0
    for t in _tensors(tree):
        st = _local(t).untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


class CostCounter(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes and collectives over what runs inside
    it, and the live bytes of the storages it makes (``arguments``' own
    storages apart)."""

    def __init__(self, arguments: Any = ()) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = {k: 0.0 for k in _COLL_KINDS}
        self.coll_counts = {k: 0 for k in _COLL_KINDS}
        self._messages: Dict[Tuple[str, int], int] = {}
        self.n_ops = 0
        self._args = {_local(t).untyped_storage()._cdata
                      for t in _tensors(arguments)}
        self._read: set = set()          # argument storages an op read
        self._live: Dict[int, int] = {}
        self._refs: Dict[int, Any] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- memory ---------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._refs[key] = weakref.ref(st, lambda _r, key=key: self._free(key))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int) -> None:
        n = self._live.pop(key, 0)
        self._refs.pop(key, None)
        self.live_bytes -= n

    # -- the dispatch -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # its local ops come back here
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors((args, out))):
            return out                     # DTensor's sharding propagation
        self._count(func, args, kwargs, out)
        for t in _tensors(out):
            self._track(t)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        self.n_ops += 1
        for t in _tensors((args, kwargs)):
            key = t.untyped_storage()._cdata
            if key in self._args:
                self._read.add(key)
        packet = func._overloadpacket
        name = str(packet)
        namespace, _, op = name.partition(".")
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif namespace == "aten" and op.rstrip("_") in _EW_OPS:
            self.flops += sum(t.numel() for t in _tensors(out))
        if name in _NO_TRAFFIC or func.is_view:
            return
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if name in _INPLACE_UPDATES:
            sizes = list(map(_nbytes, ins))
            self.bytes += 2 * (sum(sizes) - max(sizes))
            return
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if namespace not in _COLL_NAMESPACES:
            return
        kind = _COLLECTIVES.get(name)
        if kind is None:
            raise ValueError(f"CostCounter: collective {name} has no kind "
                             f"of {_COLL_KINDS}")
        msgs = ins if kind == "reduce-scatter" else outs
        for t in msgs:
            nbytes = _nbytes(t)
            self.coll[kind] += nbytes * (2.0 if kind == "all-reduce" else 1.0)
            self.coll_counts[kind] += 1
            self._messages[(kind, nbytes)] = \
                self._messages.get((kind, nbytes), 0) + 1

    # -- results ---------------------------------------------------------------
    def analyze(self) -> Dict[str, Any]:
        """JAX's ``analyze`` keys; ``messages`` are ``(kind, bytes, count)``
        per distinct message, in the order first seen."""
        return {
            "flops": float(self.flops),
            "bytes": float(self.bytes),
            "collective_bytes": sum(self.coll.values()),
            "collective_per_kind": dict(self.coll),
            "collective_counts": dict(self.coll_counts),
            "messages": [(k, b, n) for (k, b), n in self._messages.items()],
            "n_ops": self.n_ops,
        }

    def memory(self, arguments: Any, outputs: Any) -> Dict[str, int]:
        """JAX's ``memory_analysis`` sizes: the local bytes of the
        arguments the step reads and of the outputs, and the peak of live
        bytes the step made beyond the arguments.  An argument no op reads
        is left out, as ``jax.jit`` prunes unused arguments from the
        executable (``keep_unused=False``: a Mamba2 decode step's
        positions)."""
        read = [t for t in _tensors(arguments)
                if _local(t).untyped_storage()._cdata in self._read]
        return {
            "mem_temp_size_in_bytes": int(self.peak_bytes),
            "mem_argument_size_in_bytes": local_bytes(read),
            "mem_output_size_in_bytes": local_bytes(outputs),
        }


def analyze(fn, *args: Any) -> Tuple[Any, Dict[str, Any]]:
    """``fn(*args)`` under a :class:`CostCounter`: its output and the
    counts (JAX's ``analyze`` keys plus the memory sizes)."""
    with CostCounter(arguments=args) as counter:
        out = fn(*args)
    res = counter.analyze()
    res.update(counter.memory(args, out))
    return out, res

