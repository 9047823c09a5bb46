"""Cost and memory of one step, counted op by op: the port's counterpart of
XLA's ``cost_analysis()`` and ``memory_analysis()``, which the reference's
dry run reads from a compiled executable.

:class:`Counter` is a ``TorchDispatchMode``. Run a step under it (on
``meta`` tensors, as the dry run does, or on any device) and it records:

* ``flops`` -- matmul-class ops, as ``torch.utils.flop_counter`` counts
  them, plus each hand kernel's flops from its cost function
  (:mod:`repro_torch.kernels.cost`);
* ``bytes accessed`` -- operands plus outputs of every op that moves data
  (views and allocations move none), each hand kernel as its cost
  function's bytes: the unfused bound;
* ``ideal_bytes`` -- the op-level counterpart of the reference's
  ``_COUNTED_OPS``: matmuls (operands and output), sorts and top-k
  (operands and outputs), gathers, scatters and index ops (the rows they
  move, read and written, and their indices), the collectives (``c10d``
  ops, as the reference's ``_COUNTED_OPS`` charges its collectives: their
  operands and outputs, an all-reduce's buffer twice), and every
  hand-kernel call as one unit; elementwise ops, copies and reductions
  count as fused;
* ``transcendentals`` -- elements of exp, log, tanh, sigmoid, silu, gelu,
  softplus, rsqrt and softmax (their backward forms too);
* memory -- the bytes of the step's arguments, of its outputs, the outputs
  that alias an argument (updated in place), and ``temp_bytes``: the peak of
  the storages the step creates and holds at once, tracked by weak
  references to each storage, less the new outputs'. ``peak_bytes`` is
  ``argument + output + temp - alias``, as the reference computes it from
  ``memory_analysis()``.

A hand kernel called on ``meta`` (:mod:`repro_torch.kernels.ops`) allocates
what its CUDA wrapper allocates and calls :func:`charge`, which an active
counter installs as ``ops.charge``; its plain version never runs.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import import_dynamo
from repro_torch.kernels import ops

aten = torch.ops.aten

# the active counters, innermost last (a kernel charges the innermost)
_ACTIVE: List["Counter"] = []

_NO_DATA = {aten.empty, aten.empty_like, aten.empty_strided, aten.detach,
            aten.alias, aten._unsafe_view, aten.lift_fresh, aten.set_,
            aten.resize_}

_MATMUL = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten._scaled_mm,
           aten.convolution, aten.convolution_backward}

_SORT = {aten.sort, aten.topk}

# ops that move selected rows: charged their moved rows read and written,
# and their indices
_GATHER = {aten.index, aten.index_select, aten.gather, aten.embedding,
           aten.take, aten.masked_select}
_SCATTER = {aten.index_put, aten.index_put_, aten._index_put_impl_,
            aten.scatter, aten.scatter_, aten.scatter_add,
            aten.scatter_add_, aten.scatter_reduce, aten.scatter_reduce_,
            aten.index_add, aten.index_add_, aten.index_copy,
            aten.index_copy_, aten.embedding_dense_backward,
            aten.masked_scatter, aten.masked_scatter_}

# the collectives (``c10d`` ops, which take their outputs as operands):
# each charged its outputs (the first operand) and inputs (the second), an
# in-place all-reduce its buffer as both
_COLLECTIVE_INPUT = {"allgather_": 1, "_allgather_base_": 1,
                     "_reduce_scatter_base_": 1, "reduce_scatter_": 1,
                     "alltoall_base_": 1, "alltoall_": 1, "allreduce_": 0}

_TRANSCENDENTAL = {aten.exp, aten.exp_, aten.log, aten.log_, aten.tanh,
                   aten.tanh_, aten.sigmoid, aten.sigmoid_, aten.silu,
                   aten.silu_, aten.gelu, aten.gelu_, aten.softplus,
                   aten.rsqrt, aten.rsqrt_, aten._softmax, aten.logsumexp,
                   aten._log_softmax, aten.silu_backward,
                   aten.gelu_backward, aten.softplus_backward}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a tree (lists, tuples, dicts), each its
    elements times their size: what a step's arguments or outputs hold."""
    return sum(nbytes(t) for t in _tensors(tree))


def _scatter_bytes(packet, ins: List[torch.Tensor]) -> int:
    """A scatter-class op's rows moved (read and written) and its indices:
    the updates are its last tensor operand (the first for
    ``embedding_dense_backward``, the index's rows of ``self`` for a
    scatter of a scalar), the tensors between ``self`` and them its
    indices."""
    if packet is aten.embedding_dense_backward:
        return 2 * nbytes(ins[0]) + sum(nbytes(t) for t in ins[1:])
    if len(ins) == 2:               # scatter(self, dim, index, value)
        return 2 * ins[1].numel() * ins[0].element_size() + nbytes(ins[1])
    return 2 * nbytes(ins[-1]) + sum(nbytes(t) for t in ins[1:-1])


def charge(name: str, n_bytes: float, n_flops: float) -> None:
    """Charge the innermost active counter one call of hand kernel
    ``name``: ``n_bytes`` moved and ``n_flops`` done (its cost function's).
    Installed as ``kernels.ops.charge`` while a counter is active."""
    _ACTIVE[-1].kernel(name, n_bytes, n_flops)


class Counter(TorchDispatchMode):
    """Counts the ops dispatched while it is active (see the module
    docstring). Use :meth:`run` to count one step with its memory."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.ideal_bytes = 0
        self.transcendentals = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}
        self._args: set = set()

    # ---------------------------------------------------------- dispatch
    def __enter__(self):
        import_dynamo()     # before the first dispatch, which imports it
        _ACTIVE.append(self)
        ops.charge = charge
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        if not _ACTIVE:
            ops.charge = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        outs = _tensors(out)
        for t in outs:
            self._hold(t)
        if packet in _NO_DATA or func.is_view:
            return out
        ins = _tensors((args, kwargs))
        if func.namespace == "c10d":
            moved = self._collective(func, args)
            self.bytes_accessed += moved
            self.ideal_bytes += moved
            return out
        in_b = sum(nbytes(t) for t in ins)
        out_b = sum(nbytes(t) for t in outs)
        self.bytes_accessed += in_b + out_b
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if packet in _MATMUL or packet in _SORT:
            self.ideal_bytes += in_b + out_b
        elif packet in _GATHER:
            idx = sum(nbytes(t) for t in ins[1:] if not t.is_floating_point())
            self.ideal_bytes += 2 * out_b + idx
        elif packet in _SCATTER:
            self.ideal_bytes += _scatter_bytes(packet, ins)
        if packet in _TRANSCENDENTAL:
            self.transcendentals += max((t.numel() for t in ins), default=0)
        return out

    @staticmethod
    def _collective(func, args) -> int:
        """A ``c10d`` op's bytes: its outputs (its first operand) and its
        inputs (the operand :data:`_COLLECTIVE_INPUT` names; the buffer
        again for an in-place all-reduce)."""
        name = func._overloadpacket.__name__
        if name not in _COLLECTIVE_INPUT:
            raise NotImplementedError(f"the counter has no rule for "
                                      f"c10d.{name}")
        return (tensor_bytes(args[0])
                + tensor_bytes(args[_COLLECTIVE_INPUT[name]]))

    def kernel(self, name: str, n_bytes: float, n_flops: float) -> None:
        """One call of a hand kernel, counted as one unit."""
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0,
                                           "flops": 0})
        k["calls"] += 1
        k["bytes"] += n_bytes
        k["flops"] += n_flops
        self.flops += n_flops
        self.bytes_accessed += n_bytes
        self.ideal_bytes += n_bytes

    # ------------------------------------------------------------ memory
    def _hold(self, t: torch.Tensor) -> None:
        """Track ``t``'s storage if the step created it: its bytes count as
        live until the storage is freed."""
        s = t.untyped_storage()
        key = id(s)
        if key in self._held or key in self._args:
            return
        n = s.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key)

    def run(self, step, *args) -> Dict[str, Any]:
        """Run ``step(*args)`` under this counter; -> the memory record
        (``argument_bytes``, ``output_bytes``, ``temp_bytes``,
        ``alias_bytes``, ``peak_bytes``). The arguments' storages are not
        the step's: only what it creates counts toward ``temp_bytes``."""
        arg_ts = _tensors(args)
        self._args = {id(t.untyped_storage()) for t in arg_ts}
        # the step's args keep their storages alive: ids stay theirs
        with self:
            out = step(*args)
        out_ts = _tensors(out)
        alias = [t for t in out_ts if id(t.untyped_storage()) in self._args]
        new_out = sum(nbytes(t) for t in out_ts) - tensor_bytes(alias)
        mem = {"argument_bytes": tensor_bytes(arg_ts),
               "output_bytes": tensor_bytes(out_ts),
               "temp_bytes": self.peak - new_out,
               "alias_bytes": tensor_bytes(alias)}
        mem["peak_bytes"] = (mem["argument_bytes"] + mem["output_bytes"]
                             + mem["temp_bytes"] - mem["alias_bytes"])
        return mem

    def cost(self) -> Dict[str, float]:
        """The counts under the reference's ``cost_analysis`` keys."""
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes_accessed),
                "transcendentals": float(self.transcendentals),
                "ideal_bytes": float(self.ideal_bytes)}
