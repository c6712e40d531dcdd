"""A stand-in for torch's CUDA graphs on the CPU, and a guard against
host reads, shared by the tests of the compiled run
(tests/test_torch_compiled.py, tests/test_torch_loops.py,
tests/test_torch_partitioned_compiled.py, whose spawned ranks import it).

`no_host_reads` makes every way the port could read a tensor back to the
host raise `HostRead`.  `StandIn` takes the place of
`utils.graphs.CAPTURE` (a `graphs.CudaGraphs`): its capture runs the
function once, inside a guard, and its graph replays by running it again
on the static inputs; a `graphs.while_loop` met in the capture becomes a
`StandInNode` that loops its body on replay.
"""

import contextlib

import pytest
import torch
from torch.utils._pytree import tree_flatten

from hpcclassmultigridproject_tpu_torch.ops import cuda
from hpcclassmultigridproject_tpu_torch.utils import graphs


class HostRead(RuntimeError):
    """A read of a tensor's value back to the host inside the guard."""


@contextlib.contextmanager
def no_host_reads():
    """Every way the port could read a tensor back to the host, or make a
    tensor from a Python value, raises HostRead for as long as it lasts."""
    def refuse(name):
        def call(*args, **kwargs):
            raise HostRead(name)
        return call

    with pytest.MonkeyPatch.context() as mp:
        for name in ("__bool__", "__float__", "__int__", "item", "tolist",
                     "cpu", "numpy"):
            mp.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
        for name in ("tensor", "as_tensor"):
            mp.setattr(torch, name, refuse(f"torch.{name}"))
        yield


# the stand-in's replay tests a loop's predicate through the read that
# `no_host_reads` refuses: on the card that read is the kernel's
_UNGUARDED_BOOL = torch.Tensor.__bool__


class StandInGraph:
    """A captured call on the CPU: `replay` runs the function again on the
    static inputs and writes the static outputs in place, leaving
    `LAUNCHES` and `COLLECTIVES` as a replay does (no Python wrapper runs
    on a replay; a partitioned function's collectives run again, with
    every rank's replay).  Its
    loops replay as the stand-in's conditional nodes (`StandIn.while_node`),
    from the tree of nodes the capture recorded."""

    def __init__(self, owner, fn, args, out, roots, loops):
        self.owner, self.fn, self.args, self.out = owner, fn, args, out
        self.roots, self.loops = roots, loops

    def replay(self):
        saved = graphs.counts()
        if self.loops.trips is not None:  # the graph's own zeroing
            self.loops.trips.zero_()
        self.owner._frames = [[self.roots, 0]]
        try:
            new = self.fn(*self.args)
        finally:
            self.owner._frames = None
            graphs.restore_counts(saved)
        for static, fresh in zip(tree_flatten(self.out)[0],
                                 tree_flatten(new)[0], strict=True):
            if isinstance(static, torch.Tensor):
                static.copy_(fresh)


class StandInNode:
    """A conditional WHILE node on the CPU: its trip counter (the
    capture's, in `graphs.Loops`) and the nodes of its body."""

    def __init__(self, trips):
        self.trips, self.children = trips, []


class StandIn:
    """`graphs.CudaGraphs` on the CPU, counting its warm-ups and captures.
    Its capture runs the function once inside `guard` (a context manager:
    `no_host_reads` checks that the capture reads nothing back), and a
    `graphs.while_loop` met there becomes a StandInNode: the carry made
    static, the first test and the body recorded once, each test counted
    as the launch of `while_set` it is on the card.  On replay each node
    loops its body while the predicate holds, read unguarded, counting its
    trips on its device counter."""

    def __init__(self, fail=False, guard=contextlib.nullcontext):
        self.warmups = self.captures = 0
        self.fail, self.guard = fail, guard
        self._loops = self._tree = self._frames = None

    def on_card(self, device):
        return True

    def capturing(self, device):
        return self._tree is not None or self._frames is not None

    def pool(self, device):
        return object()

    def warm_up(self, fn, args, pool, device):
        self.warmups += 1
        fn(*args)

    def capture(self, fn, args, pool, device):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        self.captures += 1
        loops = graphs.Loops(device)
        self._loops, self._tree = loops, [[]]
        try:
            with self.guard():
                out = fn(*args)
            roots = self._tree[0]
        finally:
            self._loops = self._tree = None
        loops.body_nodes = 3 * len(loops)
        return StandInGraph(self, fn, args, out, roots, loops), out, 7, loops

    @staticmethod
    def _test(pred):
        assert pred.dtype == torch.bool and pred.numel() == 1
        cuda.LAUNCHES["while_set"] += 1

    def while_node(self, cond, body, carry, device):
        if self._frames is not None:  # a replay
            frame = self._frames[-1]
            node = frame[0][frame[1]]
            frame[1] += 1
            while _UNGUARDED_BOOL(cond(carry)):
                node.trips += 1
                self._frames.append([node.children, 0])
                try:
                    carry = body(carry)
                finally:
                    self._frames.pop()
            return carry
        state, static = graphs.static_carry(carry)
        k, trips = self._loops.node()
        node = StandInNode(trips)
        self._tree[-1].append(node)
        self._test(cond(state))
        self._tree.append(node.children)
        try:
            counts = graphs.capture_trip(cond, body, state, static,
                                         self._test)
        finally:
            self._tree.pop()
        self._loops.record(k, counts)
        return state
