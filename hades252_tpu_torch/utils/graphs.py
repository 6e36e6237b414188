"""CUDA graphs: the counterpart of the JAX package's jitted programs.

Where the JAX package jits a phase into one program, the port captures it
as one CUDA graph a shape on this helper: `fri_cuda`'s FRI commit phase,
sibling chain and fused pooled Merkle phase, and `prover_cuda`'s three
polynomial phases. A replay runs no Python wrapper, so a kernel wrapper
counts a graph's launches once, at its capture: `CudaGraph.held` keeps
them, `replays` counts the rest, and `_LIVE_GRAPHS` lets a caller sum them
over every graph alive.
"""

from __future__ import annotations

import weakref

import torch

from ..ops import field_cuda, perm_cuda
from . import metrics


def _clone(out):
    """A graph's outputs (tensors in nested lists and tuples), cloned out of
    its static memory."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_clone(x) for x in out)


class CudaGraph:
    """fn(*inputs) captured as one CUDA graph: the counterpart of one jitted
    program of the JAX package.

    `inputs` are the static input buffers, on the card. The graph keeps fn,
    and with it the constant tensors fn closes over, for its life: the
    captured work reads their memory. Before the capture one eager run over the buffers
    (on a side stream) makes every first-use upload: perm_cuda's
    `hades_init` and dot tables, field's constants. A call copies its
    arguments into the buffers, replays, and returns clones of the outputs.
    `pool`: a `torch.cuda.graph_pool_handle()` that graphs replayed one
    after another, in the order of their capture, share; None for a pool
    of the graph's own. A capture that fails raises.

    `held` counts the kernel launches of one replay per schedule (what the
    wrappers counted during the capture), `held_states` the states they
    hand the kernels; `replays` counts the replays, each of which adds
    `held_states` to `perm_cuda.states`. `held_inverts` and
    `held_inverted` are the same for `field_cuda`'s inversion kernel: its
    launches, and the elements that each replay adds to
    `field_cuda.inverted`; `held_conversions` and `held_converted` for its
    conversion kernel (`field_cuda.conversions`, `.converted`);
    `held_arith` and `held_arith_elements`, by op, for its element-wise
    kernel (`field_cuda.arith_launches`, `.arith_elements`). The capture
    runs nothing, so the states and elements its wrappers counted are taken
    back out."""

    def __init__(self, fn, inputs: tuple, pool=None):
        self._fn, self._inputs = fn, inputs
        with metrics.span("graph.capture"):
            device = inputs[0].device
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                fn(*inputs)
            torch.cuda.current_stream(device).wait_stream(side)
            before, states = dict(perm_cuda.launches), dict(perm_cuda.states)
            inverts, inverted = field_cuda.launches, field_cuda.inverted
            conversions, converted = field_cuda.conversions, field_cuda.converted
            arith, elements = dict(field_cuda.arith_launches), dict(field_cuda.arith_elements)
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph, pool=pool):
                self._out = fn(*inputs)
            self.held = {s: perm_cuda.launches[s] - before[s] for s in perm_cuda.SCHEDULES}
            self.held_states = {s: perm_cuda.states[s] - states[s] for s in perm_cuda.SCHEDULES}
            perm_cuda.states.update(states)
            self.held_inverts = field_cuda.launches - inverts
            self.held_inverted = field_cuda.inverted - inverted
            field_cuda.inverted = inverted
            self.held_conversions = field_cuda.conversions - conversions
            self.held_converted = field_cuda.converted - converted
            field_cuda.converted = converted
            self.held_arith = {op: field_cuda.arith_launches[op] - arith[op] for op in arith}
            self.held_arith_elements = {op: field_cuda.arith_elements[op] - elements[op]
                                        for op in elements}
            field_cuda.arith_elements.update(elements)
        self.replays = 0
        _LIVE_GRAPHS.add(self)

    def __call__(self, *args):
        with metrics.span("graph.replay"):
            for buf, x in zip(self._inputs, args, strict=True):
                buf.copy_(x)
            self._graph.replay()
            self.replays += 1
            for s, n in self.held_states.items():
                perm_cuda.states[s] += n
            field_cuda.inverted += self.held_inverted
            field_cuda.converted += self.held_converted
            for op, n in self.held_arith_elements.items():
                field_cuda.arith_elements[op] += n
            return _clone(self._out)


#: Every graph alive, so that a caller can sum what the replays launched.
_LIVE_GRAPHS: weakref.WeakSet = weakref.WeakSet()

#: Graphs kept at once of each kind (each holds its shape's buffers on the card).
_GRAPHS = 4
