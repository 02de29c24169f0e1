"""Conditional execution in a CUDA graph (``csrc/graph_cond.cu``): the port's
``lax.cond`` for a round replayed as one graph.

The reference runs parts of its single-dispatch round under ``jax.lax.cond``
(the draft scan, ``src/repro/core/engine.py:1083`` and ``:1200``; chunked
prefill, ``:1000``): XLA keeps one executable and skips the branch at run
time. A ``torch.cuda.CUDAGraph`` replays every node it captured, so the port
captures the round as segment graphs (``CUDAGraph(keep_graph=True)``, one
shared memory pool, captured in the order they run) and assembles them into
one graph of its own: a segment that the reference gates sits behind an IF
node, whose condition the ``set_cond`` kernel reads from a device scalar
that an earlier segment wrote. A body that is skipped writes nothing; the
segments after it read the same tensors either way, as ``lax.cond``'s
identity branch does.

Every graph handed to ``CondGraph`` comes from a capture into one pool, in
the order of the steps: memory a segment freed is reused only by segments
that run after it, which is what makes segment-local memory safe.

``launches`` counts ``set_cond`` launches: one per IF node in every launch of
an assembled graph. The plain version of a ``CondGraph`` is
``kernels/ref.py::cond_segments``: the same segments run eagerly, each IF
decided by a host read.

``CondGraph.walk()`` and ``walk_graph`` list the nodes of an assembled round
or of any graph PyTorch kept (``keep_graph=True``) as ``GraphNode`` records,
which ``analysis.contracts`` holds to the round's dispatch contract.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import _build

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_WALK = [_P, ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
_SIGNATURES = {
    "cg_create": [_P],
    "cg_add_child": [_P, _P],
    "cg_add_if": [_P, _P, _I, _P],
    "cg_instantiate": [_P],
    "cg_launch": [_P, _P],
    "cg_destroy": [_P],
    "cg_walk": _WALK,
    "gw_walk": _WALK,
}

Step = Tuple  # ("child", graph) or ("if", pred, graph)


class GraphNode(NamedTuple):
    """One node of a walked graph. ``top``: the index of its top-level
    ancestor (itself at depth 0), in an order that respects the edges;
    ``depth``: its nesting (a child graph's or an IF body's nodes are one
    deeper); ``gated``: inside an IF body; ``kind``: ``kernel``, ``memcpy``,
    ``memset``, ``host``, ``child``, ``conditional``, ``empty``,
    ``event_record``, ``event_wait``, ``mem_alloc``, ``mem_free``, ...;
    ``name``: a kernel's demangled function (``<unresolved>`` where no
    CUDA API call names it), a memcpy's direction (``DtoD``,
    ``DtoH``, ``HtoD``, ``HtoH``; ``M`` managed, ``?`` unknown). A call the
    walk could not make is an ``error`` record named by the call and its
    code. A memcpy node also has the address it reads (``src``) and writes
    (``dst``) and its ``nbytes``; they are 0 for other kinds."""

    top: int
    depth: int
    gated: bool
    kind: str
    name: str
    src: int = 0
    dst: int = 0
    nbytes: int = 0


def parse_walk(text: str) -> List[GraphNode]:
    """The records of a walk's text: one tab-separated line a node (top,
    depth, gated, kind, src, dst, nbytes, name)."""
    out = []
    for line in text.splitlines():
        top, depth, gated, kind, src, dst, nbytes, name = line.split("\t", 7)
        out.append(GraphNode(int(top), int(depth), gated == "1", kind, name, int(src), int(dst),
                             int(nbytes)))
    return out


def _walk(fn, handle) -> List[GraphNode]:
    cap = 1 << 16
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = ctypes.c_size_t(0)
        _build.check(fn(handle, buf, cap, ctypes.byref(n)), "graph walk")
        if n.value <= cap:
            return parse_walk(buf.raw[: n.value].decode())
        cap = n.value


def walk_graph(graph) -> List[GraphNode]:
    """The nodes of a ``torch.cuda.CUDAGraph`` captured with
    ``keep_graph=True`` (an IF node's body is not known here)."""
    lib = _build.load("graph_cond", _SIGNATURES)
    return _walk(lib.gw_walk, ctypes.c_void_p(graph.raw_cuda_graph()))


def _check_steps(steps: Sequence[Step]) -> None:
    """The assembly's input contract: each step is ("child", graph) or
    ("if", pred, graph), pred a 0-d bool or int32 CUDA tensor."""
    for step in steps:
        if step[0] == "child" and len(step) == 2:
            continue
        if step[0] != "if" or len(step) != 3:
            raise ValueError(f"graph_cond: a step is ('child', graph) or ('if', pred, graph), "
                             f"got {step!r}")
        pred = step[1]
        if (not isinstance(pred, torch.Tensor) or pred.numel() != 1
                or pred.dtype not in (torch.bool, torch.int32) or pred.device.type != "cuda"):
            raise ValueError("graph_cond: an IF predicate is a one-element bool or int32 "
                             "CUDA tensor")


class CondGraph:
    """One CUDA graph assembled from captured segment graphs, in order;
    an ("if", pred, graph) step runs its segment only when ``pred`` is
    non-zero when the step is reached. Keeps the segments (and with them
    their memory pool) and the predicates alive as long as it lives."""

    def __init__(self, steps: Sequence[Step], device):
        self._h = None
        _check_steps(steps)
        self.device = torch.device(device)
        self._lib = _build.load("graph_cond", _SIGNATURES)
        self._keep: List = list(steps)
        self.n_if = sum(1 for s in steps if s[0] == "if")
        handle = ctypes.c_void_p()
        _build.check(self._lib.cg_create(ctypes.byref(handle)), "graph_cond create")
        self._h = handle
        try:
            for step in steps:
                if step[0] == "child":
                    err = self._lib.cg_add_child(self._h, ctypes.c_void_p(step[1].raw_cuda_graph()))
                else:
                    _, pred, graph = step
                    err = self._lib.cg_add_if(self._h, _build.ptr(pred), int(pred.dtype == torch.int32),
                                              ctypes.c_void_p(graph.raw_cuda_graph()))
                _build.check(err, f"graph_cond add {step[0]}")
            _build.check(self._lib.cg_instantiate(self._h), "graph_cond instantiate")
        except Exception:
            self.close()
            raise

    def launch(self) -> None:
        """Launch the graph on the current stream (no sync)."""
        global launches
        _build.check(self._lib.cg_launch(self._h, _build.stream_ptr(self.device)), "graph_cond launch")
        launches += self.n_if

    def walk(self) -> List[GraphNode]:
        """The assembled graph's nodes, IF bodies included: per step, the
        segment's child node (or ``set_cond``'s kernel node and the IF
        node), each followed by what it holds."""
        return _walk(self._lib.cg_walk, self._h)

    def close(self) -> None:
        if self._h is not None:
            h, self._h = self._h, None
            _build.check(self._lib.cg_destroy(h), "graph_cond destroy")
            self._keep = []

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the context may be gone already
            pass
