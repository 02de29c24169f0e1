"""Dispatch contracts over the captured single-round CUDA graph.

The port's counterpart of the reference's ``analysis/contracts.py``. The
reference proves its dispatch discipline on the compiled HLO; the port
proves it on the graph a single round launches: the ``CondGraph`` that
``serving/server.py::_capture`` assembles from the round's segment graphs
(``kernels/graph_cond.py``), walked node by node (``CondGraph.walk``).

  reference                          here
  ``assert_no_host_callbacks``       no host node in the round
  ``host_transfer_ops``              no memcpy node with a host end
  ``assert_trip_count``              one IF node per gated segment of
                                     ``BatchedSpecServer._plan()``, and each
                                     segment's hand-kernel nodes equal its
                                     ``segment_launches``
  ``assert_donated``                 the cache's and ``dstate``'s storage
                                     unchanged since the capture; what the
                                     capture left live in the graph's pool,
                                     and what the round's memcpy nodes copy
                                     out of the cache, each below the
                                     cache's bytes: no second copy of it
  ``assert_no_collectives``          no NCCL kernel in a single-card round;
                                     a mesh round's NCCL kernel nodes are
                                     counted apart (``collective_counts``)
  ``server_round_contracts``         one contract per graph a round launches
  ``assert_telemetry_transparent``   telemetry changes the tail segment's
                                     kernels only

``assert_sharding`` reads XLA's placements and has no counterpart: the
port's ranks hold their shards explicitly. Every assertion reads a plain
list of ``GraphNode`` records, so each violation is testable on the CPU,
where a round runs eagerly and has no graph.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

from repro_torch.kernels.graph_cond import GraphNode

__all__ = [
    "ContractViolation",
    "GraphContract",
    "assert_donated",
    "assert_telemetry_transparent",
    "check_round",
    "round_graphs",
    "server_round_contracts",
]

# the hand kernels' functions (``csrc/*.cu``, each in an anonymous
# namespace) by the launch-count key of their wrapper; one wrapper launch
# adds one node of these, and flash decode one ``combine_kernel`` besides
HAND_KERNELS = {
    "split_kernel": "flash_decode",
    "paged_split_kernel": "flash_decode_paged",
    "tree_kernel": "tree_attention",
    "tree2_kernel": "tree_attention",
    "int8_mm_kernel": "int8_matmul",
    "grouped_kernel": "moe_grouped",
    "grouped_wgmma_kernel": "moe_grouped_bf16",
    "set_cond": "set_cond",
}
COMBINE = "combine_kernel"
_ANON = "(anonymous namespace)"
UNRESOLVED = "<unresolved>"
_CONTAINERS = ("child", "conditional")


class ContractViolation(AssertionError):
    """A captured round broke a dispatch-discipline contract."""


def kernel_base(name: str) -> str:
    """A kernel node's function without its return type, template arguments
    and parameters: ``void (anonymous namespace)::split_kernel<float, 128,
    16>(...)`` is ``(anonymous namespace)::split_kernel``."""
    s = (name[5:] if name.startswith("void ") else name).replace(_ANON, "\0")
    for i, c in enumerate(s):
        if c in "<(":
            s = s[:i]
            break
    return s.replace("\0", _ANON)


@functools.lru_cache(maxsize=4096)
def hand_kernel(name: str) -> Optional[str]:
    """The hand kernel a node's function is (a key of ``HAND_KERNELS`` or
    ``COMBINE``), or None: only functions of the anonymous namespace at the
    top level, where ``csrc/*.cu`` defines them. A name left mangled is
    matched by its ``_GLOBAL__N_1`` scope and length-prefixed identifier."""
    base = kernel_base(name)
    known = (*HAND_KERNELS, COMBINE)
    if base.startswith(_ANON + "::"):
        fn = base[len(_ANON) + 2:]
        return fn if fn in known else None
    if name.startswith("_ZN12_GLOBAL__N_1"):
        rest = name[len("_ZN12_GLOBAL__N_1"):]
        for fn in known:
            if rest.startswith(f"{len(fn)}{fn}"):
                return fn
    return None


@dataclasses.dataclass(frozen=True)
class GraphContract:
    """The walked nodes of one captured graph and, for a server's round,
    its segments in order: ``(name, gated)``, a gated segment sitting
    behind an IF node. A graph without segments (``from_graph``) is one
    segment, ``"graph"``."""

    name: str
    nodes: Tuple[GraphNode, ...]
    segments: Tuple[Tuple[str, bool], ...] = ()

    # --------------------------------------------------------- constructors
    @classmethod
    def from_server(cls, server, name: str = "round") -> "GraphContract":
        graph = getattr(server, "_graph", None)
        if graph is None:
            raise ValueError("the server has no captured round: a single-round server "
                             "captures it at build on CUDA only")
        segs = tuple((seg, pred is not None) for seg, _, pred in server._plan())
        return cls(name, tuple(graph.walk()), segs)

    @classmethod
    def from_graph(cls, graph, name: str = "graph") -> "GraphContract":
        """A ``torch.cuda.CUDAGraph`` captured with ``keep_graph=True``."""
        from repro_torch.kernels.graph_cond import walk_graph

        return cls(name, tuple(walk_graph(graph)))

    # ---------------------------------------------------------------- facts
    def _fail(self, msg: str) -> None:
        raise ContractViolation(f"[{self.name}] {msg}")

    @functools.cached_property
    def owner(self) -> Dict[int, str]:
        """Each top-level index's segment (``""`` for the assembly's own
        ``set_cond`` nodes). The top level must follow the plan: a child
        node a plain segment, a ``set_cond`` kernel node and an IF node a
        gated one, nothing else."""
        tops = [n for n in self.nodes if n.depth == 0 and n.kind != "error"]
        if not self.segments:
            return {n.top: "graph" for n in tops}
        want: List[Tuple[str, str]] = []
        for seg, gated in self.segments:
            want += [("kernel", ""), ("conditional", seg)] if gated else [("child", seg)]
        got = [n.kind for n in tops]
        if got != [k for k, _ in want]:
            self._fail(f"the top level is {got}, the plan {self.segments} asks for "
                       f"{[k for k, _ in want]}")
        out = {}
        for n, (_, seg) in zip(tops, want):
            if n.kind == "kernel" and hand_kernel(n.name) != "set_cond":
                self._fail(f"the node before an IF node runs {n.name!r}, not set_cond")
            out[n.top] = seg
        return out

    @functools.cached_property
    def _by_segment(self) -> Dict[str, Tuple[GraphNode, ...]]:
        out: Dict[str, List[GraphNode]] = collections.defaultdict(list)
        for n in self.nodes:
            if n.kind not in _CONTAINERS and n.top in self.owner:
                out[self.owner[n.top]].append(n)
        return {k: tuple(v) for k, v in out.items()}

    def segment_nodes(self, segment: str) -> Tuple[GraphNode, ...]:
        """The nodes a segment holds, its container nodes left out."""
        return self._by_segment.get(segment, ())

    @functools.cached_property
    def node_counts(self) -> Dict[str, int]:
        """Nodes by kind (containers left out)."""
        return dict(collections.Counter(n.kind for n in self.nodes if n.kind not in _CONTAINERS))

    @property
    def n_if(self) -> int:
        return sum(1 for n in self.nodes if n.kind == "conditional")

    @property
    def errors(self) -> List[str]:
        """What the walk could not read (the failed call and its code)."""
        return [n.name for n in self.nodes if n.kind == "error"]

    @property
    def unresolved(self) -> int:
        """Kernel nodes whose function no CUDA API call named."""
        return sum(1 for n in self.nodes if n.kind == "kernel" and n.name == UNRESOLVED)

    def kernel_counts(self, segment: Optional[str] = None) -> Dict[str, int]:
        """Hand-kernel launches a segment's nodes (every node's when None)
        stand for, by launch-count key; ``combine`` counts the flash-decode
        combine passes."""
        nodes = self.nodes if segment is None else self.segment_nodes(segment)
        out: Dict[str, int] = collections.Counter()
        for n in nodes:
            if n.kind != "kernel":
                continue
            fn = hand_kernel(n.name)
            if fn == COMBINE:
                out["combine"] += 1
            elif fn is not None:
                out[HAND_KERNELS[fn]] += 1
        return dict(out)

    def collective_counts(self) -> Dict[str, int]:
        """NCCL kernel nodes by function name (a mesh round's collectives)."""
        return dict(collections.Counter(n.name for n in self.nodes
                                        if n.kind == "kernel" and "nccl" in n.name.lower()))

    def summary(self) -> dict:
        """Node counts by kind, IF nodes, unresolved kernels, the hand
        kernels' nodes and the NCCL kernels': what a run prints."""
        return {"nodes": self.node_counts, "if": self.n_if, "unresolved": self.unresolved,
                "hand": self.kernel_counts(), "errors": len(self.errors),
                "collectives": sum(self.collective_counts().values())}

    # ----------------------------------------------------------- assertions
    def assert_walked(self) -> "GraphContract":
        """The walk read every node: no call of it failed."""
        if self.errors:
            self._fail(f"the walk could not read the graph: {self.errors[:4]}")
        return self

    def assert_no_host_callbacks(self) -> "GraphContract":
        hosts = [n for n in self.nodes if n.kind == "host"]
        if hosts:
            self._fail(f"{len(hosts)} host node(s) in the round: a round must not re-enter "
                       "the host")
        return self

    def assert_no_host_transfers(self) -> "GraphContract":
        bad = [n.name for n in self.nodes if n.kind == "memcpy" and n.name != "DtoD"]
        if bad:
            self._fail(f"memcpy nodes with a host end in the round: {bad}")
        return self

    def assert_gated(self) -> "GraphContract":
        """One IF node per gated segment, each after its set_cond node, and
        every gated segment's nodes inside an IF body (the reference's trip
        counts: the round's structure survived the capture)."""
        gated = [seg for seg, g in self.segments if g]
        if self.n_if != len(gated):
            self._fail(f"{self.n_if} IF nodes for the gated segments {gated}")
        for seg in gated:
            open_ = [n for n in self.segment_nodes(seg) if not n.gated]
            if open_:
                self._fail(f"segment {seg!r} has {len(open_)} node(s) outside its IF body")
        return self

    def assert_segment_launches(self, segment_launches: Dict[str, Dict[str, int]]
                                ) -> "GraphContract":
        """Each segment's hand-kernel nodes equal the launches its wrappers
        counted during the capture (``server.segment_launches``), and the
        flash-decode combine nodes their split launches."""
        for seg, counts in segment_launches.items():
            got = self.kernel_counts(seg)
            want = {k: v for k, v in counts.items() if v}
            have = {k: v for k, v in got.items() if k != "combine"}
            if have != want:
                self._fail(f"segment {seg!r} holds hand-kernel nodes {have}, its wrappers "
                           f"counted {want}")
            splits = want.get("flash_decode", 0) + want.get("flash_decode_paged", 0)
            if got.get("combine", 0) != splits:
                self._fail(f"segment {seg!r} holds {got.get('combine', 0)} combine nodes for "
                           f"{splits} flash-decode launches")
        return self

    def cache_copy_bytes(self, ranges) -> int:
        """Bytes the memcpy nodes copy out of ``ranges`` ((address, bytes)
        of each cache tensor) into memory outside them."""
        def inside(a: int) -> bool:
            return any(lo <= a < lo + n for lo, n in ranges)

        return sum(n.nbytes for n in self.nodes
                   if n.kind == "memcpy" and inside(n.src) and not inside(n.dst))

    def assert_no_cache_copy(self, ranges) -> "GraphContract":
        """The round's memcpy nodes copy fewer bytes out of the cache
        (``ranges``, as ``cache_copy_bytes`` takes them) than it holds: no
        second copy of it, kept or dropped within the round."""
        total, got = sum(n for _, n in ranges), self.cache_copy_bytes(ranges)
        if total and got >= total:
            self._fail(f"memcpy nodes copy {got} bytes out of the cache's {total}: a second copy "
                       "of the cache")
        return self

    def assert_no_collectives(self) -> "GraphContract":
        bad = [n.name for n in self.nodes if n.kind == "kernel" and "nccl" in n.name.lower()]
        if bad:
            self._fail(f"collective kernels in a single-card round: {bad[:4]}")
        return self


def assert_donated(captured: Dict[str, Tuple[int, int]], now: Dict[str, Tuple[int, int]],
                   live_bytes: Optional[int] = None, name: str = "round") -> None:
    """The in-place contract (the reference's donation): every tensor the
    graph was captured with still holds the storage it had (``captured``
    against ``now``: the server's ``state_ptrs()``, (address, bytes) by
    path, at the capture and later), and, where given, the ``live_bytes``
    the capture left allocated in the graph's pool stay below the cache's
    bytes, so no second copy of the cache lives there."""
    moved = sorted(k for k in captured if now.get(k) != captured[k])
    if moved:
        raise ContractViolation(f"[{name}] the graph writes storage these no longer hold: "
                                f"{moved[:6]}{' ...' if len(moved) > 6 else ''}")
    cache = sum(n for k, (_, n) in captured.items() if k.startswith("cache"))
    if live_bytes is not None and live_bytes >= cache:
        raise ContractViolation(f"[{name}] the capture left {live_bytes} bytes live in the graph "
                                f"pool, not below the cache's {cache}: a second copy of the cache")


def round_graphs(server) -> Dict[str, Tuple[Tuple[str, bool], ...]]:
    """The graphs one single round launches, by name, each with its
    segments ``(name, gated)``: one, the assembled round. Split and cascade
    rounds are host-driven and launch none; they raise."""
    if getattr(server, "round_mode", None) != "single":
        raise ValueError(f"a {server.mode!r} server in {server.round_mode!r} rounds has no "
                         "captured round graph (split rounds are host-driven; capturing the "
                         "cascade is ROADMAP B.1)")
    return {"round": tuple((seg, pred is not None) for seg, _, pred in server._plan())}


def server_round_contracts(server) -> Dict[str, GraphContract]:
    """One contract per graph a single round of ``server`` launches,
    cross-checked against the runtime counters: ``graph_replays`` is
    ``round_dispatches`` times their number."""
    graphs = round_graphs(server)
    out = {name: GraphContract.from_server(server, name) for name in graphs}
    stats = server.stats
    if stats["graph_replays"] != len(out) * stats["round_dispatches"]:
        raise ContractViolation(f"{stats['graph_replays']} graph replays for "
                                f"{stats['round_dispatches']} round dispatches of "
                                f"{len(out)} graph(s)")
    return out


def check_round(server) -> Dict[str, GraphContract]:
    """``server_round_contracts`` with every assertion held: the walk read
    every node, no host node or host transfer, the gated segments behind
    IF nodes, each segment's hand kernels as counted, no collective (on a
    mesh the NCCL nodes are the round's own, counted apart), no copy of
    the cache, and the cache and state in place with no second copy of the
    cache left live by the capture."""
    cons = server_round_contracts(server)
    cache = [v for k, v in server.capture_ptrs.items() if k.startswith("cache")]
    for con in cons.values():
        (con.assert_walked().assert_no_host_callbacks().assert_no_host_transfers().assert_gated()
         .assert_segment_launches(server.segment_launches).assert_no_cache_copy(cache))
        if getattr(server, "mesh", None) is None:
            con.assert_no_collectives()
    assert_donated(server.capture_ptrs, server.state_ptrs(), server.graph_live_bytes)
    return cons


def assert_telemetry_transparent(off: Dict[str, GraphContract], on: Dict[str, GraphContract],
                                 tail: str = "tail") -> Dict[str, int]:
    """Telemetry changes nothing but the tail segment, the reference's
    gate over its compiled rounds: ``off`` / ``on`` are ``server_round_contracts`` of two
    servers identical but ``telemetry=``. The same graphs, segments and IF
    nodes; no host node or host transfer on the telemetry-on side; every
    segment but ``tail`` holds the same nodes; the tail holds the
    telemetry-off tail's and more, none of them a hand kernel. Returns the
    tail's added nodes by kind."""
    if set(off) != set(on):
        raise ContractViolation(f"telemetry changed the graph set: off={sorted(off)} "
                                f"on={sorted(on)}")
    added: Dict[str, int] = {}
    for name, con_on in on.items():
        con_off = off[name]
        con_on.assert_no_host_callbacks().assert_no_host_transfers()
        if con_on.segments != con_off.segments or con_on.n_if != con_off.n_if:
            raise ContractViolation(f"[{name}] telemetry changed the segments or IF nodes: "
                                    f"{con_off.segments} -> {con_on.segments}")
        for seg, _ in con_on.segments:
            a = collections.Counter((n.kind, n.name) for n in con_off.segment_nodes(seg))
            b = collections.Counter((n.kind, n.name) for n in con_on.segment_nodes(seg))
            if seg != tail and a != b:
                raise ContractViolation(f"[{name}] telemetry changed segment {seg!r}: "
                                        f"{dict(b - a)} added, {dict(a - b)} gone")
            if seg == tail:
                if a - b:
                    raise ContractViolation(f"[{name}] telemetry dropped tail nodes: {dict(a - b)}")
                if con_on.kernel_counts(seg) != con_off.kernel_counts(seg):
                    raise ContractViolation(f"[{name}] telemetry changed the tail's hand kernels")
                for (kind, _), n in (b - a).items():
                    added[kind] = added.get(kind, 0) + n
    return added
