"""Capture-discipline lint: AST rules for the port's CUDA-graph hazards.

The counterpart of the reference's ``analysis/lint.py`` (REPRO001-005, its
JAX dispatch discipline), recast for what breaks a captured CUDA graph. A
single round is captured once at build (``serving/server.py::_capture``)
and replayed: host work inside a captured segment runs at the capture only,
a host sync there fails the capture or stalls every replay, and a tensor
the graph writes must keep its storage for as long as the graph lives.

Rules:

  PORT001  a host sync (``.item()``, ``.cpu()``, ``.tolist()``,
           ``.numpy()``, ``torch.cuda.synchronize``, ``float()`` /
           ``int()`` / ``bool()`` of a tensor) in a function reachable,
           by a static walk of the call graph, from a captured segment: the
           server's ``_seg_*`` and ``core/engine.py``'s ``*_prologue`` /
           ``*_draft`` / ``*_tail`` / ``prefill_chunk_stage``.
  PORT002  rebinding a tensor that a captured graph writes in place
           (``self.X = ...`` or ``self.X["key"] = ...`` outside
           ``__init__`` and the capture, for an ``X`` a segment method
           reads): the graph keeps writing the old storage. The
           counterpart of use-after-donate.
  PORT003  a ``CUDAGraph`` or ``torch.cuda.graph(`` built inside a loop,
           or once per call outside a capture function (``*capture*``).
  PORT004  host side effects in a function reachable from a captured
           segment (``print``, ``time.*``, Python ``random``, an ``if`` /
           ``while`` on a tensor): they run at the capture only.
  PORT005  ``time.time()`` anywhere (not monotonic), and a
           ``perf_counter`` delta around device work with no synchronize,
           event or host read between start and stop (launches return
           before the device finishes).

Waivers: append ``# port: noqa-PORT00x: <why this is safe here>`` to the
flagged line. The reason is required: a bare waiver is reported itself
(PORT000).

CLI::

    python -m repro_torch.analysis.lint src/repro_torch   # exit 1 on findings
    python -m repro_torch.analysis.lint --list-rules

Standard library only (``ast``, ``fnmatch``, ``re``).
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# leaf-name patterns of the functions a captured segment runs
DEFAULT_ROOTS = ("_seg_*", "*_prologue", "*_draft", "*_tail", "prefill_chunk_stage")

RULES = {
    "PORT000": "lint waiver without a reason",
    "PORT001": "host sync in code a captured segment reaches",
    "PORT002": "rebinding a tensor a captured graph writes in place",
    "PORT003": "CUDA graph built in a loop or once per call",
    "PORT004": "host side effect in code a captured segment reaches",
    "PORT005": "timing hygiene (wall clock / unsynced device timing)",
}

_SYNC_METHODS = {"item": True, "tolist": True, "numpy": True, "cpu": False}   # name: takes no args
_REDUCTIONS = {"any", "all", "sum", "max", "min", "mean", "argmax", "argmin", "norm", "equal",
               "allclose", "count_nonzero"}
_SHAPE_ATTRS = {"shape", "ndim", "dtype", "device"}
_WAIVER_RE = re.compile(r"#\s*port:\s*noqa-(PORT\d{3})\b[:\s-]*(.*?)\s*$")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    msg: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.msg}"


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Module:
    """One parsed file: imports, function definitions, parents."""

    def __init__(self, path: str, source: str, name: str):
        self.path = path
        self.name = name
        self.source_lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.mod_alias: Dict[str, str] = {}     # local name -> module ("np" -> "numpy")
        self.sym_alias: Dict[str, str] = {}     # local name -> imported symbol's fq name
        self.functions: Dict[str, ast.FunctionDef] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.mod_alias[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    fq = f"{node.module}.{a.name}"
                    self.mod_alias.setdefault(a.asname or a.name, fq)
                    self.sym_alias[a.asname or a.name] = fq

        def visit(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = f"{prefix}{child.name}"
                    self.functions[q] = child   # type: ignore[assignment]
                    visit(child, q + ".")
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}{child.name}.")
                else:
                    visit(child, prefix)

        visit(self.tree, "")

    def resolve(self, node: ast.AST) -> str:
        """The dotted name of a call's function with its first part resolved
        through this module's imports (``np.asarray`` -> ``numpy.asarray``)."""
        d = _dotted(node) or ""
        base = d.split(".")[0]
        fq = self.mod_alias.get(base)
        return fq + d[len(base):] if fq else d

    def is_torch(self, node: ast.AST) -> bool:
        return self.resolve(node).startswith("torch.")

    def enclosing(self, node: ast.AST, kinds) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, kinds):
                return cur
            cur = self.parents.get(cur)
        return None

    def call_targets(self, call: ast.Call) -> List[str]:
        """Candidate qualified callees of a call (and of function references
        passed as its arguments: a ``functools.partial`` body counts as
        called)."""
        out: List[str] = []
        refs = [call.func] + [a for a in call.args if isinstance(a, (ast.Name, ast.Attribute))]
        for i, f in enumerate(refs):
            d = _dotted(f)
            if not d:
                continue
            parts = d.split(".")
            if parts[0] == "self":
                cls = self.enclosing(call, ast.ClassDef)
                if cls is not None:
                    out.append(f"{self.name}.{cls.name}.{parts[-1]}")
                continue
            if d in self.sym_alias:
                out.append(self.sym_alias[d])
            if parts[0] in self.mod_alias and len(parts) > 1:
                out.append(self.mod_alias[parts[0]] + "." + ".".join(parts[1:]))
            out.append(f"{self.name}.{d}")
        return out


class Linter:
    def __init__(self, roots: Sequence[str] = DEFAULT_ROOTS):
        self.roots = tuple(roots)
        self.modules: List[_Module] = []
        self.findings: List[Finding] = []
        self.index: Dict[str, Tuple[_Module, ast.FunctionDef]] = {}

    # ------------------------------------------------------------- loading
    @staticmethod
    def _module_name(path: str) -> str:
        norm = path.replace(os.sep, "/")
        for anchor in ("/src/", "src/"):
            if anchor in norm:
                tail = norm.split(anchor, 1)[1]
                return tail[:-3].replace("/", ".") if tail.endswith(".py") else tail
        return os.path.splitext(os.path.basename(norm))[0]

    def add_source(self, path: str, source: str) -> None:
        mod = _Module(path, source, self._module_name(path))
        self.modules.append(mod)
        for q, node in mod.functions.items():
            self.index[f"{mod.name}.{q}"] = (mod, node)

    def add_paths(self, paths: Iterable[str]) -> None:
        for p in paths:
            if os.path.isdir(p):
                for dirpath, dirnames, filenames in os.walk(p):
                    dirnames[:] = sorted(d for d in dirnames if d not in ("__pycache__", "build"))
                    for fn in sorted(filenames):
                        if fn.endswith(".py"):
                            self.add_paths([os.path.join(dirpath, fn)])
            elif p.endswith(".py"):
                with open(p, encoding="utf-8") as f:
                    self.add_source(p, f.read())

    # --------------------------------------------------------- reachability
    def _is_root(self, fq: str) -> bool:
        leaf = fq.rsplit(".", 1)[-1]
        return any(fnmatch.fnmatchcase(leaf, r) for r in self.roots)

    def reachable(self) -> Set[str]:
        work = [fq for fq in self.index if self._is_root(fq)]
        seen: Set[str] = set(work)
        while work:
            mod, node = self.index[work.pop()]
            for call in ast.walk(node):
                if not isinstance(call, ast.Call):
                    continue
                for cand in mod.call_targets(call):
                    if cand in self.index and cand not in seen:
                        seen.add(cand)
                        work.append(cand)
        return seen

    # -------------------------------------------------------------- running
    def run(self) -> List[Finding]:
        reachable = self.reachable()
        # a nested function is scanned with its parent
        tops = {fq for fq in reachable if fq.rsplit(".", 1)[0] not in reachable}
        for fq in sorted(tops):
            mod, node = self.index[fq]
            where = f"reachable from a captured segment via {fq.rsplit('.', 1)[-1]}"
            self._check_port001(mod, node, where)
            self._check_port004(mod, node, where)
        for mod in self.modules:
            self._check_port002(mod)
            self._check_port003(mod)
            self._check_port005(mod)
        return self._apply_waivers()

    def _emit(self, mod: _Module, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(Finding(mod.path, getattr(node, "lineno", 0),
                                     getattr(node, "col_offset", 0), rule, msg))

    # ------------------------------------------------------------- helpers
    def _tensorish(self, mod: _Module, arg: ast.AST) -> bool:
        """Heuristic: a tensor element or a torch / reduction call's result
        is a device value; names, attributes and arithmetic are host
        scalars, and so are a tensor's shape and sizes."""
        if isinstance(arg, ast.Subscript):
            return not (isinstance(arg.value, ast.Attribute) and arg.value.attr in _SHAPE_ATTRS)
        if isinstance(arg, ast.Call):
            if mod.is_torch(arg.func):
                return True
            f = arg.func
            return isinstance(f, ast.Attribute) and f.attr in _REDUCTIONS
        return False

    def _sync_call(self, mod: _Module, node: ast.Call) -> Optional[str]:
        """What kind of host sync ``node`` is, or None."""
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
            if not (_SYNC_METHODS[f.attr] and node.args):
                return f".{f.attr}()"
        if mod.resolve(f) == "torch.cuda.synchronize":
            return "torch.cuda.synchronize"
        if (isinstance(f, ast.Name) and f.id in ("float", "int", "bool") and node.args
                and self._tensorish(mod, node.args[0])):
            return f"{f.id}() of a tensor"
        return None

    # ------------------------------------------------------------- PORT001
    def _check_port001(self, mod: _Module, fn: ast.FunctionDef, where: str) -> None:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                what = self._sync_call(mod, node)
                if what:
                    self._emit(mod, node, "PORT001", f"{what} syncs the host ({where})")

    # ------------------------------------------------------------- PORT002
    def _check_port002(self, mod: _Module) -> None:
        for cls in (n for n in ast.walk(mod.tree) if isinstance(n, ast.ClassDef)):
            methods = {m.name: m for m in cls.body if isinstance(m, ast.FunctionDef)}
            segs = [m for name, m in methods.items() if self._is_root(name)]
            if not segs:
                continue
            # self attributes the segments read, and the methods they call
            captured: Set[str] = set()
            work, seen = list(segs), {m.name for m in segs}
            while work:
                m = work.pop()
                for node in ast.walk(m):
                    d = _dotted(node) if isinstance(node, ast.Attribute) else None
                    if d and d.startswith("self.") and isinstance(node.ctx, ast.Load):
                        attr = d.split(".")[1]
                        if attr in methods and attr not in seen:
                            seen.add(attr)
                            work.append(methods[attr])
                        elif attr not in methods:
                            captured.add(attr)
            for name, m in methods.items():
                if name == "__init__" or "capture" in name:
                    continue
                for node in ast.walk(m):
                    # ``+=`` on a tensor writes it in place: only assignments rebind
                    targets = []
                    if isinstance(node, ast.Assign):
                        targets = node.targets
                    elif isinstance(node, ast.AnnAssign):
                        targets = [node.target]
                    flat: List[ast.AST] = []
                    for t in targets:
                        flat.extend(t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t])
                    for t in flat:
                        attr = self._rebound(t)
                        if attr in captured:
                            self._emit(mod, t, "PORT002",
                                       f"self.{attr} is rebound in {name}(): a captured graph "
                                       "keeps writing its old storage; write it in place")

    @staticmethod
    def _rebound(t: ast.AST) -> Optional[str]:
        """``X`` for a target ``self.X`` or ``self.X["key"]``, else None."""
        if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) and t.value.id == "self":
            return t.attr
        if (isinstance(t, ast.Subscript) and isinstance(t.slice, ast.Constant)
                and isinstance(t.slice.value, str)):
            return Linter._rebound(t.value)
        return None

    # ------------------------------------------------------------- PORT003
    def _check_port003(self, mod: _Module) -> None:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = mod.resolve(node.func)
            if name not in ("torch.cuda.CUDAGraph", "torch.cuda.graph"):
                continue
            fn = mod.enclosing(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            cur = mod.parents.get(node)
            while cur is not None and cur is not fn:
                if isinstance(cur, (ast.For, ast.While, ast.comprehension)):
                    self._emit(mod, node, "PORT003",
                               f"{name} built inside a loop: a new graph (and capture) every "
                               "iteration; capture once and replay")
                    break
                cur = mod.parents.get(cur)
            if fn is not None and "capture" not in fn.name:
                self._emit(mod, node, "PORT003",
                           f"{name} built in {fn.name}(), once per call: capture once, in a "
                           "capture function, and replay")

    # ------------------------------------------------------------- PORT004
    def _check_port004(self, mod: _Module, fn: ast.FunctionDef, where: str) -> None:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                f = node.func
                name = mod.resolve(f)
                if isinstance(f, ast.Name) and f.id in ("print", "input", "open"):
                    self._emit(mod, node, "PORT004",
                               f"{f.id}() runs at the capture only ({where})")
                elif name.startswith("time.") or name.startswith("random."):
                    self._emit(mod, node, "PORT004",
                               f"{name}() runs at the capture only ({where})")
            elif (isinstance(node, (ast.If, ast.While, ast.IfExp))
                  and self._tensor_test(mod, node.test)):
                self._emit(mod, node, "PORT004",
                           f"a Python branch on a tensor is taken once, at the capture ({where})")

    def _tensor_test(self, mod: _Module, test: ast.AST) -> bool:
        if isinstance(test, ast.BoolOp):
            return any(self._tensor_test(mod, v) for v in test.values)
        if isinstance(test, ast.UnaryOp):
            return self._tensor_test(mod, test.operand)
        if isinstance(test, ast.Compare):
            return self._tensorish(mod, test.left) and isinstance(test.left, ast.Call)
        return isinstance(test, ast.Call) and self._tensorish(mod, test)

    # ------------------------------------------------------------- PORT005
    def _check_port005(self, mod: _Module) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and mod.resolve(node.func) == "time.time":
                self._emit(mod, node, "PORT005",
                           "time.time() is not monotonic: use time.perf_counter()")
        for fn in mod.functions.values():
            self._check_unsynced(mod, fn)

    def _device_work(self, mod: _Module, node: ast.Call) -> bool:
        """A call that may launch device work: a torch function, a graph's
        launch or replay, or a function of the port itself."""
        f = node.func
        name = mod.resolve(f)
        if name.startswith("torch.") and not name.startswith("torch.cuda."):
            return True
        if isinstance(f, ast.Attribute) and f.attr in ("launch", "replay"):
            return True
        return name.startswith("repro_torch.")

    def _check_unsynced(self, mod: _Module, fn: ast.FunctionDef) -> None:
        starts: Dict[str, int] = {}
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                    and mod.resolve(node.value.func) == "time.perf_counter"
                    and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)):
                starts.setdefault(node.targets[0].id, node.lineno)
        for node in ast.walk(fn):
            if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)
                    and isinstance(node.left, ast.Call)
                    and mod.resolve(node.left.func) == "time.perf_counter"
                    and isinstance(node.right, ast.Name) and node.right.id in starts):
                continue
            lo, hi = starts[node.right.id], node.lineno
            work = synced = False
            for call in ast.walk(fn):
                if not (isinstance(call, ast.Call) and lo <= getattr(call, "lineno", 0) <= hi):
                    continue
                if self._sync_call(mod, call) or (
                        isinstance(call.func, ast.Attribute)
                        and call.func.attr in ("synchronize", "elapsed_time")):
                    synced = True
                elif self._device_work(mod, call):
                    work = True
            if work and not synced:
                self._emit(mod, node, "PORT005",
                           "perf_counter delta around device work with no synchronize, event "
                           "or host read: the launches return before the device finishes")

    # -------------------------------------------------------------- waivers
    def _apply_waivers(self) -> List[Finding]:
        out: List[Finding] = []
        waived: Dict[Tuple[str, int], str] = {}
        for mod in self.modules:
            for i, line in enumerate(mod.source_lines, start=1):
                m = _WAIVER_RE.search(line)
                if not m:
                    continue
                rule, why = m.group(1), m.group(2).strip()
                if why:
                    waived[(mod.path, i)] = rule
                else:
                    out.append(Finding(mod.path, i, 0, "PORT000",
                                       f"waiver for {rule} has no reason: say why the finding "
                                       "is safe here"))
        for f in self.findings:
            if waived.get((f.path, f.line)) != f.rule:
                out.append(f)
        return sorted(set(out), key=lambda f: (f.path, f.line, f.rule, f.col))


def run_paths(paths: Sequence[str], roots: Optional[Sequence[str]] = None) -> List[Finding]:
    linter = Linter(roots=tuple(roots) if roots else DEFAULT_ROOTS)
    linter.add_paths(paths)
    return linter.run()


def run_sources(sources: Dict[str, str], roots: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint in-memory sources, ``{path: text}``."""
    linter = Linter(roots=tuple(roots) if roots else DEFAULT_ROOTS)
    for path, text in sources.items():
        linter.add_source(path, text)
    return linter.run()


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.lint",
                                 description="Capture-discipline lint (PORT001-005).")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint (default: src/repro_torch)")
    ap.add_argument("--roots", default=None,
                    help="comma-separated extra root patterns for the PORT001/004 walk")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0
    roots = list(DEFAULT_ROOTS)
    if args.roots:
        roots.extend(r.strip() for r in args.roots.split(",") if r.strip())
    findings = run_paths(args.paths, roots=roots)
    for f in findings:
        print(f.render())
    n = len(findings)
    print(f"port-lint: {n} finding{'s' if n != 1 else ''} in {', '.join(args.paths)}",
          file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
