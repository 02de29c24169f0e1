"""Keep JAX and the JAX package out of the benchmark's process.

The port's package name begins with the JAX package's (``repro_torch``
against ``repro``), so modules are compared by their top-level name, the
part before the first dot, whole. ``install`` refuses those imports from the
start of a run; ``loaded`` names any that got in anyway (checked again once
the window has closed)."""
from __future__ import annotations

import importlib.abc
import os
import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def is_forbidden(name: str) -> bool:
    return top_level(name) in FORBIDDEN


def loaded() -> List[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({top_level(m) for m in list(sys.modules) if is_forbidden(m)})


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if is_forbidden(fullname):
            raise ImportError(f"the benchmark does not load {top_level(fullname)!r} "
                              f"(asked for {fullname!r})")
        return None


def install() -> None:
    """Refuse forbidden imports from here on, and keep libraries from loading
    JAX by themselves."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if not any(isinstance(f, _Refuse) for f in sys.meta_path):
        sys.meta_path.insert(0, _Refuse())
