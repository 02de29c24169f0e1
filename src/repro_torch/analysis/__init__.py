"""The analysis layer of the port: roofline terms on the H100
(``analysis.roofline``), counted costs of the GEMMs, kernels, layers and
model calls (``analysis.costs``), dispatch contracts over the captured round
graph (``analysis.contracts``) and the capture-discipline lint (PORT001-005,
``analysis.lint``)."""
from repro_torch.analysis.contracts import (
    ContractViolation,
    GraphContract,
    server_round_contracts,
)
from repro_torch.analysis.roofline import RooflineReport, analyze_call

__all__ = [
    "ContractViolation",
    "Finding",
    "GraphContract",
    "RooflineReport",
    "analyze_call",
    "run_paths",
    "server_round_contracts",
]


def __getattr__(name: str):
    # the lint loads on first use, so that ``python -m
    # repro_torch.analysis.lint`` does not import its module twice
    if name in ("Finding", "run_paths"):
        from repro_torch.analysis import lint

        return getattr(lint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
