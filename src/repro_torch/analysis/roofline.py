"""Roofline terms on one NVIDIA H100 SXM: the port's counterpart of the
reference's ``analysis/roofline.py``.

  compute term    = FLOPs / peak rate of the type they run in
  memory term     = bytes / HBM rate
  collective term = collective bytes / NVLink rate (the bytes one rank
                    sends in its all-reduces, ``costs.decode_collectives``;
                    0 on one device)

Counts follow one rule: each input byte read once, each
output byte written once, and data-dependent work at what the inputs need
(``analysis.costs`` computes them from the config and the shapes). A
measured time's roofline share is ``t_bound / measured``.

Constants, from NVIDIA's H100 SXM data sheet (dense rates, no sparsity, at
the full 700 W power limit; a card set lower runs slower under load):
HBM3 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s
TF32, 989 TFLOP/s bfloat16, 1979 TOP/s int8; NVLink 4 900 GB/s a GPU in
both directions together, so 450 GB/s each way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

HBM_BW = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "int8": 1979e12}
NVLINK_BW = 450e9


def dtype_name(dtype) -> str:
    """``"float32"`` for ``torch.float32`` or ``"float32"``; the key of
    ``PEAK_FLOPS`` a type's operations run at."""
    name = str(dtype).replace("torch.", "")
    if name not in PEAK_FLOPS:
        raise KeyError(f"no H100 peak for {dtype!r}; known: {sorted(PEAK_FLOPS)}")
    return name


def peak(dtype) -> float:
    """The H100's dense peak rate (operations a second) for ``dtype``."""
    return PEAK_FLOPS[dtype_name(dtype)]


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    """The roofline terms of one call, and the one record of a counted
    cost (``analysis.costs`` returns these)."""

    name: str
    flops: float                 # counted operations (2 a multiply-add)
    bytes_hbm: float             # bytes the call moves (max of analytic and tensor I/O)
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)  # empty off-mesh
    peak_memory: Optional[float] = None   # bytes, max_memory_allocated on the card
    flops_counted: float = 0.0   # FlopCounterMode's count of the aten ops run
    bytes_analytic: float = 0.0  # the analytic traffic model (analysis.costs)
    dtype: str = "bfloat16"      # the type whose peak bounds the operations
    t_ops: Optional[float] = None  # compute seconds when the flops run in several types

    @classmethod
    def of(cls, name: str, flops: float, nbytes: float, dtype) -> "RooflineReport":
        """``flops`` operations of ``dtype`` over ``nbytes`` moved."""
        return cls(name, float(flops), float(nbytes), dtype=dtype_name(dtype))

    def __add__(self, other: "RooflineReport") -> "RooflineReport":
        """Two calls in sequence: their counts summed, the compute terms
        summed at each one's peak; ``dtype`` the larger compute term's."""
        coll = dict(self.coll_bytes)
        for k, v in other.coll_bytes.items():
            coll[k] = coll.get(k, 0) + v
        dt = self.dtype if self.t_compute >= other.t_compute else other.dtype
        return RooflineReport(self.name, self.flops + other.flops, self.bytes_hbm + other.bytes_hbm,
                              coll, flops_counted=self.flops_counted + other.flops_counted,
                              bytes_analytic=self.bytes_analytic + other.bytes_analytic,
                              dtype=dt, t_ops=self.t_compute + other.t_compute)

    def named(self, name: str) -> "RooflineReport":
        return dataclasses.replace(self, name=name)

    @property
    def coll_total(self) -> float:
        return float(sum(self.coll_bytes.values()))

    @property
    def t_compute(self) -> float:
        return self.t_ops if self.t_ops is not None else self.flops / peak(self.dtype)

    @property
    def t_memory(self) -> float:
        """Memory term from the analytic traffic model where given, else
        from the bytes the call moves."""
        return (self.bytes_analytic or self.bytes_hbm) / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_total / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bound_by(self) -> str:
        """The bottleneck in a kernel record's words: ``"bytes"``,
        ``"operations"`` or ``"collective"``."""
        return {"compute": "operations", "memory": "bytes"}.get(self.bottleneck, "collective")

    def bound_ms(self) -> Tuple[float, str]:
        """(the least time in ms, ``bound_by``)."""
        return self.t_bound * 1e3, self.bound_by

    def share(self, ms: float) -> float:
        """The roofline share of a measured time in ms: ``t_bound / measured``."""
        return self.t_bound * 1e3 / ms

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "dtype": self.dtype,
            "flops": self.flops,
            "flops_counted": self.flops_counted,
            "bytes_hbm": self.bytes_hbm,
            "bytes_analytic": self.bytes_analytic,
            "coll_bytes": self.coll_bytes,
            "peak_memory": self.peak_memory,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
        }


def analyze_call(name: str, fn, *args, dtype, device, analytic_flops: float = 0.0,
                 analytic_bytes: float = 0.0, **kwargs) -> RooflineReport:
    """Roofline terms of one call ``fn(*args, **kwargs)``, run once.

    FLOPs are the larger of ``analytic_flops`` (``analysis.costs``) and
    ``FlopCounterMode``'s count of the aten ops the call runs (a hand
    kernel, launched through ctypes, is invisible to it). The memory term
    is the larger of ``analytic_bytes`` and the bytes of the call's tensor
    inputs and outputs, each read or written once. ``peak_memory`` is
    ``max_memory_allocated`` over the call on the card, None on the CPU."""
    import torch

    from repro_torch.analysis import costs

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out, counted = costs.count_flops(fn, *args, **kwargs)
    peak_mem = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak_mem = float(torch.cuda.max_memory_allocated(dev))
    io = costs.tensor_bytes(args, kwargs, out)
    return RooflineReport(name, max(float(counted["total"]), analytic_flops),
                          max(float(io), analytic_bytes), {}, peak_mem,
                          flops_counted=float(counted["total"]), bytes_analytic=analytic_bytes,
                          dtype=dtype_name(dtype))
