"""Draft-level bank: a §4.1 DSIA hierarchy made into executable batched
levels for the ``cascade_fused`` serving mode; the port of the reference's
``serving/draft_bank.py``.

``dsia.build_hierarchy`` describes a hierarchy as one ``DraftSpec`` per
level (gates, quantize, attn_override and the App. D cold-start priors).
The bank turns each neural level into what the batched round runs:

  - **layers** — on a homogeneous stack a level runs its kept layers only
    (``layer_ids``, slice exec, over views of the target's params and
    cache, as the server's single drafter does); elsewhere it runs every
    layer under its 0/1 gate vector (``gates``, mask exec);
  - **int8 levels** — ``int8_exec="kernel"`` (what ``"auto"`` picks on a
    CUDA device) quantizes the level's MLP weights once, at build
    (``kernels.ops.prequantize``: int8 and column scales), for the layers
    the level runs, and sets ``quantize="int8"``: each MLP product then
    quantizes its activation rows and runs the W8A8 kernel. Levels over the
    same params share one copy. ``"sim"`` (what ``"auto"`` picks on the
    CPU) is the reference's off-TPU simulation: a fake-quantized copy of
    every weight (``engine.fake_quant_int8``). ``param_bytes`` counts the
    copy made either way;
  - **attn_override** — StreamingAttention levels carry the override dict
    ``models.model.decode_step`` applies to full-attention layers.

``levels[0]`` is the strongest level (closest to the target), ``levels[-1]``
the cheapest, the cascade's drafter. The retrieval bottom (PLD) is kept as
``bank.pld`` for priors; it never runs on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config.base import ModelConfig
from repro_torch.core.dsia import PLD_SPEC, DraftSpec
from repro_torch.core.engine import fake_quant_int8
from repro_torch.kernels.ops import QuantWeight, prequantize
from repro_torch.models import model as M
from repro_torch.models import shard_utils as SU

INT8_EXECS = ("auto", "kernel", "sim")


class QuantStack:
    """A stacked (R, K, N) weight of which some layers were quantized once:
    ``stack[r]`` (the layer view ``models.model._run_stack`` takes) is layer
    r's ``QuantWeight``; a layer that was not quantized raises."""

    def __init__(self, layers: Dict[int, QuantWeight]):
        self.layers = layers

    def __getitem__(self, r: int) -> QuantWeight:
        if r not in self.layers:
            raise KeyError(f"layer {r} of this level was not quantized")
        return self.layers[r]


@dataclasses.dataclass(frozen=True)
class DraftLevel:
    """One executable cascade level (see the module docstring)."""
    index: int                       # 0 = strongest, len-1 = cheapest/drafter
    spec: DraftSpec
    params: dict                     # executable params (shared, or with a quantized copy)
    gates: Optional[np.ndarray]      # (num_layers,) float32, None = all layers on
    layer_ids: Optional[List[int]]   # kept layers (slice exec), None = every layer
    quantize: Optional[str]          # "int8" -> W8A8 kernel path at decode
    attn_override: Optional[dict]    # {"kind", "window", "sink"} or None
    owns_params: bool                # True iff ``params`` holds a quantized copy

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def exec_gates(self) -> Optional[np.ndarray]:
        """The gate vector a decode takes: None under slice exec."""
        return self.gates if self.layer_ids is None else None


class DraftBank:
    """A materialized DSIA hierarchy and its per-(level, slot) tracker keys.

    ``int8_exec`` picks the ActivationQuant execution: ``"kernel"`` (the
    MLP weights quantized once, the W8A8 kernel on CUDA tensors, its plain
    version on CPU tensors), ``"sim"`` (the fake-quantized copy) or
    ``"auto"`` (``"kernel"`` on a CUDA device, ``"sim"`` on the CPU)."""

    def __init__(self, cfg: ModelConfig, params: dict, hierarchy: Sequence[DraftSpec], *,
                 int8_exec: str = "auto"):
        if int8_exec not in INT8_EXECS:
            raise ValueError(f"unknown int8_exec {int8_exec!r}")
        if int8_exec == "auto":
            int8_exec = "kernel" if params["embed"].device.type == "cuda" else "sim"
        self.int8_exec = int8_exec
        self.cfg = cfg
        neural = [s for s in hierarchy if s.kind == "neural"]
        retrieval = [s for s in hierarchy if s.kind == "retrieval"]
        if not neural:
            raise ValueError("hierarchy has no neural level to execute")
        self.pld: DraftSpec = retrieval[0] if retrieval else PLD_SPEC
        segs = M.layout(cfg)
        homogeneous = len(segs) == 1 and len(segs[0].unit) == 1
        self._sim: Optional[dict] = None                      # the fake-quantized copy
        self._quant: Dict[Tuple[int, int, str, int], QuantWeight] = {}   # one per weight
        self.levels: List[DraftLevel] = []
        for i, spec in enumerate(neural):
            gates = layer_ids = None
            if spec.gates is not None:
                gates = spec.gates_array(cfg.num_layers)
                if homogeneous:
                    layer_ids = [int(j) for j in np.flatnonzero(gates > 0)]
            level_params, quantize, owns = params, None, False
            if spec.quantize is not None:
                if spec.quantize != "int8":
                    raise ValueError(f"level {spec.name!r}: unsupported quantize "
                                     f"{spec.quantize!r} (only 'int8')")
                if int8_exec == "kernel":
                    # mask exec runs every layer, gated-off ones too
                    runs = layer_ids if layer_ids is not None else range(cfg.num_layers)
                    level_params, quantize = self._quantized(params, runs), "int8"
                else:
                    if self._sim is None:
                        self._sim = fake_quant_int8(params, cfg=cfg)
                    level_params = self._sim
                owns = True
            override = None
            if spec.attn_override is not None:
                kind, window, sink = spec.attn_override
                override = {"kind": kind, "window": window, "sink": sink}
            self.levels.append(DraftLevel(index=i, spec=spec, params=level_params, gates=gates,
                                          layer_ids=layer_ids, quantize=quantize,
                                          attn_override=override, owns_params=owns))
        self.param_bytes = sum(q.nbytes for q in self._quant.values())
        if self._sim is not None:
            leaves: list = []
            M.tree_map(leaves.append, self._sim)
            self.param_bytes += sum(t.numel() * t.element_size() for t in leaves)

    def _quantized(self, params: dict, runs) -> dict:
        """``params`` with the MLP weights of the layers ``runs`` replaced by
        ``QuantStack``s, each layer's weight quantized once for the bank.
        Only dense MLPs are quantized: an MoE layer's experts, its shared
        expert and its router stay in the model's type, as in the reference
        (``src/repro/models/model.py::_mlp_layer``), so on an MoE stack the
        level quantizes nothing and ``param_bytes`` is 0, as the reference's
        kernel execution reports."""
        out = dict(params, segments=[])
        for si, seg in enumerate(M.layout(self.cfg)):
            unit = []
            for u, p in enumerate(params["segments"][si]):
                if "mlp" not in p:
                    unit.append(p)
                    continue
                mlp = {}
                for name, w in p["mlp"].items():
                    layers = {}
                    for g in runs:            # global layer g = start + r * U + u
                        off = g - seg.start
                        if not (0 <= off < seg.repeats * len(seg.unit) and off % len(seg.unit) == u):
                            continue
                        r = off // len(seg.unit)
                        key = (si, u, name, r)
                        if key not in self._quant:
                            # a row-parallel weight's column scales are the
                            # whole column's (a MAX over model)
                            k_axes = ("model" if name == "w_down" and SU.tensor_parallel()
                                      else None)
                            self._quant[key] = prequantize(w[r], k_axes=k_axes)
                        layers[r] = self._quant[key]
                    mlp[name] = QuantStack(layers)
                unit.append(dict(p, mlp=mlp))
            out["segments"].append(unit)
        return out

    # ------------------------------------------------------------- accessors
    def __len__(self) -> int:
        return len(self.levels)

    @property
    def drafter(self) -> DraftLevel:
        """The cheapest level: it runs the drafting scan."""
        return self.levels[-1]

    @property
    def rescorers(self) -> List[DraftLevel]:
        """The stronger levels in rescore order: just above the drafter
        first, the strongest (target-adjacent) level last."""
        return self.levels[-2::-1]

    # ----------------------------------------------------- tracker key schema
    def slot_key(self, level: int, slot: int) -> str:
        """Acceptance key of (level, slot): level 0's alpha prices the
        target's acceptance of the strongest level's tokens; level i > 0's
        prices level i-1's acceptance of level i's tokens."""
        return f"casc{level}:{slot}"

    def direct_key(self, slot: int) -> str:
        """The target's acceptance of the cheapest level's tokens (observed
        on rounds routed single-level; prices the no-rescore plan)."""
        return f"cascdir:{slot}"

    def cost_key(self, level: int) -> str:
        return f"casc_rescore:{self.levels[level].name}"

    # ------------------------------------------------------- App. D priors
    def alpha_prior(self, level: int) -> float:
        """Cold-start acceptance prior of ``slot_key(level, ·)``."""
        spec = self.levels[level].spec
        if level == 0:
            return float(spec.prior_alpha)
        return spec.prior_alpha_given(self.levels[level - 1].spec)

    def direct_prior(self) -> float:
        """Compositional cold-start prior of the cheapest-vs-target plan."""
        p = 1.0
        for i in range(len(self.levels)):
            p *= self.alpha_prior(i)
        return float(p)

    def c_prior(self, level: int) -> float:
        return float(self.levels[level].spec.prior_c)
