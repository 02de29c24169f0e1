"""Host-side CAS-Spec core of the port: DSIA specs, DyTC, engine, verification."""
from repro_torch.core.cascade import ARScheduler, BaseScheduler
from repro_torch.core.dsia import DraftSpec, PLD_SPEC, build_hierarchy, layer_sparsity
from repro_torch.core.dytc import DyTCConfig, DyTCScheduler
from repro_torch.core.engine import SpecEngine, fake_quant_int8

__all__ = [
    "ARScheduler", "BaseScheduler", "DraftSpec", "DyTCConfig", "DyTCScheduler", "PLD_SPEC",
    "SpecEngine", "build_hierarchy", "fake_quant_int8", "layer_sparsity",
]
