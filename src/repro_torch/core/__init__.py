"""Host-side CAS-Spec core of the port: DSIA specs, DyTC, engine, verification."""
from repro_torch.core.cascade import (
    ARScheduler,
    BaseScheduler,
    HCScheduler,
    PLDScheduler,
    SDScheduler,
    TreeScheduler,
    TreeVCScheduler,
    VCHCScheduler,
    VCScheduler,
)
from repro_torch.core.dsia import (
    DraftSpec,
    PLD_SPEC,
    activation_quant,
    build_hierarchy,
    layer_sparsity,
    streaming_attention,
)
from repro_torch.core.dytc import DyTCConfig, DyTCScheduler
from repro_torch.core.engine import SpecEngine, fake_quant_int8

__all__ = [
    "ARScheduler", "BaseScheduler", "DraftSpec", "DyTCConfig", "DyTCScheduler", "HCScheduler",
    "PLDScheduler", "PLD_SPEC", "SDScheduler", "SpecEngine", "TreeScheduler", "TreeVCScheduler",
    "VCHCScheduler", "VCScheduler", "activation_quant", "build_hierarchy", "fake_quant_int8",
    "layer_sparsity", "streaming_attention",
]
