"""Hybrid plasticity on the LM (``repro/plasticity``)."""
from repro_torch.plasticity.three_factor import (  # noqa: F401
    HybridReadoutTrainer,
)
