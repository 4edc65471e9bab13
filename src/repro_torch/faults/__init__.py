"""Fault injection and defect tolerance for the emulated silicon:
declarative ``FaultPlan`` overlays (``faults.model``, a copy of the
reference's), the hooks threaded through the emulation (``faults.inject``,
plans put on the device once), and commissioning-style screening /
blacklist reduction (``faults.blacklist``)."""
from repro_torch.faults.blacklist import (Blacklist, cadc_zero_code, screen,
                                          screen_chip, screen_links)
from repro_torch.faults.model import (FaultPlan, as_plans, chain,
                                      remap_link_faults, sample_fault_plan,
                                      slice_chips)

__all__ = ["FaultPlan", "as_plans", "chain", "sample_fault_plan",
           "remap_link_faults", "slice_chips", "Blacklist", "cadc_zero_code", "screen",
           "screen_chip", "screen_links"]
