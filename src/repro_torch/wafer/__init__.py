"""Wafer-scale multi-chip emulation: topologies, route plans
(``repro_torch.wafer.topology``, a copy of the reference's) and the
inter-chip event router (``repro_torch.wafer.router``)."""
from repro_torch.wafer.router import InterChipRouter, WindowLoop, run_windows
from repro_torch.wafer.topology import (WaferPlan, WaferTopology, make_plan,
                                        monolithic_plan, monolithic_weights,
                                        reroute_plan, s5_column_plan)

__all__ = ["InterChipRouter", "WindowLoop", "run_windows", "WaferPlan",
           "WaferTopology", "make_plan", "monolithic_plan",
           "monolithic_weights", "reroute_plan", "s5_column_plan"]
