"""Chip telemetry: counters, phase timing and run reports
(``repro/obs``).

``repro_torch.obs.trace``
    ``Telemetry``, counters as 0-d device tensors threaded through a run
    (``None`` is off and launches nothing; on only reads the dataflow, so
    outputs are bit-identical; nothing in an update reads the host, so
    the counters ride inside a captured trial graph).

``repro_torch.obs.timing``
    Phase timing: ``PhaseTimer`` spans (CUDA events on a card, the host
    clock on the CPU), ``profile_phases`` for one AnnCore window, and a
    ``torch.profiler`` trace hook.

``repro_torch.obs.report``
    Structured run reports (JSON + markdown) merging counters, timings,
    config and provenance.
"""
from repro_torch.obs.trace import Telemetry, init_telemetry, summary  # noqa: F401
