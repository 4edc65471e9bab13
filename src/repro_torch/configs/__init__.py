"""Architecture configs (one module per assigned architecture).

A copy of ``repro/configs``: importing this package registers every
config with ``repro_torch.config``, as the reference's registers with
``repro.config``.
"""
from repro_torch.configs import (  # noqa: F401
    smollm_360m,
    minitron_4b,
    qwen15_05b,
    phi4_mini_38b,
    internvl2_2b,
    moonshot_16b_a3b,
    llama4_scout_17b,
    hubert_xlarge,
    hymba_15b,
    mamba2_130m,
    bss2,
)
