"""PyTorch/CUDA port of the BrainScaleS-2 machine model.

``repro_torch`` mirrors the module layout of the JAX package ``repro``
(``configs/``, ``core/``, ``kernels/<name>/{ref,ops}.py``, ``verif/``) so
the counterpart of every module is found under the same name. It imports
``torch`` only: neither ``jax`` nor anything of ``repro``.

Entry points take an explicit ``device``. They run on ``cuda`` unless the
caller passes ``device="cpu"``; with no card and no device given they
raise (``resolve_device``) instead of carrying on on the CPU.

Every kernel wrapper dispatches by the device of its tensors: CPU tensors
run the plain PyTorch version beside the kernel, CUDA tensors launch the
hand-written CUDA kernel (``csrc/``) or raise. See ``README.md`` for how
the tests run here and how ``chip_smoke.py`` runs the port on the card.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda`` and raises
    when no card is present (the port never falls back to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' explicitly to "
                "run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)
