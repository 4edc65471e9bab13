"""Hand-written CUDA kernels for the machine model's hot spots.

Each kernel has a plain PyTorch version (``ref.py``) and a wrapper
(``ops.py``) that dispatches by the device of its tensors: CPU tensors run
the plain version, CUDA tensors launch the kernel from ``csrc/`` (built
and loaded by ``_build.py``) or raise. There is no knob that selects the
plain version on the card and no fallback when a launch fails. Each
wrapper counts its launches in ``LAUNCHES`` so a run can show that it went
through the kernels.

  synray         masked event x 6-bit-weight synaptic-current product
                 (replaces ``repro/kernels/synray``)
  synray_sparse  the same product over the window's fired rows, the
                 records kept as ``core.events.regroup_window`` keeps
                 them (or over given [T, K] records), equal to ``synray``
                 bit for bit on windows that fit (replaces
                 ``repro/kernels/synray_sparse``)
  census         the sparse route's gate: the window census and its
                 no-drop predicate as a device flag that the two route
                 kernels read (no TPU kernel: the reference's
                 ``lax.cond`` predicate), for a window that did not come
                 out of ``stp_scan``
  neuron_scan    T-step AdEx window with the state in registers
                 (replaces ``repro/kernels/neuron_scan``)
  corr           T-step correlation-sensor window with per-step saturation
                 (replaces ``repro/kernels/corr``)
  ppu_update     fixed-function R-STDP update: CADC read, eligibility,
                 weight step, 6-bit store (replaces
                 ``repro/kernels/ppu_update``)
  ppuvm_exec     the PPU-VM: a whole instruction-word program per synapse
                 lane, 8 Q8.8 registers, saturating integer arithmetic
                 (replaces ``repro/kernels/ppuvm_exec``)
  stp_scan       the STP efficacy trajectory of a window, one thread per
                 driver row (no TPU kernel: the reference's ``lax.scan``
                 of ``stp.efficacy`` and ``stp.update``); in its census
                 form also both Dale halves' censuses and flags, the gate
                 of ``AnnCore``'s two synaptic windows

Instance prefix: a fleet of independent chips is folded into one leading
N axis with the helpers below, as in the reference.
"""
from __future__ import annotations

import math

# launch counts per kernel name; each wrapper adds one where it launches
LAUNCHES = {"synray": 0, "synray_sparse": 0, "census": 0, "neuron_scan": 0,
            "corr": 0, "ppu_update": 0, "ppuvm_exec": 0, "stp_scan": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fold_instance(x, n_core: int):
    """[*prefix, *core] -> [N, *core] with N = prod(prefix) (N=1 when the
    prefix is empty). ``n_core`` is the number of trailing core dims."""
    core = x.shape[x.ndim - n_core:]
    return x.reshape(math.prod(x.shape[:x.ndim - n_core]), *core)


def unfold_instance(y, prefix):
    """Inverse of ``fold_instance``: [N, *core] -> [*prefix, *core]."""
    return y.reshape(*prefix, *y.shape[1:])


def fold_instance_time(x, n_core: int):
    """[T, *prefix, *core] -> [N, T, *core]: time-major window operands
    fold their instance prefix in front of the time axis."""
    n_prefix = x.ndim - 1 - n_core
    x = x.movedim(0, n_prefix)
    return fold_instance(x, n_core + 1)


def unfold_instance_time(y, prefix):
    """Inverse of ``fold_instance_time``: [N, T, *core] -> [T, *prefix,
    *core]."""
    y = y.reshape(*prefix, *y.shape[1:])
    return y.movedim(len(prefix), 0)
