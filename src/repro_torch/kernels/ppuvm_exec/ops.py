"""Wrapper of the ppuvm_exec kernel (``csrc/ppuvm_exec.cu``): a PPU-VM
program run over [..., R, C] synapse lanes.

The instance prefix folds into the kernel's lane axis. ``mod`` has its
slot axis first (``[n_mod, *prefix, C]``) and the returned register file
its register axis first (``[8, *prefix, R, C]``), as the reference's vmap
conventions give them (``repro/kernels/ppuvm_exec/ops.py:47-53``). CPU
tensors run the plain version (``ref.py``); CUDA tensors launch the
kernel, which equals the plain version bit for bit, or raise. The words
must already lie on the card: the wrapper never copies them host to
device (put a program on the device once, when it is uploaded). The
kernel takes a program of any length: it decodes up to ``MAX_WORDS``
words into its shared memory once, and a longer program ``MAX_WORDS``
words at a time on every tile. It reads int8 and int32 weight planes as
they are (the synapse store's int8 needs no conversion launch), and
converts the float32 rate counters to Q8.8 itself (``rates_to_fixed``):
on the card the wrapper launches nothing but the kernel for the operands
path C passes.
"""
from __future__ import annotations

import math

import torch

from repro_torch import kernels
from repro_torch.analysis import cost
from repro_torch.kernels.ppuvm_exec.ref import run_program_ref
from repro_torch.ppuvm import isa

MAX_WORDS = 12288     # csrc/ppuvm_exec.cu: words decoded at a time (48 KB)


def work(N: int, R: int, C: int, n_words: int, n_planes: int, n_mod: int,
         w_bytes: int = 1) -> cost.Work:
    """One program's work at [N, R, C]: each lane's weight (``w_bytes``)
    and its ``n_planes`` int32 planes read, the int32 weight and the 8
    registers written, the rates and the ``n_mod`` modulator slots
    ([N, C] each) and the words read; one instruction a word and lane."""
    lanes = N * R * C
    return cost.Work(flops=float(n_words * lanes),
                     bytes=float(lanes * (w_bytes + 4 * (n_planes + 1 + 8))
                                 + N * C * 4 * (1 + n_mod) + 4 * n_words))


def run_program(words, weights, qc, qa, rates, mod=None, noise=None):
    """words [P] int32; weights [..., R, C] integer; qc/qa/noise
    broadcastable to it; rates [..., C] float; mod [n_mod, ..., C] Q8.8.
    Returns (weights_out int32 [..., R, C], regs int32 [8, ..., R, C])."""
    if cost.ACTIVE is not None:
        R, C = weights.shape[-2:]
        return cost.kernel_call(
            "ppuvm_exec", work(math.prod(weights.shape[:-2]), R, C,
                               len(words), 3 if noise is not None else 2,
                               1 if mod is None else mod.shape[0],
                               weights.element_size()),
            run_program, words, weights, qc, qa, rates, mod, noise)
    if weights.device.type == "cpu":
        return run_program_ref(words, weights, qc, qa, rates, mod, noise)
    from repro_torch.kernels import _build
    dev = weights.device
    if dev.type != "cuda":
        raise ValueError(f"ppuvm_exec: unsupported device {dev}")
    if not (isinstance(words, torch.Tensor) and words.device == dev
            and words.dtype == torch.int32 and words.dim() == 1
            and words.is_contiguous()):
        raise ValueError(f"ppuvm_exec: words must be a contiguous int32 [P] "
                         f"tensor on {dev} (upload the program once)")
    lane = tuple(weights.shape)
    prefix, (R, C) = lane[:-2], lane[-2:]
    N = math.prod(prefix)

    def plane(x, keep=(torch.int32,)):
        if x.device != dev:
            raise ValueError(f"ppuvm_exec: operands must lie on {dev}")
        x = torch.broadcast_to(x, lane)
        if x.dtype not in keep:
            x = x.to(torch.int32)
        return x.contiguous()

    w = plane(weights, keep=(torch.int8, torch.int32))
    c, a = plane(qc), plane(qa)
    nz = None if noise is None else plane(noise)
    if rates.device != dev:
        raise ValueError(f"ppuvm_exec: operands must lie on {dev}")
    # the kernel takes rates_to_fixed of the float32 counters itself
    rates = torch.broadcast_to(rates, (*prefix, C)).to(torch.float32
                                                       ).contiguous()
    n_mod = 1
    if mod is not None:
        if mod.device != dev:
            raise ValueError(f"ppuvm_exec: operands must lie on {dev}")
        n_mod = mod.shape[0]
        mod = torch.broadcast_to(mod, (n_mod, *prefix, C)
                                 ).to(torch.int32).contiguous()
    w_out = torch.empty(lane, dtype=torch.int32, device=dev)
    regs = torch.empty((isa.N_REGS, *lane), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().ppuvm_exec_launch(
        words.data_ptr(), words.numel(), w.data_ptr(), w.element_size(),
        c.data_ptr(), a.data_ptr(), rates.data_ptr(),
        None if mod is None else mod.data_ptr(), n_mod,
        None if nz is None else nz.data_ptr(), w_out.data_ptr(),
        regs.data_ptr(), N, R, C, stream)
    _build.check(err, "ppuvm_exec")
    kernels.LAUNCHES["ppuvm_exec"] += 1
    return w_out, regs
