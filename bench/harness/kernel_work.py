"""The work of each hand-written kernel of the port, as the benchmark
counts it: frozen copies of the formulas of ``repro_torch.kernels.*.ops``
``work()`` at the shapes the cells run, with the data-dependent parts
counted from the inputs the benchmark made (``tests`` tie each to the
port's ``work()`` at full activity once). Each returns ``(flops,
bytes)``: every input byte read once and every output byte written once.

The reference's model FLOPs of a §5 trial (``repro/core/hybrid.py:
688-691``) are here too: what a trial computes whatever implements it.
"""
from __future__ import annotations

# trace names of the port's kernels (``csrc/*.cu``, templates and
# arguments stripped) -> the kernel they belong to
FAMILIES = {
    "synray_kernel": "synray",
    "gated_kernel": "synray_sparse",
    "ordered_kernel": "synray_sparse",
    "record_kernel": "synray_sparse",
    "census_kernel": "census",
    "neuron_scan_kernel": "neuron_scan",
    "corr_kernel": "corr",
    "ppu_update_kernel": "ppu_update",
    "ppuvm_exec_kernel": "ppuvm_exec",
    "stp_scan_kernel": "stp_scan",
}


def family(trace_name: str):
    """The port's kernel a trace name belongs to, or ``None`` for any
    other device operation (PyTorch's own kernels, copies, sets)."""
    base = trace_name.replace("(anonymous namespace)::", "")
    base = base.removeprefix("void ").split("<", 1)[0].split("(", 1)[0]
    return FAMILIES.get(base.rsplit("::", 1)[-1].strip())


def stp_scan(T: int, N: int, R: int, census: bool = True):
    """The STP trajectory of a [T, N, R] window: spikes read and
    efficacies written, r0, the scale and r_T; 14 operations a step and
    row (15 with the census test), the two censuses out."""
    return ((15.0 if census else 14.0) * T * N * R,
            float(2 * T * N * R * 4 + 3 * N * R * 4 + (24 if census else 0)))


def synray(T: int, N: int, R: int, C: int, n_events: float):
    """The dense product of one Dale half of R rows onto C columns: an
    FMA per column for every (step, row) that carries an event (the
    kernel skips the others); the half's efficacies, the step-0
    addresses, the two int8 stores and the output."""
    return (2.0 * n_events * C,
            float(T * N * R * 4 + N * R + 2 * N * R * C + T * N * C * 4))


def synray_sparse(T: int, N: int, R: int, C: int, n_events: float):
    """The event-sparse product of the same half: an FMA per column for
    every record; the half's efficacies and addresses, the two int8
    stores and the output."""
    return (2.0 * n_events * C,
            float(T * N * R * 5 + 2 * N * R * C + T * N * C * 4))


def neuron_scan(T: int, N: int, C: int):
    """A [T, N, C] AdEx window: both current windows read, the six state
    planes and twelve parameter rows read, the spikes and the six planes
    written; about 30 operations a step and neuron."""
    return (30.0 * T * N * C,
            float((2 * T * N * C + 6 * N * C + 12 * N * C + T * N * C
                   + 6 * N * C) * 4))


def corr(T: int, N: int, R: int, C: int, n_pre: float, n_post: float):
    """The correlation sensors over a [T, N, R, C] window: the two traces
    every step, and per post spike a multiply, add and clamp down its
    column's R causal accumulators, per pre event the same along its
    row's C anti-causal ones (the kernel skips the steps no spike
    touches); the spike windows, traces and both accumulators read, the
    traces and accumulators written."""
    return (float(2 * T * N * (R + C) + 3 * R * n_post + 3 * C * n_pre),
            float((T * N * (R + C) + 2 * N * (R + C) + 4 * N * R * C) * 4))


def s5_model_flops(R: int, C: int, T: int):
    """The reference's model FLOPs of one instance-trial: the event
    product, the neuron and sensor updates and the correlation outer
    product, a step."""
    return float((2 * R * C + 40 * C + 4 * R * C) * T)


def roofline_s(flops: float, nbytes: float, peaks: dict):
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory bandwidth."""
    return max(flops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes_per_s"])
