"""Synapse array: 6-bit weights + 6-bit address matching (paper §2.1).

Each synapse stores a 6-bit weight and a 6-bit address; an event on a row
carries a source address and the synapse forwards current only when the
stored address matches. The hot operation — events x weights -> per-column
currents — is the masked product of ``repro_torch.kernels.synray``, or
at low event density its event-sparse twin ``repro_torch.kernels.
synray_sparse`` over the window's fired rows (the records of
``core.events``), the route chosen by the window's census: the one
``AnnCore``'s STP scan takes of each Dale half as it writes the
efficacies (``repro_torch.kernels.stp_scan``), or for any other window
the census kernel's (``repro_torch.kernels.census``).
"""
from __future__ import annotations

from typing import NamedTuple

import math

import torch

from repro_torch.analysis import cost
from repro_torch.core import events

WMAX = 63  # 6-bit


class SynapseArray(NamedTuple):
    weights: torch.Tensor    # [..., rows, cols] int8 in [0, 63]
    addresses: torch.Tensor  # [..., rows, cols] int8 in [0, 63]


def init_array(shape_prefix, rows, cols, device) -> SynapseArray:
    z = torch.zeros((*shape_prefix, rows, cols), dtype=torch.int8,
                    device=device)
    return SynapseArray(weights=z, addresses=z.clone())


def synaptic_current(weights, addresses, row_events, event_addr, gain):
    """Per-column synaptic current from one event step.

    weights/addresses: [..., R, C] int8; row_events: [..., R] float;
    event_addr: [..., R] int8; gain: scalar or [..., C]. Returns [..., C].
    """
    match = (addresses == event_addr.unsqueeze(-1)).to(torch.float32)
    w_eff = weights.to(torch.float32) * match
    i = torch.einsum("...rc,...r->...c", w_eff,
                     row_events.to(torch.float32))
    return i * gain


# Density below which "auto" routes a window through the event-sparse
# path; it sizes the default capacities (``events.default_max_events`` /
# ``default_k_cap``), and the capacities are the gate. With ``const_addr``
# the reference's dense alternative is the once-resolved plain matmul, so
# the lower threshold applies (``repro/core/synapse.py:50-65``).
SPARSE_THRESHOLD = 0.05
SPARSE_THRESHOLD_CONST_ADDR = 0.02
# Static work floor (T * R * C MACs): below it sparse="auto" is plain
# dense, with no census and no branch.
SPARSE_MIN_DENSE_WORK = 2 * 1024 * 1024


def _dense_window(weights, addresses, row_events_t, event_addr_t,
                  const_addr):
    """The dense whole-window path (currents before the gain): the synray
    kernel on a CUDA device (in its const-address form with
    ``const_addr``); on the CPU, with ``const_addr``, the once-resolved
    matmul of the reference's ``ref`` branch, else the kernel's plain
    version. A cost recorder counts the CPU's resolved matmul as the
    card's const-address kernel."""
    from repro_torch.kernels.synray import ops as synray_ops
    if weights.device.type == "cpu" and const_addr:
        if cost.ACTIVE is None:
            return _resolved_matmul(weights, addresses, row_events_t,
                                    event_addr_t)
        R, C = weights.shape[-2:]
        return cost.kernel_call(
            "synray", synray_ops.work(row_events_t.shape[0],
                                      math.prod(weights.shape[:-2]), R, C),
            _resolved_matmul, weights, addresses, row_events_t, event_addr_t)
    # on the card const_addr selects the kernel's const-address form (the
    # match of step 0 folded into the weights), bit-equal to its general
    # form on constant addresses
    return synray_ops.synaptic_current(
        row_events_t.to(torch.float32), event_addr_t, weights,
        addresses, const_addr=const_addr)


def _resolved_matmul(weights, addresses, row_events_t, event_addr_t):
    """The reference's ``ref`` branch with ``const_addr``: the step-0
    address match resolved once into the weights, then one product."""
    match = (addresses == event_addr_t[0].unsqueeze(-1)).to(torch.float32)
    w_eff = weights.to(torch.float32) * match
    ev = row_events_t.to(torch.float32)
    if weights.ndim == 2:     # no instance prefix: plain matmul
        return ev @ w_eff
    return torch.einsum("t...r,...rc->t...c", ev, w_eff)


def _sparse_window(weights, addresses, row_events_t, event_addr_t,
                   max_events, k_cap):
    """The event-sparse whole-window path (currents before the gain):
    gather-accumulate only the fired rows (``synray_sparse``; on the card
    one launch that reads the window in place, on the CPU the records of
    ``events.regroup_window`` and the plain version). Equal to the dense
    kernel bit for bit on the card as long as the window fits the
    capacities; overflow drops records."""
    from repro_torch.kernels.synray_sparse import ops as sparse_ops
    return sparse_ops.sparse_current_window(
        row_events_t.to(torch.float32), event_addr_t, weights, addresses,
        max_events=max_events, k_cap=k_cap)


def _route_works(weights, row_events_t, const_addr, max_events, k_cap):
    """The gated pair's two routes' work (``cost.gate_call``), from the
    window's shapes alone."""
    from repro_torch.kernels.synray import ops as synray_ops
    from repro_torch.kernels.synray_sparse import ops as sparse_ops
    T = row_events_t.shape[0]
    R, C = weights.shape[-2:]
    N = math.prod(weights.shape[:-2])
    return {"synray_sparse": sparse_ops.work_window(
                T, N, R, C, max_events, k_cap, row_events_t.stride(-1)),
            "synray": synray_ops.work(T, N, R, C, const_addr)}


def _gated_window(weights, addresses, row_events_t, event_addr_t, gain,
                  const_addr, max_events, k_cap, telemetry=None,
                  census=None):
    """Both routes under the device's census, the reference's ``lax.cond``
    (``repro/core/synapse.py:250-257``) with no read back to the host:
    the census (``census``, the STP scan's for this half, which counted
    the route already; else the census kernel's, which writes the flag and
    counts the route in ``route_counts``) decides, then the sparse kernel
    runs where the window fits and the dense kernel where it does not,
    into one buffer. With ``telemetry`` the decision is counted from that
    census (``(fits, n_events, k_max)``, read on the device) and the
    return value is ``(currents, telemetry)``. A cost recorder counts
    the two route kernels as one entry, the larger route's
    (``cost.gate_call``), as it counts the CPU's gate."""
    from repro_torch.kernels.census import ops as census_ops
    from repro_torch.kernels.synray import ops as synray_ops
    from repro_torch.kernels.synray_sparse import ops as sparse_ops
    ev = row_events_t.to(torch.float32)
    flag = census
    if flag is None:
        flag = census_ops.census(ev, max_events, k_cap,
                                 routes=route_counts(ev.device))

    def both_routes():
        out = torch.empty((*ev.shape[:-1], weights.shape[-1]),
                          dtype=torch.float32, device=ev.device)
        sparse_ops.sparse_current_window(
            ev, event_addr_t, weights, addresses, max_events=max_events,
            k_cap=k_cap, flag=flag, out=out)
        return synray_ops.synaptic_current(
            ev, event_addr_t, weights, addresses, const_addr=const_addr,
            flag=flag, out=out)
    if cost.ACTIVE is None:
        out = both_routes()
    else:
        out = cost.gate_call(_route_works(weights, ev, const_addr,
                                          max_events, k_cap), both_routes)
    if telemetry is None:
        return out * gain
    from repro_torch.obs import trace as obs_trace
    return out * gain, obs_trace.count_gate(telemetry, flag[0], flag[1],
                                            flag[2])


# The gate's decisions per device, int64 [dense, sparse] on the device:
# the census adds to it where it decides, so a run reads the routes it
# took after its timed region, with no read inside it.
_ROUTES = {}


def route_counts(device) -> torch.Tensor:
    """The [dense, sparse] decision counter of ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _ROUTES:
        _ROUTES[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return _ROUTES[device]


def reset_route_counts() -> None:
    for c in _ROUTES.values():
        c.zero_()


def route_plan(T: int, R: int, C: int, *, const_addr: bool = False,
               sparse: str = "auto", max_events: int = None,
               k_cap: int = None):
    """The route of a [T, ..., R] window onto C columns from its shapes
    alone: ``(route, max_events, k_cap)`` with route "dense", "sparse" or
    "gate" (the census decides), by the reference's rules
    (``repro/core/synapse.py:223-258``).

    "never" is dense; "auto" below ``SPARSE_MIN_DENSE_WORK`` is dense
    without a census; "always" is sparse; "auto" above the floor is the
    gate, with the capacities sized by the density threshold unless
    given. ``AnnCore`` plans both Dale halves this way before its STP
    scan, which takes the gated halves' censuses as it writes them."""
    if sparse not in ("auto", "never", "always"):
        raise ValueError(f"unknown sparse mode {sparse!r}")
    if sparse == "auto" and T * R * C < SPARSE_MIN_DENSE_WORK:
        sparse = "never"
    if sparse == "never":
        return "dense", max_events, k_cap
    thr = SPARSE_THRESHOLD_CONST_ADDR if const_addr else SPARSE_THRESHOLD
    if max_events is None:
        max_events = events.default_max_events(T, R, thr)
    if k_cap is None:
        k_cap = events.default_k_cap(R, thr)
    return ("gate" if sparse == "auto" else "sparse"), max_events, k_cap


def window_route(row_events_t, C: int, *, const_addr: bool = False,
                 sparse: str = "auto", max_events: int = None,
                 k_cap: int = None, census=None):
    """The route of one window: ``(route, max_events, k_cap)`` with route
    "dense", "sparse" or "gate", by ``route_plan`` from the window's
    shapes, and where that is the gate, by the window's census
    (``events.window_stats`` over the worst instance of the prefix, one
    decision for the whole call, and ``events.census_fits``): sparse
    when the window fits the capacities, else dense. On the card the
    decision stays on the device, as the reference's ``lax.cond`` keeps
    it: the route is "gate", and ``synaptic_current_window`` launches
    both route kernels, each of which runs only on its side of the flag.
    On the CPU the census's plain version is read back and the host
    branches (the plain version of the gate). ``census`` is the window's
    census as the STP scan gave it (int32 ``(fits, n_events, k_max)``,
    its decision counted there); without it the census kernel computes
    it and adds the decision to ``route_counts``."""
    T, R = row_events_t.shape[0], row_events_t.shape[-1]
    route, max_events, k_cap = route_plan(
        T, R, C, const_addr=const_addr, sparse=sparse,
        max_events=max_events, k_cap=k_cap)
    if route != "gate" or row_events_t.device.type != "cpu":
        return route, max_events, k_cap
    if census is None:
        from repro_torch.kernels.census import ops as census_ops
        census = census_ops.census(row_events_t.to(torch.float32),
                                   max_events, k_cap,
                                   routes=route_counts("cpu"))
    return ("sparse" if bool(census[0]) else "dense"), max_events, k_cap


def synaptic_current_window(weights, addresses, row_events_t, event_addr_t,
                            gain, const_addr: bool = False,
                            sparse: str = "auto", max_events: int = None,
                            k_cap: int = None, telemetry=None, census=None,
                            plan_cols: int = None):
    """Whole-window synaptic currents: [T, ..., R] events -> [T, ..., C].

    Weights and addresses are constant between PPU writes, so the per-step
    masked product collapses into one time-batched product (time is the
    kernel's batch axis). ``const_addr=True`` asserts each row's event
    address is the same at every step of the window; the CPU path then
    resolves the mask once into an effective weight matrix.

    ``sparse`` selects the event-sparse route (``window_route``): "auto"
    (default) takes it when the window's census fits the capacities and
    goes dense otherwise, so overflow never drops records (on the card
    the sparse and the dense kernel are both launched behind the
    census's flag, which decides which one computes);
    "never" is dense; "always" forces sparse, where overflow drops
    records. The density threshold ``SPARSE_THRESHOLD``, or
    ``SPARSE_THRESHOLD_CONST_ADDR`` with ``const_addr``, sizes the default
    capacities (``max_events`` about threshold * T * R records, ``k_cap``
    per step); both are overridable.

    ``telemetry`` (``repro_torch.obs.trace.Telemetry``, or ``None`` = off)
    counts the routing decision (``repro/core/synapse.py:155-262``): a
    static route with ``count_route``, a census-gated one with
    ``count_gate`` on the census the gate took (on the card the census
    tensor itself, read on the device). With telemetry the
    return value is ``(currents, telemetry)``; the currents are the same
    bits either way.

    ``census`` is this window's census as ``AnnCore``'s STP scan took it
    (``kernels.stp_scan`` with capacities: the int32 ``(fits, n_events,
    k_max)`` of this Dale half, its decision already in ``route_counts``);
    where the route is the gate, it decides in place of the census
    kernel, on the card and on the CPU, and telemetry counts it.

    ``plan_cols`` is the column count the route is planned from
    (``route_plan``): by default the weights', a column part's whole
    chip's where ``AnnCore`` runs one.
    """
    if plan_cols is None:
        plan_cols = weights.shape[-1]
    route, max_events, k_cap = window_route(
        row_events_t, plan_cols, const_addr=const_addr,
        sparse=sparse, max_events=max_events, k_cap=k_cap, census=census)
    if route == "gate":
        return _gated_window(weights, addresses, row_events_t, event_addr_t,
                             gain, const_addr, max_events, k_cap, telemetry,
                             census)
    T, R = row_events_t.shape[0], row_events_t.shape[-1]
    gated = sparse == "auto" and T * R * plan_cols >= SPARSE_MIN_DENSE_WORK
    if route == "sparse":
        fn, args = _sparse_window, (max_events, k_cap)
    else:
        fn, args = _dense_window, (const_addr,)
    args = (weights, addresses, row_events_t, event_addr_t, *args)
    if gated and cost.ACTIVE is not None:
        # the CPU's gate, counted as the card's: the larger route
        i = cost.gate_call(_route_works(weights, row_events_t, const_addr,
                                        max_events, k_cap), fn, *args)
    else:
        i = fn(*args)
    i = i * gain
    if telemetry is None:
        return i
    from repro_torch.obs import trace as obs_trace
    if not gated:
        return i, obs_trace.count_route(telemetry, route == "sparse")
    # the CPU's gate decided on the host from the plain census: the
    # scan's, or the same census again for the counters (no route counted
    # twice, nor the census by a cost recorder)
    if census is None:
        from repro_torch.kernels.census import ops as census_ops
        with cost.paused():
            census = census_ops.census(row_events_t.to(torch.float32),
                                       max_events, k_cap)
    return i, obs_trace.count_gate(telemetry, census[0], census[1],
                                   census[2])


def quantize_weight(w_float):
    """Saturating 6-bit write (the PPU's vector-store semantics)."""
    return torch.clamp(torch.round(w_float), 0, WMAX).to(torch.int8)
