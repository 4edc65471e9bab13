"""Wrapper of the neuron_scan kernel (``csrc/neuron_scan.cu``).

``neuron_window`` integrates a whole [T, ..., C] current window of AdEx
dynamics in one call, with the contract of scanning ``adex.step`` over
it. CPU tensors run the plain version (``ref.py``); CUDA tensors launch
the kernel, one thread per (instance, column) with the state in
registers and the currents staged ahead of the membrane chain. The five
state leaves and the rate counters go to the kernel as six [N, C] planes
and come back as six new ones (no packing launch); the parameters are
packed once into the reference kernel's row layout:

  params [N, 12, C]: e_leak, v_thres, delta_t, g_leak, a, b, e_reset,
                     tau_refrac, de, di, alpha, aw
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels
from repro_torch.analysis import cost
from repro_torch.core import adex
from repro_torch.kernels import fold_instance
from repro_torch.kernels.neuron_scan.ref import neuron_window_ref

PARAM_ROWS = ("e_leak", "v_thres", "delta_t", "g_leak", "a", "b",
              "e_reset", "tau_refrac")
DECAY_ROWS = ("de", "di", "alpha", "aw")
STATE_ROWS = ("v", "w", "i_exc", "i_inh", "refrac")


def pack_params(params, decays, cshape):
    """[*prefix, 12, C] float32 parameter block of the kernel."""
    rows = [params[k] for k in PARAM_ROWS] + [decays[k] for k in DECAY_ROWS]
    return torch.stack([r.expand(cshape).to(torch.float32) for r in rows],
                       dim=len(cshape) - 1)


def work(T: int, N: int, C: int, record_v: bool = False) -> cost.Work:
    """One window's work at [T, N, C]: both current windows read, the six
    state planes and the 12 parameter rows read, the spikes (and with
    ``record_v`` the membrane) and the six planes written; about 30
    operations and one exp a step and neuron."""
    n_bytes = (2 * T * N * C + 6 * N * C + 12 * N * C + T * N * C
               + 6 * N * C + (T * N * C if record_v else 0)) * 4
    return cost.Work(flops=30.0 * T * N * C, bytes=float(n_bytes),
                     transcendentals=float(T * N * C))


def neuron_window(state: adex.NeuronState, rate_counters, ie_t, ii_t,
                  params, *, dt: float, use_adex: bool, decays=None,
                  record_v: bool = False, packed_params=None):
    """ie_t/ii_t: [T, ..., C] float32 currents; state/params broadcast over
    the instance prefix. Returns ``(new_state, rate_counters, recs)`` with
    ``recs = (spikes_t,)`` or ``(spikes_t, v_t)``.

    ``packed_params`` may pass ``pack_params(...)`` precomputed (the
    parameters are constant across windows)."""
    if cost.ACTIVE is not None:
        return cost.kernel_call(
            "neuron_scan", work(ie_t.shape[0], math.prod(ie_t.shape[1:-1]),
                                ie_t.shape[-1], record_v), neuron_window,
            state, rate_counters, ie_t, ii_t, params, dt=dt,
            use_adex=use_adex, decays=decays, record_v=record_v,
            packed_params=packed_params)
    if decays is None:
        decays = adex.decay_factors(params, dt)
    if ie_t.device.type == "cpu":
        return neuron_window_ref(state, rate_counters, ie_t, ii_t, params,
                                 dt=dt, use_adex=use_adex, decays=decays,
                                 record_v=record_v)
    return _launch(state, rate_counters, ie_t, ii_t, params, decays,
                   dt=dt, use_adex=use_adex, record_v=record_v,
                   packed_params=packed_params)


def chain_floor_probe(state, rate_counters, ie_t, ii_t, params, *,
                      dt: float, decays, packed_params=None):
    """A measurement aid on the card, not a window: the kernel's AdEx form
    with every step's currents taken from registers (step 0's values)
    instead of the staged window, so that its time is the membrane
    chain's alone. Counts no launch. Returns what ``neuron_window``
    returns, for those currents."""
    if ie_t.device.type != "cuda":
        raise ValueError("neuron_scan: the chain-floor probe runs on a card")
    return _launch(state, rate_counters, ie_t, ii_t, params, decays,
                   dt=dt, use_adex=True, record_v=False,
                   packed_params=packed_params, probe=True)


def _launch(state, rate_counters, ie_t, ii_t, params, decays, *, dt,
            use_adex, record_v, packed_params, probe=False):
    from repro_torch.kernels import _build
    dev = ie_t.device
    if dev.type != "cuda":
        raise ValueError(f"neuron_scan: unsupported device {dev}")
    T = ie_t.shape[0]
    cshape = tuple(ie_t.shape[1:])
    prefix, C = cshape[:-1], cshape[-1]
    N = math.prod(prefix)
    for name, x in (("ie_t", ie_t), ("ii_t", ii_t)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"neuron_scan: {name} must be contiguous "
                             "float32")
    if tuple(ii_t.shape) != tuple(ie_t.shape):
        raise ValueError(f"neuron_scan: shapes {tuple(ie_t.shape)} "
                         f"{tuple(ii_t.shape)}")
    leaves = [getattr(state, f) for f in STATE_ROWS] + [rate_counters]
    if any(x.device != dev for x in leaves):
        raise ValueError("neuron_scan: state not on the currents' device")
    st_in = [fold_instance(x.expand(cshape).to(torch.float32).contiguous(),
                           1) for x in leaves]
    if packed_params is None:
        packed_params = pack_params(params, decays, cshape)
    params12 = fold_instance(packed_params, 2)
    if tuple(params12.shape) != (N, 12, C) or params12.device != dev \
            or not params12.is_contiguous():
        raise ValueError("neuron_scan: bad packed parameter block")
    spikes = torch.empty((T, N, C), dtype=torch.float32, device=dev)
    st_out = [torch.empty((N, C), dtype=torch.float32, device=dev)
              for _ in leaves]
    v_rec = (torch.empty((T, N, C), dtype=torch.float32, device=dev)
             if record_v else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (ie_t.data_ptr(), ii_t.data_ptr(), _ptrs(st_in),
            params12.data_ptr(), spikes.data_ptr(), _ptrs(st_out))
    if probe:
        err = _build.lib().neuron_scan_floor_launch(*args, N, T, C,
                                                     float(dt), stream)
    else:
        err = _build.lib().neuron_scan_launch(
            *args, None if v_rec is None else v_rec.data_ptr(), N, T, C,
            float(dt), int(bool(use_adex)), stream)
    _build.check(err, "neuron_scan")
    if not probe:
        kernels.LAUNCHES["neuron_scan"] += 1
    st6 = [x.reshape(cshape) for x in st_out]
    new_state = adex.NeuronState(*st6[:5])
    recs = (spikes.reshape(T, *cshape),)
    if record_v:
        recs = (recs[0], v_rec.reshape(T, *cshape))
    return new_state, st6[5], recs


def _ptrs(planes):
    """The six state planes' addresses as the kernel's pointer array."""
    return (ctypes.c_void_p * len(planes))(*(x.data_ptr() for x in planes))
