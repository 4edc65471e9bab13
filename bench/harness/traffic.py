"""The general traffic generator: everything a run feeds the system,
made on the device from ``--seed`` in a few large calls.

Frozen copies of the distributions the port samples with
(``repro_torch.verif.mismatch.sample_instance``, ``repro_torch.core.hybrid
.draw_trials`` / ``events_from_background``), so that a later change to
the program cannot change what the benchmark feeds it. The same seed gives
the same tensors on the same device; the reference is handed the very
tensors the program is handed.
"""
from __future__ import annotations

import numpy as np
import torch

# per-neuron parameters in the order they are drawn, and how each varies:
# ("mul", sigma key) scales by 1 + sigma n, ("add", sigma key) adds sigma n
NEURON_PARAMS = ("g_leak", "e_leak", "v_thres", "e_reset", "v_exp",
                 "delta_t", "tau_w", "a", "b", "tau_refrac", "tau_syn_exc",
                 "tau_syn_inh", "c_mem")
_SIGMA = {"g_leak": ("mul", "sigma_g_leak"),
          "tau_syn_exc": ("mul", "sigma_tau_syn"),
          "tau_syn_inh": ("mul", "sigma_tau_syn"),
          "v_thres": ("add", "sigma_v_thres")}


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number
    below 2**63)."""
    return torch.Generator(device=device).manual_seed(int(seed))


def instance(gen: torch.Generator, chip: dict, prefix, n_rows: int,
             n_cols: int) -> dict:
    """A mismatch realisation of ``prefix``-many chips of ``n_rows`` driver
    rows and ``n_cols`` neuron columns, in the port's instance layout:
    two draws, one of every column parameter and one of the row
    parameter."""
    dev = gen.device
    prefix = tuple(prefix)
    mm, nom = chip["mismatch"], chip["neuron"]
    cols = torch.randn((len(NEURON_PARAMS) + 3, *prefix, n_cols),
                       generator=gen, device=dev)
    rows = torch.randn((*prefix, n_rows), generator=gen, device=dev)
    params = {}
    for i, name in enumerate(NEURON_PARAMS):
        kind, key = _SIGMA.get(name, ("mul", "sigma_capmem"))
        n = cols[i]
        if kind == "add":
            params[name] = nom[name] + mm[key] * n
        else:
            params[name] = nom[name] * (1.0 + mm[key] * n)
    k = len(NEURON_PARAMS)
    return dict(
        neuron_params=params,
        weight_gain=1.0 + mm["sigma_weight_gain"] * cols[k],
        stp_offset=mm["sigma_stp_offset"] * rows,
        stp_calib=torch.full((*prefix, n_rows), 2 ** (chip["calib_bits"] - 1),
                             dtype=torch.int32, device=dev),
        cadc_offset=mm["sigma_cadc_offset"] * cols[k + 1],
        cadc_gain=1.0 + mm["sigma_cadc_gain"] * cols[k + 2])


def patterns(exp: dict):
    """[3, I] float32 masks of the stimuli none, A and B: A on the first
    ``pattern_size`` channels, B sharing ``overlap`` of them."""
    k, I = exp["pattern_size"], exp["n_inputs"]
    n_shared = int(round(exp["overlap"] * k))
    a = list(range(k))
    b = a[:n_shared] + list(range(k, 2 * k - n_shared))
    m = np.zeros((3, I), np.float32)
    m[1, a] = 1
    m[2, b] = 1
    return m


def burst_schedule(exp: dict):
    """[T] float32, 1 on the steps of a pattern burst."""
    T = exp["trial_steps"]
    times = np.linspace(T // 8, T - T // 8, exp["pattern_repeats"],
                        dtype=np.float32).astype(np.int64)
    d = np.arange(T)[:, None] - times[None, :]
    return np.any((d >= 0) & (d < exp["burst_width"]), axis=1
                  ).astype(np.float32)


def stimuli(n: int, cycle):
    """The stimulus of each of ``n`` trials: ``cycle`` repeated."""
    return np.resize(np.asarray(cycle, np.int32), n)


def s5_draws(gen: torch.Generator, exp: dict, stims, prefix):
    """Every trial's input events and exploration noise: background
    spikes Bernoulli(``bg_prob``) [n, T, *prefix, I] under the stimuli's
    bursts, clipped to {0, 1}, input i driving rows 2i (excitatory) and
    2i + 1 (inhibitory); xi = ``noise`` N(0, 1) [n, *prefix, I, C].
    Returns ``(events [n, T, *prefix, 2I], xi)``."""
    dev = gen.device
    prefix = tuple(prefix)
    n, T, I = len(stims), exp["trial_steps"], exp["n_inputs"]
    u = torch.rand((n, T, *prefix, I), generator=gen, device=dev)
    xi = exp["noise"] * torch.randn((n, *prefix, I, exp["n_neurons"]),
                                    generator=gen, device=dev)
    bg = (u < exp["bg_prob"]).to(torch.float32)
    del u
    pat = torch.as_tensor(patterns(exp)[np.asarray(stims)], device=dev)
    burst = torch.as_tensor(burst_schedule(exp), device=dev)
    shape_b = (1, T) + (1,) * len(prefix) + (1,)
    shape_p = (n, 1) + (1,) * len(prefix) + (I,)
    ev = torch.clamp(bg + burst.reshape(shape_b) * pat.reshape(shape_p), 0, 1)
    return ev.repeat_interleave(2, dim=-1), xi


def pick(rng: np.random.Generator, lo: int, hi: int, n: int, exclude=()):
    """``n`` distinct whole numbers in ``[lo, hi)`` outside ``exclude``,
    drawn from ``rng``, sorted."""
    pool = [k for k in range(lo, hi) if k not in set(exclude)]
    return sorted(int(x) for x in rng.choice(pool, size=n, replace=False))
