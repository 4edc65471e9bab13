"""Carry the reference's data into the port, and back.

The reference (the JAX package ``repro``) and the port share field names
and layouts, so a state moves over leaf by leaf as numpy arrays:

* ``instance``: a reference instance dict (``sample_instance`` /
  ``ideal_instance``, leaves as numpy) -> the port's;
* ``core_state`` / ``experiment_state``: a reference ``AnnCoreState`` or
  ``ExperimentState`` (numpy leaves) -> the port's; ``to_numpy`` goes
  back to a nested tuple/dict of numpy arrays with the same structure;
* ``draws``: injected per-trial event grids and xi walks -> ``Draws``;
* ``plan``: a reference ``WaferPlan`` -> the port's (its numpy arrays);
* ``mapping``: a reference ``ChipMapping`` -> the port's, field by field
  (``instance`` takes the mapper's spec-shaped ``net_inst`` as it is);
* ``params`` / ``lm_cache``: any reference LM state tree (parameters,
  AdamW state with its 0-d int32 ``step``, error-feedback trees, a
  decode cache; nested dicts, numpy leaves) -> the same tree of tensors
  on a device, leaf for leaf in the same dtypes (``params`` with a
  device-mesh ``ctx`` and the tree's ``decls``: DTensors placed by the
  decls); ``to_numpy`` goes back;
* ``replay_reference_draws``: the reference's ``jax.random`` key chain
  replayed, so both packages consume the same numbers (PyTorch cannot
  reproduce threefry streams); ``replay_rstdp_xi`` likewise for the xi
  plane of ``VectorUnit.apply_rstdp`` / ``rules.rstdp``. Both take the
  ``jax.random`` module as an argument: this module imports no JAX
  itself. ``replay_three_factor_draws`` likewise for a step of
  ``HybridReadoutTrainer``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import adex, correlation, stp, synapse
from repro_torch.core.anncore import AnnCoreState
from repro_torch.core.hybrid import (Draws, ExperimentState, RSTDPConfig,
                                     events_from_background)
from repro_torch.mapper import (ChipMapping, ColumnPartition,
                                NetworkSpec)
from repro_torch.parallel.sharding import place_tree
from repro_torch.wafer.topology import WaferPlan, WaferTopology

_PLAN_ARRAYS = ("src_chip", "src_col", "dst_chip", "dst_row", "addr",
                "fwd_src_chip", "fwd_src_row", "fwd_dst_chip", "fwd_dst_row",
                "fwd_addr")


def _t(x, device):
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def instance(ref_inst: Dict, device=None) -> Dict:
    """Reference instance dict -> the port's, on ``device``: a chip or
    fleet instance, or the mapper's spec-shaped ``net_inst``
    (``sample_network_instance``: rows = sources, columns = neurons)."""
    device = resolve_device(device)
    out = {k: _t(v, device) for k, v in ref_inst.items()
           if k != "neuron_params"}
    out["neuron_params"] = {k: _t(v, device) for k, v in
                            ref_inst["neuron_params"].items()}
    return out


def core_state(ref, device=None) -> AnnCoreState:
    """Reference ``AnnCoreState`` (numpy or array leaves) -> the port's."""
    device = resolve_device(device)
    return AnnCoreState(
        neuron=adex.NeuronState(*(_t(x, device) for x in ref.neuron)),
        stp=stp.STPState(*(_t(x, device) for x in ref.stp)),
        corr=correlation.CorrelationState(
            *(_t(x, device) for x in ref.corr)),
        syn=synapse.SynapseArray(*(_t(x, device) for x in ref.syn)),
        rate_counters=_t(ref.rate_counters, device))


def experiment_state(ref, device=None) -> ExperimentState:
    """Reference ``ExperimentState`` -> the port's. The reference's PRNG
    key, telemetry and wafer slots are dropped: replay the key with
    ``replay_reference_draws`` instead."""
    device = resolve_device(device)
    return ExperimentState(core=core_state(ref.core, device),
                           w_signed=_t(ref.w_signed, device),
                           mean_reward=_t(ref.mean_reward, device))


def to_numpy(tree):
    """Port state (any nesting of NamedTuples, dicts and tensors) -> the
    same structure with numpy leaves, comparable field by field with the
    reference's."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [to_numpy(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _t(tree, device)


def params(ref_tree, device=None, ctx=None, decls=None) -> Dict:
    """A reference LM state tree, nested dicts with numpy leaves (the
    parameters of ``init_params`` over ``build_model(...).decls``, an
    AdamW state ``{m, v, step}``, an error-feedback tree, a decode cache)
    -> the same tree of tensors on ``device``, leaf for leaf (0-d leaves
    stay 0-d, dtypes stay). With a ``ctx`` on a device mesh each leaf is
    placed on it by ``decls`` (the tree's ``ParamDecl`` tree), each rank
    keeping its shard."""
    if ctx is None or not ctx.places:
        return _tree(ref_tree, resolve_device(device))
    if decls is None:
        raise ValueError("placing a tree on a device mesh needs its decls")
    return place_tree(_tree(ref_tree, "cpu"), decls, ctx)


lm_cache = params     # the decode cache is a tree like the parameters


def draws(events, xi, device=None) -> Draws:
    """Injected draws: events [n_trials, T, *prefix, 2I], xi
    [n_trials, *prefix, I, C]."""
    device = resolve_device(device)
    return Draws(events=_t(np.asarray(events, np.float32), device),
                 xi=_t(np.asarray(xi, np.float32), device))


def plan(ref_plan) -> WaferPlan:
    """Reference ``WaferPlan`` -> the port's: the same topology, geometry
    and route / forward arrays (int32 copies), validated again."""
    topo = ref_plan.topology
    return WaferPlan(
        topology=WaferTopology(topo.n_chips, topo.kind),
        n_rows=ref_plan.n_rows, n_cols=ref_plan.n_cols,
        **{k: np.array(getattr(ref_plan, k), np.int32) for k in _PLAN_ARRAYS})


def mapping(ref_mapping) -> ChipMapping:
    """Reference ``ChipMapping`` -> the port's: the spec, the column
    partition, the row tables and planes (numpy copies in the same
    dtypes), the plan (``plan``) and the relay counts, validated again."""
    r = ref_mapping
    spec = NetworkSpec(n_in=r.spec.n_in, n_neurons=r.spec.n_neurons,
                       w_in=np.array(r.spec.w_in),
                       w_rec=np.array(r.spec.w_rec), name=r.spec.name)
    part = ColumnPartition(col_chip=np.array(r.part.col_chip),
                           col_slot=np.array(r.part.col_slot),
                           n_chips=r.part.n_chips, chip_cols=r.part.chip_cols)
    out = ChipMapping(
        spec=spec, part=part, plan=plan(r.plan),
        n_relayed_edges=r.n_relayed_edges, n_transit_rows=r.n_transit_rows,
        **{k: np.array(getattr(r, k)) for k in (
            "row_source", "row_sign", "row_addr", "weights", "addresses")})
    out.validate()
    return out


def replay_reference_draws(jax_random, key, stims,
                           ecfg: RSTDPConfig = RSTDPConfig(), prefix=(),
                           device=None) -> Draws:
    """The draws the reference's ``scanned_training`` consumes from
    ``key`` for the stimuli ``stims`` (``repro/core/hybrid.py:460-466``
    for the events, ``:446`` then ``:481-482`` for xi), as ``Draws``.

    ``jax_random`` is the ``jax.random`` module; ``key`` the reference's
    run key (``PRNGKey(seed + 1)`` in ``run_training``, or a state's
    ``key`` to continue a run)."""
    T, I, C = ecfg.trial_steps, ecfg.n_inputs, ecfg.n_neurons
    bgs, xis = [], []
    k = key
    for _ in range(len(stims)):
        k, k_ev, k_rule = jax_random.split(k, 3)
        kb, _kp = jax_random.split(k_ev)
        u = np.asarray(jax_random.uniform(kb, (T, *prefix, I)))
        bgs.append((u < np.float32(ecfg.bg_prob)).astype(np.float32))
        _key, sub = jax_random.split(k_rule)
        xis.append(np.asarray(
            ecfg.noise * jax_random.normal(sub, (*prefix, I, C))))
    bg = torch.from_numpy(np.stack(bgs))
    ev = events_from_background(bg, np.asarray(stims), ecfg)
    return draws(ev.numpy(), np.stack(xis), device)


def replay_rstdp_xi(jax_random, key, shape, noise: float, device=None):
    """The xi plane the reference's ``VectorUnit.apply_rstdp`` /
    ``rules.rstdp`` draws from the rule state's ``key``
    (``repro/core/ppu.py:170-171``): ``key, sub = split(key)``, then
    ``noise * normal(sub, shape)``. Returns ``(next key, xi)``, the key
    for the reference's next call and xi as a float32 tensor on
    ``device``."""
    device = resolve_device(device)
    key, sub = jax_random.split(key)
    xi = np.asarray(noise * jax_random.normal(sub, tuple(shape)), np.float32)
    return key, _t(xi, device)


def replay_three_factor_draws(jax_random, key, n_tokens: int, vocab: int,
                              d_model: int, noise: float = 0.0,
                              device=None):
    """The draws one step of the reference's ``HybridReadoutTrainer``
    consumes from its state's ``key``
    (``repro/plasticity/three_factor.py:87-98``): ``key, k_samp, k_noise =
    split(key, 3)``; ``categorical(k_samp, logits / T)`` is
    ``argmax(gumbel(k_samp, [N, V]) + logits / T)``, and with ``noise > 0``
    ``normal(k_noise, [d, V])``. Returns ``(next key, gumbel, noise or
    None)``, the draws as float32 tensors on ``device`` for the port's
    ``step(..., gumbel=, noise=)``."""
    device = resolve_device(device)
    key, k_samp, k_noise = jax_random.split(key, 3)
    g = _t(np.asarray(jax_random.gumbel(k_samp, (n_tokens, vocab)),
                      np.float32), device)
    nz = None
    if noise:
        nz = _t(np.asarray(jax_random.normal(k_noise, (d_model, vocab)),
                           np.float32), device)
    return key, g, nz
