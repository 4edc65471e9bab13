"""Plasticity rules executed by the PPU vector unit (the twin of
``repro/core/rules.py``).

R-STDP (the paper's §5 experiment, Eqs. 2-3):

    <R_i>  <-  <R_i> + gamma (R_i - <R_i>)                      (2)
    dw_ij  =   eta * (R_i - <R_i>) * e_ij + xi_ij               (3)

with e_ij the causal STDP eligibility from the analog correlation sensors
and xi a small random walk. Also provided: plain additive STDP and a
rate-homeostasis rule.

The reference draws xi from a ``jax.random`` key carried in the rule
state. Here the xi plane is injected (``xi=``, e.g. the reference's draw
replayed by ``repro_torch.convert.replay_rstdp_xi``) or drawn from a
``torch.Generator``; the rule state holds no key.
"""
from __future__ import annotations

import torch


def draw_xi(shape, noise: float, generator: torch.Generator, device):
    """The random-walk plane ``noise * N(0, 1)`` of ``shape``, drawn on the
    generator's device and moved to ``device``."""
    return (noise * torch.randn(shape, generator=generator,
                                device=generator.device)).to(device)


def rstdp(weights, obs, rule_state, *, reward, eta: float = 0.5,
          gamma: float = 0.3, noise: float = 0.3, xi=None,
          generator: torch.Generator = None):
    """Reward-modulated STDP (paper Eqs. 2-3).

    weights: [..., R, C] float32; obs['causal'/'acausal']: [..., R, C]
    int codes; reward: [..., C]; rule_state: dict(mean_reward=[..., C]).
    ``xi``: the injected [..., R, C] random walk (already scaled by
    ``noise``); without it the walk is drawn from ``generator``.
    """
    mean_r = rule_state["mean_reward"]
    mean_r_new = mean_r + gamma * (reward - mean_r)                   # Eq. 2
    elig = (obs["causal"] - obs["acausal"]).to(torch.float32) / 255.0
    mod = (reward - mean_r).unsqueeze(-2)                             # Eq. 3
    if xi is None:
        if generator is None:
            raise ValueError("rstdp: pass the xi plane or a generator")
        xi = draw_xi(weights.shape, noise, generator, weights.device)
    w_new = weights + eta * mod * elig + xi
    return w_new, dict(mean_reward=mean_r_new)


def stdp(weights, obs, rule_state, *, eta_plus: float = 0.1,
         eta_minus: float = 0.12):
    """Plain additive STDP from the correlation codes."""
    dw = (eta_plus * obs["causal"].to(torch.float32)
          - eta_minus * obs["acausal"].to(torch.float32)) / 255.0
    return weights + dw, rule_state


def homeostasis(weights, obs, rule_state, *, target_rate: float,
                eta: float = 0.2):
    """Rate homeostasis: scale a column's weights toward a target rate."""
    err = (target_rate - obs["rates"]).unsqueeze(-2)
    return weights + eta * err, rule_state
