"""The paper's hybrid-plasticity scheme as an LM feature
(``repro/plasticity/three_factor.py``).

BrainScaleS-2's learning rules are software on a processor coupled to
the substrate, fed by local correlation observables and a global scalar
factor, writing quantized weights with no host round trip. On the LM:

  * substrate      = the frozen backbone producing features;
  * correlations   = eligibility e = phi(x) (outer) (onehot(sample) - p),
                     the local pre/post correlation of the readout;
  * global factor  = R - <R> with R = [sampled token == label]
                     (reward-modulated, paper Eqs. 2-3);
  * PPU semantics  = the whole update is device work with no read to the
                     host, and the readout weights live quantized
                     (``arch.plasticity_bits``, 6-bit signed by default,
                     like the synapse SRAM) with saturating writes.

Sampling is the Gumbel-max form of ``jax.random.categorical``:
``argmax(logits / T + g)`` with ``g`` standard Gumbel. ``step`` takes
``g`` (and the weight noise) as injected draws; without them it draws
from the state's ``torch.Generator``.

Under a device mesh the frozen backbone runs on the placed parameters
(plain leaves are placed by their decls); its features are gathered
whole, and the int8 readout and its update stay replicated: every rank
computes them alike from the same draws (the same seed on every rank).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.config import ArchConfig
from repro_torch.models.transformer import build_model, prefix_len
from repro_torch.parallel.sharding import ShardingCtx, full, place_tree


@dataclasses.dataclass(frozen=True)
class ThreeFactorConfig:
    eta: float = 2.0
    gamma: float = 0.05          # <R> tracking (paper Eq. 2)
    w_scale: float = 0.02        # dequant scale per LSB
    noise: float = 0.0
    temperature: float = 1.0


class PlasticState(NamedTuple):
    w_q: torch.Tensor            # [d, V] int8 quantized readout
    mean_r: torch.Tensor         # 0-d <R>
    generator: torch.Generator   # the sampling and noise draws


def sample_gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, ``u`` uniform in
    [tiny, 1) (``jax.random.gumbel``'s construction), on the generator's
    device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class HybridReadoutTrainer:
    """Reward-modulated plasticity on a quantized readout head, on
    ``device`` (``None``: ``cuda``, raising without a card; under a
    device mesh the rank's device)."""

    def __init__(self, arch: ArchConfig, ctx: Optional[ShardingCtx] = None,
                 pcfg: ThreeFactorConfig = ThreeFactorConfig(),
                 device=None):
        self.arch = arch
        self.ctx = ctx or ShardingCtx()
        self.pcfg = pcfg
        self.device = self.ctx.device or resolve_device(device)
        self.bundle = build_model(arch, self.ctx)
        self.wmax = 2 ** (arch.plasticity_bits - 1) - 1    # signed 6-bit: 31

    def init_state(self, generator: torch.Generator) -> PlasticState:
        d, v = self.arch.d_model, self.arch.vocab_padded
        return PlasticState(
            w_q=torch.zeros((d, v), dtype=torch.int8, device=self.device),
            mean_r=torch.zeros((), dtype=torch.float32, device=self.device),
            generator=generator)

    def step(self, params, pstate: PlasticState, batch, gumbel=None,
             noise=None):
        """One hybrid-plasticity step on the device, with no read to the
        host. ``gumbel`` [N, V] (N = batch x label positions) and
        ``noise`` [d, V] replace the generator's draws where given.
        Returns (new state, metrics as 0-d tensors)."""
        w_new, mean_r, metrics = self.update(params, pstate, batch, gumbel,
                                             noise)
        # PPU write-back: saturating quantized store
        w_q = torch.clamp(torch.round(w_new), -self.wmax, self.wmax
                          ).to(torch.int8)
        return PlasticState(w_q=w_q, mean_r=mean_r,
                            generator=pstate.generator), metrics

    @torch.no_grad()
    def update(self, params, pstate: PlasticState, batch, gumbel=None,
               noise=None):
        """The step before the write-back: ``(w_new, mean_r, metrics)``,
        ``w_new`` the updated readout in LSBs as float32, which ``step``
        rounds and clips to the signed ``plasticity_bits`` range."""
        arch, pcfg = self.arch, self.pcfg
        # substrate forward (backbone frozen: the "analog core")
        params = place_tree(params, self.bundle.decls, self.ctx)
        feats = full(self.bundle.features(params, batch, use_remat=False)[0])
        pl_ = prefix_len(arch)
        if pl_:
            feats = feats[:, pl_:]
        labels = batch["labels"]
        b, s, d = feats.shape
        phi = feats.reshape(b * s, d).float()
        y = labels.reshape(b * s).long()

        w = pstate.w_q.float() * pcfg.w_scale
        logits = phi @ w                                    # [N, V]
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < arch.vocab, logits, -1e30)
        z = logits / pcfg.temperature
        p = torch.softmax(z, dim=-1)

        if gumbel is None:
            gumbel = sample_gumbel(pstate.generator, z.shape)
        samp = torch.argmax(gumbel + z, dim=-1)
        r = (samp == y).float()                             # [N]
        mean_r = pstate.mean_r + pcfg.gamma * (torch.mean(r) - pstate.mean_r)
        mod = r - mean_r                                    # Eq. 2/3

        # local eligibility: pre (outer) (post_sampled - expectation);
        # -p + 1 at the sample is onehot - p bit for bit
        post = p.neg_().scatter_add_(
            1, samp[:, None], torch.ones_like(samp[:, None], dtype=p.dtype))
        dw = pcfg.eta * torch.einsum("n,nd,nv->dv", mod, phi, post) \
            / phi.shape[0]
        if pcfg.noise:
            if noise is None:
                noise = torch.randn(dw.shape, generator=pstate.generator,
                                    device=pstate.generator.device)
            dw = dw + pcfg.noise * noise

        w_new = pstate.w_q.float() + dw / pcfg.w_scale
        metrics = dict(reward=torch.mean(r), mean_r=mean_r,
                       acc_greedy=torch.mean(
                           (torch.argmax(logits, -1) == y).float()))
        return w_new, mean_r, metrics

    def host_loop_step(self, params, pstate: PlasticState, batch,
                       gumbel=None, noise=None):
        """Host-in-the-loop baseline: the state crosses to the host and
        back, and the metrics come back as numpy (the pre-BSS2 workflow
        the paper's architecture eliminates)."""
        dev = pstate.w_q.device
        pstate = PlasticState(w_q=pstate.w_q.cpu().to(dev),
                              mean_r=pstate.mean_r.cpu().to(dev),
                              generator=pstate.generator)
        new, m = self.step(params, pstate, batch, gumbel, noise)
        return new, {k: v.cpu().numpy() for k, v in m.items()}
